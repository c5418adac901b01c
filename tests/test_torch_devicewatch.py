"""The memory half of the port's device plane (``utils/devicewatch.py``)
held to the JAX package on the CPU.

Equal: the memory ledger's components — state tables from each tensor's
shape and dtype, the staging-arena pool and the archive's segment cache —
and its high-watermarks, for the same configuration and stream. Pinned
divergences: the compile and retrace watchdog has nothing to watch in
eager torch, so ``compileFamilies`` is empty; the allocator fields
(``liveArrays``, ``deviceMemoryStats``) come from ``torch.cuda`` and are
None on a CPU engine. The scrape export, the query-path device-time
harvest and a ``torch.profiler`` capture are pinned on their own.
"""

import json
import pathlib

import numpy as np

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.utils import devicewatch as jdw
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.utils import devicewatch as tdw
from sitewhere_tpu_torch.utils.metrics import MetricsRegistry
from tests.test_torch_ingest_wire import SIZES, json_stream, pinned

ZONE = [[(-1.0, -1.0), (-1.0, 50.0), (10.0, 50.0), (10.0, -1.0)]]


def _engines(tmp_path, **kw):
    cfg = dict(SIZES, analytics_devices=16, analytics_window=8,
               archive_segment_rows=32, **kw)
    jeng = JaxEngine(JaxEngineConfig(**cfg, archive_dir=str(tmp_path / "j")))
    teng = Engine(EngineConfig(**cfg, archive_dir=str(tmp_path / "t")), device="cpu")
    jeng.epoch, teng.epoch = pinned(JaxEpoch), pinned(EpochBase)
    for eng in (jeng, teng):
        eng.set_geofence_zones(ZONE)
        rng = np.random.default_rng(1)
        for k in range(6):
            eng.ingest_json_batch(json_stream(k, rng))
            if k == 3:
                eng.flush_async()
        eng.flush()
        eng.query_events(limit=300)
    return jeng, teng


def test_memory_ledger_components_match_jax(tmp_path):
    jeng, teng = _engines(tmp_path, dispatch_depth=2)
    lj = jdw.memory_ledger(jeng)
    lt = tdw.memory_ledger(teng)
    assert lt["components"] == lj["components"]
    assert set(lt["components"]) >= {"ring_store", "registry", "device_state",
                                     "pipeline_metrics", "telemetry_windows",
                                     "geofence_zones", "arena_pool",
                                     "segment_cache"}
    assert lt["totalBytes"] == lj["totalBytes"]
    assert lt["highWatermarks"] == lj["highWatermarks"]
    assert lt["liveArrays"] is None and lt["deviceMemoryStats"] is None


def test_compile_families_are_empty_in_eager_torch(tmp_path):
    """The pinned divergence: no program is traced or compiled per shape,
    so the payload's compile posture is empty (the JAX one is not)."""
    jeng, teng = _engines(tmp_path)
    assert jdw.device_memory_payload(jeng)["compileFamilies"]
    doc = tdw.device_memory_payload(teng)
    assert doc["compileFamilies"] == {}
    json.dumps(doc)


def test_high_watermarks_peek_and_reset_on_scrape():
    eng = Engine(EngineConfig(**SIZES, ingest_arenas=-1), device="cpu")
    rng = np.random.default_rng(2)
    eng.ingest_json_batch(json_stream(0, rng)[:40])
    eng.flush()
    peek = tdw.memory_ledger(eng)["highWatermarks"]
    assert peek["staged_backlog_rows"] == 40
    assert tdw.memory_ledger(eng)["highWatermarks"] == peek      # a peek
    reg = MetricsRegistry()
    tdw.export_devicewatch(eng, reg)                             # the scrape
    assert tdw.memory_ledger(eng)["highWatermarks"]["staged_backlog_rows"] == 0
    g = reg.gauge("swtpu_device_mem_hwm")
    assert g.value(component="staged_backlog_rows", engine=eng.metrics_label) == 40


def test_export_devicewatch_gauges_and_query_device_time(tmp_path):
    _, teng = _engines(tmp_path)
    reg = MetricsRegistry()
    tdw.export_devicewatch(teng, reg)
    mem = reg.gauge("swtpu_device_mem_bytes")
    led = tdw.memory_ledger(teng)
    for comp, nbytes in led["components"].items():
        assert mem.value(component=comp, engine=teng.metrics_label) == nbytes
    assert reg.histogram("swtpu_device_exec_seconds").count(family="query") == 1
    tdw.export_devicewatch(teng, reg)          # each query record once
    assert reg.histogram("swtpu_device_exec_seconds").count(family="query") == 1


def test_capture_device_profile_writes_a_chrome_trace(tmp_path):
    out = tdw.capture_device_profile(1, base_dir=str(tmp_path))
    assert out["ms"] == 50.0 and "trace.json" in out["files"] and out["bytes"] > 0
    assert pathlib.Path(out["dir"]).parent == tmp_path
    json.loads((pathlib.Path(out["dir"]) / "trace.json").read_text())


def test_tree_nbytes_counts_every_tensor():
    eng = Engine(EngineConfig(**SIZES), device="cpu")
    st = eng.state.store
    assert tdw.tree_nbytes(st) == sum(
        getattr(st, f).numel() * getattr(st, f).element_size()
        for f in st.__dataclass_fields__ if hasattr(getattr(st, f), "numel"))
    assert tdw.tree_nbytes(None) == 0
