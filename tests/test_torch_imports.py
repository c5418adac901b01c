"""Import hygiene of the port: ``sitewhere_tpu_torch`` and ``chip_smoke.py``
import in a subprocess where importing ``jax``, ``flax``, ``optax`` or
anything of ``sitewhere_tpu`` RAISES — the port runs on machines that have
none of them. Only the parity tests import both packages."""

import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_DRIVER = r"""
import importlib
import importlib.util
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

import sitewhere_tpu_torch

names = ["sitewhere_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(sitewhere_tpu_torch.__path__,
                                          "sitewhere_tpu_torch.")]
failures = []
for name in names:
    try:
        importlib.import_module(name)
    except BaseException as e:
        failures.append(f"{name}: {type(e).__name__}: {e}")
try:
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
except BaseException as e:
    failures.append(f"chip_smoke.py: {type(e).__name__}: {e}")
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
if leaked:
    failures.append(f"blocked modules present: {leaked}")
print(len(names))
print(" ".join(names))
print("\n".join(failures))
sys.exit(1 if failures else 0)
"""


def test_port_and_chip_smoke_import_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _DRIVER, str(REPO / "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, (
        f"the port grew a JAX import:\n{res.stdout}\n{res.stderr}")
    # every module was walked: the wire-ingest and durability modules, the
    # archive, the outbound feed, the analytics jobs and the parallel
    # package too
    count, names = res.stdout.splitlines()[:2]
    assert int(count) >= 50
    assert {"sitewhere_tpu_torch.utils.archive", "sitewhere_tpu_torch.outbound.feed",
            "sitewhere_tpu_torch.ops.window_fill",
            "sitewhere_tpu_torch.models.analytics",
            # the host plane
            "sitewhere_tpu_torch.utils.metrics", "sitewhere_tpu_torch.utils.tracing",
            "sitewhere_tpu_torch.utils.flight", "sitewhere_tpu_torch.utils.qos",
            "sitewhere_tpu_torch.utils.autotune", "sitewhere_tpu_torch.utils.devicewatch",
            "sitewhere_tpu_torch.utils.conservation", "sitewhere_tpu_torch.ingest.workers",
            "sitewhere_tpu_torch.loadgen",
            # sequence parallelism
            "sitewhere_tpu_torch.parallel", "sitewhere_tpu_torch.parallel.ring_attention",
            # the multi-shard engines and what they stand on
            "sitewhere_tpu_torch.parallel.mesh", "sitewhere_tpu_torch.parallel.router",
            "sitewhere_tpu_torch.parallel.exchange", "sitewhere_tpu_torch.parallel.sharded",
            "sitewhere_tpu_torch.parallel.multihost",
            "sitewhere_tpu_torch.parallel.placement", "sitewhere_tpu_torch.utils.shardobs",
            # the mesh product engine and the offline reshard
            "sitewhere_tpu_torch.parallel.distributed",
            "sitewhere_tpu_torch.parallel.reshard",
            # the two-process job, the event sources and the leaves under them
            "sitewhere_tpu_torch.parallel.multihost_demo",
            "sitewhere_tpu_torch.ingest.sources", "sitewhere_tpu_torch.ingest.dedup",
            "sitewhere_tpu_torch.utils.lifecycle", "sitewhere_tpu_torch.utils.scripting",
            "sitewhere_tpu_torch.utils.faults", "sitewhere_tpu_torch.native.route_fallback",
            } <= set(names.split())


_SHARDED_PROBE = r"""
import json
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

from sitewhere_tpu_torch.core.types import EventType
from sitewhere_tpu_torch.engine import EngineConfig
from sitewhere_tpu_torch.parallel.placement import shard_for_token
from sitewhere_tpu_torch.parallel.router import ShardRouter
from sitewhere_tpu_torch.parallel.sharded import ShardedEngine, SpmdEngine
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation
from sitewhere_tpu_torch.utils.metrics import MetricsRegistry, export_spmd_metrics

eng = SpmdEngine(EngineConfig(device_capacity=16, token_capacity=32,
                              assignment_capacity=32, store_capacity=256,
                              batch_capacity=16, channels=4, use_native=False),
                 n_shards=2, device="cpu")
wire = [json.dumps({"deviceToken": f"d{i % 5}", "type": "DeviceMeasurement",
                    "request": {"name": "t", "value": float(i), "eventDate": 1000 + i}}
                   ).encode() for i in range(20)]
eng.ingest_json_batch(wire)
eng.flush()
page = eng.query_events(limit=5)
ok = check_conservation(build_ledger(eng)) == []
reg = MetricsRegistry()
export_spmd_metrics(eng, reg)
sh = ShardedEngine(n_shards=2, device_capacity_per_shard=8, token_capacity_per_shard=8,
                   assignment_capacity_per_shard=8, store_capacity_per_shard=64,
                   channels=4, device="cpu")
router = ShardRouter(2, 8, 8, 4)
for t in range(12):
    router.append(EventType.MEASUREMENT, t, 0, t, t, values=[1.0])
sh.step(router.emit())
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(json.dumps({"persisted": eng.metrics()["persisted"], "total": page["total"],
                  "conserved": ok, "sharded": sh.global_metrics()["processed"],
                  "shards": sorted({shard_for_token(f"d{i}", 2) for i in range(5)}),
                  "leaked": leaked}))
"""


def test_sharded_engines_run_with_jax_blocked():
    """The multi-shard engines, the slot map, the router, the shard metrics
    and the conservation stage run end to end where jax and the JAX
    package cannot be imported."""
    res = subprocess.run([sys.executable, "-c", _SHARDED_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"persisted": 20, "total": 20, "conserved": True, "sharded": 12,
                   "shards": [0, 1], "leaked": []}


_DISTRIBUTED_PROBE = r"""
import json
import pathlib
import sys
import tempfile

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

from sitewhere_tpu_torch.parallel.distributed import (DistributedConfig,
                                                      DistributedEngine,
                                                      recover_distributed,
                                                      restore_distributed)
from sitewhere_tpu_torch.parallel.reshard import reshard_snapshot
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation

tmp = pathlib.Path(tempfile.mkdtemp())
eng = DistributedEngine(DistributedConfig(
    n_shards=2, device_capacity_per_shard=16, token_capacity_per_shard=32,
    assignment_capacity_per_shard=32, store_capacity_per_shard=128, channels=4,
    batch_capacity_per_shard=16, wal_dir=str(tmp / "wal"), device="cpu"))
wire = [json.dumps({"deviceToken": f"d{i % 5}", "type": "DeviceMeasurement",
                    "request": {"name": "t", "value": float(i), "eventDate": 1000 + i}}
                   ).encode() for i in range(20)]
eng.ingest_json_batch(wire[:10])
eng.flush()
eng.save(tmp / "snap")
eng.ingest_json_batch(wire[10:])
eng.flush()
ok = check_conservation(build_ledger(eng)) == []
eng.wal.close()
back = recover_distributed(tmp / "snap", device="cpu")
reshard_snapshot(tmp / "snap", tmp / "one", 1)
one = restore_distributed(tmp / "one", device="cpu")
feed = eng.make_feed_consumer("g").poll()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(json.dumps({"persisted": back.metrics()["persisted"],
                  "resharded": one.metrics()["persisted"], "feed": len(feed),
                  "total": eng.query_events(limit=5)["total"], "conserved": ok,
                  "leaked": leaked}))
"""


def test_distributed_engine_runs_with_jax_blocked():
    """The mesh engine, its WAL recovery, the offline reshard, the feed and
    the conservation ledger run where jax and the JAX package cannot be
    imported."""
    res = subprocess.run([sys.executable, "-c", _DISTRIBUTED_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"persisted": 20, "resharded": 10, "feed": 20, "total": 20,
                   "conserved": True, "leaked": []}


_SOURCES_PROBE = r"""
import asyncio
import json
import sys
import tempfile

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.decoders import (CompositeDecoder,
                                                 JsonBatchEventDecoder,
                                                 JsonDeviceRequestDecoder)
from sitewhere_tpu_torch.ingest.dedup import AlternateIdDeduplicator
from sitewhere_tpu_torch.ingest.sources import (EventSourcesManager, InboundEventSource,
                                                InMemoryEventReceiver,
                                                SocketEventReceiver)
from sitewhere_tpu_torch.models import anomaly as tan
from sitewhere_tpu_torch.native.binding import route_payloads
from sitewhere_tpu_torch.parallel.multihost_demo import worker_main

# the demo's worker, as one process of a job of one
worker_main(0, 1, f"file://{tempfile.mkdtemp()}/store", 2, "cpu")

# one DP x TP step on a (1, 1) mesh
dist.init_process_group("gloo", init_method=f"file://{tempfile.mkdtemp()}/store",
                        rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "tp"))
cfg = tan.AnomalyConfig(sensors=2, window=4, hidden=8, lstm_hidden=8, latent=2,
                        dtype=torch.float32)
model = tan.distribute_model(tan.AnomalyModel(cfg, device="cpu"), mesh)
step = tan.make_train_step_dp_tp(model, tan.adamw(model.parameters(), 1e-3), mesh)
loss = float(step(torch.rand(2, 4, 2)))
dist.destroy_process_group()

# a receiver -> decoder -> dedup -> manager -> Engine.process
eng = Engine(EngineConfig(device_capacity=16, token_capacity=32, assignment_capacity=32,
                          store_capacity=256, batch_capacity=16, channels=4),
             device="cpu")
mgr = EventSourcesManager(eng.process, eng.process)
mem, sock = InMemoryEventReceiver(), SocketEventReceiver(framing="newline")
mgr.add_source(InboundEventSource("m", JsonDeviceRequestDecoder(), [mem],
                                  AlternateIdDeduplicator()))
mgr.add_source(InboundEventSource("s", CompositeDecoder(
    lambda p, m: ("batch", p), {"batch": JsonBatchEventDecoder()}), [sock]))
msg = json.dumps({"deviceToken": "a", "type": "DeviceMeasurement",
                  "request": {"name": "t", "value": 1.0, "alternateId": "x"}}).encode()

async def run():
    await mgr.initialize()
    await mgr.start()
    _, w = await asyncio.open_connection("127.0.0.1", sock.bound_port)
    w.write(b"[" + msg + b"]\n")
    await w.drain()
    w.close()
    await asyncio.sleep(0.2)
    await mgr.stop()

mem.submit(msg)
mem.submit(msg)
asyncio.run(run())
eng.flush()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(json.dumps({"finite": loss == loss, "processed": eng.metrics()["processed"],
                  "routes": route_payloads([msg], 3).tolist(), "leaked": leaked}))
"""


def test_demo_worker_tp_step_and_sources_run_with_jax_blocked():
    """The two-process demo's worker, a DP x TP step on a one-rank mesh and
    the event sources into the engine run where jax and the JAX package
    cannot be imported."""
    res = subprocess.run([sys.executable, "-c", _SOURCES_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("MULTIHOST_OK rank=0/1 shards=[0, 1] persisted=48")
    out = json.loads(lines[-1])
    assert out["finite"] and out["processed"] == 2 and out["leaked"] == []
    assert len(out["routes"]) == 1


_TRAIN_PROBE = r"""
import json
import math
import pathlib
import sys
import tempfile

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the port tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

import torch

from sitewhere_tpu_torch.convert import adamw_state_from_optax
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.models.anomaly import (AnomalyConfig, AnomalyModel, adamw,
                                                loss_fn, make_train_step)
from sitewhere_tpu_torch.models.service import AnalyticsService
from sitewhere_tpu_torch.rules import RuleSetWatcher, RulesManager

eng = Engine(EngineConfig(device_capacity=16, token_capacity=32, assignment_capacity=32,
                          store_capacity=256, batch_capacity=16, channels=4,
                          analytics_devices=8, analytics_window=4, use_native=False),
             device="cpu")
for t in range(6):
    for d in range(4):
        eng.process(DecodedRequest(type=RequestType.DEVICE_MEASUREMENT,
                                   device_token=f"d{d}",
                                   measurements={"a": float(t * d), "b": float(t)}))
eng.flush()
cfg = AnomalyConfig(sensors=4, window=4, hidden=8, lstm_hidden=8, latent=2)
svc = AnalyticsService(eng, cfg)
loss = svc.train_on_live(batch_size=4, steps=2)
tmp = pathlib.Path(tempfile.mkdtemp())
svc.save_model(tmp / "ckpt")
back = AnalyticsService(eng, cfg, seed=1)
back.restore_model(tmp / "ckpt")
same = all(torch.equal(back.model.state_dict()[k], v)
           for k, v in svc.model.state_dict().items())
mgr = RulesManager(eng, active=False)
rules = tmp / "rules.json"
rules.write_text(json.dumps({"name": "r", "rules": [
    {"name": "hot", "kind": "threshold", "channel": "a", "op": ">", "value": 9.0}]}))
w = RuleSetWatcher(mgr, rules, interval_s=0.01)
w.start()
w.stop()
mgr.promote()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(math.isfinite(loss), same, mgr.active, mgr.spill_rollups(), leaked)
sys.exit(0 if math.isfinite(loss) and same and mgr.active and not leaked else 1)
"""


def test_training_and_rules_runtime_run_with_jax_blocked():
    """Training, the checkpoint, standby promotion, the watcher and the
    rollup spill run in a process where importing ``jax``, ``optax``,
    ``flax``, ``orbax`` or the JAX package raises."""
    res = subprocess.run([sys.executable, "-c", _TRAIN_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    assert res.stdout.split() == ["True", "True", "True", "{'spilled':", "0,",
                                  "'rollups':", "0}", "[]"]


_WORKER_PROBE = r"""
import sys
import threading

BLOCKED = ("torch", "jax", "jaxlib", "flax", "optax", "sitewhere_tpu")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"BLOCKED: the decode worker tried to import {name!r}")
        return None

sys.meta_path.insert(0, _Blocker())

import multiprocessing as mp
import numpy as np
from multiprocessing import shared_memory

from sitewhere_tpu_torch.ingest import workers

# one decode job through the worker's own loop, in this torch-less process
max_msgs, max_bytes, channels = 8, 4096, 4
shm_in = shared_memory.SharedMemory(create=True, size=workers._HDR * 8
                                    + (max_msgs + 1) * 8 + max_bytes)
shm_out = shared_memory.SharedMemory(create=True,
                                     size=workers._out_bytes(max_msgs, channels))
parent, child = mp.Pipe()
t = threading.Thread(target=workers._worker_main,
                     args=(child, shm_in.name, shm_out.name, max_msgs, max_bytes,
                           channels, 64))
t.start()
pay = [b'{"deviceToken": "wk-1", "type": "DeviceMeasurement",'
       b' "request": {"name": "temp", "value": 21.5}}']
hdr = np.ndarray((workers._HDR,), np.int64, buffer=shm_in.buf)
offs = np.ndarray((max_msgs + 1,), np.int64, buffer=shm_in.buf, offset=workers._HDR * 8)
data_off = workers._HDR * 8 + (max_msgs + 1) * 8
offs[0], offs[1] = 0, len(pay[0])
shm_in.buf[data_off:data_off + len(pay[0])] = pay[0]
hdr[0], hdr[1] = 1, len(pay[0])
parent.send(("decode",))
reply = parent.recv()
parent.send(None)
t.join(timeout=30)
shm_in.close(); shm_in.unlink(); shm_out.close(); shm_out.unlink()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
print(reply[0], reply[1], reply[3], reply[4])
sys.exit(1 if leaked or reply[:2] != ("done", 1) else 0)
"""


def test_decode_worker_entry_runs_with_torch_blocked():
    """A spawned ``DecodeWorkerPool`` child imports only the worker's module
    chain: ``_worker_main`` imports and decodes a batch in a process where
    importing ``torch`` (or JAX, or the JAX package) raises."""
    res = subprocess.run([sys.executable, "-c", _WORKER_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    assert res.stdout.split()[:3] == ["done", "1", "['wk-1']"]


def test_entry_points_raise_without_a_gpu(tmp_path):
    """Called with no ``device``, an entry point asks for CUDA and raises on
    a machine without one, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from sitewhere_tpu_torch.core.events import EventBatch, HostEventBuffer
    from sitewhere_tpu_torch.engine import Engine, EngineConfig
    from sitewhere_tpu_torch.models.anomaly import AnomalyConfig, AnomalyModel
    from sitewhere_tpu_torch.models.transformer import (TelemetryTransformer,
                                                        TransformerConfig)
    from sitewhere_tpu_torch.ops.rules import RollupBlock, RuleBlock
    from sitewhere_tpu_torch.pipeline import PipelineState
    from sitewhere_tpu_torch.utils.checkpoint import (recover_engine,
                                                      restore_engine,
                                                      save_engine)

    small = EngineConfig(device_capacity=8, token_capacity=8,
                         assignment_capacity=8, store_capacity=64,
                         batch_capacity=8)
    save_engine(Engine(small, device="cpu"), tmp_path / "snap")
    calls = [
        lambda: Engine(small),
        lambda: Engine(dataclasses.replace(small, use_native=False)),
        lambda: restore_engine(tmp_path / "snap"),
        lambda: recover_engine(tmp_path / "snap"),
        lambda: PipelineState.create(8, 8, 8, 64),
        lambda: EventBatch.zeros(4),
        lambda: HostEventBuffer(4).emit(),
        lambda: AnomalyModel(AnomalyConfig(sensors=2, window=4, hidden=8,
                                           lstm_hidden=8, latent=2)),
        lambda: TelemetryTransformer(TransformerConfig(sensors=2, d_model=16,
                                                       heads=1, layers=1, mlp=8)),
        lambda: RuleBlock.zeros(
            {k: [0] for k in ("active", "etype", "tenant", "ch_a", "val_a",
                              "ch_b", "val_b", "window_ms")},
            ((0, 0, 3, 0, -1),), groups=4),
        lambda: RollupBlock.zeros(
            {k: [0] for k in ("channel", "scope", "etype", "window_ms")},
            groups=4, buckets=2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """``python3 chip_smoke.py`` exits non-zero and prints no result line
    when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_ab_records_a_tree_without_a_card_and_fails(tmp_path):
    """``chip_ab.py`` runs each tree in a process of its own: without a
    card the tree's record carries the error, no timings, and the run
    exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = tmp_path / "ab.json"
    res = subprocess.run([sys.executable, str(REPO / "chip_ab.py"), "--out", str(out),
                          "--shapes", "d64_bf16", str(REPO)],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 1, res.stderr
    (run,) = json.loads(out.read_text())["runs"]
    assert "no CUDA device" in run["error"] and "timings" not in run
