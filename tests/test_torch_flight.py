"""The port's flight recorder (``utils/flight.py``) and its wiring in the
engine, held to the JAX package on the CPU.

Byte for byte: the recorder's ring (wraparound, eviction counts, the
trace-id index, traceparent joins) and the stage-duration rules on the
same inputs. Equal but not byte for byte (timestamps differ): the stage
names of each lifecycle record and their order, on every ingest path —
the arena, the copy path, the Python decode path (``process()``), a scan
chunk, a WAL and a deeper dispatch queue — and on the query path. Pinned
port behaviour: every summary carries a ``trace_id``, every record
reaches ``device_ready`` and ``readback`` with stage durations that sum
to no more than its end to end, a record fully dispatched by a mid-batch
flush still completes, ``device_ready`` is stamped by the wait that
observed the dispatch (not at enqueue), and a failed flush dumps the
recent records.
"""

import logging

import numpy as np
import pytest

from sitewhere_tpu.utils import flight as jflight
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.loadgen import generate_measurements_message
from sitewhere_tpu_torch.utils import flight as tflight
from tests.test_torch_ingest_wire import SIZES, engines, json_stream

PATHS = {
    "arena": {},
    "copy": dict(ingest_arenas=-1),
    "python": dict(use_native=False),
    "scan3": dict(scan_chunk=3),
    "depth2": dict(dispatch_depth=2),
    "two_threads": dict(ingest_workers=2),
}


_TAIL = ("device_ready", "readback")


def _order(rec: dict, order) -> list[str]:
    """A record's stage names in time order (ties in canonical order).
    ``device_ready`` and ``readback`` close every lifecycle in canonical
    order: the JAX arena recycle may overwrite ``device_ready`` after the
    readback, whenever its asynchronous CPU step happened to finish."""
    st = rec["stagesUs"]
    return sorted(st, key=lambda s: (s in _TAIL, 0 if s in _TAIL else st[s],
                                     order.index(s)))


def _shape(rec: dict) -> tuple:
    """What a record must share with the JAX engine's: kind, tenant,
    payloads, stage names in order, and its annotation keys (their timing
    values aside)."""
    meta = {k for k in rec if k not in ("traceId", "startedMs", "stagesUs",
                                        "rank")}
    counts = {k: rec[k] for k in ("decoded", "failed", "staged") if k in rec}
    return (rec["kind"], rec["tenant"], rec["payloads"],
            tuple(_order(rec, tflight.STAGE_ORDER)), frozenset(meta),
            tuple(sorted(counts.items())))


def _drive(eng, rng, batches=4):
    for k in range(batches):
        eng.ingest_json_batch(json_stream(k, rng), "t2" if k == 2 else "default")
        if k == 1:
            eng.flush_async()
    eng.flush()


@pytest.mark.parametrize("path", list(PATHS))
def test_stage_names_and_order_match_jax(path, tmp_path):
    """Each ingest record of the same stream carries the JAX record's
    stages in the JAX record's order, and its counts."""
    kw = dict(PATHS[path])
    jeng, teng = engines(**kw)
    for eng, seed in ((jeng, 3), (teng, 3)):
        _drive(eng, np.random.default_rng(seed))
    jr = [_shape(r) for r in reversed(jeng.recent_traces(64))]
    tr = [_shape(r) for r in reversed(teng.recent_traces(64))]
    assert tr == jr
    if path != "python":
        # the Python decode path's record ends at commit, in the JAX
        # package too: its summary stages nothing on the batch path
        for r in teng.recent_traces(64):
            st = r["stagesUs"]
            assert st["dispatch"] <= st["device_ready"] <= st["readback"]


@pytest.mark.parametrize("group_commit", [True, False])
def test_wal_stages_match_jax(tmp_path, group_commit):
    """With a WAL the records gain ``wal_append`` (and, under group
    commit, ``wal_durable`` with the gate's milliseconds)."""
    jeng, teng = (None, None)
    from sitewhere_tpu.engine import Engine as JaxEngine
    from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig

    kw = dict(SIZES, wal_group_commit=group_commit)
    jeng = JaxEngine(JaxEngineConfig(**kw, wal_dir=str(tmp_path / "j")))
    teng = Engine(EngineConfig(**kw, wal_dir=str(tmp_path / "t")), device="cpu")
    for eng in (jeng, teng):
        _drive(eng, np.random.default_rng(4), batches=3)
        eng.wal.close()
    jr = [_shape(r) for r in reversed(jeng.recent_traces(64))]
    tr = [_shape(r) for r in reversed(teng.recent_traces(64))]
    assert tr == jr
    stages = teng.recent_traces(1)[0]["stagesUs"]
    assert "wal_append" in stages
    assert ("wal_durable" in stages) == group_commit


def test_query_record_stages_match_jax(tmp_path):
    """A query's record: lookup, device, format (and archive when the
    archive answers), as the JAX engine stamps them."""
    from sitewhere_tpu.engine import Engine as JaxEngine
    from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig

    kw = dict(SIZES, archive_segment_rows=16)
    jeng = JaxEngine(JaxEngineConfig(**kw, archive_dir=str(tmp_path / "j")))
    teng = Engine(EngineConfig(**kw, archive_dir=str(tmp_path / "t")), device="cpu")
    for eng in (jeng, teng):
        _drive(eng, np.random.default_rng(5), batches=6)
        eng.query_events(limit=8)
        eng.query_events(device_token="d-1", limit=4)
        eng.query_events(tenant="nobody")
    jq = [tuple(_order(r, tflight.QUERY_STAGE_ORDER))
          for r in jeng.flight.recent(16, kind="query")]
    tq = [tuple(_order(r, tflight.QUERY_STAGE_ORDER))
          for r in teng.flight.recent(16, kind="query")]
    assert tq == jq and ("lookup", "device", "format", "archive") in tq


def test_every_record_completes_and_its_stages_fit_its_e2e():
    eng = Engine(EngineConfig(**SIZES, dispatch_depth=2), device="cpu")
    rng = np.random.default_rng(6)
    ids = [eng.ingest_json_batch(json_stream(k, rng))["trace_id"] for k in range(5)]
    eng.flush()
    for tid in ids:
        (rec,) = eng.get_trace(tid)["records"]
        st = rec["stagesUs"]
        assert {"decode", "commit", "dispatch", "device_ready", "readback"} <= set(st)
        durs = tflight.stage_durations(st)
        assert sum(v for v in durs.values() if v) * 1000 <= st["device_ready"] + 1e-6
        assert st["decode"] <= st["commit"] <= st["dispatch"] <= st["device_ready"] \
            <= st["readback"]
    assert eng.get_trace("f" * 32)["records"] == []
    assert [r["traceId"] for r in eng.recent_traces(5)] == ids[::-1]


def test_device_ready_is_stamped_by_the_wait_that_observed_the_dispatch():
    """At ``dispatch_depth`` 2 a batch's ``device_ready`` comes from the
    depth wait of the next dispatch, never from its own enqueue: it lands
    after the next batch's dispatch mark; drain stamps the last one."""
    eng = Engine(EngineConfig(**SIZES, dispatch_depth=2, ingest_arenas=-1),
                 device="cpu")
    recs = []
    for k in range(3):
        pay = [generate_measurements_message(f"w-{i % 8}", i) for i in range(20)]
        tid = eng.ingest_json_batch(pay)["trace_id"]
        eng.flush_async()
        recs.append(eng.flight._by_id[tid][0])
        assert "dispatch" in recs[-1].stages
        assert "device_ready" not in recs[-1].stages   # nothing waited yet
    for a, b in zip(recs, recs[1:]):
        assert a.stages["device_ready"] >= b.stages["dispatch"]
    eng.drain()
    assert recs[2].stages["device_ready"] <= recs[2].stages["readback"]


def test_a_batch_dispatched_mid_ingest_still_completes():
    """Copy path: a batch whose rows all dispatched in mid-ingest buffer
    flushes joins the newest in-flight dispatch and completes."""
    eng = Engine(EngineConfig(**{**SIZES, "batch_capacity": 8}, ingest_arenas=-1),
                 device="cpu")
    res = eng.ingest_json_batch([generate_measurements_message(f"lg-{i % 4}", i)
                                 for i in range(16)])
    eng.flush()
    (rec,) = eng.get_trace(res["trace_id"])["records"]
    assert {"decode", "commit", "dispatch", "device_ready", "readback"} <= set(rec["stagesUs"])


def test_slo_harvest_hands_out_each_completed_record_once():
    eng = Engine(EngineConfig(**SIZES), device="cpu")
    rng = np.random.default_rng(7)
    for k in range(3):
        eng.ingest_json_batch(json_stream(k, rng))
    eng.flush()
    first = eng.slo_harvest()
    assert len(first) == 3 and all("device_ready" in r.stages for r in first)
    assert eng.slo_harvest() == []


def test_recorder_ring_matches_jax():
    """The same begin / bind / mark sequence, with fixed traceparents,
    gives the same ring, index, eviction count and harvest in both
    packages."""
    rj, rt = jflight.FlightRecorder(capacity=5), tflight.FlightRecorder(capacity=5)
    for i in range(13):
        tp = f"00-{i % 4:032x}-{i:016x}-01"
        for rec in (rj, rt):
            r = rec.begin("ingest" if i % 3 else "query", tenant=f"t{i % 2}",
                          n_payloads=i, traceparent=tp)
            with rec.bind(r):
                rec.current().mark("decode")
                rec.current().add("path", "arena")
            if i % 2:
                r.mark("device_ready")
    for rec in (rj, rt):
        assert len(rec) == 5
    assert rt.dropped == rj.dropped
    shape = lambda recs: [(r["traceId"], r["kind"], r["tenant"], r["payloads"],
                           sorted(r["stagesUs"]), r.get("path")) for r in recs]
    assert shape(rt.recent(10)) == shape(rj.recent(10))
    assert shape(rt.recent(10, kind="query")) == shape(rj.recent(10, kind="query"))
    for i in range(4):
        tid = f"{i:032x}"
        assert shape(rt.records_of(tid)) == shape(rj.records_of(tid))
    assert ([r.trace_id for r in rt.harvest_completed()]
            == [r.trace_id for r in rj.harvest_completed()])
    off = tflight.FlightRecorder(enabled=False)
    assert off.begin("ingest").trace_id is None and len(off) == 0


def test_stage_durations_match_jax():
    rng = np.random.default_rng(8)
    names = list(tflight.STAGE_ORDER) + list(tflight.QUERY_STAGE_ORDER)
    for _ in range(200):
        keep = rng.random(len(names)) < 0.7
        st = {n: float(np.round(rng.uniform(0, 5000), 1))
              for n, k in zip(names, keep) if k}
        assert tflight.stage_durations(st) == jflight.stage_durations(st)
        assert tflight.query_stage_durations(st) == jflight.query_stage_durations(st)


def test_a_failed_flush_dumps_the_recent_records(caplog):
    eng = Engine(EngineConfig(**SIZES, ingest_arenas=-1), device="cpu")
    eng.ingest_json_batch([generate_measurements_message("e-1", 0)])

    def boom(*a, **kw):
        raise RuntimeError("step failed")

    eng._step = boom
    with caplog.at_level(logging.ERROR), pytest.raises(RuntimeError):
        eng.flush()
    assert any("last 1 flight records" in r.getMessage() for r in caplog.records)


def test_recorder_off_summaries_carry_no_trace_id():
    eng = Engine(EngineConfig(**SIZES, flight_recorder=False), device="cpu")
    res = eng.ingest_json_batch([generate_measurements_message("n-1", 0)])
    assert "trace_id" not in res and eng.recent_traces() == []
    eng.flush()
