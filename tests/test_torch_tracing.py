"""The port's span plane (``utils/tracing.py``) held to the JAX package on
the CPU.

Byte for byte: head sampling (a seeded ``zlib.crc32`` of the trace id),
the spans a tracer keeps for fixed trace ids, seeds and durations (the
slowest-decile tail keep included), traceparent handling, and the Chrome
timeline of the same flight record. Equal: the span names an engine
emits on the same stream (shard decode, query rounds with the archive)
and the timeline's event names. The torch counterparts of the JAX
profiler hooks — ``device_trace`` (``torch.profiler`` to a Chrome trace)
and ``annotate`` (``record_function``) — and the debug bundle over the
ported planes are pinned on their own.
"""

import json

import numpy as np
import pytest

from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.utils import tracing as jtr
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.utils import tracing as ttr
from tests.test_torch_ingest_wire import json_stream, pinned

SHARD_SIZES = dict(device_capacity=128, token_capacity=512,
                   assignment_capacity=512, store_capacity=1024,
                   batch_capacity=256, channels=4)


def _ids(n, seed):
    rng = np.random.default_rng(seed)
    return [f"{int(x):032x}" for x in rng.integers(0, 2**62, n)]


@pytest.mark.parametrize("sample", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("seed", [0, 7])
def test_head_sampling_matches_jax(sample, seed):
    tj = jtr.SpanTracer(sample=sample, seed=seed)
    tt = ttr.SpanTracer(sample=sample, seed=seed)
    ids = _ids(400, seed) + ["", None]
    assert [tt.head_sampled(t) for t in ids] == [tj.head_sampled(t) for t in ids]


@pytest.mark.parametrize("seed", [1, 2])
def test_kept_spans_match_jax_for_fixed_ids_seeds_and_durations(seed):
    """The same retroactive spans (fixed names, trace ids and intervals)
    keep the same set under head sampling and the tail keep, with the
    same counters, ring and per-trace index."""
    rng = np.random.default_rng(seed)
    ids = _ids(60, seed + 10)
    tracers = [jtr.SpanTracer(capacity=200, sample=0.25, seed=seed),
               ttr.SpanTracer(capacity=200, sample=0.25, seed=seed)]
    for i in range(600):
        name = ["ingest.shard_decode", "query.round.fetch", "x.y"][i % 3]
        tid = ids[int(rng.integers(0, len(ids)))]
        t0 = int(rng.integers(0, 10**9))
        dur = int(rng.lognormal(10, 1))
        for tr in tracers:
            tr.record(name, t0, t0 + dur, trace_id=tid, shard=i % 4)
    tj, tt = tracers
    assert (tt.recorded, tt.sampled_out, tt.dropped) == (tj.recorded, tj.sampled_out,
                                                         tj.dropped)
    key = lambda spans: [(s["name"], s["traceId"], s["durUs"], s["tags"]) for s in spans]
    assert key(tt.recent(500)) == key(tj.recent(500))
    for tid in ids[:10]:
        assert key(tt.spans_of(tid)) == key(tj.spans_of(tid))
    assert ({s["traceId"] for s in tt.recent(500)}
            == {s["traceId"] for s in tj.recent(500)})


def test_traceparent_context_matches_jax():
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    for bad in (None, "", "garbage", "00-short-x-01"):
        assert ttr.trace_id_of(bad) == jtr.trace_id_of(bad)
    assert ttr.trace_id_of(tp) == jtr.trace_id_of(tp) == "ab" * 16
    assert ttr.current_traceparent() is None
    with ttr.bind_traceparent(tp):
        assert ttr.current_traceparent() == tp
        with ttr.bind_traceparent(None):
            assert ttr.current_traceparent() == tp
        tracer = ttr.SpanTracer()
        with tracer.begin("outer") as outer:
            with tracer.begin("inner") as inner:
                pass
        assert outer.trace_id == inner.trace_id == "ab" * 16
        assert inner.parent_id == outer.span_id
    assert ttr.current_traceparent() is None
    new = ttr.new_traceparent(rank=3)
    parts = new.split("-")
    assert parts[0] == "00" and len(parts[1]) == 32 and parts[1].startswith("0003")
    assert len(parts[2]) == 16 and parts[3] == "01"


def _span_engines(**kw):
    jeng = JaxEngine(JaxEngineConfig(**SHARD_SIZES, ingest_workers=2, **kw))
    teng = Engine(EngineConfig(**SHARD_SIZES, ingest_workers=2, **kw), device="cpu")
    from sitewhere_tpu.core.events import EpochBase as JaxEpoch
    from sitewhere_tpu_torch.core.events import EpochBase

    jeng.epoch, teng.epoch = pinned(JaxEpoch), pinned(EpochBase)
    return jeng, teng


def test_engine_span_names_match_jax(tmp_path):
    """The same stream leaves the same span names, with the same counts,
    in both engines: a shard decode span a shard of each batch and the
    query rounds' snapshot, archive and fetch spans."""
    jeng, teng = _span_engines(archive_segment_rows=64)
    counts = []
    for eng, d in ((jeng, "j"), (teng, "t")):
        rng = np.random.default_rng(2)
        for k in range(8):
            pay = json_stream(k, rng) + json_stream(k + 50, rng)
            eng.ingest_json_batch(pay)
        eng.flush()
        eng.query_events(limit=8)
        eng.query_events(device_token="d-3", limit=4)
        names: dict = {}
        for s in eng.tracer.recent(4096):
            names[s["name"]] = names.get(s["name"], 0) + 1
        counts.append(names)
    assert counts[1] == counts[0]
    assert counts[1]["ingest.shard_decode"] >= 8


def test_engine_span_names_match_jax_with_archive(tmp_path):
    cfg = dict(archive_segment_rows=64)
    jeng = JaxEngine(JaxEngineConfig(**SHARD_SIZES, **cfg,
                                     archive_dir=str(tmp_path / "j")))
    teng = Engine(EngineConfig(**SHARD_SIZES, **cfg, archive_dir=str(tmp_path / "t")),
                  device="cpu")
    from sitewhere_tpu.core.events import EpochBase as JaxEpoch
    from sitewhere_tpu_torch.core.events import EpochBase

    jeng.epoch, teng.epoch = pinned(JaxEpoch), pinned(EpochBase)
    counts = []
    for eng in (jeng, teng):
        rng = np.random.default_rng(9)
        for k in range(10):
            eng.ingest_json_batch(json_stream(k, rng) + json_stream(k + 30, rng))
        eng.flush()
        eng.query_events(limit=200)
        names = sorted(s["name"] for s in eng.tracer.recent(4096))
        counts.append(names)
    assert counts[1] == counts[0]
    assert "query.round.archive" in counts[1]


def test_trace_timeline_matches_jax_for_the_same_record():
    """A flight record exported as Chrome trace events gives the same
    event names, phases and durations in both packages; the engine's
    timeline merges its flight intervals with its live spans."""
    rec = {"traceId": "c" * 32, "kind": "ingest", "tenant": "t", "rank": 0,
           "payloads": 3, "startedMs": 1000,
           "stagesUs": {"decode": 5.0, "arena_fill": 6.0, "wal_append": 9.0,
                        "commit": 11.5, "wal_durable": 12.0, "dispatch": 20.0,
                        "device_ready": 80.0, "readback": 85.0}}
    assert ttr._flight_events(rec) == jtr._flight_events(rec)
    ev = ttr._flight_events(rec) + [{"name": "s", "ph": "X", "ts": 1e6, "dur": 1.0,
                                     "pid": 0, "tid": "w"}]
    assert ttr.finish_timeline("c" * 32, ev) == jtr.finish_timeline("c" * 32, ev)

    _, teng = _span_engines()
    rng = np.random.default_rng(4)
    tid = teng.ingest_json_batch(json_stream(0, rng) + json_stream(1, rng))["trace_id"]
    teng.flush()
    doc = teng.get_trace_timeline(tid)
    cats = {e.get("cat") for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert cats == {"flight", "span"}
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"ingest", "ingest.decode", "ingest.device", "ingest.shard_decode"} <= names
    json.dumps(doc)


def test_debug_bundle_over_the_ported_planes():
    eng = Engine(EngineConfig(**SHARD_SIZES, qos=True), device="cpu")
    rng = np.random.default_rng(5)
    eng.ingest_json_batch(json_stream(0, rng))
    eng.flush()
    b = ttr.debug_bundle(eng)
    for key in ("config", "prometheus", "metrics", "flights", "slowestTraces",
                "spans", "spanStats", "qos", "conservation", "device",
                "replication", "spmd"):
        assert key in b, key
    assert b["conservation"]["balanced"] and b["device"]["compileFamilies"] == {}
    assert b["replication"] == {"clustered": False} and b["spmd"] == {"spmd": False}
    assert "swtpu_engine_processed" in b["prometheus"]
    json.dumps(b, default=str)


def test_profile_threads_folds_named_stacks():
    import threading

    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="swtpu-probe", daemon=True)
    t.start()
    try:
        out = ttr.profile_threads(0.02, interval_s=0.005,
                                  thread_filter=lambda n: n == "swtpu-probe")
    finally:
        stop.set()
    assert out["samples"] >= 1 and out["threads"] == ["swtpu-probe"]
    assert all(s.startswith("swtpu-probe;") for s in out["stacks"])


def test_device_trace_and_annotate_use_the_torch_profiler(tmp_path):
    import torch

    @ttr.annotate("probe.stage")
    def work(x):
        return x * 2

    with ttr.device_trace(str(tmp_path / "prof")) as prof:
        work(torch.ones(4))
    names = {e.key for e in prof.key_averages()}
    assert "probe.stage" in names
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name") == "probe.stage" for e in doc["traceEvents"])
    assert ttr._STAGE_HIST.count(stage="probe.stage") >= 1
