"""The port's multiprocess ``DecodeWorkerPool`` (``ingest/workers.py``) held
to the JAX package's pool and to the in-process path on the CPU.

Each pool here spawns at most two decode processes. Byte for byte: the
state, host mirrors and summaries of a port engine fed through a 2-worker
pool against a JAX engine fed through its own 2-worker pool, and against a
port engine decoding in-process — with measurement names, alert types and
alternate ids interned in other orders by the workers than by the engine
(the dictionary federation and the lane permutation), location rows
through a shifted lane map, registration envelopes and broken payloads.
The ambiguous-lane fallback, the refusals, the autotuner's fan-out knob
of the sharded decoder and its spans are pinned too.
"""

import json

import numpy as np
import pytest

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.ingest.workers import DecodeWorkerPool as JaxPool
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.workers import DecodeWorkerPool
from tests.test_torch_ingest_wire import BASE_MS, assert_engines_equal, pinned
from tests.torch_parity import assert_tree_equal

CFG = dict(device_capacity=256, token_capacity=512, assignment_capacity=512,
           store_capacity=4096, batch_capacity=64, channels=8)


def _batches(seed: int, n: int = 6) -> list[list[bytes]]:
    """Batches whose names, alert types and alternate ids arrive in a
    different first-seen order per batch (each worker interns its own
    subset), with locations, an envelope and broken payloads."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        pay = []
        for i in range(40):
            d = f"w-{int(rng.integers(0, 24))}"
            ts = BASE_MS + 50 * b + i
            kind = rng.random()
            if kind < 0.55:
                names = rng.permutation(["n0", "n1", "n2", f"x{b % 3}"])[:2]
                req = {"type": "DeviceMeasurements", "request": {
                    "measurements": {str(n): float(i) * 0.5 for n in names},
                    "eventDate": ts, "alternateId": f"alt-{b}-{i % 5}"}}
            elif kind < 0.75:
                req = {"type": "DeviceLocation", "request": {
                    "latitude": float(i), "longitude": -float(b),
                    "elevation": 2.5, "eventDate": ts}}
            else:
                req = {"type": "DeviceAlert", "request": {
                    "type": f"a{int(rng.integers(0, 4))}", "level": "Error",
                    "eventDate": ts}}
            pay.append(json.dumps({"deviceToken": d, **req}).encode())
        pay.insert(7, json.dumps({"deviceToken": f"gw-{b}", "type": "RegisterDevice",
                                  "request": {"deviceTypeToken": "gw"}}).encode())
        pay.append(b"{broken")
        out.append(pay)
    return out


def _engines(**kw):
    jeng = JaxEngine(JaxEngineConfig(**CFG, **kw))
    teng = Engine(EngineConfig(**CFG, **kw), device="cpu")
    ref = Engine(EngineConfig(**CFG, **kw), device="cpu")
    jeng.epoch, teng.epoch, ref.epoch = (pinned(JaxEpoch), pinned(EpochBase),
                                         pinned(EpochBase))
    return jeng, teng, ref


@pytest.mark.parametrize("path", ["arena", "copy"])
def test_two_worker_pool_matches_jax_pool_and_in_process(path):
    kw = {} if path == "arena" else dict(ingest_arenas=-1)
    jeng, teng, ref = _engines(**kw)
    # the engine knows some names first, so worker name ids diverge
    seed_batch = [json.dumps({"deviceToken": "seed", "type": "DeviceMeasurements",
                              "request": {"measurements": {"x2": 1.0, "n2": 2.0},
                                          "eventDate": BASE_MS}}).encode()]
    for eng in (jeng, teng, ref):
        eng.ingest_json_batch(seed_batch)
        eng.flush()
    batches = _batches(3)
    with JaxPool(jeng, n_workers=2, max_msgs=64) as jp, \
            DecodeWorkerPool(teng, n_workers=2, max_msgs=64) as tp:
        for b in batches:
            jp.submit(b)
            tp.submit(b)
        js, ts = jp.flush(), tp.flush()
        assert ts == js
        assert tp.stats() == jp.stats() and tp.stats()["fallback_batches"] == 0
    for b in batches:
        ref.ingest_json_batch(b)
    for eng in (jeng, teng, ref):
        eng.flush()
    assert_engines_equal(jeng, teng)
    assert_tree_equal(ref.state, teng.state)
    assert teng.token_device == ref.token_device
    assert teng.query_events(alternate_id="alt-2-3")["total"] \
        == ref.query_events(alternate_id="alt-2-3")["total"] > 0


def test_pool_falls_back_on_a_lane_conflict():
    """More names than channels can make a worker's lane map ambiguous:
    the pool decodes that worker's batches in the engine instead, keeps
    every event and counts the fallback."""
    eng = Engine(EngineConfig(**{**CFG, "channels": 3}), device="cpu")
    eng.epoch = pinned(EpochBase)

    def meas(token, name, value, ts):
        return json.dumps({"deviceToken": token, "type": "DeviceMeasurements",
                           "request": {"measurements": {name: value},
                                       "eventDate": BASE_MS + ts}}).encode()

    with DecodeWorkerPool(eng, n_workers=1, max_msgs=64) as pool:
        eng.ingest_json_batch([meas("seed", "b", 1.0, 1)])
        eng.flush()
        for i, name in enumerate(["a", "b", "c", "d"]):
            pool.submit([meas("lc-1", name, float(i), 10 + i)])
        pool.flush()
        stats = pool.stats()
    eng.flush()
    assert stats["lane_conflicts"] == 1 and stats["fallback_batches"] >= 1
    m = eng.metrics()
    assert m["persisted"] >= 5
    assert m["worker_fallback_batches"] == stats["fallback_batches"]


def test_pool_refusals():
    with pytest.raises(ValueError, match="strict_channels"):
        DecodeWorkerPool(Engine(EngineConfig(**CFG, strict_channels=True),
                                device="cpu"), n_workers=1)
    with pytest.raises(ValueError, match="native"):
        DecodeWorkerPool(Engine(EngineConfig(**CFG, use_native=False), device="cpu"),
                         n_workers=1)
    eng = Engine(EngineConfig(**CFG), device="cpu")
    with DecodeWorkerPool(eng, n_workers=1, max_msgs=4, max_bytes=256) as pool:
        with pytest.raises(ValueError, match="max_msgs"):
            pool.submit([b"{}"] * 5)
        with pytest.raises(ValueError, match="max_bytes"):
            pool.submit([b"x" * 100] * 3)


def test_sharded_decoder_fan_out_knob_and_spans():
    """The autotuner's knob clamps the shard fan-out; each shard of a
    batch leaves an ``ingest.shard_decode`` span on the batch's trace."""
    eng = Engine(EngineConfig(**{**CFG, "batch_capacity": 256}, ingest_workers=2),
                 device="cpu")
    sharder = eng._sharder
    assert sharder.set_active_workers(9) == 2 and sharder.set_active_workers(0) == 1
    pay = [b for batch in _batches(4, n=8) for b in batch][:256]
    res = eng.ingest_json_batch(pay)
    assert sharder.last_workers == 1
    assert eng.set_ingest_tuning(ingest_workers=2)["ingest_workers"] == 2
    res = eng.ingest_json_batch(pay)
    eng.flush()
    assert sharder.last_workers == 2
    spans = eng.tracer.spans_of(res["trace_id"])
    assert sorted(s["tags"]["shard"] for s in spans
                  if s["name"] == "ingest.shard_decode") == [0, 1]
    (rec,) = eng.get_trace(res["trace_id"])["records"]
    assert rec["ingest_workers"] == 2
