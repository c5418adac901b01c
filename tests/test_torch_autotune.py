"""The port's stage-time autotuner (``utils/autotune.py``) and
``Engine.set_ingest_tuning``, held to the JAX package on the CPU.

No test here waits on wall-clock stage times: the decision rules run over
a seeded grid of stats, and the controller steers from synthetic flight
records whose stage marks are written by the test. Byte for byte with the
JAX package: ``decide`` and ``decide_slo`` over the grid, and the
controller's decisions, stage medians and SLO p99 from the same records.
Pinned for the port: a retune of each knob keeps state byte-identical to
the JAX engine after the same retune (and, for the knobs that move no
batch boundary, to an engine that never retuned), a ``scan_chunk`` retune
drains in-flight dispatches and rebuilds the arena pool, and the
controller evaluates every ``autotune_interval`` dispatches.
"""

import numpy as np
import pytest

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.utils import autotune as jat
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.utils import autotune as tat
from sitewhere_tpu_torch.utils.metrics import REGISTRY
from tests.test_torch_ingest_wire import SIZES, assert_engines_equal, json_stream, pinned
from tests.torch_parity import assert_tree_equal

SHARD = dict(SIZES, batch_capacity=128, store_capacity=1024, ingest_workers=2)


def _stats(rng):
    return {k: (None if rng.random() < 0.1 else float(rng.lognormal(0, 1.5)))
            for k in ("decode_ms", "wal_ms", "dispatch_wait_ms", "device_ms")}


@pytest.mark.parametrize("seed", [0, 1])
def test_decide_and_decide_slo_match_jax_over_a_seeded_grid(seed):
    rng = np.random.default_rng(seed)
    fired = set()
    for _ in range(2000):
        stats = _stats(rng)
        cur = {"ingest_workers": int(rng.integers(1, 5)),
               "dispatch_depth": int(rng.integers(1, 6)),
               "scan_chunk": int(2 ** rng.integers(0, 4)),
               "shed_threshold": (None if rng.random() < 0.3
                                  else int(rng.integers(1, 4096)))}
        bounds = {"max_workers": 4, "max_depth": 4, "max_chunk": 8,
                  "min_shed": 64, "max_shed": 2048}
        out = tat.decide(stats, cur, bounds)
        assert out == jat.decide(stats, cur, bounds)
        p99 = None if rng.random() < 0.1 else float(rng.lognormal(3, 1))
        target = float(rng.choice([0.0, 10.0, 25.0, 50.0]))
        slo = tat.decide_slo(p99, target, stats, cur, bounds)
        assert slo == jat.decide_slo(p99, target, stats, cur, bounds)
        fired |= {k for k, _, _ in out + slo}
    assert fired == {"ingest_workers", "dispatch_depth", "scan_chunk",
                     "shed_threshold"}


def _synthetic(eng, n, stages_ms, tenant="default"):
    """``n`` ingest records with the given stage offsets (ms from start)."""
    for i in range(n):
        rec = eng.flight.begin("ingest", tenant=tenant, n_payloads=10 + i)
        rec.stages = {s: rec.t0_ns + int(v * (1 + 0.01 * i) * 1e6)
                      for s, v in stages_ms.items()}


SCENARIOS = {
    # decode dominates the device: widen the fan-out
    "decode": {"decode": 9.0, "arena_fill": 9.1, "commit": 9.3,
               "dispatch": 9.5, "device_ready": 11.0},
    # the device dominates the host: deepen the dispatch queue
    "device": {"decode": 0.5, "arena_fill": 0.6, "commit": 0.7,
               "dispatch": 0.8, "device_ready": 12.0},
    # dispatch waits dominate: a bigger scan chunk (opt-in)
    "dispatch": {"decode": 0.5, "commit": 0.6, "dispatch": 9.0,
                 "device_ready": 10.0},
    # with a WAL stage
    "wal": {"decode": 1.0, "wal_append": 7.0, "commit": 7.1,
            "wal_durable": 7.2, "dispatch": 7.3, "device_ready": 8.0},
}


def _tuned_engines(**kw):
    cfg = {**SHARD, **kw}
    jeng = JaxEngine(JaxEngineConfig(**cfg, autotune=True))
    teng = Engine(EngineConfig(**cfg, autotune=True), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_tuner_decisions_from_synthetic_records_match_jax(scenario):
    jeng, teng = _tuned_engines(autotune_scan_chunk=True, dispatch_depth=2)
    for eng in (jeng, teng):
        assert eng._autotuner.window_stats() is None   # below MIN_SAMPLES
        _synthetic(eng, 12, SCENARIOS[scenario])
    dj, dt = jeng._autotuner.evaluate(), teng._autotuner.evaluate()
    assert dt == dj and dt is not None
    assert teng._autotuner.current() == jeng._autotuner.current()
    assert (teng.config.dispatch_depth, teng.config.scan_chunk) == \
        (jeng.config.dispatch_depth, jeng.config.scan_chunk)
    lbl = teng._autotuner.label
    g = REGISTRY.gauge("swtpu_autotune_dispatch_depth")
    assert g.value(engine=lbl) == teng.config.dispatch_depth


def test_slo_objective_steers_the_shed_threshold_like_jax():
    """With a p99 target the tuner reads the window's p99 from the
    harvested records (its own engine's series only) and halves the shed
    threshold while the tail is over target, as the JAX tuner does."""
    jeng, teng = _tuned_engines(qos=True, slo_p99_target_ms=5.0,
                                ingest_workers=1)
    for eng in (jeng, teng):
        _synthetic(eng, 12, SCENARIOS["decode"], tenant="slo-t")
    dj, dt = jeng._autotuner.evaluate(), teng._autotuner.evaluate()
    assert dt == dj and dt["knob"] == "shed_threshold"
    assert teng.qos.shed_threshold == jeng.qos.shed_threshold
    assert teng._autotuner.slo_p99_ms() is None   # nothing new this window


def test_tuner_evaluates_every_interval_dispatches():
    eng = Engine(EngineConfig(**SIZES, autotune=True, autotune_interval=3,
                              ingest_arenas=-1), device="cpu")
    rng = np.random.default_rng(3)
    for k in range(4):
        eng.ingest_json_batch(json_stream(k, rng))
        eng.flush_async()
    eng.flush()
    dispatches = len([r for r in eng.recent_traces(64)])
    assert eng._autotuner.evaluations >= 1
    assert eng._autotuner._since < 3 and dispatches == 4


KNOBS = {"dispatch_depth": 3, "ingest_workers": 1, "shed_threshold": 64,
         "scan_chunk": 3}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_set_ingest_tuning_keeps_state_byte_identical(knob):
    """A mid-stream retune of each knob leaves state, mirrors and
    summaries equal to the JAX engine's after the same retune; the free
    knobs (all but ``scan_chunk``, whose quiesce dispatches the partial
    arena and so moves batch boundaries) also leave the state equal to a
    port engine that never retuned. A scan-chunk retune drains the
    in-flight dispatches and rebuilds the arena pool."""
    engines = [JaxEngine(JaxEngineConfig(**SHARD, qos=True)),
               Engine(EngineConfig(**SHARD, qos=True), device="cpu"),
               Engine(EngineConfig(**SHARD, qos=True), device="cpu")]
    jeng, teng, fixed = engines
    jeng.epoch = pinned(JaxEpoch)
    teng.epoch, fixed.epoch = pinned(EpochBase), pinned(EpochBase)
    rngs = [np.random.default_rng(4) for _ in engines]
    for k in range(6):
        for eng, rng in zip(engines, rngs):
            eng.ingest_json_batch(json_stream(k, rng))
        if k == 2:
            pool = teng._arena_pool
            jeng.set_ingest_tuning(**{knob: KNOBS[knob]})
            applied = teng.set_ingest_tuning(**{knob: KNOBS[knob]})
            assert applied[knob] == KNOBS[knob]
            if knob == "scan_chunk":
                assert teng._arena_pool is not pool and teng._arena_step is not None
                assert pool.inflight_count == 0
    for eng in engines:
        eng.flush()
    assert_engines_equal(jeng, teng)
    if knob != "scan_chunk":
        assert_tree_equal(fixed.state, teng.state)
    if knob == "scan_chunk":
        teng.set_ingest_tuning(scan_chunk=1)
        assert teng._arena_step is None
