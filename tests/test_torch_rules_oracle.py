"""The port's rules oracle (``sitewhere_tpu_torch/rules/oracle.py``) held
to the JAX package's on seeded event streams: every rule kind (threshold,
windowed aggregate, sequence, absence) at every comparison operator, and
the rollup ring. Both are plain host code; the answers must be equal
sets and tables."""

import numpy as np
import pytest

from sitewhere_tpu.rules import oracle as joracle
from sitewhere_tpu_torch.rules import oracle as toracle

SEEDS = (0, 1, 2)
OPS = (0, 1, 2, 3)        # >, >=, <, <=


def stream(seed: int, n: int = 600, groups: int = 7) -> list[dict]:
    """A seeded stream: mostly rising timestamps with some late events,
    values on a coarse grid (ties with the thresholds occur), and either
    channel missing now and then."""
    rng = np.random.default_rng(seed)
    late = rng.integers(0, 400, n) * (rng.random(n) < 0.1)
    ts = np.cumsum(rng.integers(0, 90, n)) - late
    vals = rng.integers(0, 40, n) * 5.0
    vals_b = rng.integers(0, 40, n) * 5.0
    out = []
    for i in range(n):
        out.append({"ts": int(ts[i]), "group": int(rng.integers(0, groups)),
                    "value": None if rng.random() < 0.08 else float(vals[i]),
                    "value_b": None if rng.random() < 0.08 else float(vals_b[i])})
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("op", OPS)
def test_threshold_fire_keys_match_jax(seed, op):
    ev = stream(seed)
    for value, cooldown in ((90.0, 1000), (20.0, 250)):
        kw = dict(op=op, value=value, cooldown_ms=cooldown)
        got = toracle.threshold_fire_keys(ev, **kw)
        assert got == joracle.threshold_fire_keys(ev, **kw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("agg", ("count", "sum", "min", "max"))
def test_window_fire_keys_match_jax(seed, agg):
    ev = stream(seed)
    value = {"count": 3, "sum": 300.0, "min": 15.0, "max": 150.0}[agg]
    for op in OPS:
        for where in (None, (0, 30.0), (3, 100.0)):
            kw = dict(agg=agg, op=op, value=value, window_ms=2000, where=where)
            got = toracle.window_fire_keys(ev, **kw)
            assert got == joracle.window_fire_keys(ev, **kw), kw


@pytest.mark.parametrize("seed", SEEDS)
def test_sequence_fire_keys_match_jax(seed):
    ev = stream(seed)
    for op_a in OPS:
        for op_b in OPS:
            kw = dict(op_a=op_a, val_a=90.0, op_b=op_b, val_b=100.0, within_ms=4000)
            got = toracle.sequence_fire_keys(ev, **kw)
            assert got == joracle.sequence_fire_keys(ev, **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_absence_fire_keys_match_jax(seed):
    ev = stream(seed)
    wm = max(e["ts"] for e in ev) + 5000
    fired = 0
    for op in OPS:
        for final in (None, wm):
            kw = dict(op=op, value=60.0, deadline_ms=300, final_watermark=final)
            got = toracle.absence_fire_keys(ev, **kw)
            assert got == joracle.absence_fire_keys(ev, **kw)
            fired += len(got)
    assert fired


@pytest.mark.parametrize("seed", SEEDS)
def test_rollup_oracle_matches_jax(seed):
    ev = stream(seed)
    for window_ms, buckets in ((1000, 8), (250, 3)):
        got = toracle.rollup_oracle(ev, window_ms=window_ms, buckets=buckets)
        assert got == joracle.rollup_oracle(ev, window_ms=window_ms, buckets=buckets)
        assert got
