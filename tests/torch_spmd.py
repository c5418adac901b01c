"""Shared drive of the multi-shard parity tests (``tests/test_torch_spmd*.py``,
``tests/test_torch_shardobs.py``): a JAX ``SpmdEngine`` (8 virtual CPU
devices, ``tests/conftest.py``) and the port's, every shard on the CPU,
fed the same wire stream of ``tests/test_spmd.py`` with both clocks
pinned. Engines are built once per module by the tests' fixtures."""

from __future__ import annotations

import jax

from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.parallel.sharded import SpmdEngine as JaxSpmdEngine
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.parallel.sharded import SpmdEngine
from tests.test_spmd import CFG, RULESET, FixedEpoch, _meas, _stream  # noqa: F401
from tests.torch_parity import assert_tree_equal


class TorchFixedEpoch(EpochBase):
    """The port's pinned clock, equal to ``tests.test_spmd.FixedEpoch``."""

    def __init__(self, now_ms: int = 500_000):
        super().__init__(0.0)
        self._now = now_ms

    def now_ms(self) -> int:
        return self._now


def jax_spmd(n_shards, scan_chunk=1, depth=0, arena=True, **kw):
    eng = JaxSpmdEngine(JaxEngineConfig(**{**CFG, "scan_chunk": scan_chunk,
                                           "ingest_arenas": depth, **kw}),
                        n_shards=n_shards, arena=arena)
    eng.epoch = FixedEpoch()
    return eng


def torch_spmd(n_shards, scan_chunk=1, depth=0, arena=True, **kw):
    eng = SpmdEngine(EngineConfig(**{**CFG, "scan_chunk": scan_chunk,
                                     "ingest_arenas": depth, **kw}),
                     n_shards=n_shards, arena=arena, device="cpu")
    eng.epoch = TorchFixedEpoch()
    return eng


def jax_single(**kw):
    eng = JaxEngine(JaxEngineConfig(**{**CFG, **kw}))
    eng.epoch = FixedEpoch()
    return eng


def torch_single(**kw):
    eng = Engine(EngineConfig(**{**CFG, **kw}), device="cpu")
    eng.epoch = TorchFixedEpoch()
    return eng


def run(engines, events, chunk=32):
    """``tests.test_spmd._run``: the stream in wire chunks, a flush after
    each, every engine fed the same chunk in turn."""
    for lo in range(0, len(events), chunk):
        wire = [_meas(t, v, ts) for t, v, ts in events[lo:lo + chunk]]
        for e in engines:
            e.ingest_json_batch(wire)
            e.flush()


def settle(*engines):
    for e in engines:
        e.barrier()
        e.drain()


def page(eng, canonical: bool = True, **kw):
    """A query page; ``canonical`` drops the assignment id (another id
    space on a single-card engine)."""
    out = eng.query_events(**kw)
    return out["total"], [{k: v for k, v in ev.items()
                           if not (canonical and k == "assignmentId")}
                          for ev in out["events"]]


def assert_state_equal(jeng, teng, parts=("store", "registry", "device_state",
                                          "metrics", "next_device",
                                          "next_assignment")):
    """The port's stacked state against the JAX engine's, byte for byte."""
    ref = jax.device_get(jeng.state)
    got = teng.state
    for part in parts:
        r, g = getattr(ref, part), getattr(got, part)
        if hasattr(g, "shape"):
            from tests.torch_parity import assert_leaf_equal

            assert_leaf_equal(r, g, part)
        else:
            assert_tree_equal(r, g, part)
