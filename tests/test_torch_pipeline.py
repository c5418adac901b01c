"""Parity of the port's fused pipeline step with the JAX step.

A seeded multi-batch stream (auto-registration with registry overflow,
dead letters, tenant mismatches, multi-arena ring wrap, telemetry windows)
goes through ``sitewhere_tpu.pipeline.make_pipeline_step`` on the CPU and
through ``sitewhere_tpu_torch.pipeline.pipeline_step`` with
``device="cpu"``, both starting from the same bytes
(``convert.pipeline_state_from_numpy``). After every step every leaf of
the state — registry, store, device state, windows, metrics including
``tenant_counters`` — and every ``StepOutput`` field must be identical:
int and bool leaves byte for byte, float leaves exactly (they are copies).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sitewhere_tpu.core.events import EventBatch as JaxBatch
from sitewhere_tpu.pipeline import PipelineConfig as JaxConfig
from sitewhere_tpu.pipeline import PipelineState as JaxState
from sitewhere_tpu.pipeline import make_pipeline_step
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.core.events import EventBatch
from sitewhere_tpu_torch.pipeline import PipelineConfig, PipelineState, pipeline_step
from tests.torch_parity import assert_leaf_equal, assert_tree_equal, make_batch

B, C, W = 48, 4, 8
N_TOKENS, TOKEN_CAP = 28, 32


def _stream(seed, n_batches):
    rng = np.random.default_rng(seed)
    return [make_batch(rng, B, C, N_TOKENS, TOKEN_CAP, W, ts0=100 * k)
            for k in range(n_batches)]


@pytest.mark.parametrize("arenas,store_cap,register", [
    (1, 256, "always"),          # one ring, wraps within the stream
    (4, 1024, "always"),         # per-tenant arenas (tenant % 4)
    (1, 256, "first_batch"),     # auto_register=False after batch 0
])
def test_pipeline_step_matches_jax(arenas, store_cap, register):
    jstate = JaxState.create(
        device_capacity=20, token_capacity=TOKEN_CAP, assignment_capacity=24,
        store_capacity=store_cap, channels=C, analytics_devices=12,
        analytics_window=W, store_arenas=arenas)
    tstate = convert.pipeline_state_from_numpy(jax.device_get(jstate), "cpu")
    assert_tree_equal(jstate, tstate)
    for k, cols in enumerate(_stream(seed=11 + arenas, n_batches=14)):
        auto = register == "always" or k == 0
        jstep = make_pipeline_step(JaxConfig(auto_register=auto))
        jstate, jout = jstep(jstate, JaxBatch(**cols))
        tstate, tout = pipeline_step(
            tstate, EventBatch.from_numpy("cpu", **cols),
            PipelineConfig(auto_register=auto))
        assert_tree_equal(jstate, tstate, f"batch {k} state")
        for f in jout._fields:
            assert_leaf_equal(getattr(jout, f), getattr(tout, f),
                              f"batch {k} out.{f}")
    # the stream exercised what it is meant to
    m = tstate.metrics
    assert int(m.registered) > 0 and int(m.missed) > 0
    if register == "always":
        assert int(m.reg_overflow) > 0          # 28 tokens, 20 device rows
    assert int(tstate.store.epoch.sum()) > 0 or arenas > 1
    assert int(tstate.windows.filled.max()) > W  # a window wrapped


def test_pipeline_state_create_matches_jax():
    kw = dict(device_capacity=16, token_capacity=32, assignment_capacity=32,
              store_capacity=128, channels=3, analytics_devices=4,
              analytics_window=5, store_arenas=2)
    assert_tree_equal(JaxState.create(**kw),
                      PipelineState.create(**kw, device="cpu"))


def test_pipeline_step_leaves_input_state_untouched():
    """The step is functional: the state it was given stays as it was."""
    state = PipelineState.create(16, 32, 32, 256, channels=C,
                                 analytics_devices=8, analytics_window=W,
                                 device="cpu")
    before = _state_np(state)
    cols = _stream(seed=3, n_batches=1)[0]
    pipeline_step(state, EventBatch.from_numpy("cpu", **cols), PipelineConfig())
    assert_tree_equal(before, state)


def _state_np(state):
    """A copy of the port's state with numpy leaves (same attribute names)."""

    def conv(x):
        if dataclasses.is_dataclass(x):
            return type("NS", (), {f.name: conv(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
        return None if x is None else x.numpy().copy()

    return conv(state)


def test_state_dtypes_never_widen():
    """No int64 leaks into stored state: every id / timestamp leaf stays
    int32 through a step."""
    state = PipelineState.create(16, 32, 32, 256, channels=C,
                                 analytics_devices=8, analytics_window=W,
                                 device="cpu")
    cols = _stream(seed=5, n_batches=1)[0]
    state, out = pipeline_step(state, EventBatch.from_numpy("cpu", **cols),
                               PipelineConfig())

    def walk(x):
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            if dataclasses.is_dataclass(v):
                yield from walk(v)
            elif v is not None:
                yield f.name, v

    for name, leaf in walk(state):
        assert leaf.dtype in (torch.int32, torch.float32, torch.bool), name
    for name in out._fields:
        assert getattr(out, name).dtype == torch.int32, name
