"""Shared drive of the entity and outbound service twins: each package's
service classes under one namespace (``J`` the JAX package, ``T`` the
port), engines of one size with pinned clocks, the process-global
invocation counters and the services' wall clocks pinned, and the
comparison of two runs: their answers in plain form
(``torch_parity.plain``) and their engines leaf for leaf."""

import itertools
import time
import types

import jax

from tests.test_torch_admin import assert_same
from tests.test_torch_ingest_wire import pinned
from tests.torch_parity import plain, service_namespace

SIZES = dict(device_capacity=64, token_capacity=128, assignment_capacity=128,
             store_capacity=4096, batch_capacity=16, channels=4)
FROZEN_S = 1_750_000_000.0      # the services' wall clock, pinned

J = service_namespace("sitewhere_tpu")
T = service_namespace("sitewhere_tpu_torch")
BOTH = (J, T)


def engine(P, **kw):
    """An engine of ``P`` at the JAX tests' size (the port's on the CPU),
    its clock pinned."""
    cfg = P.EngineConfig(**{**SIZES, **kw})
    eng = P.Engine(cfg, device="cpu") if P.port else P.Engine(cfg)
    eng.epoch = pinned(P.EpochBase)
    return eng


def pin_services(monkeypatch) -> None:
    """Both packages' invocation counters start at 1, and the entity, batch
    and alarm clocks read ``FROZEN_S``."""
    frozen = types.SimpleNamespace(time=lambda: FROZEN_S)
    for P in BOTH:
        monkeypatch.setattr(P.mod("commands.model"), "_invocation_ids",
                            itertools.count(1))
        for name in ("management.entities", "management.batch"):
            monkeypatch.setattr(P.mod(name), "time", frozen)


def frozen_wall_clock(monkeypatch) -> None:
    """``time.time`` itself pinned: for the alarm updaters, which import the
    module inside the call. Host-only tests: nothing waits on the clock."""
    monkeypatch.setattr(time, "time", lambda: FROZEN_S)


def twin(run, *args):
    """``run(P, *args)`` for the JAX package and the port; the plain forms
    of the two answers must be equal. Returns both answers."""
    a, b = run(J, *args), run(T, *args)
    assert plain(b) == plain(a)
    return a, b


def twin_engines(run, *args):
    """``run(P, *args) -> (answers, engine)`` for both packages: the plain
    answers equal, and every state leaf, host mirror, interner and counter
    of the two engines equal. Returns both answers."""
    (a, jeng), (b, teng) = run(J, *args), run(T, *args)
    assert plain(b) == plain(a)
    jax.block_until_ready(jeng.state)
    assert_same(jeng, teng)
    return a, b


def measure(P, eng, token, name="temp", value=1.0, tenant="default"):
    eng.process(P.DecodedRequest(
        type=P.RequestType.DEVICE_MEASUREMENT, device_token=token, tenant=tenant,
        measurements={name: value}))


