"""Shared drive of the server twins: one instance of each package (the
JAX package's, and the port's on the CPU) behind its REST gateway, the
same request script sent to both, and the two runs compared.

A case is a function of one ``Side``: it sends requests through
``S.call`` (the JAX tests' ``call``: ``(status, body)``) and makes the JAX
test's assertions on what comes back. ``twin`` runs the case against the
JAX instance, then against the port's, and holds the two logs equal —
every status, the headers that matter (``Content-Type``, ``Allow``,
``Retry-After``) and every body after ``mask`` — and the two engines leaf
for leaf. Both sides are driven with ``aiohttp``'s client, so the port's
own HTTP layer is held to aiohttp's wire behaviour as well.

Clocks and randomness are pinned on both sides: the engines' clocks, the
services' wall clocks, the JWT secret and password salts, the tenant
auth tokens, the batch-operation uuids and the invocation counters.
What still differs between two engines is masked by name (``MASK_KEYS``):
trace ids, which each engine draws at random (in a logged path too).
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import itertools
import re

import aiohttp
import jax

from tests.test_torch_admin import assert_same
from tests.test_torch_ingest_wire import pinned
from tests.torch_parity import plain, server_pins
from tests.torch_services import BOTH, FROZEN_S, SIZES, J, T, pin_services

__all__ = ["BOTH", "J", "T", "SIZES", "Side", "compare_mesh", "make_instance",
           "mask", "mesh_engine", "pin_servers", "rest_side", "run_twin"]

HEADERS_KEPT = ("Content-Type", "Allow", "Retry-After")
MASK_KEYS = frozenset({"trace_id", "traceId"})
_JWT = re.compile(r"^eyJ[\w-]+\.[\w-]+\.[\w-]+$")
_HEX32 = re.compile(r"[0-9a-f]{32}")     # a trace id in a path


def mask(x):
    """``x`` with the values of ``MASK_KEYS`` and any JWT replaced by a
    placeholder, recursively."""
    if isinstance(x, dict):
        return {k: ("<masked>" if k in MASK_KEYS else mask(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [mask(v) for v in x]
    if isinstance(x, str) and _JWT.match(x):
        return "<jwt>"
    return x


_uuids = itertools.count(1)


def pin_servers(monkeypatch) -> None:
    """``torch_services.pin_services``, and on both packages the pins of
    ``torch_parity.server_pins`` at ``FROZEN_S``: ``uuid.uuid4`` counts
    from 1 (``reset_uuids``)."""
    pin_services(monkeypatch)
    for P in BOTH:      # the table of tests/torch_parity.py, as chip_smoke.py's
        for mod, attr, value in server_pins(P, FROZEN_S, lambda: next(_uuids)):
            monkeypatch.setattr(mod, attr, value)


def reset_uuids() -> None:
    global _uuids
    _uuids = itertools.count(1)


def make_instance(P, engine_kw: dict | None = None, **inst_kw):
    """``SiteWhereTpuInstance`` of ``P`` at the JAX tests' engine size (the
    port's on the CPU), its engine's clock pinned."""
    I = P.mod("instance.instance")
    cfg = I.InstanceConfig(engine=P.EngineConfig(**{**SIZES, **(engine_kw or {})}),
                           **inst_kw)
    inst = (I.SiteWhereTpuInstance(cfg, device="cpu") if P.port
            else I.SiteWhereTpuInstance(cfg))
    inst.engine.epoch = pinned(P.EpochBase)
    return inst


class Side:
    """One package's running gateway: ``P`` its namespace, ``inst`` the
    instance, ``loop`` the event loop it serves on, ``log`` what ``call``
    saw."""

    def __init__(self, P, inst, loop, server, session, token):
        self.P, self.inst, self.loop = P, inst, loop
        self.server, self.session, self.token = server, session, token
        self.base = f"http://127.0.0.1:{server.port}"
        self.log: list = []

    def call(self, method, path, json_body=None, headers=None, raw=False,
             params=None, keep=None, data=None):
        """``(status, body)`` of one request under the admin JWT (a
        ``headers`` Authorization replaces it). ``raw`` returns the bytes;
        ``keep(body)`` is what the log records of the body instead of its
        masked self."""
        async def go():
            h = {"Authorization": f"Bearer {self.token}", **(headers or {})}
            async with self.session.request(method, self.base + path,
                                            json=json_body, data=data,
                                            headers=h, params=params) as r:
                body = await (r.read() if raw else r.json(content_type=None))
                return r.status, body, {k: r.headers.get(k) for k in HEADERS_KEPT}

        status, body, hdrs = self.loop.run_until_complete(go())
        seen = mask(keep(body) if keep is not None else body)
        self.log.append((method, _HEX32.sub("<hex32>", path), params, status,
                         hdrs, seen))
        return status, body

    def run(self, coro):
        return self.loop.run_until_complete(coro)

    def note(self, *values) -> None:
        """Record values of the case's own (masked) in the log."""
        self.log.append(("note", mask(plain(list(values)))))

    def mod(self, name: str):
        return self.P.mod(name)

    def src(self, text: str) -> str:
        """Source text written for the JAX package, naming this side's."""
        return text.replace("sitewhere_tpu.", f"{self.P.root}.")


async def _jwt(session, base) -> str:
    basic = base64.b64encode(b"admin:password").decode()
    async with session.get(f"{base}/api/authapi/jwt",
                           headers={"Authorization": f"Basic {basic}"}) as r:
        assert r.status == 200
        return (await r.json())["token"]


@contextlib.contextmanager
def rest_side(P, inst=None, **kw):
    """``P``'s instance (``make_instance(P, **kw)`` unless given) served by
    its ``web.rest.start_server`` on a fresh loop, an aiohttp session and
    the admin JWT; torn down on exit."""
    loop = asyncio.new_event_loop()
    inst = inst if inst is not None else make_instance(P, **kw)
    server = loop.run_until_complete(P.mod("web.rest").start_server(inst))

    async def open_session():
        return aiohttp.ClientSession()

    session = loop.run_until_complete(open_session())
    try:
        token = loop.run_until_complete(
            _jwt(session, f"http://127.0.0.1:{server.port}"))
        yield Side(P, inst, loop, server, session, token)
    finally:
        loop.run_until_complete(session.close())
        loop.run_until_complete(server.cleanup())
        loop.close()


def compare_logs(jlog: list, tlog: list) -> None:
    for i, (a, b) in enumerate(zip(jlog, tlog)):
        assert b == a, f"entry {i}: port {b!r}\n  != JAX {a!r}"
    assert len(tlog) == len(jlog), (len(tlog), len(jlog))


def compare_engines(jeng, teng) -> None:
    jeng.flush()
    teng.flush()
    jax.block_until_ready(jeng.state)
    assert_same(jeng, teng)


def run_twin(case, engines=compare_engines, make=None,
             **kw) -> tuple[Side, Side]:
    """``case(S)`` against each package's gateway (``rest_side(P, **kw)``,
    over ``make(P)`` when given); the logs equal and ``engines(jax_engine,
    port_engine)`` holds (None: no engine comparison)."""
    sides = []
    for P in BOTH:
        reset_uuids()
        with rest_side(P, inst=make(P) if make else None, **kw) as S:
            case(S)
        sides.append(S)
    compare_logs(sides[0].log, sides[1].log)
    if engines is not None:
        engines(sides[0].inst.engine, sides[1].inst.engine)
    return sides[0], sides[1]


# ------------------------------------------------------------------- RPC
class RpcLog(list):
    """What a side's RPC clients saw: ``(method, params, result)`` or
    ``(method, params, "error", code, message)`` entries, masked; and the
    instances the case built (``instances``)."""

    def __init__(self):
        super().__init__()
        self.instances: list = []


def rpc_names(P, log: RpcLog):
    """``(_instance, RpcClient, CachedDeviceClient, RpcError,
    build_instance_rpc, system_jwt)`` of ``P`` for a twin of
    ``tests/test_rpc.py``: ``_instance()`` builds ``make_instance(P)``
    (kept in ``log.instances``) and ``RpcClient`` records every call."""
    client, protocol = P.mod("rpc.client"), P.mod("rpc.protocol")
    server = P.mod("rpc.server")
    RpcError = protocol.RpcError

    class RecordingClient(client.RpcClient):
        async def call(self, method, **params):
            shown = mask(plain({k: v for k, v in params.items()
                                if k != "_attachment"}))
            try:
                res = await super().call(method, **params)
            except RpcError as e:
                log.append((method, shown, "error", e.code, str(e)))
                raise
            log.append((method, shown, mask(plain(res))))
            return res

    def _instance():
        inst = make_instance(P)
        log.instances.append(inst)
        return inst

    return (_instance, RecordingClient, client.CachedDeviceClient, RpcError,
            server.build_instance_rpc, server.system_jwt)


def run_rpc_twin(go) -> tuple[RpcLog, RpcLog]:
    """``await go(P, log)`` for each package on a fresh loop; the two
    logs equal, and the instances' engines leaf for leaf."""
    logs = []
    for P in BOTH:
        reset_uuids()
        log = RpcLog()
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(go(P, log))
        finally:
            loop.close()
        logs.append(log)
    compare_logs(logs[0], logs[1])
    assert len(logs[1].instances) == len(logs[0].instances)
    for a, b in zip(logs[0].instances, logs[1].instances):
        compare_engines(a.engine, b.engine)
    return logs[0], logs[1]


# ------------------------------------------------------------ mesh engines
def mesh_engine(P, **kw):
    """A ``DistributedEngine`` of ``P`` at ``tests/test_distributed.py``'s
    ``small_config(**kw)`` (the port's shards on the CPU), clock pinned."""
    from tests.test_torch_distributed import small_config
    from tests.torch_spmd import FixedEpoch, TorchFixedEpoch

    dist = P.mod("parallel.distributed")
    cfg = small_config(**kw)
    if P.port:
        eng = dist.DistributedEngine(dist.DistributedConfig(**cfg, device="cpu"))
        eng.epoch = TorchFixedEpoch()
    else:
        eng = dist.DistributedEngine(dist.DistributedConfig(**cfg))
        eng.epoch = FixedEpoch()
    return eng


def compare_mesh(jeng, teng):
    """Two mesh engines' stacked state byte for byte, and their mirrors."""
    from tests.test_torch_distributed import mirrors
    from tests.torch_spmd import assert_state_equal

    jeng.flush()
    teng.flush()
    assert_state_equal(jeng, teng)
    assert mirrors(teng) == mirrors(jeng)
