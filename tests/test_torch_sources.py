"""The host-only leaves under the event sources (``utils/lifecycle``,
``ingest/dedup``, ``utils/scripting``, ``utils/faults``, the rest of
``ingest/decoders``, ``IngestLog.durable_view``, ``TokenInterner.truncate``,
``EpochBase.to_unix_s``, ``native/route_fallback`` and
``native/binding.route_payloads``) and ``ingest/sources.py``, each held to
the JAX package's module on the same inputs.

The source tests wire a receiver -> decoder -> deduplicator ->
``EventSourcesManager`` -> ``Engine.process`` on both sides, as
``tests/test_ingest.py``'s ``_wire`` does, with both engines' clocks
pinned, and compare what each side counted, dead-lettered and stored:
the engine state byte for byte.
"""

import asyncio
import dataclasses
import json
import os
import random
import re
import time

import jax
import numpy as np
import pytest

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.core.registry import TokenInterner as JaxInterner
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.ingest import decoders as jdec
from sitewhere_tpu.ingest import dedup as jdedup
from sitewhere_tpu.ingest import requests as jreq
from sitewhere_tpu.ingest import sources as jsrc
from sitewhere_tpu.native import binding as jbind
from sitewhere_tpu.native import route_fallback as jroute
from sitewhere_tpu.utils import faults as jfaults
from sitewhere_tpu.utils import lifecycle as jlife
from sitewhere_tpu.utils import scripting as jscript
from sitewhere_tpu.utils.ingestlog import IngestLog as JaxIngestLog
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.core.registry import TokenInterner
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest import decoders as tdec
from sitewhere_tpu_torch.ingest import dedup as tdedup
from sitewhere_tpu_torch.ingest import requests as treq
from sitewhere_tpu_torch.ingest import sources as tsrc
from sitewhere_tpu_torch.native import binding as tbind
from sitewhere_tpu_torch.native import route_fallback as troute
from sitewhere_tpu_torch.utils import faults as tfaults
from sitewhere_tpu_torch.utils import lifecycle as tlife
from sitewhere_tpu_torch.utils import scripting as tscript
from sitewhere_tpu_torch.utils.ingestlog import IngestLog
from tests.torch_parity import assert_tree_equal

BASE_S = 1_700_000_000.0
MINI = dict(device_capacity=64, token_capacity=128, assignment_capacity=128,
            store_capacity=4096, batch_capacity=16, channels=4)
SIDES = {"jax": (jdec, jdedup, jreq, jsrc), "port": (tdec, tdedup, treq, tsrc)}


def measurement_json(token="dev-1", name="fuel.level", value=123.4, **kw):
    return json.dumps({"deviceToken": token, "type": "DeviceMeasurement",
                       "request": {"name": name, "value": value, **kw}}).encode()


def _fields(req) -> dict:
    """A DecodedRequest of either package as plain values (enums by name)."""
    out = {}
    for f in dataclasses.fields(req):
        v = getattr(req, f.name)
        out[f.name] = v.name if hasattr(v, "name") and hasattr(v, "value") else v
    return out


def _decode_or_error(dec, payload):
    try:
        return [_fields(r) for r in dec.decode(payload, {"m": 1})]
    except Exception as e:      # both packages raise their own class
        return ("error", type(e).__name__, str(e))


# ------------------------------------------------------------- decoders

BATCH_PAYLOADS = [
    json.dumps({"deviceToken": "shared", "requests": [
        {"type": "DeviceMeasurement", "request": {"name": "a", "value": 1}},
        {"type": "DeviceMeasurement", "request": {"name": "b", "value": 2}}]}).encode(),
    json.dumps([{"deviceToken": "l1", "type": "DeviceLocation",
                 "request": {"latitude": 1.0, "longitude": 2.0}},
                {"deviceToken": "l2", "type": "DeviceAlert",
                 "request": {"type": "fire", "level": "Error"}}]).encode(),
    json.dumps({"requests": [{"deviceToken": "own", "type": "DeviceMeasurement",
                              "request": {"name": "x", "value": 3}}]}).encode(),
    b"{not json", b'{"no": "requests"}', b"42",
    json.dumps([{"deviceToken": "bad", "type": "Nope", "request": {}}]).encode(),
]


@pytest.mark.parametrize("i", range(len(BATCH_PAYLOADS)))
def test_batch_decoder_matches_jax(i):
    p = BATCH_PAYLOADS[i]
    want = _decode_or_error(jdec.JsonBatchEventDecoder(), p)
    assert _decode_or_error(tdec.JsonBatchEventDecoder(), p) == want
    if i == 0:
        assert [r["device_token"] for r in want] == ["shared", "shared"]


def test_string_and_debug_decoders_match_jax():
    text = measurement_json("s-1").decode()
    for mod in (jdec, tdec):
        assert mod.JsonStringDecoder().wire_tag == "json"
        assert mod.BinaryEventDecoder.wire_tag == "binary"
        assert mod.EchoStringDecoder().decode(b"hello", {}) == []
    assert (_decode_or_error(tdec.JsonStringDecoder(), text)
            == _decode_or_error(jdec.JsonStringDecoder(), text))
    logged = tdec.PayloadLoggerDecoder(tdec.JsonDeviceRequestDecoder())
    jlogged = jdec.PayloadLoggerDecoder(jdec.JsonDeviceRequestDecoder())
    for p in (measurement_json("p-1"), b"[1, 2]"):
        assert _decode_or_error(logged, p) == _decode_or_error(jlogged, p)


def _composite(mod):
    def extractor(payload, metadata):
        obj = json.loads(payload)
        return obj["deviceType"], json.dumps(obj["body"]).encode()

    return mod.CompositeDecoder(extractor, {"sensor": mod.JsonDeviceRequestDecoder()},
                                default=None)


def test_composite_and_scripted_decoders_match_jax():
    payloads = [
        json.dumps({"deviceType": "sensor", "body": {
            "deviceToken": "c1", "type": "DeviceMeasurement",
            "request": {"name": "x", "value": 5}}}).encode(),
        json.dumps({"deviceType": "unknown", "body": {}}).encode(),
        b"not json",
    ]
    for p in payloads:
        assert (_decode_or_error(_composite(tdec), p)
                == _decode_or_error(_composite(jdec), p))
    assert _decode_or_error(_composite(tdec), payloads[0])[0]["device_token"] == "c1"

    def scripted(mod, rq):
        return mod.ScriptedDecoder(lambda p, m: [rq.DecodedRequest(
            type=rq.RequestType.DEVICE_MEASUREMENT, device_token=p.decode(),
            measurements={"v": 1.0})])

    assert (_decode_or_error(scripted(tdec, treq), b"tok")
            == _decode_or_error(scripted(jdec, jreq), b"tok"))
    for bad in (lambda p, m: 1 / 0, lambda p, m: "not a list"):
        got = _decode_or_error(tdec.ScriptedDecoder(bad), b"x")
        want = _decode_or_error(jdec.ScriptedDecoder(bad), b"x")
        assert got == want and got[0] == "error"


SPLIT_CASES = [
    b' [ {"a": [1, 2], "s": "x,]}"} , {"b": {"c": 3}},\n {"d": 4} ] ',
    b"[]", b'["lone"]', b"[1, 2.5, true, null]", b'{"not": "array"}',
    b'[{"unterminated": 1}', b"[1,,2]", b'[{"e": "q\\"]"}, 3]',
]


@pytest.mark.parametrize("raw", SPLIT_CASES)
def test_split_json_array_matches_jax(raw):
    def run(mod):
        try:
            return mod.split_json_array(raw)
        except Exception as e:
            return ("error", type(e).__name__, str(e))

    assert run(tdec) == run(jdec)
    if raw == SPLIT_CASES[0]:
        assert run(tdec) == [b'{"a": [1, 2], "s": "x,]}"}', b'{"b": {"c": 3}}', b'{"d": 4}']


def _requests(rq):
    R = rq.RequestType
    return [
        rq.DecodedRequest(type=R.DEVICE_MEASUREMENT, device_token="m", event_ts_ms=5,
                          alternate_id="alt", metadata={"k": "v"},
                          measurements={"t": 1.5, "u": -2.0}),
        rq.DecodedRequest(type=R.DEVICE_LOCATION, device_token="l", latitude=1.0,
                          longitude=2.0, elevation=3.0),
        rq.DecodedRequest(type=R.DEVICE_LOCATION, device_token="l0"),
        rq.DecodedRequest(type=R.ACKNOWLEDGE, device_token="a",
                          originating_event_id="e-1", response="ok"),
        rq.DecodedRequest(type=R.DEVICE_STATE_CHANGE, device_token="s", attribute="mode",
                          state_type="eco", previous_state="a", new_state="b"),
        rq.DecodedRequest(type=R.REGISTER_DEVICE, device_token="r", tenant="t2",
                          extras={"deviceTypeToken": "gw", "areaToken": "n"}),
    ]


def test_envelope_from_request_matches_jax_and_round_trips():
    from sitewhere_tpu.core.types import AlertLevel as JLevel
    from sitewhere_tpu_torch.core.types import AlertLevel as TLevel

    jr = _requests(jreq) + [jreq.DecodedRequest(
        type=jreq.RequestType.DEVICE_ALERT, device_token="al", alert_type="fire",
        alert_level=JLevel.ERROR, alert_message="hot")]
    tr = _requests(treq) + [treq.DecodedRequest(
        type=treq.RequestType.DEVICE_ALERT, device_token="al", alert_type="fire",
        alert_level=TLevel.ERROR, alert_message="hot")]
    for a, b in zip(jr, tr):
        env = tdec.envelope_from_request(b)
        assert env == jdec.envelope_from_request(a)
        back = tdec.request_from_envelope(json.loads(json.dumps(env)))
        assert _fields(back) == _fields(jdec.request_from_envelope(
            json.loads(json.dumps(env))))


# ---------------------------------------------------------------- dedup

def test_alternate_id_dedup_matches_jax():
    def run(dd, rq):
        d = dd.AlternateIdDeduplicator(capacity=4)
        seq = []
        for i in [0, 0, 1, 2, 3, 4, 0, 5, 1, None, None, 5]:
            r = rq.DecodedRequest(type=rq.RequestType.DEVICE_MEASUREMENT,
                                  device_token="a" if i != 5 else "b",
                                  alternate_id=None if i is None else f"m{i}",
                                  measurements={"x": 1})
            seq.append(d.is_duplicate(r))
        s = dd.ScriptedDeduplicator(lambda r: r.device_token == "b")
        seq.append(s.is_duplicate(rq.DecodedRequest(
            type=rq.RequestType.DEVICE_MEASUREMENT, device_token="b")))
        return seq

    got = run(tdedup, treq)
    assert got == run(jdedup, jreq)
    assert got[:2] == [False, True] and got[9:11] == [False, False]


# -------------------------------------------------------------- sources

def _pin(epoch_cls, now_ms=5000):
    class Pinned(epoch_cls):
        def now_ms(self):
            return now_ms

    return Pinned(BASE_S)


def _wired(side: str):
    """A mini engine of ``side`` wired as tests/test_ingest.py's _wire."""
    _, _, _, src = SIDES[side]
    if side == "jax":
        eng = JaxEngine(JaxEngineConfig(**MINI))
        eng.epoch = _pin(JaxEpoch)
    else:
        eng = Engine(EngineConfig(**MINI), device="cpu")
        eng.epoch = _pin(EpochBase)
    mgr = src.EventSourcesManager(on_event_request=eng.process,
                                  on_registration_request=eng.process)
    return eng, mgr


def _same_engines(jeng, teng, tokens) -> None:
    jeng.flush()
    teng.flush()
    assert teng.metrics() == jeng.metrics()
    for tok in tokens:
        assert teng.get_device_state(tok) == jeng.get_device_state(tok), tok
    assert_tree_equal(jax.device_get(jeng.state), teng.state)


def test_source_decode_dedup_and_dead_letter_match_jax():
    counts = {}
    engines = {}
    for side, (dec, dd, _, src) in SIDES.items():
        eng, mgr = _wired(side)
        recv = src.InMemoryEventReceiver()
        s = src.InboundEventSource("json-src", dec.JsonDeviceRequestDecoder(), [recv],
                                   dd.AlternateIdDeduplicator())
        mgr.add_source(s)
        rets = [recv.submit(measurement_json("m-1")),
                recv.submit(b"not json at all"),
                recv.submit(measurement_json("m-1", alternateId="dup-1")),
                recv.submit(measurement_json("m-1", alternateId="dup-1"))]
        with pytest.raises(ValueError, match="duplicate source id"):
            mgr.add_source(src.InboundEventSource("json-src", dec.JsonDeviceRequestDecoder()))
        counts[side] = (rets, s.decoded_count, s.failed_count, s.duplicate_count,
                        [(sid, p) for sid, p, _ in mgr.failed_decodes])
        engines[side] = eng
    assert counts["port"] == counts["jax"]
    assert counts["port"][:4] == ([1, 0, 1, 0], 2, 1, 1)
    _same_engines(engines["jax"], engines["port"], ["m-1"])
    assert engines["port"].metrics()["processed"] == 2


def test_engine_end_to_end_state_matches_jax():
    engines, infos = {}, {}
    for side, (dec, _, _, src) in SIDES.items():
        eng, mgr = _wired(side)
        recv = src.InMemoryEventReceiver()
        mgr.add_source(src.InboundEventSource("s", dec.JsonDeviceRequestDecoder(), [recv],
                                              tenant="default"))
        recv.submit(measurement_json("dev-A", "temp", 21.5))
        recv.submit(measurement_json("dev-A", "temp", 23.5))
        recv.submit(json.dumps({"deviceToken": "dev-A", "type": "DeviceLocation",
                                "request": {"latitude": 1.0, "longitude": 2.0}}).encode())
        recv.submit(json.dumps({"deviceToken": "dev-B", "type": "RegisterDevice",
                                "request": {"deviceTypeToken": "mega2560",
                                            "areaToken": "peachtree"}}).encode())
        engines[side] = eng
        infos[side] = dataclasses.asdict(eng.get_device("dev-B"))
    assert infos["port"] == infos["jax"]
    assert infos["port"]["device_type"] == "mega2560" and not infos["port"]["auto_registered"]
    _same_engines(engines["jax"], engines["port"], ["dev-A", "dev-B"])
    st = engines["port"].get_device_state("dev-A")
    assert st["measurements"]["temp"]["value"] == 23.5
    assert st["event_counts"]["MEASUREMENT"] == 2


def _frames(framing: str, payloads: list[bytes]) -> list[bytes]:
    """What one connection a payload list sends per framing."""
    if framing == "newline":
        return [b"".join(p + b"\n" for p in payloads)]
    if framing == "length_prefixed":
        return [b"".join(len(p).to_bytes(4, "big") + p for p in payloads)]
    return list(payloads)           # read_all: one connection a payload


@pytest.mark.parametrize("framing", ["newline", "length_prefixed", "read_all"])
def test_socket_receiver_framings_match_jax(framing):
    payloads = [measurement_json(f"sock-{i}", value=float(i)) for i in range(5)]
    payloads.append(b"garbage")

    async def run():
        sides = {}
        for side, (dec, _, _, src) in SIDES.items():
            eng, mgr = _wired(side)
            recv = src.SocketEventReceiver(framing=framing)
            s = mgr.add_source(src.InboundEventSource(
                "sock", dec.JsonDeviceRequestDecoder(), [recv]))
            await mgr.initialize()
            await mgr.start()
            sides[side] = (eng, mgr, recv, s)
        try:
            for eng, mgr, recv, s in sides.values():
                for chunk in _frames(framing, payloads):
                    _, w = await asyncio.open_connection("127.0.0.1", recv.bound_port)
                    w.write(chunk)
                    await w.drain()
                    w.close()
                    await w.wait_closed()
            for _ in range(100):
                if all(s.decoded_count + s.failed_count == len(payloads)
                       for _, _, _, s in sides.values()):
                    break
                await asyncio.sleep(0.02)
        finally:
            for _, mgr, _, _ in sides.values():
                await mgr.stop()
        return sides

    sides = asyncio.run(run())
    (jeng, jmgr, _, js), (teng, tmgr, _, ts) = sides["jax"], sides["port"]
    assert (ts.decoded_count, ts.failed_count) == (js.decoded_count, js.failed_count) == (5, 1)
    assert tmgr.describe() == jmgr.describe()
    assert tmgr.status is tlife.LifecycleStatus.STOPPED
    _same_engines(jeng, teng, [f"sock-{i}" for i in range(5)])


def test_websocket_receiver_matches_jax():
    websockets = pytest.importorskip("websockets")

    async def run():
        sides = {}
        for side, (dec, _, _, src) in SIDES.items():
            eng, mgr = _wired(side)
            recv = src.WebSocketEventReceiver()
            s = mgr.add_source(src.InboundEventSource(
                "ws", dec.JsonDeviceRequestDecoder(), [recv]))
            await mgr.initialize()
            await mgr.start()
            sides[side] = (eng, recv, s, mgr)
        try:
            for _, recv, s, _ in sides.values():
                async with websockets.connect(f"ws://127.0.0.1:{recv.bound_port}") as ws:
                    await ws.send(measurement_json("ws-1"))
                    await ws.send(measurement_json("ws-2").decode())   # a text frame
                for _ in range(100):
                    if s.decoded_count == 2:
                        break
                    await asyncio.sleep(0.02)
        finally:
            for *_, mgr in sides.values():
                await mgr.stop()
        return sides

    sides = asyncio.run(run())
    assert sides["port"][2].decoded_count == sides["jax"][2].decoded_count == 2
    _same_engines(sides["jax"][0], sides["port"][0], ["ws-1", "ws-2"])


def test_polling_rest_receiver_matches_jax():
    aiohttp_web = pytest.importorskip("aiohttp.web")

    async def run():
        hits = {"n": 0}

        async def handler(request):
            hits["n"] += 1
            return aiohttp_web.Response(body=measurement_json("poll-1", value=float(hits["n"])))

        app = aiohttp_web.Application()
        app.router.add_get("/events", handler)
        runner = aiohttp_web.AppRunner(app)
        await runner.setup()
        site = aiohttp_web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        sides = {}
        try:
            for side, (dec, _, _, src) in SIDES.items():
                eng, mgr = _wired(side)
                recv = src.PollingRestReceiver(f"http://127.0.0.1:{port}/events",
                                               interval_s=3600)
                s = mgr.add_source(src.InboundEventSource(
                    "poll", dec.JsonDeviceRequestDecoder(), [recv]))
                await mgr.initialize()
                await mgr.start()
                for _ in range(200):
                    if s.decoded_count == 1:
                        break
                    await asyncio.sleep(0.02)
                await mgr.stop()
                sides[side] = (eng, s)
        finally:
            await runner.cleanup()
        return sides

    sides = asyncio.run(run())
    assert sides["port"][1].decoded_count == sides["jax"][1].decoded_count == 1
    # each side polled once: the first response, 1.0, reached each engine
    for side in ("jax", "port"):
        eng = sides[side][0]
        eng.flush()
        assert eng.get_device_state("poll-1")["event_counts"]["MEASUREMENT"] == 1


def test_batcher_is_duck_typed_and_exclusive_with_dedup():
    class Batcher:
        def __init__(self):
            self.added, self.flushed = [], 0

        def add(self, payload, tenant, binary, on_durable):
            self.added.append((payload, tenant, binary))

        def flush(self):
            self.flushed += 1

    results = {}
    for side, (dec, dd, _, src) in SIDES.items():
        b = Batcher()
        mgr = src.EventSourcesManager(on_event_request=lambda r: None, batcher=b)
        recv = src.InMemoryEventReceiver()
        s = mgr.add_source(src.InboundEventSource("b", dec.BinaryEventDecoder(), [recv],
                                                  tenant="t9"))
        with pytest.raises(ValueError, match="mutually exclusive"):
            src.InboundEventSource("x", dec.JsonDeviceRequestDecoder(),
                                   deduplicator=dd.AlternateIdDeduplicator(), batcher=b)
        fired = []
        recv.submit("text-payload", on_durable=lambda: fired.append(1))
        asyncio.run(mgr.stop())
        results[side] = (b.added, b.flushed, s.batched_count, fired)
    assert results["port"] == results["jax"] == ([(b"text-payload", "t9", True)], 1, 1, [])


# ------------------------------------------------------------ lifecycle

def _tree(life, fail_optional: bool, fail_required: bool):
    class Comp(life.LifecycleComponent):
        def __init__(self, name, required=True, boom=None):
            super().__init__(name, required)
            self.boom, self.calls = boom, []

        async def on_initialize(self):
            self.calls.append("init")

        async def on_start(self):
            self.calls.append("start")
            if self.boom == "start":
                raise RuntimeError(f"{self.name} failed to start")

        async def on_stop(self):
            self.calls.append("stop")

    root = Comp("root")
    a = root.add_child(Comp("a", required=False, boom="start" if fail_optional else None))
    b = root.add_child(Comp("b", boom="start" if fail_required else None))
    return root, [root, a, b]


@pytest.mark.parametrize("case", [(False, False), (True, False), (False, True)])
def test_lifecycle_transitions_match_jax(case):
    def run(life):
        root, comps = _tree(life, *case)
        trail = []

        async def go():
            for phase in ("initialize", "start", "stop"):
                try:
                    await getattr(root, phase)()
                except RuntimeError as e:
                    trail.append(("raised", phase, str(e)))
                trail.append([c.status.value for c in comps])

        asyncio.run(go())
        return trail, [c.calls for c in comps], root.describe()

    got = run(tlife)
    assert got == run(jlife)
    assert got[0][-1] == ["stopped"] * 3


# ---------------------------------------------------------------- faults

def test_fault_plans_replay_from_seed_as_jax():
    def run(mod, seed):
        plan = (mod.FaultPlan(seed).drop(0, 1, prob=0.3, method_prefix="Rpc.")
                .partition(2, 3, prob=0.5).delay(1, 0, delay_s=0.0, prob=0.5)
                .delay_jitter(3, 1, base_s=0.0, jitter_s=1e-5, prob=0.5).kill(4))
        inj = mod.install(plan)
        outcomes = []
        try:
            for i in range(400):
                src, dst = i % 4, (i * 7 + 1) % 5
                try:
                    mod.check(src, dst, "Rpc.call" if i % 3 else "Other.call")
                    outcomes.append("ok")
                except ConnectionError as e:
                    outcomes.append(str(e))
        finally:
            mod.clear()
        mod.check(0, 4, "Rpc.call")      # no plan installed: a no-op
        plan.revive(4)
        return outcomes, inj.counters

    got = run(tfaults, 7)
    assert got == run(jfaults, 7)
    assert got == run(tfaults, 7)         # the same seed replays exactly
    assert got != run(tfaults, 8)
    assert all(v > 0 for v in got[1].values()), got[1]


# ------------------------------------------------------------- scripting

def test_script_manager_templates_and_hot_reload_match_jax(tmp_path):
    tmgr, jmgr = tscript.ScriptManager("script-templates"), jscript.ScriptManager("script-templates")
    assert tmgr.list_scripts() == jmgr.list_scripts()
    assert "event-decoder.py" in tmgr.list_scripts()
    reqs = tmgr.handle("event-decoder.py", "decode")(b"dev-9,temp,21.5", {})
    want = jmgr.handle("event-decoder.py", "decode")(b"dev-9,temp,21.5", {})
    assert [_fields(r) for r in reqs] == [_fields(r) for r in want]
    assert reqs[0].device_token == "dev-9"
    with pytest.raises(tscript.ScriptError, match="does not define"):
        tmgr.handle("event-decoder.py", "nope")
    with pytest.raises(tscript.ScriptError, match="requires a 'script' path"):
        tscript.script_handle({}, "decode", tmgr)

    script = tmp_path / "dec.py"
    script.write_text("def decode(p, m):\n    return []\n")
    h = tscript.script_handle({"script": str(script)}, "decode")
    dec = tdec.ScriptedDecoder(h)
    assert dec.decode(b"", {}) == []
    script.write_text(
        "from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType\n"
        "def decode(p, m):\n"
        "    return [DecodedRequest(type=RequestType.DEVICE_MEASUREMENT,\n"
        "            device_token=p.decode(), measurements={'x': 1.0})]\n")
    os.utime(script, (time.time() + 5, time.time() + 5))
    (req,) = dec.decode(b"sc-1", {})
    assert isinstance(req, treq.DecodedRequest) and req.device_token == "sc-1"
    assert h.name == "dec.py:decode"


def test_script_management_versions_match_jax(tmp_path):
    def run(mod, root):
        sm = mod.ScriptManagement(root, manager=mod.ScriptManager())
        out = [sm.create_script("decoders", "default", script_id="csv",
                                content="def decode(p, m):\n    return [1]\n")]
        out.append(sm.clone_version("decoders", "default", "csv", "v1"))
        out.append(sm.update_script("decoders", "default", "csv", "v2",
                                    content="def decode(p, m):\n    return [2]\n",
                                    category="parsers"))
        active = sm.active_path("decoders", "default", "csv")
        h = sm.manager.handle(active, "decode")
        first = h(b"", {})
        out.append(sm.activate("decoders", "default", "csv", "v2"))
        os.utime(active, (time.time() + 5, time.time() + 5))
        second = h(b"", {})
        out += [sm.list_scripts("decoders", "default"),
                sm.list_by_category("decoders", "default"),
                sm.get_content("decoders", "default", "csv", "v2"),
                sm.delete_script("decoders", "default", "csv"),
                sm.delete_script("decoders", "default", "csv")]
        # the version stamps are wall-clock times
        return re.sub(r'"createdMs": [0-9]+', '"createdMs": 0',
                      json.dumps(out, sort_keys=True)), first, second

    got = run(tscript, tmp_path / "port")
    assert got == run(jscript, tmp_path / "jax")
    assert got[1:] == ([1], [2])
    with pytest.raises(tscript.ScriptError, match="invalid path component"):
        tscript.ScriptManagement(tmp_path / "x").active_path("..", "t", "s")


# --------------------------------------------------- WAL durable view

def test_durable_view_reports_nothing_before_first_commit(tmp_path):
    views = []
    for cls, d in ((IngestLog, "port"), (JaxIngestLog, "jax")):
        log = cls(tmp_path / d, group_commit=True, group_window_s=5.0)
        views.append(log.durable_view())
        log.close()
    assert views[0] == views[1]
    assert views[0] and all(v == 0 for v in views[0].values())


def test_durable_view_after_rotation_matches_jax(tmp_path):
    views = []
    for cls, d in ((IngestLog, "port"), (JaxIngestLog, "jax")):
        log = cls(tmp_path / d, segment_bytes=256, group_commit=True)
        trail = []
        for i in range(8):
            log.append(f"pre-{i}".encode() * 8)
            log.flush()
            trail.append(log.durable_view())
        log.append_watermark(100)
        for i in range(8):
            log.append(f"post-{i}".encode() * 8)
        log.sync()
        trail.append(log.durable_view())
        segs = sorted((tmp_path / d).glob("segment-*.log"))
        assert len(segs) >= 2
        assert trail[-1] == {s.name: s.stat().st_size for s in segs}
        log.close()
        views.append(trail)
    assert views[0] == views[1]


# --------------------------------------------------------------- routes

def _cluster_route_payloads() -> list[bytes]:
    """The payload set of tests/test_cluster.py's route agreement test."""
    long_tok = "L" * 3000
    return [json.dumps({"deviceToken": f"dev-{i}", "type": "DeviceMeasurement",
                        "request": {"name": "t", "value": 1.0}}).encode()
            for i in range(40)] + [
        b'{"hardwareId": "hw-7", "type": "DeviceMeasurement"}',
        b'{"deviceToken": "", "hardwareId": "hw-8"}',
        b'{"deviceToken": 12345}',
        b'{"deviceToken": null, "hardwareId": "hw-9"}',
        b'{"type": "DeviceMeasurement"}',
        b'{broken json',
        b'[1,2,3]',
        json.dumps({"deviceToken": 'esc"tok\\en'}).encode(),
        json.dumps({"deviceToken": "télémetre"}).encode(),
        b'{"deviceToken": "first", "deviceToken": "second"}',
        b'{"deviceToken": "keep", "deviceToken": 42}',
        json.dumps({"deviceToken": "dt-wins", "hardwareId": "hw-loses"}).encode(),
        b'{"deviceToken": "x", "request": {"na',
        b'{"deviceToken": "x"} garbage',
        b'{"deviceToken": "a\nb"}',
        b'{"a": "c\rd", "deviceToken": "y"}',
        b'{"deviceToken": "\\ud83d\\ude00-dev"}',
        '{"deviceToken": "\U0001F600-dev"}'.encode(),
        b'{"deviceToken": "\\ud83d lonely"}',
        ('{"deviceToken": "%s"}' % long_tok).encode(),
        ('{"a": 1.5e3, "deviceToken": "after-num", "b": true,'
         ' "c": null, "d": [1, {"x": "y"}]}').encode(),
    ]


def _binary_route_payloads() -> list[bytes]:
    out = [tdec.encode_binary_request(treq.DecodedRequest(
        type=treq.RequestType.DEVICE_MEASUREMENT, device_token=f"pb-{i}",
        measurements={"a": 1.0})) for i in range(20)]
    return out + [b"", b"\x01", b"\x02\x01\x03\x00abc", b"\x01\x01\x05\x00ab",
                  b"\x01\x01\x02\x00\xff\xfe", b"\x01\x01\x00\x00"]


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("n_ranks", [1, 5, 7])
def test_route_payloads_and_fallback_match_jax_rank_for_rank(binary, n_ranks):
    payloads = _binary_route_payloads() if binary else _cluster_route_payloads()
    got = tbind.route_payloads(payloads, n_ranks, binary=binary)
    want = jbind.route_payloads(payloads, n_ranks, binary=binary)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    one = troute.route_binary_payload if binary else troute.route_json_payload
    jone = jroute.route_binary_payload if binary else jroute.route_json_payload
    for i, p in enumerate(payloads):
        assert int(got[i]) == one(p, n_ranks) == jone(p, n_ranks), (i, p[:60])
    # JAX's contract: a batch that is not a list[bytes] routes through the
    # fallback (None here, on both sides)
    assert tbind.route_payloads(tuple(payloads), n_ranks, binary=binary) is None
    assert jbind.route_payloads(tuple(payloads), n_ranks, binary=binary) is None


def test_route_randomized_differential_matches_jax():
    """The seeded fuzz of tests/test_ingest.py's scanner/router test:
    random valid envelopes, then random mutations of them, routed by the
    port's native router, the JAX package's and the port's fallback."""
    rng = random.Random(1234)
    alphabet = "abcXYZ0189-_.é😀\"\\\n\t"

    def rand_token():
        return "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 24)))

    def rand_envelope():
        t = rng.choice(["DeviceMeasurement", "DeviceLocation", "DeviceAlert"])
        req = {"name": rand_token(), "value": rng.uniform(-1e6, 1e6)} \
            if t == "DeviceMeasurement" else {"latitude": 1.0, "longitude": 2.0} \
            if t == "DeviceLocation" else {"type": rand_token(), "level": "Info"}
        env = {"deviceToken": rand_token(), "type": t, "request": req}
        if rng.random() < 0.2:
            env["extraKey"] = rng.choice([None, True, [1, {"a": "b"}], "x"])
        return env

    payloads = [json.dumps(rand_envelope(), ensure_ascii=rng.random() < 0.5).encode()
                for _ in range(1500)]
    mut = []
    for p in payloads[:800]:
        b = bytearray(p)
        for _ in range(rng.randint(1, 4)):
            op = rng.random()
            if op < 0.4 and len(b) > 2:
                del b[rng.randrange(len(b)):]
            elif op < 0.8 and b:
                b[rng.randrange(len(b))] = rng.randrange(256)
            else:
                b.insert(rng.randrange(len(b) + 1), rng.randrange(256))
        mut.append(bytes(b))
    for batch in (payloads, mut):
        got = tbind.route_payloads(batch, 7)
        np.testing.assert_array_equal(got, jbind.route_payloads(batch, 7))
        assert [troute.route_json_payload(p, 7) for p in batch] == got.tolist()


def test_route_payloads_raises_on_a_failed_build(monkeypatch):
    """The port's pinned rule: a failed native build raises (the JAX
    binding returns None and its caller falls back)."""
    monkeypatch.setattr(tbind, "_py_lib", None)
    monkeypatch.setattr(tbind, "_PY_SRC", tbind._PY_SRC.with_name("missing.cpp"))
    with pytest.raises((RuntimeError, OSError)):
        tbind.route_payloads([b'{"deviceToken": "a"}'], 3)


# ------------------------------------------------------ interner, clock

def test_interner_truncate_and_epoch_to_unix_s_match_jax():
    t, j = TokenInterner(16), JaxInterner(16)
    for tok in ("a", "b", "c", "d", "e"):
        assert t.intern(tok) == j.intern(tok)
    t.truncate(2)
    j.truncate(2)
    assert len(t) == len(j) == 2
    assert dict(t.items()) == dict(j.items())
    assert t.lookup("c") == j.lookup("c")
    assert t.intern("e") == j.intern("e") == 2
    for ms in (0, 1, -1500, 2**31 - 1):
        assert EpochBase(BASE_S).to_unix_s(ms) == JaxEpoch(BASE_S).to_unix_s(ms)
    assert EpochBase(BASE_S).to_unix_s(EpochBase(BASE_S).to_ms(BASE_S + 12.5)) == BASE_S + 12.5
