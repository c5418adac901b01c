"""The persistent-connection wire edge (``ingest/wire_edge.py``) and the MQTT
codec it speaks (``ingest/mqtt.py``), held to the JAX package's modules.

Every case of ``tests/test_wire_edge.py`` has a twin here: the same traffic
goes through the JAX package's edge or batcher into a JAX ``Engine`` and
through the port's into a port ``Engine(device="cpu")``, both clocks
pinned. Where the JAX case drives a ``FakeEngine``, the twin drives a
``Recording`` proxy with the same surface (the batch-ingest calls recorded,
its own ``qos``, injected stalls) in front of a real engine. Each twin
compares the engines' state byte for byte, ``metrics()``, the edge's
``snapshot()`` and the acks each client received. Batch splits never hang
on timing: sockets wait for each ack before the next frame (or send an SWP
flush hint and wait for the group's acks), batchers are ``auto=False`` with
explicit ``flush()``, and the deadline and size flushes run on an injected
clock. Which thread drains an arrival window first (the flusher or a
flush hint) moves only ``flushes`` and ``flush_occupancy_pct``, in both
packages; socket twins compare every other snapshot key.
"""

import asyncio
import json
import logging
import random
import struct
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.ingest import decoders as jdec
from sitewhere_tpu.ingest import dedup as jdedup
from sitewhere_tpu.ingest import mqtt as jmqtt
from sitewhere_tpu.ingest import requests as jreq
from sitewhere_tpu.ingest import sources as jsrc
from sitewhere_tpu.ingest import wire_edge as jwe
from sitewhere_tpu.parallel.sharded import SpmdEngine as JaxSpmdEngine
from sitewhere_tpu.utils import conservation as jcons
from sitewhere_tpu.utils import metrics as jmetrics
from sitewhere_tpu.utils import qos as jqos
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest import decoders as tdec
from sitewhere_tpu_torch.ingest import dedup as tdedup
from sitewhere_tpu_torch.ingest import mqtt as tmqtt
from sitewhere_tpu_torch.ingest import requests as treq
from sitewhere_tpu_torch.ingest import sources as tsrc
from sitewhere_tpu_torch.ingest import wire_edge as twe
from sitewhere_tpu_torch.parallel.sharded import SpmdEngine
from sitewhere_tpu_torch.utils import conservation as tcons
from sitewhere_tpu_torch.utils import metrics as tmetrics
from sitewhere_tpu_torch.utils import qos as tqos
from tests.test_wire_edge import W_CFG, FixedEpoch, _alt_payload, _payload
from tests.torch_parity import assert_tree_equal
from tests.torch_spmd import TorchFixedEpoch, assert_state_equal

SIDES = {
    "jax": types.SimpleNamespace(name="jax", mqtt=jmqtt, we=jwe, src=jsrc, dec=jdec,
                                 dedup=jdedup, req=jreq, qos=jqos, cons=jcons,
                                 metrics=jmetrics),
    "port": types.SimpleNamespace(name="port", mqtt=tmqtt, we=twe, src=tsrc, dec=tdec,
                                  dedup=tdedup, req=treq, qos=tqos, cons=tcons,
                                  metrics=tmetrics),
}
# keys of a snapshot moved by which thread drains a window first
TIMING_KEYS = ("flushes", "flush_occupancy_pct")
# metrics of a multi-shard engine the two packages share (tests/test_torch_spmd.py)
SPMD_METRICS = ("processed", "found", "missed", "registered", "persisted",
                "reg_overflow", "channel_collisions", "staged", "arena_rows",
                "arena_pool_size")
WAIT_S = 10


def _engine(side: str, kind: str = "engine", scan_chunk=None):
    if side == "jax":
        if kind == "engine":
            eng = JaxEngine(JaxEngineConfig(**W_CFG))
        else:
            eng = JaxSpmdEngine(JaxEngineConfig(**{**W_CFG, "scan_chunk": scan_chunk}),
                                n_shards=2)
        eng.epoch = FixedEpoch()
    else:
        if kind == "engine":
            eng = Engine(EngineConfig(**W_CFG), device="cpu")
        else:
            eng = SpmdEngine(EngineConfig(**{**W_CFG, "scan_chunk": scan_chunk}),
                             n_shards=2, device="cpu")
        eng.epoch = TorchFixedEpoch()
    return eng


class Recording:
    """The JAX tests' ``FakeEngine`` surface in front of a real engine: each
    batch-ingest call is recorded, then forwarded, unless one of the first
    ``stalls`` calls raises the side's ``ShedError`` (an arena stall);
    ``qos`` is the proxy's own (None admits everything); every other
    attribute is the engine's."""

    def __init__(self, engine, ns, stalls: int = 0):
        self.__dict__.update(engine=engine, ns=ns, stalls=stalls, calls=0,
                             json_batches=[], binary_batches=[], qos=None)

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def __setattr__(self, name, value):
        if name in self.__dict__:
            self.__dict__[name] = value
        else:
            setattr(self.engine, name, value)

    def _call(self, kind, payloads, tenant, kw):
        self.__dict__["calls"] += 1
        if self.calls <= self.stalls:
            raise self.ns.qos.ShedError("arena stall", tenant=tenant,
                                        retry_after_s=0.05, reason="stall")
        getattr(self, f"{kind}_batches").append((list(payloads), tenant))
        return getattr(self.engine, f"ingest_{kind}_batch")(payloads, tenant=tenant, **kw)

    def ingest_json_batch(self, payloads, tenant="default", **kw):
        return self._call("json", payloads, tenant, kw)

    def ingest_binary_batch(self, payloads, tenant="default", **kw):
        return self._call("binary", payloads, tenant, kw)


class DenyAll:
    """A QoS gate refusing every admission (the JAX tests' ``_DenyAll``)."""

    def admit(self, tenant, n):
        return types.SimpleNamespace(admitted=False, retry_after_s=0.25, reason="rate")


class GatedClock:
    """A clock that stands still until the test moves it: a deadline
    expires exactly when the test says, never on the wall clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _settle(eng) -> None:
    eng = getattr(eng, "engine", eng)
    eng.flush()
    for fn in ("barrier", "drain"):
        m = getattr(eng, fn, None)
        if m is not None:
            m()


def _same_engines(jeng, teng, spmd: bool = False) -> None:
    """The port's engine against the JAX one: state byte for byte and
    ``metrics()`` (the shared keys of a multi-shard engine)."""
    jeng, teng = getattr(jeng, "engine", jeng), getattr(teng, "engine", teng)
    _settle(jeng)
    _settle(teng)
    if spmd:
        assert_state_equal(jeng, teng)
        a, b = jeng.metrics(), teng.metrics()
        assert {k: b[k] for k in SPMD_METRICS} == {k: a[k] for k in SPMD_METRICS}
    else:
        assert_tree_equal(jax.device_get(jeng.state), teng.state)
        assert teng.metrics() == jeng.metrics()


def _twin(scenario, kind="engine", scan_chunk=None, stalls=0, qos=None):
    """Run ``scenario(ns, eng)`` on each side; returns {side: (eng, result)}
    after holding the port's engine to the JAX one and its result (acks,
    snapshots, recorded calls) equal to the JAX one's."""
    out = {}
    for side, ns in SIDES.items():
        eng = Recording(_engine(side, kind, scan_chunk), ns, stalls=stalls)
        if qos is not None:
            eng.qos = qos()
        out[side] = (eng, scenario(ns, eng))
    (je, jr), (te, tr) = out["jax"], out["port"]
    assert tr == jr
    assert te.json_batches == je.json_batches
    assert te.binary_batches == je.binary_batches
    _same_engines(je, te, spmd=kind != "engine")
    return out


def _snap(edge, exact: bool = False) -> dict:
    s = edge.snapshot()
    return s if exact else {k: v for k, v in s.items() if k not in TIMING_KEYS}


async def _quiet(edge) -> dict:
    """The edge's snapshot once every connection has closed and no frame
    is pending (connection teardown runs on the server's own schedule)."""
    async def wait():
        while True:
            s = edge.snapshot()
            if s["connections_live"] == 0 and s["pending"] == 0:
                return
            await asyncio.sleep(0.01)

    await asyncio.wait_for(wait(), WAIT_S)
    return _snap(edge)


def _binary(ns, i):
    R = ns.req.RequestType
    return ns.dec.encode_binary_request(ns.req.DecodedRequest(
        type=R.DEVICE_MEASUREMENT, device_token=f"wb-{i % 3}",
        measurements={"temp": 1.0 + i}, event_ts_ms=2_000 + i))


# --- alternate-id byte scan ----------------------------------------------------

SCAN_CASES = [_alt_payload("m-7"), b'{"alternateId" \t:\n "a b"}', b'{"alternateId": "q\\"x"}',
              _payload(0), b'{"alternateId": 12}', b'{"alternateId": "open',
              b'{"alternateId"}', b'{"deviceToken": "d\\u00e9", "alternateId": "\xc3\xa9"}',
              b'{"alternateId": "\xff"}', b'{"alternateId":"x\\']


def test_extract_alternate_id_variants():
    rng = random.Random(5)
    cases = list(SCAN_CASES)
    for _ in range(200):        # seeded mutations of a payload with both keys
        b = bytearray(_alt_payload(f"s-{rng.randrange(100)}", rng.randrange(9)))
        for _ in range(rng.randint(1, 3)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        cases.append(bytes(b))
    for p in cases:
        assert twe.extract_alternate_id(p) == jwe.extract_alternate_id(p), p
        assert twe.extract_device_token(p) == jwe.extract_device_token(p), p
    assert twe.extract_alternate_id(SCAN_CASES[0]) == "m-7"
    assert twe.extract_alternate_id(SCAN_CASES[2]) == 'q"x'
    assert twe.extract_alternate_id(SCAN_CASES[4]) is None


def test_alt_id_ring_bounded_fifo():
    seen = {}
    for side, ns in SIDES.items():
        ring = ns.we.AltIdRing(capacity=3)
        log = []
        for op, x in [("add", "a"), ("add", "b"), ("add", "c"), ("add", "d"),
                      ("seen", "a"), ("seen", "d"), ("seen", "b"), ("add", "b"),
                      ("add", "e"), ("seen", "b"), ("seen", "c")]:
            log.append(getattr(ring, op)(x))
        seen[side] = log
    assert seen["port"] == seen["jax"]
    assert seen["port"][4:7] == [False, True, True] and seen["port"][9] is False


# --- WireBatcher ------------------------------------------------------------------

def test_batcher_size_flush_and_run_splitting():
    def scenario(ns, eng):
        b = ns.we.WireBatcher(eng, flush_rows=64, auto=False)
        acks = []
        # arrival order: t1 json, t1 json, t2 json, t1 binary, t1 binary
        for p, tenant, binary in ((_payload(0), "t1", False), (_payload(1), "t1", False),
                                  (_payload(2, dev=9), "t2", False),
                                  (_binary(ns, 0), "t1", True), (_binary(ns, 1), "t1", True)):
            b.add(p, tenant=tenant, binary=binary,
                  on_durable=lambda p=p: acks.append(p))
        pending = b.pending
        n = b.flush()
        c = b.counters()
        b.close()
        return pending, n, b.pending, acks, c

    out = _twin(scenario)
    eng, (pending, n, after, acks, c) = out["port"]
    assert (pending, n, after) == (5, 5, 0)
    assert [t for _, t in eng.json_batches] == ["t1", "t2"]
    assert len(eng.binary_batches) == 1 and len(acks) == 5
    assert c["rows_submitted"] == 5 and c["flushes"] == c["flushes_drain"] == 1


def test_batcher_auto_size_threshold():
    def scenario(ns, eng):
        b = ns.we.WireBatcher(eng, flush_rows=4, flush_interval_s=30.0, auto=True,
                              clock=GatedClock())
        done = threading.Event()
        for i in range(4):
            b.add(_payload(i), on_durable=done.set if i == 3 else None)
        assert done.wait(WAIT_S), "size-threshold flush never fired"
        c = b.counters()
        b.close()
        return c

    c = _twin(scenario)["port"][1]
    assert c["flushes_size"] == 1 and c["rows_submitted"] == 4


def test_batcher_auto_deadline_flush():
    """A window under the size threshold drains at its deadline: the
    clock moves past it and the barrier's notify wakes the flusher."""
    def scenario(ns, eng):
        clock = GatedClock()
        b = ns.we.WireBatcher(eng, flush_rows=100, flush_interval_s=0.05, auto=True,
                              clock=clock)
        acked = []
        for i in range(3):
            b.add(_payload(i), on_durable=lambda i=i: acked.append(i))
        fired = threading.Event()
        clock.t = 1.0
        b.add_barrier(fired.set)
        assert fired.wait(WAIT_S), "deadline flush never fired"
        c = b.counters()
        b.close()
        return acked, c

    acked, c = _twin(scenario)["port"][1]
    assert acked == [0, 1, 2]           # ack order == ingest order
    assert c["flushes_deadline"] == 1 and c["flushes_size"] == 0


def test_batcher_shed_withholds_acks():
    def scenario(ns, eng):
        b = ns.we.WireBatcher(eng, flush_rows=64, auto=False)
        acks, stalls = [], []
        b.add(_payload(0), on_durable=lambda: acks.append(0),
              on_stall=lambda e: stalls.append((type(e).__name__, e.reason, e.retry_after_s)))
        n = b.flush()
        c = b.counters()
        b.close()
        return n, acks, stalls, c

    n, acks, stalls, c = _twin(scenario, stalls=1)["port"][1]
    assert n == 0 and acks == [] and stalls == [("ShedError", "stall", 0.05)]
    assert c["frames_stalled"] == 1


def test_batcher_closed_raises():
    for ns in SIDES.values():
        b = ns.we.WireBatcher(Recording(_engine(ns.name), ns), auto=False)
        b.close()
        with pytest.raises(RuntimeError, match="wire batcher closed"):
            b.add(b"late")
        with pytest.raises(RuntimeError, match="wire batcher closed"):
            b.add_barrier(lambda: None)


def test_batcher_on_staged_fires_only_on_success():
    def scenario(ns, eng):
        b = ns.we.WireBatcher(eng, flush_rows=64, auto=False)
        staged = []
        b.add(_payload(0), on_staged=lambda: staged.append(0))
        b.flush()
        first = list(staged)            # stalled: no commit
        b.add(_payload(0), on_staged=lambda: staged.append(1))
        b.flush()
        b.close()
        return first, staged

    first, staged = _twin(scenario, stalls=1)["port"][1]
    assert first == [] and staged == [1]


# --- sources: the batched submit API ----------------------------------------------

def test_source_routes_through_batched_submit():
    def scenario(ns, eng):
        batcher = ns.we.WireBatcher(eng, flush_rows=64, auto=False)
        mgr = ns.src.EventSourcesManager(on_event_request=lambda r: None, batcher=batcher)
        recv = ns.src.InMemoryEventReceiver()
        src = ns.src.InboundEventSource("batched", ns.dec.JsonDeviceRequestDecoder(), [recv])
        mgr.add_source(src)
        assert src.batcher is batcher
        fired = []
        for i in range(3):
            recv.submit(_payload(i), on_durable=lambda i=i: fired.append(i))
        before = (src.batched_count, src.decoded_count, batcher.pending,
                  len(eng.json_batches), list(fired))
        batcher.flush()
        batcher.close()
        return before, fired

    before, fired = _twin(scenario)["port"][1]
    assert before == (3, 0, 3, 0, []) and fired == [0, 1, 2]


def test_source_per_payload_path_acks_synchronously():
    def scenario(ns, eng):
        mgr = ns.src.EventSourcesManager(on_event_request=eng.process)
        recv = ns.src.InMemoryEventReceiver()
        mgr.add_source(ns.src.InboundEventSource("plain", ns.dec.JsonDeviceRequestDecoder(),
                                                 [recv]))
        fired = []
        recv.submit(_payload(0), on_durable=lambda: fired.append("ok"))
        recv.submit(b"not json", on_durable=lambda: fired.append("dlq"))
        return fired, [(s, p) for s, p, _ in mgr.failed_decodes]

    fired, dead = _twin(scenario)["port"][1]
    assert fired == ["ok", "dlq"] and dead == [("plain", b"not json")]


def test_source_batcher_dedup_mutually_exclusive():
    for ns in SIDES.values():
        with pytest.raises(ValueError, match="mutually exclusive"):
            ns.src.InboundEventSource(
                "x", ns.dec.JsonDeviceRequestDecoder(), [ns.src.InMemoryEventReceiver()],
                deduplicator=ns.dedup.AlternateIdDeduplicator(),
                batcher=ns.we.WireBatcher(Recording(_engine(ns.name), ns), auto=False))


# --- the MQTT codec -------------------------------------------------------------

VARINT_EDGES = [0, 1, 127, 128, 129, 16383, 16384, 16385, 2097151, 2097152, 268435455]


def _body(pkt: bytes) -> bytes:
    """A packet's body: past the header byte and the remaining-length varint."""
    i = 1
    while pkt[i] & 0x80:
        i += 1
    return pkt[i + 1:]


def test_mqtt_codec_bytes_match_jax():
    """Varints at every length boundary and seeded packets: the port's
    encoders give the JAX package's bytes and its decoders its values."""
    rng = np.random.default_rng(11)
    for n in VARINT_EDGES + [int(x) for x in rng.integers(0, 268435455, 64)]:
        assert tmqtt.encode_varint(n) == jmqtt.encode_varint(n)
    for i in range(64):
        topic = f"swtpu/t{int(rng.integers(4))}/" + "x" * int(rng.integers(0, 40))
        payload = rng.bytes(int(rng.choice([0, 1, 120, 200, 20000])))
        qos, pid = int(rng.integers(3)), int(rng.integers(1, 65536))
        pkt = tmqtt.encode_publish(topic, payload, qos, pid)
        assert pkt == jmqtt.encode_publish(topic, payload, qos, pid)
        flags, body = pkt[0] & 0x0F, _body(pkt)
        assert tmqtt.decode_publish(flags, body) == jmqtt.decode_publish(flags, body)
        cid = f"c-{i}"
        user = None if i % 2 else f"u{i}"
        pw = None if i % 3 else f"p{i}"
        conn = tmqtt.encode_connect(cid, i, user, pw)
        assert conn == jmqtt.encode_connect(cid, i, user, pw)
        cbody = _body(conn)
        assert tmqtt.decode_connect(cbody) == jmqtt.decode_connect(cbody) == (cid, i)
        subs = [(f"a/{j}/#", j % 3) for j in range(1 + i % 3)]
        assert tmqtt.encode_subscribe(i + 1, subs) == jmqtt.encode_subscribe(i + 1, subs)
        pt, fl = int(rng.integers(1, 15)), int(rng.integers(16))
        assert tmqtt.encode_packet(pt, fl, payload) == jmqtt.encode_packet(pt, fl, payload)
    with pytest.raises(ValueError, match="bad protocol name"):
        tmqtt.decode_connect(b"\x00\x04MQTX\x04\x02\x00\x00\x00\x00")
    for pattern, topic in [("a/+/c", "a/b/c"), ("a/#", "a"), ("a/#", "a/b/c"), ("+", "a/b"),
                           ("a/b", "a/b/c"), ("#", "x"), ("a/+", "a"), ("a/b/c", "a/b")]:
        assert tmqtt.topic_matches(pattern, topic) == jmqtt.topic_matches(pattern, topic)


def test_mqtt_fragmented_reads_and_frame_limit_match_jax():
    """Byte-at-a-time delivery across a 1-, 2- and 3-byte remaining length
    frames as contiguous delivery does; the server-side limit refuses the
    body before reading it; a 5-byte varint is malformed. Both packages."""
    async def read_all(ns, data, limit=None):
        r = asyncio.StreamReader()
        out = []

        async def feed():
            for i in range(len(data)):
                r.feed_data(data[i:i + 1])
                await asyncio.sleep(0)
            r.feed_eof()

        task = asyncio.ensure_future(feed())
        try:
            while True:
                if limit is None:
                    out.append(await ns.mqtt.read_packet(r))
                else:
                    out.append(await ns.mqtt.read_packet_limited(r, limit))
        except asyncio.IncompleteReadError:
            out.append("eof")
        except Exception as e:
            out.append((type(e).__name__, str(e)))
        await task
        return out

    pkts = [jmqtt.encode_publish("t/x", b"p" * n, 1, 7) for n in (10, 125, 200, 16400)]
    pkts.append(jmqtt.encode_packet(jmqtt.PINGREQ, 0, b""))
    stream = b"".join(pkts)
    got = {}
    for side, ns in SIDES.items():
        got[side] = (asyncio.run(read_all(ns, stream)),
                     asyncio.run(read_all(ns, stream, limit=1000)),
                     asyncio.run(read_all(ns, b"\x30\xff\xff\xff\xff\x01")))
    assert got["port"] == got["jax"]
    plain, limited, bad = got["port"]
    assert [p[2][7:8] for p in plain[:4]] == [b"p"] * 4 and plain[-1] == "eof"
    assert limited[3][0] == "FrameTooLarge" and bad[0][0] == "ValueError"


# --- the MQTT server ---------------------------------------------------------------

def _edge_cfg(ns, **kw):
    base = dict(mqtt_port=0, tcp_port=None, flush_rows=1, flush_interval_s=0.01)
    base.update(kw)
    return ns.we.WireEdgeConfig(**base)


async def _mqtt_connect(ns, port, keepalive=0, fragment=False):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    pkt = ns.mqtt.encode_connect("t-client", keepalive=keepalive)
    if fragment:
        for i in range(len(pkt)):
            w.write(pkt[i:i + 1])
            await w.drain()
            await asyncio.sleep(0.001)
    else:
        w.write(pkt)
        await w.drain()
    ptype, _, body = await asyncio.wait_for(ns.mqtt.read_packet(r), WAIT_S)
    assert ptype == ns.mqtt.CONNACK and body == b"\x00\x00"
    return r, w


async def _read(ns, r, timeout=WAIT_S):
    ptype, _, body = await asyncio.wait_for(ns.mqtt.read_packet(r), timeout)
    return ptype, int.from_bytes(body[:2], "big") if len(body) >= 2 else None


def _edge_run(ns, eng, cfg, client):
    """Start an edge on ``eng``, run ``client(edge)``, then take the quiet
    snapshot and stop the edge; returns (client's result, snapshot)."""
    async def run():
        edge = ns.we.WireEdge(eng, cfg)
        await edge.start()
        try:
            res = await client(edge)
            snap = await _quiet(edge)
        finally:
            await edge.stop()
        return res, snap

    return asyncio.run(run())


def test_mqtt_fragmented_frames_across_varint_boundary():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _mqtt_connect(ns, edge.mqtt_port, fragment=True)
            payload = _payload(0) + b" " * 160     # a 2-byte remaining length
            pkt = ns.mqtt.encode_publish("swtpu/default/events", payload, qos=1, packet_id=3)
            assert len(pkt) > 129
            for i in range(len(pkt)):
                w.write(pkt[i:i + 1])
                await w.drain()
                await asyncio.sleep(0.0005)
            ack = await _read(ns, r)
            w.close()
            return [ack]

        return _edge_run(ns, eng, _edge_cfg(ns), client)

    eng, (acks, snap) = _twin(scenario)["port"]
    assert acks == [(tmqtt.PUBACK, 3)]
    assert eng.json_batches == [([_payload(0) + b" " * 160], "default")]
    assert snap["frames_admitted"] == snap["rows_submitted"] == 1


def test_mqtt_qos1_duplicate_redelivery_no_double_ingest():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _mqtt_connect(ns, edge.mqtt_port)
            acks = []
            for pid in (7, 8):          # the second offer is a DUP redelivery
                w.write(ns.mqtt.encode_publish("swtpu/default/events",
                                               _alt_payload("alt-42"), qos=1, packet_id=pid))
                await w.drain()
                acks.append(await _read(ns, r))
            w.close()
            return acks

        return _edge_run(ns, eng, _edge_cfg(ns), client)

    eng, (acks, snap) = _twin(scenario)["port"]
    assert acks == [(tmqtt.PUBACK, 7), (tmqtt.PUBACK, 8)]
    assert eng.json_batches == [([_alt_payload("alt-42")], "default")]
    assert (snap["frames_received"], snap["frames_admitted"], snap["frames_duplicate"]) == (2, 1, 1)


def test_mqtt_qos2_park_release_single_ingest():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _mqtt_connect(ns, edge.mqtt_port)
            pub = ns.mqtt.encode_publish("swtpu/default/events", _payload(1), qos=2,
                                         packet_id=9)
            acks = []
            for _ in range(2):           # a redelivered PUBLISH replaces the parked copy
                w.write(pub)
                await w.drain()
                acks.append(await _read(ns, r))
            w.write(ns.mqtt.encode_packet(ns.mqtt.PUBREL, 2, (9).to_bytes(2, "big")))
            await w.drain()
            acks.append(await _read(ns, r))
            w.close()
            return acks

        return _edge_run(ns, eng, _edge_cfg(ns), client)

    eng, (acks, _) = _twin(scenario)["port"]
    assert acks == [(tmqtt.PUBREC, 9), (tmqtt.PUBREC, 9), (tmqtt.PUBCOMP, 9)]
    assert eng.json_batches == [([_payload(1)], "default")]


def test_mqtt_oversized_frame_rejected_before_body():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _mqtt_connect(ns, edge.mqtt_port)
            w.write(ns.mqtt.encode_publish("swtpu/default/events", b"z" * 256, qos=1,
                                           packet_id=1))
            await w.drain()
            return await asyncio.wait_for(r.read(16), WAIT_S)

        return _edge_run(ns, eng, _edge_cfg(ns, max_frame_bytes=64), client)

    eng, (tail, snap) = _twin(scenario)["port"]
    assert tail == b"" and snap["frames_invalid"] == snap["frames_received"] == 1
    assert eng.json_batches == []


def test_mqtt_keepalive_timeout_disconnects():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _mqtt_connect(ns, edge.mqtt_port, keepalive=1)
            w.write(ns.mqtt.encode_packet(ns.mqtt.PINGREQ, 0, b""))
            await w.drain()
            pong = await _read(ns, r)
            return pong, await asyncio.wait_for(r.read(16), WAIT_S)

        return _edge_run(ns, eng, _edge_cfg(ns, keepalive_grace=0.3), client)

    _, ((pong, tail), snap) = _twin(scenario)["port"]
    assert pong == (tmqtt.PINGRESP, None) and tail == b""
    assert snap["keepalive_timeouts"] == 1 and snap["connections_live"] == 0


def test_mqtt_shed_withholds_puback_and_disconnects():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _mqtt_connect(ns, edge.mqtt_port)
            w.write(ns.mqtt.encode_publish("swtpu/default/events", _payload(0), qos=1,
                                           packet_id=5))
            await w.drain()
            return await asyncio.wait_for(r.read(16), WAIT_S)

        return _edge_run(ns, eng, _edge_cfg(ns), client)

    eng, (tail, snap) = _twin(scenario, qos=DenyAll)["port"]
    assert tail == b""
    assert (snap["frames_shed"], snap["frames_admitted"], snap["backpressure_events"]) == (1, 0, 1)
    assert eng.json_batches == []


def test_mqtt_qos2_shed_release_withholds_pubcomp_until_ingest():
    """A PUBREL whose released frame is shed re-parks it: no PUBCOMP until
    a release stages, then a true duplicate PUBREL re-completes."""
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _mqtt_connect(ns, edge.mqtt_port)
            w.write(ns.mqtt.encode_publish("swtpu/default/events", _payload(2), qos=2,
                                           packet_id=11))
            await w.drain()
            acks = [await _read(ns, r)]
            rel = ns.mqtt.encode_packet(ns.mqtt.PUBREL, 2, (11).to_bytes(2, "big"))
            for _ in range(2):
                w.write(rel)
                await w.drain()
                with pytest.raises(asyncio.TimeoutError):
                    await _read(ns, r, timeout=0.3)
            eng.qos = None              # pressure clears
            for _ in range(2):
                w.write(rel)
                await w.drain()
                acks.append(await _read(ns, r))
            w.close()
            return acks

        return _edge_run(ns, eng, _edge_cfg(ns), client)

    eng, (acks, snap) = _twin(scenario, qos=DenyAll)["port"]
    assert acks == [(tmqtt.PUBREC, 11), (tmqtt.PUBCOMP, 11), (tmqtt.PUBCOMP, 11)]
    assert eng.json_batches == [([_payload(2)], "default")]
    assert snap["frames_shed"] == 2 and snap["frames_admitted"] == 1


def test_dedup_key_scoped_by_tenant_and_device():
    def pay(dev, alt):
        return json.dumps({"deviceToken": dev, "type": "DeviceMeasurement",
                           "request": {"name": "temp", "value": 1.0, "eventDate": 1_000,
                                       "alternateId": alt}}).encode()

    offers = [("swtpu/t1/events", pay("wd-0", "seq-1")),
              ("swtpu/t2/events", pay("wd-5", "seq-1")),
              ("swtpu/t1/events", pay("wd-1", "seq-1")),
              ("swtpu/t1/events", pay("wd-0", "seq-1"))]     # the true duplicate

    def scenario(ns, eng):
        async def client(edge):
            r, w = await _mqtt_connect(ns, edge.mqtt_port)
            acks = []
            for pid, (topic, payload) in enumerate(offers, start=1):
                w.write(ns.mqtt.encode_publish(topic, payload, qos=1, packet_id=pid))
                await w.drain()
                acks.append(await _read(ns, r))
            w.close()
            return acks

        return _edge_run(ns, eng, _edge_cfg(ns), client)

    eng, (acks, snap) = _twin(scenario)["port"]
    assert acks == [(tmqtt.PUBACK, pid) for pid in (1, 2, 3, 4)]
    assert (snap["frames_admitted"], snap["frames_duplicate"]) == (3, 1)
    assert [t for _, t in eng.json_batches] == ["t1", "t2", "t1"]


def test_wire_snapshot_disposition_balance():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _mqtt_connect(ns, edge.mqtt_port)
            dup = _alt_payload("bal-1")
            w.write(ns.mqtt.encode_publish("swtpu/default/events", dup, qos=1, packet_id=1))
            await w.drain()
            acks = [await _read(ns, r)]       # PUBACK: the frame staged
            w.write(ns.mqtt.encode_publish("swtpu/default/events", dup, qos=1, packet_id=2))
            w.write(ns.mqtt.encode_publish("swtpu/default/events", _payload(3), qos=1,
                                           packet_id=3))
            await w.drain()
            acks += sorted([await _read(ns, r), await _read(ns, r)])
            w.write(ns.mqtt.encode_packet(ns.mqtt.DISCONNECT, 0, b""))
            await w.drain()
            w.close()
            return acks

        return _edge_run(ns, eng, _edge_cfg(ns, max_frame_bytes=4096), client)

    _, (acks, snap) = _twin(scenario)["port"]
    assert acks == [(tmqtt.PUBACK, 1), (tmqtt.PUBACK, 2), (tmqtt.PUBACK, 3)]
    assert snap["frames_received"] == (snap["frames_admitted"] + snap["frames_shed"]
                                       + snap["frames_invalid"] + snap["frames_duplicate"])
    assert snap["frames_admitted"] == (snap["rows_submitted"] + snap["frames_stalled"]
                                       + snap["pending"])
    assert snap["frames_duplicate"] == 1


# --- the SWP server ------------------------------------------------------------------

async def _swp_connect(ns, port, tenant=b"default", fmt=b"json"):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(ns.we.SWP_MAGIC + b" " + tenant + b" " + fmt + b"\n")
    await w.drain()
    return r, w


async def _swp_rec(r, timeout=WAIT_S):
    return struct.unpack("!BI", await asyncio.wait_for(r.readexactly(5), timeout))


def _swp_cfg(ns, **kw):
    return ns.we.WireEdgeConfig(**{"mqtt_port": None, "tcp_port": 0, **kw})


def test_swp_cumulative_durable_acks():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _swp_connect(ns, edge.tcp_port)
            for i in range(3):
                p = _payload(i)
                w.write(struct.pack("!I", len(p)) + p)
            w.write(struct.pack("!I", 0))      # flush hint
            await w.drain()
            recs = []
            while not recs or recs[-1][1] < 3:
                recs.append(await _swp_rec(r))
            w.close()
            return recs[-1]

        return _edge_run(ns, eng, _swp_cfg(ns, flush_rows=64, flush_interval_s=5.0), client)

    eng, (last, _) = _twin(scenario)["port"]
    assert last == (twe.SWP_ACK, 3)
    # one arrival window -> ONE engine call for all three frames
    assert eng.json_batches == [([_payload(0), _payload(1), _payload(2)], "default")]


def test_swp_bad_handshake_and_oversize():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await asyncio.open_connection("127.0.0.1", edge.tcp_port)
            w.write(b"NOTSWP default json\n")
            await w.drain()
            recs = [await _swp_rec(r)]
            w.close()
            r, w = await _swp_connect(ns, edge.tcp_port)
            w.write(struct.pack("!I", 4096))   # an oversized length prefix
            await w.drain()
            recs.append(await _swp_rec(r))
            w.close()
            return recs

        return _edge_run(ns, eng, _swp_cfg(ns, max_frame_bytes=64), client)

    eng, (recs, snap) = _twin(scenario)["port"]
    assert recs == [(twe.SWP_ERR, 64)] * 2 and snap["frames_invalid"] == 2
    assert eng.json_batches == []


def test_swp_shed_code_carries_retry_after():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _swp_connect(ns, edge.tcp_port)
            p = _payload(0)
            w.write(struct.pack("!I", len(p)) + p)
            await w.drain()
            rec = await _swp_rec(r)
            w.close()
            return rec

        return _edge_run(ns, eng, _swp_cfg(ns), client)

    eng, (rec, _) = _twin(scenario, qos=DenyAll)["port"]
    assert rec == (twe.SWP_SHED, 250) and eng.json_batches == []


def test_shed_frame_leaves_no_dedup_entry_redelivery_reingested():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _swp_connect(ns, edge.tcp_port)
            p = _alt_payload("shed-1")
            w.write(struct.pack("!I", len(p)) + p)
            await w.drain()
            recs = [await _swp_rec(r)]
            eng.qos = None              # pressure clears; the client resends
            w.write(struct.pack("!I", len(p)) + p)
            await w.drain()
            recs.append(await _swp_rec(r))
            w.close()
            return recs

        return _edge_run(ns, eng, _swp_cfg(ns, flush_rows=1, flush_interval_s=0.01), client)

    eng, (recs, snap) = _twin(scenario, qos=DenyAll)["port"]
    assert recs == [(twe.SWP_SHED, 250), (twe.SWP_ACK, 1)]
    assert eng.json_batches == [([_alt_payload("shed-1")], "default")]
    assert (snap["frames_shed"], snap["frames_admitted"], snap["frames_duplicate"]) == (1, 1, 0)


def test_stalled_frame_leaves_no_dedup_entry_redelivery_reingested():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _swp_connect(ns, edge.tcp_port)
            p = _alt_payload("stall-1")
            recs = []
            for _ in range(2):
                w.write(struct.pack("!I", len(p)) + p)
                await w.drain()
                recs.append(await _swp_rec(r))
            w.close()
            return recs

        return _edge_run(ns, eng, _swp_cfg(ns, flush_rows=1, flush_interval_s=0.01), client)

    eng, (recs, snap) = _twin(scenario, stalls=1)["port"]
    assert recs == [(twe.SWP_SHED, 50), (twe.SWP_ACK, 1)]
    assert eng.json_batches == [([_alt_payload("stall-1")], "default")]
    assert (snap["frames_stalled"], snap["frames_duplicate"], snap["frames_admitted"]) == (1, 0, 2)


# --- byte identity against the direct batch-ingest path ----------------------------

@pytest.mark.parametrize("kind,scan_chunk", [("engine", None), ("spmd", 1), ("spmd", 2)])
def test_wire_batched_path_byte_identical(kind, scan_chunk):
    """Frames through the batcher equal direct ``ingest_json_batch`` with
    the same splits (store, metrics, conservation) in each package, and
    the port's edge-fed engine equals the JAX one."""
    payloads = [_payload(i) for i in range(48)]
    fed = {}
    for side, ns in SIDES.items():
        a, b = _engine(side, kind, scan_chunk), _engine(side, kind, scan_chunk)
        batcher = ns.we.WireBatcher(a, flush_rows=16, auto=False)
        for lo in range(0, len(payloads), 16):
            for p in payloads[lo:lo + 16]:
                batcher.add(p)
            batcher.flush()
            b.ingest_json_batch(payloads[lo:lo + 16])
        batcher.close()
        _settle(a)
        _settle(b)
        assert a.metrics() == b.metrics()
        for e in (a, b):
            assert ns.cons.check_conservation(ns.cons.build_ledger(e)) == []
        fed[side] = (a, b)
    _same_engines(fed["jax"][0], fed["port"][0], spmd=kind != "engine")
    if kind == "engine":
        assert_tree_equal(fed["port"][0].state, fed["port"][1].state)
    else:
        assert_state_equal(fed["port"][1], fed["port"][0])


def test_swp_socket_byte_identical_and_conservation():
    """Live SWP frames in groups of 16 (a flush hint and an ack barrier
    each) against the direct calls, in both packages; the ledger's "wire"
    stage is present and balances while the edge is attached, a phantom
    frame is a wire-frames violation and one more admitted frame a
    wire-rows one; ``metrics()`` holds no wire key."""
    payloads = [_payload(i) for i in range(32)]

    def scenario(ns, eng):
        oracle = _engine(ns.name)
        out = {}

        async def run():
            edge = ns.we.WireEdge(eng, _swp_cfg(ns, flush_rows=16, flush_interval_s=5.0))
            await edge.start()
            r, w = await _swp_connect(ns, edge.tcp_port)
            acked = 0
            for lo in range(0, len(payloads), 16):
                for p in payloads[lo:lo + 16]:
                    w.write(struct.pack("!I", len(p)) + p)
                w.write(struct.pack("!I", 0))
                await w.drain()
                while acked < lo + 16:
                    code, acked = await _swp_rec(r)
                    assert code == ns.we.SWP_ACK
                oracle.ingest_json_batch(payloads[lo:lo + 16])
            w.close()
            r2, w2 = await asyncio.open_connection("127.0.0.1", edge.tcp_port)
            w2.write(b"NOTSWP default json\n")
            await w2.drain()
            out["err"] = await _swp_rec(r2)
            w2.close()
            out["snap"] = await _quiet(edge)
            _settle(eng)
            ledger = ns.cons.build_ledger(eng.engine)
            out["stage"] = ledger["stages"].get("wire")
            out["clean"] = ns.cons.check_conservation(ledger)
            edge.frames_received += 1
            out["phantom"] = [v.equation for v in ns.cons.check_conservation(
                ns.cons.build_ledger(eng.engine))]
            edge.frames_received -= 1
            edge.frames_admitted += 1
            edge.frames_received += 1
            out["extra"] = [v.equation for v in ns.cons.check_conservation(
                ns.cons.build_ledger(eng.engine))]
            edge.frames_admitted -= 1
            edge.frames_received -= 1
            await edge.stop()
            out["after"] = "wire" in ns.cons.build_ledger(eng.engine)["stages"]

        asyncio.run(run())
        _settle(oracle)
        _settle(eng)
        assert eng.metrics() == oracle.metrics()
        assert not any("wire" in k for k in eng.metrics())
        if ns.name == "port":
            assert_tree_equal(oracle.state, eng.engine.state)
        else:
            assert_tree_equal(jax.device_get(oracle.state), jax.device_get(eng.engine.state))
        return out

    out = _twin(scenario)["port"][1]
    assert out["err"] == (twe.SWP_ERR, 1 << 20)
    assert out["snap"]["frames_invalid"] == 1 and out["snap"]["rows_submitted"] == 32
    assert out["stage"]["frames_received"] == 33 and out["clean"] == []
    assert out["phantom"] == ["wire-frames"] and out["extra"] == ["wire-rows"]
    assert out["after"] is False


# --- the observability plane ------------------------------------------------------

def test_wire_scrape_series_only_with_edge_attached():
    def scenario(ns, eng):
        async def client(edge):
            r, w = await _swp_connect(ns, edge.tcp_port)
            for i in range(2):
                p = _payload(i)
                w.write(struct.pack("!I", len(p)) + p)
            w.write(struct.pack("!I", 0))
            await w.drain()
            acked = 0
            while acked < 2:
                _, acked = await _swp_rec(r)
            reg = ns.metrics.MetricsRegistry()
            ns.metrics.export_wire_metrics(eng, reg)
            text = reg.expose_text()
            w.close()
            return sorted(line for line in text.splitlines() if "swtpu_wire" in line
                          and not line.startswith("#"))

        lines, _ = _edge_run(ns, eng, _swp_cfg(ns, flush_rows=64, flush_interval_s=5.0),
                             client)
        reg = ns.metrics.MetricsRegistry()
        ns.metrics.export_wire_metrics(eng, reg)     # the edge stopped: nothing
        return lines, "swtpu_wire" in reg.expose_text(), ns.we.aggregate_wire_snapshot(eng)

    lines, after, agg = _twin(scenario)["port"][1]
    assert 'swtpu_wire_frames_total{disposition="admitted"} 2' in lines
    assert "swtpu_wire_connections_live 1" in lines
    assert "swtpu_wire_rows_submitted_total 2" in lines
    assert after is False and agg is None


def test_aggregate_multi_edge_peak_and_occupancy():
    totals = {}
    for side, ns in SIDES.items():
        eng = types.SimpleNamespace(wire_edges=[])
        cfg = ns.we.WireEdgeConfig(mqtt_port=None, tcp_port=None, flush_rows=100)
        e1, e2 = ns.we.WireEdge(eng, cfg), ns.we.WireEdge(eng, cfg)
        eng.wire_edges = [e1, e2]
        for edge, peak, flushes, rows in ((e1, 5, 10, 800), (e2, 3, 7, 630)):
            edge.connections_peak = peak
            edge.frames_received = edge.frames_admitted = rows
            b = edge.batchers[0]
            b.flushes_drain = flushes
            b.flush_rows_sum = b.rows_submitted = rows
        totals[side] = ns.we.aggregate_wire_snapshot(eng)
        for e in (e1, e2):
            e.batchers[0].close()
    assert totals["port"] == totals["jax"]
    assert totals["port"]["connections_peak"] == 5
    assert totals["port"]["flush_occupancy_pct"] == 84.1
    assert totals["port"]["frames_received"] == 1430


# --- the websocket listener -------------------------------------------------------

def test_websocket_listener_matches_jax():
    """The port's ws listener against the JAX one on the same frames: the
    SWP contract over websocket messages (text handshake, binary and text
    frames, acks as binary messages; a size flush at the third frame)."""
    websockets = pytest.importorskip("websockets")

    def scenario(ns, eng):
        async def client(edge):
            recs = []
            async with websockets.connect(f"ws://127.0.0.1:{edge.ws_port}") as ws:
                await ws.send("SWTP1 default json")
                await ws.send(_payload(0))
                await ws.send(_payload(1).decode())
                await ws.send(_payload(2))
                while not recs or recs[-1][1] < 3:
                    msg = await asyncio.wait_for(ws.recv(), WAIT_S)
                    recs.append(struct.unpack("!BI", msg))
            async with websockets.connect(f"ws://127.0.0.1:{edge.ws_port}") as ws:
                await ws.send("SWTP1 default xml")
                recs.append(struct.unpack("!BI", await asyncio.wait_for(ws.recv(), WAIT_S)))
            return recs

        return _edge_run(ns, eng, ns.we.WireEdgeConfig(
            mqtt_port=None, ws_port=0, flush_rows=3, flush_interval_s=30.0), client)

    eng, (recs, snap) = _twin(scenario)["port"]
    assert recs[-2:] == [(twe.SWP_ACK, 3), (twe.SWP_ERR, 1 << 20)]
    assert eng.json_batches == [([_payload(0), _payload(1), _payload(2)], "default")]
    assert snap["frames_invalid"] == 1 and snap["rows_submitted"] == 3


def test_websocket_listener_off_without_the_library(monkeypatch, caplog):
    """Where ``websockets`` cannot be imported (the GPU machine), both
    edges log a warning and serve MQTT without the ws listener."""
    monkeypatch.setitem(sys.modules, "websockets", None)

    def scenario(ns, eng):
        async def client(edge):
            r, w = await _mqtt_connect(ns, edge.mqtt_port)
            w.write(ns.mqtt.encode_publish("swtpu/default/events", _payload(4), qos=1,
                                           packet_id=2))
            await w.drain()
            ack = await _read(ns, r)
            w.close()
            with pytest.raises(AssertionError):
                edge.ws_port
            return ack

        with caplog.at_level(logging.WARNING, logger=ns.we.__name__):
            caplog.clear()
            out = _edge_run(ns, eng, _edge_cfg(ns, ws_port=0), client)
            warned = [r.getMessage() for r in caplog.records if r.name == ns.we.__name__]
        return out, warned

    eng, ((ack, _), warned) = _twin(scenario)["port"]
    assert ack == (tmqtt.PUBACK, 2) and len(eng.json_batches) == 1
    assert warned == ["websocket listener disabled: websockets library unavailable"]


# --- no fallback hides the card ---------------------------------------------------

def test_edge_on_an_engine_whose_native_build_fails_raises(monkeypatch):
    """The engine under an edge raises when its native build fails (there
    is no CPU fallback), so no edge is ever built on it; an edge's batcher
    that meets an engine error counts its frames stalled and acks none."""
    from sitewhere_tpu_torch.native import binding

    def broken(*a, **kw):
        raise OSError("no native library")

    monkeypatch.setattr(binding, "NativeInterner", broken)
    with pytest.raises(OSError):
        Engine(EngineConfig(**W_CFG), device="cpu")
    monkeypatch.undo()

    class Failing:
        wal = None
        device = torch.device("cpu")

        def ingest_json_batch(self, payloads, tenant="default"):
            raise RuntimeError("CUDA error: an illegal memory access")

    b = twe.WireBatcher(Failing(), auto=False)
    acks = []
    b.add(_payload(0), on_durable=lambda: acks.append(1))
    assert b.flush() == 0 and acks == [] and b.counters()["frames_stalled"] == 1
    b.close()
