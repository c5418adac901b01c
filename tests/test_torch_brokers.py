"""The broker receivers and their codecs (``ingest/mqtt.py``'s client, broker
and receiver, ``ingest/coap.py``, ``ingest/amqp.py``, ``ingest/stomp.py``,
``ingest/eventhub.py``), held to the JAX package's modules.

Codecs: each protocol's encoders give the JAX package's bytes and its
decoders its values over seeded messages. Receivers: each case is a twin of
a JAX case (``tests/test_ingest.py``'s MQTT and CoAP cases,
``tests/test_amqp.py``, ``tests/test_stomp.py``, ``tests/test_eventhub.py``;
the two connector cases wait for the outbound connectors): the same
traffic through the JAX receiver into a JAX ``Engine`` and through the
port's into a port ``Engine(device="cpu")``, both clocks pinned, compared on
the engine state byte for byte, ``metrics()``, the source counts and what
each client received. A publisher waits until its message is counted
before it sends the next, so competing consumers never reorder the
engine's rows.
"""

import asyncio
import json
import types

import jax
import numpy as np
import pytest

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.ingest import amqp as jamqp
from sitewhere_tpu.ingest import coap as jcoap
from sitewhere_tpu.ingest import decoders as jdec
from sitewhere_tpu.ingest import eventhub as jhub
from sitewhere_tpu.ingest import mqtt as jmqtt
from sitewhere_tpu.ingest import sources as jsrc
from sitewhere_tpu.ingest import stomp as jstomp
from sitewhere_tpu.ingest import wire_edge as jwe
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest import amqp as tamqp
from sitewhere_tpu_torch.ingest import coap as tcoap
from sitewhere_tpu_torch.ingest import decoders as tdec
from sitewhere_tpu_torch.ingest import eventhub as thub
from sitewhere_tpu_torch.ingest import mqtt as tmqtt
from sitewhere_tpu_torch.ingest import sources as tsrc
from sitewhere_tpu_torch.ingest import stomp as tstomp
from sitewhere_tpu_torch.ingest import wire_edge as twe
from tests.torch_parity import assert_tree_equal

BASE_S = 1_700_000_000.0
MINI = dict(device_capacity=64, token_capacity=128, assignment_capacity=128,
            store_capacity=4096, batch_capacity=16, channels=4)
SIDES = {
    "jax": types.SimpleNamespace(name="jax", mqtt=jmqtt, coap=jcoap, amqp=jamqp,
                                 stomp=jstomp, hub=jhub, src=jsrc, dec=jdec, we=jwe),
    "port": types.SimpleNamespace(name="port", mqtt=tmqtt, coap=tcoap, amqp=tamqp,
                                  stomp=tstomp, hub=thub, src=tsrc, dec=tdec, we=twe),
}
WAIT_S = 10


def measurement_json(token="dev-1", name="fuel.level", value=123.4, **kw):
    return json.dumps({"deviceToken": token, "type": "DeviceMeasurement",
                       "request": {"name": name, "value": value, **kw}}).encode()


def _pin(epoch_cls, now_ms=5000):
    class Pinned(epoch_cls):
        def now_ms(self):
            return now_ms

    return Pinned(BASE_S)


def _engine(side: str):
    if side == "jax":
        eng = JaxEngine(JaxEngineConfig(**MINI))
        eng.epoch = _pin(JaxEpoch)
    else:
        eng = Engine(EngineConfig(**MINI), device="cpu")
        eng.epoch = _pin(EpochBase)
    return eng


def _wired(ns):
    """A mini engine of the side wired as tests/test_ingest.py's ``_wire``."""
    eng = _engine(ns.name)
    return eng, ns.src.EventSourcesManager(on_event_request=eng.process,
                                           on_registration_request=eng.process)


async def until(pred, what: str = "condition") -> None:
    async def wait():
        while not pred():
            await asyncio.sleep(0.005)

    try:
        await asyncio.wait_for(wait(), WAIT_S)
    except asyncio.TimeoutError:
        raise AssertionError(f"timed out waiting for {what}") from None


def _counted(src) -> int:
    return src.decoded_count + src.failed_count + src.duplicate_count + src.batched_count


def _twin(scenario):
    """``scenario(ns)`` returns (engine or None, observations) for each side;
    the port's observations must equal the JAX one's and its engine the JAX
    engine (state byte for byte, ``metrics()``). Returns the port's pair."""
    out = {side: scenario(ns) for side, ns in SIDES.items()}
    (je, jobs), (te, tobs) = out["jax"], out["port"]
    assert tobs == jobs
    if te is not None:
        je.flush()
        te.flush()
        assert te.metrics() == je.metrics()
        assert_tree_equal(jax.device_get(je.state), te.state)
    return out["port"]


# --- codecs ------------------------------------------------------------------------

def test_coap_codec_bytes_match_jax():
    rng = np.random.default_rng(3)
    for i in range(80):
        path = ["x" * int(n) for n in rng.integers(0, 40, int(rng.integers(0, 4)))]
        token = rng.bytes(int(rng.integers(0, 9)))
        payload = rng.bytes(int(rng.choice([0, 1, 50, 300])))
        args = (int(rng.integers(4)), int(rng.choice([1, 2, 3, 4, 0x41, 0x84])),
                int(rng.integers(65536)), token, path, payload)
        data = tcoap.encode_message(*args)
        assert data == jcoap.encode_message(*args)
        assert tcoap.decode_message(data) == jcoap.decode_message(data)
        assert tcoap.decode_message(data)["uri_path"] == path
    for bad in (b"", b"\x00\x01\x02\x03", b"\x80" * 4):
        with pytest.raises(ValueError, match="not a CoAP v1 message"):
            tcoap.decode_message(bad)
        with pytest.raises(ValueError):
            jcoap.decode_message(bad)


def test_amqp_arg_codec_and_frames_match_jax():
    """``tests/test_amqp.py::test_arg_codec_roundtrip`` and seeded argument
    lists, methods and content frames, byte for byte."""
    def write(mod, ops):
        w = mod.ArgWriter()
        for op, v in ops:
            getattr(w, op)(v)
        return w.done()

    fixed = [("short", 0), ("shortstr", "queue-name"), ("bit", False), ("bit", True),
             ("bit", False), ("longstr", b"payload"), ("long", 42), ("longlong", 1 << 40),
             ("table", {"k": "v"})]
    data = write(tamqp, fixed)
    assert data == write(jamqp, fixed)
    r = tamqp.ArgReader(data)
    assert (r.short(), r.shortstr(), r.bits(3), r.longstr(), r.long(), r.longlong(),
            r.table()) == (0, "queue-name", [False, True, False], b"payload", 42, 1 << 40,
                           {"k": "v"})
    rng = np.random.default_rng(4)
    kinds = ("octet", "short", "long", "longlong", "shortstr", "longstr", "table", "bit")
    for _ in range(60):
        ops = []
        for k in rng.choice(kinds, int(rng.integers(1, 12))):
            v = {"octet": lambda: int(rng.integers(256)),
                 "short": lambda: int(rng.integers(1 << 16)),
                 "long": lambda: int(rng.integers(1 << 32)),
                 "longlong": lambda: int(rng.integers(1 << 62)),
                 "shortstr": lambda: "s" * int(rng.integers(0, 200)),
                 "longstr": lambda: rng.bytes(int(rng.integers(0, 500))),
                 "table": lambda: {f"k{j}": f"v{j}" for j in range(int(rng.integers(0, 4)))},
                 "bit": lambda: bool(rng.integers(2))}[str(k)]()
            ops.append((str(k), v))
        data = write(tamqp, ops)
        assert data == write(jamqp, ops)
        ch, cm = int(rng.integers(1, 5)), (int(rng.integers(10, 90)), int(rng.integers(10, 60)))
        assert tamqp.encode_method(ch, cm, data) == jamqp.encode_method(ch, cm, data)
        body = rng.bytes(int(rng.choice([0, 10, 200_000])))
        assert tamqp.encode_content(ch, body) == jamqp.encode_content(ch, body)


def test_topic_key_matching():
    cases = [("a.b.c", "a.b.c"), ("a.*.c", "a.x.c"), ("a.*.c", "a.x.y.c"), ("a.#", "a"),
             ("a.#", "a.b.c.d"), ("#.c", "a.b.c"), ("#", "anything.at.all"), ("a.b", "a.b.c"),
             ("a.b.c", "a.b"), ("*.#.*", "a"), ("*.#.*", "a.b"), ("#.#", ""), ("a.*", "a.")]
    got = [tamqp.topic_key_matches(p, k) for p, k in cases]
    assert got == [jamqp.topic_key_matches(p, k) for p, k in cases]
    assert got[:9] == [True, True, False, True, True, True, True, False, False]


def test_stomp_frame_codec_and_escaping_match_jax():
    """``tests/test_stomp.py::test_frame_codec_roundtrip`` and seeded frames
    whose headers hold every escaped character, through both readers."""
    rng = np.random.default_rng(5)
    alphabet = list("ab:\\\r\nz é")
    frames = [("SEND", {"destination": "/queue/q", "weird:key": "line\nbreak"},
               b"\x00binary\x00")]
    for i in range(40):
        headers = {"".join(rng.choice(alphabet, int(rng.integers(1, 8)))) + f"-{i}-{j}":
                   "".join(rng.choice(alphabet, int(rng.integers(0, 12))))
                   for j in range(int(rng.integers(0, 4)))}
        frames.append((["SEND", "MESSAGE", "SUBSCRIBE"][i % 3], headers,
                       rng.bytes(int(rng.choice([0, 5, 100]))).replace(b"\x00", b"")
                       if i % 2 else rng.bytes(int(rng.integers(1, 64)))))
    wire = b""
    for f in frames:
        data = tstomp.encode_frame(*f)
        assert data == jstomp.encode_frame(*f)
        wire += b"\n" + data           # a heart-beat newline between frames

    async def read(mod):
        r = asyncio.StreamReader()
        r.feed_data(wire)
        r.feed_eof()
        return [await mod.read_frame(r) for _ in frames]

    got = asyncio.run(read(tstomp))
    assert got == asyncio.run(read(jstomp))
    for (cmd, headers, body), (gcmd, gheaders, gbody) in zip(frames, got):
        assert gcmd == cmd and gbody == body
        assert {k: v for k, v in gheaders.items() if k != "content-length"} == headers
    for s in ("a:b", "x\\y", "\r\n", "plain", "\\c"):
        assert tstomp._escape(s) == jstomp._escape(s)
        assert tstomp._unescape(tstomp._escape(s)) == s
        assert tstomp._unescape(s) == jstomp._unescape(s)


# --- MQTT: broker, client and receiver ------------------------------------------

def test_mqtt_broker_and_receiver():
    """``tests/test_ingest.py::test_mqtt_broker_and_receiver``."""
    def scenario(ns):
        async def run():
            broker = ns.mqtt.MqttBroker()
            await broker.start()
            eng, mgr = _wired(ns)
            recv = ns.mqtt.MqttEventReceiver("127.0.0.1", broker.bound_port,
                                             topic="sitewhere/input/#")
            src = mgr.add_source(ns.src.InboundEventSource(
                "mqtt", ns.dec.JsonDeviceRequestDecoder(), [recv]))
            await mgr.initialize()
            await mgr.start()
            try:
                pub = ns.mqtt.MqttClient("127.0.0.1", broker.bound_port, "publisher")
                await pub.connect()
                await pub.publish("sitewhere/input/mq-1", measurement_json("mq-1"), qos=0)
                await pub.publish("sitewhere/input/mq-2", measurement_json("mq-2"), qos=1)
                await pub.publish("other/topic", measurement_json("mq-3"))  # not subscribed
                await pub.publish("sitewhere/input/mq-4", measurement_json("mq-4"), qos=2)
                await until(lambda: _counted(src) == 3, "3 mqtt payloads")
                await pub.disconnect()
            finally:
                await mgr.stop()
                await broker.stop()
            return eng, (src.decoded_count, recv.reconnects)

        return asyncio.run(run())

    eng, obs = _twin(scenario)
    assert obs == (3, 0) and eng.metrics()["registered"] == 3   # mq-3 filtered by topic


def test_mqtt_qos2_exactly_once():
    """``tests/test_ingest.py::test_mqtt_qos2_exactly_once``: the broker's
    4-way handshake delivers once despite a redelivered PUBLISH."""
    def scenario(ns):
        m = ns.mqtt

        async def run():
            broker = m.MqttBroker()
            await broker.start()
            got = []
            sub = m.MqttClient("127.0.0.1", broker.bound_port, "sub")
            sub.on_message = lambda t, p: got.append((t, p))
            await sub.connect()
            await sub.subscribe("q2/#", qos=2)
            pub = m.MqttClient("127.0.0.1", broker.bound_port, "pub")
            await pub.connect()
            await pub.publish("q2/a", b"one", qos=2)
            await until(lambda: len(got) == 1, "the first qos2 delivery")
            reader, writer = await asyncio.open_connection("127.0.0.1", broker.bound_port)
            writer.write(m.encode_connect("raw"))
            await writer.drain()
            seen = [(await asyncio.wait_for(m.read_packet(reader), WAIT_S))[0]]
            pkt = m.encode_publish("q2/b", b"two", qos=2, packet_id=7)
            for _ in range(2):                     # a redelivery, same pid
                writer.write(pkt)
                await writer.drain()
                seen.append((await asyncio.wait_for(m.read_packet(reader), WAIT_S))[0])
            writer.write(m.encode_packet(m.PUBREL, 0x02, (7).to_bytes(2, "big")))
            await writer.drain()
            seen.append((await asyncio.wait_for(m.read_packet(reader), WAIT_S))[0])
            await until(lambda: len(got) == 2, "the released qos2 delivery")
            writer.close()
            await pub.disconnect()
            await sub.disconnect()
            await broker.stop()
            return None, (got, seen)

        return asyncio.run(run())

    _, (got, seen) = _twin(scenario)
    assert got == [("q2/a", b"one"), ("q2/b", b"two")]
    assert seen == [tmqtt.CONNACK, tmqtt.PUBREC, tmqtt.PUBREC, tmqtt.PUBCOMP]


def test_mqtt_client_inbound_qos2_dedup():
    """``tests/test_ingest.py::test_mqtt_client_inbound_qos2_dedup``: the
    client side of exactly-once against a scripted server."""
    def scenario(ns):
        m = ns.mqtt

        async def run():
            seen, replies = [], []
            done = asyncio.Event()

            async def server(reader, writer):
                ptype, _, _ = await m.read_packet(reader)
                assert ptype == m.CONNECT
                writer.write(m.encode_packet(m.CONNACK, 0, b"\x00\x00"))
                ptype, _, body = await m.read_packet(reader)
                assert ptype == m.SUBSCRIBE
                writer.write(m.encode_packet(m.SUBACK, 0, body[:2] + b"\x02"))
                pkt = m.encode_publish("t/1", b"payload", qos=2, packet_id=9)
                for _ in range(2):                 # the same qos2 packet twice
                    writer.write(pkt)
                    await writer.drain()
                    replies.append((await m.read_packet(reader))[0])
                writer.write(m.encode_packet(m.PUBREL, 0x02, (9).to_bytes(2, "big")))
                await writer.drain()
                replies.append((await m.read_packet(reader))[0])
                done.set()
                writer.close()

            srv = await asyncio.start_server(server, "127.0.0.1", 0)
            cli = m.MqttClient("127.0.0.1", srv.sockets[0].getsockname()[1], "c")
            cli.on_message = lambda t, p: seen.append(p)
            await cli.connect()
            await cli.subscribe("t/#", qos=2)
            await asyncio.wait_for(done.wait(), WAIT_S)
            await cli.disconnect()
            srv.close()
            await srv.wait_closed()
            return None, (seen, replies)

        return asyncio.run(run())

    _, (seen, replies) = _twin(scenario)
    assert seen == [b"payload"] and replies == [tmqtt.PUBREC, tmqtt.PUBREC, tmqtt.PUBCOMP]


def test_mqtt_receiver_reconnects_after_broker_restart():
    """``tests/test_ingest.py::test_mqtt_receiver_reconnects_after_broker_restart``."""
    def scenario(ns):
        m = ns.mqtt

        async def run():
            broker = m.MqttBroker()
            await broker.start()
            port = broker.bound_port
            eng, mgr = _wired(ns)
            recv = m.MqttEventReceiver("127.0.0.1", port, topic="sitewhere/input/#",
                                       reconnect_initial_s=0.05)
            src = mgr.add_source(ns.src.InboundEventSource(
                "mqtt", ns.dec.JsonDeviceRequestDecoder(), [recv]))
            await mgr.initialize()
            await mgr.start()
            try:
                pub = m.MqttClient("127.0.0.1", port, "p1")
                await pub.connect()
                await pub.publish("sitewhere/input/a", measurement_json("rc-1"))
                await until(lambda: src.decoded_count == 1, "rc-1")
                await pub.disconnect()
                await broker.stop()
                broker2 = m.MqttBroker(port=port)
                for _ in range(50):
                    try:
                        await broker2.start()
                        break
                    except OSError:
                        await asyncio.sleep(0.05)
                await until(lambda: recv.reconnects == 1, "the receiver's reconnect")
                pub2 = m.MqttClient("127.0.0.1", port, "p2")
                await pub2.connect()
                await pub2.publish("sitewhere/input/b", measurement_json("rc-2"))
                await until(lambda: src.decoded_count == 2, "rc-2")
                await pub2.disconnect()
                await broker2.stop()
            finally:
                await mgr.stop()
            return eng, (src.decoded_count, recv.reconnects)

        return asyncio.run(run())

    eng, obs = _twin(scenario)
    assert obs == (2, 1) and eng.metrics()["registered"] == 2


# --- CoAP -------------------------------------------------------------------------

def test_coap_receiver_and_client():
    """``tests/test_ingest.py::test_coap_receiver_and_client``, plus a
    ping (RST), a GET (BAD_REQUEST) and a non-confirmable POST."""
    def scenario(ns):
        c = ns.coap

        async def run():
            eng, mgr = _wired(ns)
            recv = c.CoapServerEventReceiver()
            src = mgr.add_source(ns.src.InboundEventSource(
                "coap", ns.dec.JsonDeviceRequestDecoder(), [recv]))
            await mgr.initialize()
            await mgr.start()
            try:
                client = c.CoapClient("127.0.0.1", recv.bound_port)
                replies = [await client.request(c.POST, ["events", "co-1"],
                                                measurement_json("co-1")),
                           await client.request(c.PUT, ["events"], measurement_json("co-2")),
                           await client.request(c.GET, ["events"]),
                           await client.request(0, [])]
                await until(lambda: src.decoded_count == 2, "two coap payloads")
            finally:
                await mgr.stop()
            return eng, [(r["type"], r["code"], r["payload"]) for r in replies]

        return asyncio.run(run())

    eng, replies = _twin(scenario)
    assert [r[1] for r in replies] == [tcoap.CREATED, tcoap.CHANGED, tcoap.BAD_REQUEST, 0]
    assert eng.metrics()["registered"] == 2


def test_coap_batched_ack_waits_for_the_flush():
    """A CoAP source on the manager's shared ``WireBatcher``: the
    confirmable POST's ACK is withheld until its window flushes (WAL
    before ack), and the payload reaches the engine through the batch
    facade."""
    def scenario(ns):
        c = ns.coap

        async def run():
            eng = _engine(ns.name)
            batcher = ns.we.WireBatcher(eng, flush_rows=64, auto=False)
            mgr = ns.src.EventSourcesManager(on_event_request=eng.process, batcher=batcher)
            recv = c.CoapServerEventReceiver()
            src = mgr.add_source(ns.src.InboundEventSource(
                "coap", ns.dec.JsonDeviceRequestDecoder(), [recv]))
            await mgr.initialize()
            await mgr.start()
            try:
                client = c.CoapClient("127.0.0.1", recv.bound_port, timeout=WAIT_S)
                reply = asyncio.ensure_future(client.request(
                    c.POST, ["events"], measurement_json("cb-1", value=2.5)))
                await until(lambda: batcher.pending == 1, "the batched payload")
                early = reply.done()
                batcher.flush()
                got = await reply
            finally:
                await mgr.stop()
                batcher.close()
            return eng, (early, got["type"], got["code"], src.batched_count,
                         src.decoded_count)

        return asyncio.run(run())

    _, obs = _twin(scenario)
    assert obs == (False, tcoap.ACK, tcoap.CREATED, 1, 0)


# --- AMQP -------------------------------------------------------------------------

def test_broker_publish_consume_default_exchange():
    def scenario(ns):
        a = ns.amqp

        async def run():
            broker = a.AmqpBroker()
            await broker.start()
            got = []
            try:
                consumer = a.AmqpClient("127.0.0.1", broker.bound_port)
                consumer.on_message = lambda ex, key, body: got.append((ex, key, body))
                await consumer.connect()
                await consumer.declare_queue("q1")
                await consumer.consume("q1")
                producer = a.AmqpClient("127.0.0.1", broker.bound_port)
                await producer.connect()
                await producer.publish("", "q1", b"hello")
                await producer.publish("", "other-queue", b"dropped")
                await producer.publish("", "q1", b"again")
                await until(lambda: len(got) == 2, "two deliveries")
                await producer.close()
                await consumer.close()
            finally:
                await broker.stop()
            return None, got

        return asyncio.run(run())

    assert _twin(scenario)[1] == [("", "q1", b"hello"), ("", "q1", b"again")]


def test_broker_topic_exchange_and_pending_buffer():
    def scenario(ns):
        a = ns.amqp

        async def run():
            broker = a.AmqpBroker()
            await broker.start()
            got = []
            try:
                producer = a.AmqpClient("127.0.0.1", broker.bound_port)
                await producer.connect()
                await producer.declare_exchange("ex.telemetry", "topic")
                await producer.declare_queue("qt")
                await producer.bind_queue("qt", "ex.telemetry", "site.*.temp")
                await producer.publish("ex.telemetry", "site.a.temp", b"m1")
                await producer.publish("ex.telemetry", "site.a.humidity", b"nope")
                consumer = a.AmqpClient("127.0.0.1", broker.bound_port)
                consumer.on_message = lambda ex, key, body: got.append((ex, key, body))
                await consumer.connect()
                await consumer.declare_queue("qt")
                await consumer.consume("qt")
                await until(lambda: len(got) == 1, "the buffered message")
                await producer.publish("ex.telemetry", "site.b.temp", b"m2")
                await until(lambda: len(got) == 2, "the live message")
                await producer.close()
                await consumer.close()
            finally:
                await broker.stop()
            return None, got

        return asyncio.run(run())

    got = _twin(scenario)[1]
    assert [b for _, _, b in got] == [b"m1", b"m2"]


def test_rabbitmq_receiver_end_to_end():
    def scenario(ns):
        a = ns.amqp

        async def run():
            broker = a.AmqpBroker()
            await broker.start()
            eng, mgr = _wired(ns)
            recv = a.RabbitMqEventReceiver("127.0.0.1", broker.bound_port, queue="sw.input")
            src = mgr.add_source(ns.src.InboundEventSource(
                "amqp", ns.dec.JsonDeviceRequestDecoder(), [recv]))
            await mgr.initialize()
            await mgr.start()
            try:
                pub = a.AmqpClient("127.0.0.1", broker.bound_port)
                await pub.connect()
                for i, body in enumerate([measurement_json("amqp-1"), b"{bad",
                                          measurement_json("amqp-2", value=7.5)]):
                    await pub.publish("", "sw.input", body)
                    await until(lambda: _counted(src) == i + 1, f"amqp message {i}")
                await pub.close()
            finally:
                await mgr.stop()
                await broker.stop()
            return eng, (src.decoded_count, src.failed_count,
                         [(s, p) for s, p, _ in mgr.failed_decodes])

        return asyncio.run(run())

    eng, obs = _twin(scenario)
    assert obs == (2, 1, [("amqp", b"{bad")]) and eng.metrics()["registered"] == 2


def test_rabbitmq_receiver_reconnects():
    """The broker comes up after the receiver starts; the reconnect loop
    attaches once it is reachable."""
    def scenario(ns):
        a = ns.amqp

        async def run():
            probe = a.AmqpBroker()
            await probe.start()
            port = probe.bound_port
            await probe.stop()
            eng, mgr = _wired(ns)
            recv = a.RabbitMqEventReceiver("127.0.0.1", port, queue="sw.input",
                                           reconnect_interval_s=0.1)
            src = mgr.add_source(ns.src.InboundEventSource(
                "amqp", ns.dec.JsonDeviceRequestDecoder(), [recv]))
            await mgr.initialize()
            await mgr.start()
            broker = a.AmqpBroker(port=port)
            await broker.start()
            try:
                await until(lambda: _consuming(broker, "sw.input"), "the receiver's consumer")
                pub = a.AmqpClient("127.0.0.1", port)
                await pub.connect()
                await pub.publish("", "sw.input", measurement_json("rc-1"))
                await until(lambda: src.decoded_count == 1, "rc-1")
                await pub.close()
            finally:
                await mgr.stop()
                await broker.stop()
            return eng, src.decoded_count

        return asyncio.run(run())

    eng, n = _twin(scenario)
    assert n == 1 and eng.metrics()["registered"] == 1


def _consuming(broker, queue: str) -> bool:
    q = broker.queues.get(queue)
    return q is not None and bool(q.consumers)


# --- STOMP ------------------------------------------------------------------------

def test_queue_round_robin_and_topic_fanout():
    def scenario(ns):
        s = ns.stomp

        async def run():
            broker = s.StompBroker()
            await broker.start()
            got = {"a": [], "b": []}
            try:
                clients = {}
                for name in ("a", "b"):
                    c = s.StompClient("127.0.0.1", broker.bound_port)
                    c.on_message = (lambda n: lambda d, h, body: got[n].append(body))(name)
                    await c.connect()
                    await c.subscribe("/queue/work")
                    await c.subscribe("/topic/news")
                    clients[name] = c
                pub = s.StompClient("127.0.0.1", broker.bound_port)
                await pub.connect()
                for i in range(4):
                    await pub.send("/queue/work", b"q%d" % i)
                await pub.send("/topic/news", b"t0")
                await until(lambda: sum(map(len, got.values())) == 6, "six deliveries")
                for c in clients.values():
                    await c.disconnect()
                await pub.disconnect()
            finally:
                await broker.stop()
            return None, {k: sorted(v) for k, v in got.items()}

        return asyncio.run(run())

    got = _twin(scenario)[1]
    assert sorted(got["a"] + got["b"]) == [b"q0", b"q1", b"q2", b"q3", b"t0", b"t0"]
    assert len(got["a"]) == len(got["b"]) == 3 and b"t0" in got["a"] and b"t0" in got["b"]


def test_queue_buffers_until_subscriber():
    def scenario(ns):
        s = ns.stomp

        async def run():
            broker = s.StompBroker()
            await broker.start()
            got = []
            try:
                pub = s.StompClient("127.0.0.1", broker.bound_port)
                await pub.connect()
                await pub.send("/queue/later", b"early", {"x-h": "a:b"})
                sub = s.StompClient("127.0.0.1", broker.bound_port)
                sub.on_message = lambda d, h, body: got.append((d, h.get("x-h"), body))
                await sub.connect()
                await sub.subscribe("/queue/later")
                await until(lambda: len(got) == 1, "the buffered message")
                await pub.disconnect()
                await sub.disconnect()
            finally:
                await broker.stop()
            return None, got

        return asyncio.run(run())

    assert _twin(scenario)[1] == [("/queue/later", "a:b", b"early")]


def _stomp_feed(ns, eng, mgr, recv, port, bodies):
    """Sources wired, each body sent to the queue and counted before the
    next (competing consumers cannot reorder the engine's rows)."""
    async def run():
        src = mgr.add_source(ns.src.InboundEventSource(
            "amq", ns.dec.JsonDeviceRequestDecoder(), [recv]))
        await mgr.initialize()
        await mgr.start()
        try:
            pub = ns.stomp.StompClient("127.0.0.1", port() if callable(port) else port)
            await pub.connect()
            for i, body in enumerate(bodies):
                await pub.send("/queue/SITEWHERE.IN", body)
                await until(lambda: _counted(src) == i + 1, f"stomp message {i}")
            await pub.disconnect()
        finally:
            await mgr.stop()
        return eng, (src.decoded_count, src.failed_count)

    return run()


def test_activemq_broker_receiver_end_to_end():
    def scenario(ns):
        eng, mgr = _wired(ns)
        recv = ns.stomp.ActiveMqBrokerEventReceiver("swbroker", "SITEWHERE.IN",
                                                    num_consumers=2)
        return asyncio.run(_stomp_feed(ns, eng, mgr, recv, lambda: recv.bound_port,
                                       [measurement_json("amq-1"),
                                        measurement_json("amq-2", value=1.5)]))

    eng, obs = _twin(scenario)
    assert obs == (2, 0) and eng.metrics()["registered"] == 2


def test_activemq_client_receiver_against_external_broker():
    def scenario(ns):
        async def run():
            broker = ns.stomp.StompBroker(broker_name="external")
            await broker.start()
            try:
                eng, mgr = _wired(ns)
                recv = ns.stomp.ActiveMqClientEventReceiver("127.0.0.1", broker.bound_port,
                                                            "SITEWHERE.IN", num_consumers=3)
                return await _stomp_feed(ns, eng, mgr, recv, broker.bound_port,
                                         [measurement_json(f"c-{i}", value=float(i))
                                          for i in range(6)])
            finally:
                await broker.stop()

        return asyncio.run(run())

    eng, obs = _twin(scenario)
    assert obs == (6, 0)
    assert eng.metrics()["registered"] == 6 and eng.metrics()["persisted"] == 6


def test_receiver_requires_names():
    for ns in SIDES.values():
        with pytest.raises(ValueError, match="Broker name"):
            ns.stomp.ActiveMqBrokerEventReceiver("", "q")
        with pytest.raises(ValueError, match="Queue name"):
            ns.stomp.ActiveMqBrokerEventReceiver("b", "")
        with pytest.raises(ValueError, match="Queue name"):
            ns.stomp.ActiveMqClientEventReceiver("h", 1, "")


# --- EventHub ---------------------------------------------------------------------

def test_partition_key_stability_and_round_robin():
    def scenario(ns):
        hub = ns.hub.EventHub("telemetry", partition_count=4)
        sent = [hub.send(b"%d" % i, partition_key=f"dev-{i % 3}") for i in range(9)]
        keyless = [hub.send(b"x").partition_id for _ in range(8)]
        return None, ([(e.partition_id, e.sequence_number, e.offset) for e in sent], keyless)

    sent, keyless = _twin(scenario)[1]
    assert sent[0][0] == sent[3][0] == sent[6][0] and sent[0][1] < sent[3][1] < sent[6][1]
    assert set(keyless) == {0, 1, 2, 3}


def test_processor_host_batches_and_checkpoints(tmp_path):
    def scenario(ns):
        hub = ns.hub.EventHub("telemetry", partition_count=2)
        path = tmp_path / f"{ns.name}.json"
        for i in range(12):
            hub.send(b"m%d" % i, partition_key=f"k{i}")

        def run_host(store, n):
            got = []

            async def run():
                host = ns.hub.EventProcessorHost(hub, "$Default", store, checkpoint_every=5)
                host.on_events = lambda pid, batch: got.extend((pid, ev.body) for ev in batch)
                await host.register()
                await until(lambda: len(got) == n, f"{n} events")
                await host.unregister()

            asyncio.run(run())
            return got

        got = run_host(ns.hub.CheckpointStore(path), 12)
        store = ns.hub.CheckpointStore(path)
        total = sum(store.get("$Default", p, hub.epoch) for p in range(2))
        resumed = run_host(store, 12 - total)
        return None, (got, total, resumed)

    got, total, resumed = _twin(scenario)[1]
    assert sorted(b for _, b in got) == sorted(b"m%d" % i for i in range(12))
    assert 12 - 2 * 4 <= total < 12 and len(resumed) == 12 - total


def test_two_hosts_split_partitions():
    def scenario(ns):
        hub = ns.hub.EventHub("telemetry", partition_count=4)
        seen = {1: set(), 2: set()}

        async def run():
            h1 = ns.hub.EventProcessorHost(hub, "grp")
            h2 = ns.hub.EventProcessorHost(hub, "grp")
            h1.on_events = lambda pid, batch: seen[1].add(pid)
            h2.on_events = lambda pid, batch: seen[2].add(pid)
            await h1.register()
            await h2.register()
            for i in range(32):
                hub.send(b"x", partition_key=f"k{i}")
            await until(lambda: len(seen[1] | seen[2]) == 4, "all four partitions")
            await h1.unregister()
            await h2.unregister()

        asyncio.run(run())
        return None, seen

    seen = _twin(scenario)[1]
    assert seen[1] and seen[2] and not (seen[1] & seen[2])
    assert seen[1] | seen[2] == {0, 1, 2, 3}


def test_retention_trims_and_reader_ages_out():
    def scenario(ns):
        hub = ns.hub.EventHub("small", partition_count=1, retention=5)
        for i in range(12):
            hub.send(b"m%d" % i, partition_key="k")
        batch = hub.read(0, 0, 100)
        return None, (hub.end_offset(0), [(e.body, e.offset) for e in batch])

    end, batch = _twin(scenario)[1]
    assert end == 12 and batch == [(b"m%d" % i, i) for i in range(7, 12)]


def test_checkpoint_clamped_to_fresh_hub(tmp_path):
    def scenario(ns):
        path = tmp_path / f"{ns.name}.json"
        ns.hub.CheckpointStore(path).checkpoint("$Default", 0, 10, epoch="previous-run-epoch")
        hub = ns.hub.EventHub("fresh", partition_count=1)
        got = []

        async def run():
            host = ns.hub.EventProcessorHost(hub, "$Default", ns.hub.CheckpointStore(path))
            host.on_events = lambda pid, batch: got.extend(e.body for e in batch)
            await host.register()
            hub.send(b"first", partition_key="k")
            await until(lambda: got, "the first event")
            await host.unregister()

        asyncio.run(run())
        return None, got

    assert _twin(scenario)[1] == [b"first"]


def test_eventhub_receiver_end_to_end():
    def scenario(ns):
        hub = ns.hub.EventHub("ingest", partition_count=3)

        async def run():
            eng, mgr = _wired(ns)
            recv = ns.hub.EventHubEventReceiver(hub)
            src = mgr.add_source(ns.src.InboundEventSource(
                "hub", ns.dec.JsonDeviceRequestDecoder(), [recv]))
            await mgr.initialize()
            await mgr.start()
            try:
                for i in range(10):
                    hub.send(json.dumps({"deviceToken": f"hub-{i}", "type": "DeviceMeasurement",
                                         "request": {"name": "t", "value": float(i)}}).encode(),
                             partition_key=f"hub-{i}")
                await until(lambda: src.decoded_count == 10, "ten hub events")
            finally:
                await mgr.stop()
            return eng, src.decoded_count

        return asyncio.run(run())

    eng, n = _twin(scenario)
    assert n == 10
    assert eng.metrics()["registered"] == 10 and eng.metrics()["persisted"] == 10
