"""Native AMQP 0-9-1: wire codec, asyncio client, embedded broker, receiver
(port of ``sitewhere_tpu/ingest/amqp.py``; plain Python on the port's
``ingest/sources.py``).

The reference ingests from RabbitMQ by declaring a queue and consuming it
with auto-ack (sources/rabbitmq/RabbitMqInboundEventReceiver.java:120-140 —
``queueDeclare(queue, durable, false, false, null)`` then
``basicConsume(queue, true, consumer)``), with scheduled reconnect on
connection loss (lines 60-75), and publishes outbound events to a per-tenant
*topic* exchange (connectors/rabbitmq/RabbitMqOutboundConnector.java:96-97,
233 — ``exchangeDeclare(exchange, "topic")`` + ``basicPublish(exchange,
topic, json)``). No AMQP library ships in this image, so the protocol subset
needed for those two paths is implemented here: connection negotiation with
PLAIN auth, channels, exchange.declare (direct/topic/fanout), queue.declare,
queue.bind with AMQP topic wildcards (``*`` one word, ``#`` zero or more),
basic.publish / basic.consume / basic.deliver with auto-ack, and an embedded
broker used by tests and the load generator.

Legacy-compat receiver: this path submits one payload at a time through
``InboundEventSource`` (per-event decode + engine call). New high-rate
device transports should front the batched persistent-connection edge
(``ingest/wire_edge.py`` — MQTT/SWP/websocket frames into staging-arena
arrival windows); broker sources that must stay on this receiver can
inherit the sources manager's shared ``WireBatcher`` when their decoder
is batchable.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from collections import deque
from typing import Any, Callable

from sitewhere_tpu_torch.ingest.sources import InboundEventReceiver

logger = logging.getLogger(__name__)

PROTOCOL_HEADER = b"AMQP\x00\x00\x09\x01"
FRAME_METHOD, FRAME_HEADER, FRAME_BODY, FRAME_HEARTBEAT = 1, 2, 3, 8
FRAME_END = 0xCE

# (class, method) ids used by the subset
CONN_START, CONN_START_OK = (10, 10), (10, 11)
CONN_TUNE, CONN_TUNE_OK = (10, 30), (10, 31)
CONN_OPEN, CONN_OPEN_OK = (10, 40), (10, 41)
CONN_CLOSE, CONN_CLOSE_OK = (10, 50), (10, 51)
CH_OPEN, CH_OPEN_OK = (20, 10), (20, 11)
CH_CLOSE, CH_CLOSE_OK = (20, 40), (20, 41)
EX_DECLARE, EX_DECLARE_OK = (40, 10), (40, 11)
Q_DECLARE, Q_DECLARE_OK = (50, 10), (50, 11)
Q_BIND, Q_BIND_OK = (50, 20), (50, 21)
BASIC_CONSUME, BASIC_CONSUME_OK = (60, 20), (60, 21)
BASIC_PUBLISH, BASIC_DELIVER = (60, 40), (60, 60)


# --- argument codec ----------------------------------------------------------


class ArgWriter:
    """Packs AMQP method arguments (subset: octet/short/long/longlong/
    shortstr/longstr/table/bits)."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self._bits: list[bool] = []

    def _flush_bits(self) -> None:
        while self._bits:
            chunk, self._bits = self._bits[:8], self._bits[8:]
            self.buf.append(sum(1 << i for i, b in enumerate(chunk) if b))

    def octet(self, v: int) -> "ArgWriter":
        self._flush_bits()
        self.buf.append(v & 0xFF)
        return self

    def short(self, v: int) -> "ArgWriter":
        self._flush_bits()
        self.buf += v.to_bytes(2, "big")
        return self

    def long(self, v: int) -> "ArgWriter":
        self._flush_bits()
        self.buf += v.to_bytes(4, "big")
        return self

    def longlong(self, v: int) -> "ArgWriter":
        self._flush_bits()
        self.buf += v.to_bytes(8, "big")
        return self

    def shortstr(self, s: str) -> "ArgWriter":
        self._flush_bits()
        b = s.encode()
        self.buf.append(len(b))
        self.buf += b
        return self

    def longstr(self, b: bytes) -> "ArgWriter":
        self._flush_bits()
        self.buf += len(b).to_bytes(4, "big") + b
        return self

    def table(self, t: dict[str, str] | None = None) -> "ArgWriter":
        self._flush_bits()
        body = bytearray()
        for k, v in (t or {}).items():
            kb, vb = k.encode(), v.encode()
            body.append(len(kb))
            body += kb + b"S" + len(vb).to_bytes(4, "big") + vb
        self.buf += len(body).to_bytes(4, "big") + body
        return self

    def bit(self, v: bool) -> "ArgWriter":
        self._bits.append(bool(v))
        return self

    def done(self) -> bytes:
        self._flush_bits()
        return bytes(self.buf)


class ArgReader:
    def __init__(self, data: bytes):
        self.data, self.off = data, 0

    def _take(self, n: int) -> bytes:
        b = self.data[self.off: self.off + n]
        self.off += n
        return b

    def octet(self) -> int:
        return self._take(1)[0]

    def short(self) -> int:
        return int.from_bytes(self._take(2), "big")

    def long(self) -> int:
        return int.from_bytes(self._take(4), "big")

    def longlong(self) -> int:
        return int.from_bytes(self._take(8), "big")

    def shortstr(self) -> str:
        return self._take(self.octet()).decode()

    def longstr(self) -> bytes:
        return self._take(self.long())

    def table(self) -> dict[str, str]:
        end = self.long() + self.off
        out: dict[str, str] = {}
        while self.off < end:
            key = self.shortstr()
            kind = self._take(1)
            if kind == b"S":
                out[key] = self.longstr().decode()
            elif kind == b"t":
                out[key] = str(bool(self.octet()))
            else:  # unknown field kind: bail out of the table conservatively
                self.off = end
                break
        return out

    def bits(self, n: int = 1) -> list[bool]:
        v = self.octet()
        return [bool(v >> i & 1) for i in range(n)]


def encode_method(channel: int, cm: tuple[int, int], args: bytes) -> bytes:
    payload = cm[0].to_bytes(2, "big") + cm[1].to_bytes(2, "big") + args
    return (bytes([FRAME_METHOD]) + channel.to_bytes(2, "big")
            + len(payload).to_bytes(4, "big") + payload + bytes([FRAME_END]))


def encode_content(channel: int, body: bytes, class_id: int = 60) -> bytes:
    """Content header (no properties) + one body frame."""
    hdr = (class_id.to_bytes(2, "big") + b"\x00\x00"
           + len(body).to_bytes(8, "big") + b"\x00\x00")
    out = (bytes([FRAME_HEADER]) + channel.to_bytes(2, "big")
           + len(hdr).to_bytes(4, "big") + hdr + bytes([FRAME_END]))
    if body:
        out += (bytes([FRAME_BODY]) + channel.to_bytes(2, "big")
                + len(body).to_bytes(4, "big") + body + bytes([FRAME_END]))
    return out


async def read_frame(reader: asyncio.StreamReader) -> tuple[int, int, bytes]:
    head = await reader.readexactly(7)
    ftype = head[0]
    channel = int.from_bytes(head[1:3], "big")
    size = int.from_bytes(head[3:7], "big")
    payload = await reader.readexactly(size)
    (end,) = await reader.readexactly(1)
    if end != FRAME_END:
        raise ValueError("missing AMQP frame-end octet")
    return ftype, channel, payload


def topic_key_matches(pattern: str, key: str) -> bool:
    """AMQP topic-exchange match: ``.``-separated words, ``*`` = exactly one
    word, ``#`` = zero or more words."""
    pw, kw = pattern.split("."), key.split(".")

    def match(pi: int, ki: int) -> bool:
        while pi < len(pw):
            seg = pw[pi]
            if seg == "#":
                if pi == len(pw) - 1:
                    return True
                return any(match(pi + 1, j) for j in range(ki, len(kw) + 1))
            if ki >= len(kw) or (seg != "*" and seg != kw[ki]):
                return False
            pi += 1
            ki += 1
        return ki == len(kw)

    return match(0, 0)


# --- broker ------------------------------------------------------------------


class _Queue:
    def __init__(self, name: str):
        self.name = name
        self.pending: deque[bytes] = deque()
        # (writer, channel, consumer_tag) round-robin
        self.consumers: deque[tuple[asyncio.StreamWriter, int, str]] = deque()


class AmqpBroker:
    """Embedded AMQP 0-9-1 broker: direct/topic/fanout exchanges, queue
    bindings, round-robin delivery to auto-ack consumers. Stands in for the
    external RabbitMQ the reference assumes, the same way ingest/mqtt.py's
    MqttBroker stands in for an MQTT broker."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._server: asyncio.AbstractServer | None = None
        self.exchanges: dict[str, str] = {"": "direct", "amq.topic": "topic"}
        self.queues: dict[str, _Queue] = {}
        self.bindings: list[tuple[str, str, str]] = []  # (exchange, queue, key)
        self._writers: set[asyncio.StreamWriter] = set()
        self._tags = itertools.count(1)

    @property
    def bound_port(self) -> int:
        assert self._server is not None and self._server.sockets
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)

    async def stop(self) -> None:
        for w in list(self._writers):
            w.close()
        self._writers.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def _route(self, exchange: str, key: str) -> list[_Queue]:
        kind = self.exchanges.get(exchange, "direct")
        if exchange == "":
            q = self.queues.get(key)
            return [q] if q is not None else []
        out = []
        for ex, qname, pattern in self.bindings:
            if ex != exchange:
                continue
            ok = (kind == "fanout" or (kind == "direct" and pattern == key)
                  or (kind == "topic" and topic_key_matches(pattern, key)))
            if ok and qname in self.queues:
                out.append(self.queues[qname])
        return out

    async def _deliver(self, q: _Queue, body: bytes, exchange: str, key: str) -> None:
        while q.consumers:
            writer, channel, tag = q.consumers[0]
            if writer.is_closing():
                q.consumers.popleft()
                continue
            q.consumers.rotate(-1)
            args = (ArgWriter().shortstr(tag).longlong(1).bit(False)
                    .shortstr(exchange).shortstr(key).done())
            try:
                writer.write(encode_method(channel, BASIC_DELIVER, args)
                             + encode_content(channel, body))
                await writer.drain()
                return
            except ConnectionError:
                q.consumers.popleft()
        q.pending.append(body)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        # publish state machine: after basic.publish we expect header + body
        pub: dict[int, tuple[str, str, int, bytearray]] = {}
        try:
            if await reader.readexactly(8) != PROTOCOL_HEADER:
                writer.close()
                return
            writer.write(encode_method(
                0, CONN_START,
                ArgWriter().octet(0).octet(9).table()
                .longstr(b"PLAIN").longstr(b"en_US").done()))
            await writer.drain()
            while True:
                ftype, channel, payload = await read_frame(reader)
                if ftype == FRAME_HEARTBEAT:
                    continue
                if ftype == FRAME_HEADER:
                    ex, key, _, acc = pub[channel]
                    size = int.from_bytes(payload[4:12], "big")
                    pub[channel] = (ex, key, size, acc)
                    if size == 0:
                        await self._publish(channel, pub)
                    continue
                if ftype == FRAME_BODY:
                    ex, key, size, acc = pub[channel]
                    acc += payload
                    if len(acc) >= size:
                        await self._publish(channel, pub)
                    continue
                r = ArgReader(payload)
                cm = (r.short(), r.short())
                if cm == CONN_START_OK:
                    writer.write(encode_method(
                        0, CONN_TUNE,
                        ArgWriter().short(2047).long(131072).short(0).done()))
                elif cm == CONN_TUNE_OK:
                    pass
                elif cm == CONN_OPEN:
                    writer.write(encode_method(0, CONN_OPEN_OK,
                                               ArgWriter().shortstr("").done()))
                elif cm == CONN_CLOSE:
                    writer.write(encode_method(0, CONN_CLOSE_OK, b""))
                    await writer.drain()
                    break
                elif cm == CH_OPEN:
                    writer.write(encode_method(channel, CH_OPEN_OK,
                                               ArgWriter().longstr(b"").done()))
                elif cm == CH_CLOSE:
                    writer.write(encode_method(channel, CH_CLOSE_OK, b""))
                elif cm == EX_DECLARE:
                    r.short()  # reserved
                    name, kind = r.shortstr(), r.shortstr()
                    self.exchanges[name] = kind or "direct"
                    writer.write(encode_method(channel, EX_DECLARE_OK, b""))
                elif cm == Q_DECLARE:
                    r.short()
                    name = r.shortstr()
                    q = self.queues.setdefault(name, _Queue(name))
                    writer.write(encode_method(
                        channel, Q_DECLARE_OK,
                        ArgWriter().shortstr(name).long(len(q.pending))
                        .long(len(q.consumers)).done()))
                elif cm == Q_BIND:
                    r.short()
                    qname, ex, key = r.shortstr(), r.shortstr(), r.shortstr()
                    self.queues.setdefault(qname, _Queue(qname))
                    self.bindings.append((ex, qname, key))
                    writer.write(encode_method(channel, Q_BIND_OK, b""))
                elif cm == BASIC_CONSUME:
                    r.short()
                    qname = r.shortstr()
                    tag = r.shortstr() or f"ctag-{next(self._tags)}"
                    q = self.queues.setdefault(qname, _Queue(qname))
                    q.consumers.append((writer, channel, tag))
                    writer.write(encode_method(channel, BASIC_CONSUME_OK,
                                               ArgWriter().shortstr(tag).done()))
                    await writer.drain()
                    while q.pending:
                        await self._deliver(q, q.pending.popleft(), "", qname)
                elif cm == BASIC_PUBLISH:
                    r.short()
                    ex, key = r.shortstr(), r.shortstr()
                    pub[channel] = (ex, key, -1, bytearray())
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            self._writers.discard(writer)
            for q in self.queues.values():
                q.consumers = deque(c for c in q.consumers if c[0] is not writer)
            writer.close()

    async def _publish(self, channel: int, pub: dict) -> None:
        ex, key, _, acc = pub.pop(channel)
        body = bytes(acc)
        for q in self._route(ex, key):
            await self._deliver(q, body, ex, key)


# --- client ------------------------------------------------------------------


class AmqpClient:
    """Minimal asyncio AMQP 0-9-1 client: one connection, one channel,
    auto-ack consumption (the exact subset the reference's receiver and
    connector use)."""

    def __init__(self, host: str, port: int, username: str = "guest",
                 password: str = "guest", vhost: str = "/"):
        self.host, self.port = host, port
        self.username, self.password, self.vhost = username, password, vhost
        self.on_message: Callable[[str, str, bytes], Any] | None = None
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._task: asyncio.Task | None = None
        self._replies: deque[asyncio.Future] = deque()

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        self._writer.write(PROTOCOL_HEADER)
        await self._writer.drain()
        ftype, _, payload = await read_frame(self._reader)
        r = ArgReader(payload)
        assert (r.short(), r.short()) == CONN_START, "expected connection.start"
        sasl = b"\x00" + self.username.encode() + b"\x00" + self.password.encode()
        self._writer.write(encode_method(
            0, CONN_START_OK,
            ArgWriter().table().shortstr("PLAIN").longstr(sasl)
            .shortstr("en_US").done()))
        _, _, payload = await read_frame(self._reader)
        r = ArgReader(payload)
        assert (r.short(), r.short()) == CONN_TUNE, "expected connection.tune"
        self._writer.write(encode_method(
            0, CONN_TUNE_OK, ArgWriter().short(2047).long(131072).short(0).done()))
        self._writer.write(encode_method(
            0, CONN_OPEN, ArgWriter().shortstr(self.vhost).shortstr("").bit(False).done()))
        _, _, payload = await read_frame(self._reader)
        r = ArgReader(payload)
        assert (r.short(), r.short()) == CONN_OPEN_OK, "expected connection.open-ok"
        await self._rpc(CH_OPEN, ArgWriter().shortstr("").done(), start_loop=True)

    async def _rpc(self, cm: tuple[int, int], args: bytes,
                   start_loop: bool = False) -> bytes:
        fut = asyncio.get_running_loop().create_future()
        self._replies.append(fut)
        self._writer.write(encode_method(1, cm, args))
        await self._writer.drain()
        if start_loop:
            self._task = asyncio.create_task(self._read_loop())
        return await asyncio.wait_for(fut, 10)

    async def _read_loop(self) -> None:
        deliver: tuple[str, str] | None = None
        size, acc = -1, bytearray()
        try:
            while True:
                ftype, _, payload = await read_frame(self._reader)
                if ftype == FRAME_METHOD:
                    r = ArgReader(payload)
                    cm = (r.short(), r.short())
                    if cm == BASIC_DELIVER:
                        r.shortstr()   # consumer tag
                        r.longlong()   # delivery tag
                        r.bits()       # redelivered
                        deliver = (r.shortstr(), r.shortstr())
                        size, acc = -1, bytearray()
                    elif self._replies:
                        fut = self._replies.popleft()
                        if not fut.done():
                            fut.set_result(payload)
                elif ftype == FRAME_HEADER and deliver is not None:
                    size = int.from_bytes(payload[4:12], "big")
                    if size == 0:
                        await self._dispatch(deliver, b"")
                        deliver = None
                elif ftype == FRAME_BODY and deliver is not None:
                    acc += payload
                    if len(acc) >= size:
                        await self._dispatch(deliver, bytes(acc))
                        deliver = None
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            pass

    async def _dispatch(self, deliver: tuple[str, str], body: bytes) -> None:
        if self.on_message is not None:
            res = self.on_message(deliver[0], deliver[1], body)
            if asyncio.iscoroutine(res):
                await res

    async def declare_exchange(self, name: str, kind: str = "topic") -> None:
        await self._rpc(EX_DECLARE,
                        ArgWriter().short(0).shortstr(name).shortstr(kind)
                        .bit(False).bit(True).bit(False).bit(False).bit(False)
                        .table().done())

    async def declare_queue(self, name: str, durable: bool = False) -> None:
        await self._rpc(Q_DECLARE,
                        ArgWriter().short(0).shortstr(name).bit(False)
                        .bit(durable).bit(False).bit(False).bit(False)
                        .table().done())

    async def bind_queue(self, queue: str, exchange: str, routing_key: str) -> None:
        await self._rpc(Q_BIND,
                        ArgWriter().short(0).shortstr(queue).shortstr(exchange)
                        .shortstr(routing_key).bit(False).table().done())

    async def consume(self, queue: str) -> None:
        await self._rpc(BASIC_CONSUME,
                        ArgWriter().short(0).shortstr(queue).shortstr("")
                        .bit(False).bit(True).bit(False).bit(False)
                        .table().done())

    async def publish(self, exchange: str, routing_key: str, body: bytes) -> None:
        args = (ArgWriter().short(0).shortstr(exchange).shortstr(routing_key)
                .bit(False).bit(False).done())
        self._writer.write(encode_method(1, BASIC_PUBLISH, args)
                           + encode_content(1, body))
        await self._writer.drain()

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
        if self._writer is not None:
            try:
                self._writer.write(encode_method(
                    0, CONN_CLOSE,
                    ArgWriter().short(200).shortstr("bye").short(0).short(0).done()))
                await self._writer.drain()
            except ConnectionError:
                pass
            self._writer.close()
            self._writer = None


# --- receiver ----------------------------------------------------------------


class RabbitMqEventReceiver(InboundEventReceiver):
    """Declare a queue and consume it with auto-ack, reconnecting on loss
    (reference: sources/rabbitmq/RabbitMqInboundEventReceiver.java:60-140)."""

    def __init__(self, host: str, port: int, queue: str = "sitewhere.input",
                 durable: bool = False, username: str = "guest",
                 password: str = "guest", reconnect_interval_s: float = 5.0):
        super().__init__(f"rabbitmq:{queue}")
        self.host, self.port = host, port
        self.queue, self.durable = queue, durable
        self.username, self.password = username, password
        self.reconnect_interval_s = reconnect_interval_s
        self.client: AmqpClient | None = None
        self._reconnect_task: asyncio.Task | None = None

    async def _connect(self) -> None:
        self.client = AmqpClient(self.host, self.port, self.username, self.password)
        self.client.on_message = lambda ex, key, body: self.submit(
            body, {"exchange": ex, "routing_key": key})
        await self.client.connect()
        await self.client.declare_queue(self.queue, self.durable)
        await self.client.consume(self.queue)

    async def on_start(self) -> None:
        try:
            await self._connect()
        except (OSError, ConnectionError):
            logger.info("rabbitmq receiver: connect failed, scheduling reconnect")
            self._reconnect_task = asyncio.create_task(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        while True:
            await asyncio.sleep(self.reconnect_interval_s)
            try:
                await self._connect()
                return
            except (OSError, ConnectionError):
                continue

    async def on_stop(self) -> None:
        if self._reconnect_task is not None:
            self._reconnect_task.cancel()
        if self.client is not None:
            await self.client.close()
