"""Native MQTT 3.1.1: wire codec, asyncio client, embedded broker, receiver
(port of ``sitewhere_tpu/ingest/mqtt.py``; plain Python on the port's
``ingest/sources.py``).

The reference's primary ingest protocol is MQTT via the fusesource client
(sources/mqtt/MqttInboundEventReceiver.java:40-120 — subscribe thread +
processor pool, QoS 0/1/2) and it also embeds an ActiveMQ broker for
broker-style sources (sources/activemq/ActiveMqBrokerEventReceiver). No MQTT
library ships in this image, so the protocol is implemented here: a minimal,
dependency-free MQTT 3.1.1 subset (CONNECT/CONNACK, PUBLISH QoS 0/1 with
PUBACK, SUBSCRIBE/SUBACK, PING, DISCONNECT) sufficient for telemetry ingest,
command downlink publishing (commands/destinations.py), and an embedded
broker used by tests and the load generator.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable

from sitewhere_tpu_torch.ingest.sources import InboundEventReceiver

logger = logging.getLogger(__name__)

# control packet types
CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
PUBREC, PUBREL, PUBCOMP = 5, 6, 7
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = 8, 9, 10, 11
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14


def encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


async def read_varint(reader: asyncio.StreamReader) -> int:
    mult, value = 1, 0
    for _ in range(4):
        (b,) = await reader.readexactly(1)
        value += (b & 0x7F) * mult
        if not b & 0x80:
            return value
        mult *= 128
    raise ValueError("malformed remaining-length varint")


def _utf8(s: str) -> bytes:
    b = s.encode()
    return len(b).to_bytes(2, "big") + b


def encode_packet(ptype: int, flags: int, payload: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + encode_varint(len(payload)) + payload


async def read_packet(reader: asyncio.StreamReader) -> tuple[int, int, bytes]:
    (h,) = await reader.readexactly(1)
    length = await read_varint(reader)
    body = await reader.readexactly(length) if length else b""
    return h >> 4, h & 0x0F, body


class FrameTooLarge(ValueError):
    """Remaining-length exceeds the receiver's frame budget; the packet
    body was deliberately NOT consumed (callers close the connection)."""


async def read_packet_limited(reader: asyncio.StreamReader,
                              max_bytes: int) -> tuple[int, int, bytes]:
    """Server-side :func:`read_packet` with an oversized-frame guard: the
    remaining-length varint is checked BEFORE the body read, so a hostile
    or misconfigured client can never make the edge buffer an arbitrarily
    large packet (ingest/wire_edge.py counts these as ``frames_invalid``)."""
    (h,) = await reader.readexactly(1)
    length = await read_varint(reader)
    if length > max_bytes:
        raise FrameTooLarge(f"remaining length {length} > {max_bytes}")
    body = await reader.readexactly(length) if length else b""
    return h >> 4, h & 0x0F, body


def decode_connect(body: bytes) -> tuple[str, int]:
    """Parse a CONNECT variable header + payload into
    ``(client_id, keepalive_s)``; raises ``ValueError`` on malformed input
    (the wire edge counts and disconnects)."""
    nlen = int.from_bytes(body[:2], "big")
    if body[2: 2 + nlen] != b"MQTT":
        raise ValueError(f"bad protocol name {body[2: 2 + nlen]!r}")
    off = 2 + nlen + 2          # name + level byte + connect flags
    keepalive = int.from_bytes(body[off: off + 2], "big")
    off += 2
    idlen = int.from_bytes(body[off: off + 2], "big")
    client_id = body[off + 2: off + 2 + idlen].decode()
    return client_id, keepalive


def encode_connect(client_id: str, keepalive: int = 60,
                   username: str | None = None, password: str | None = None) -> bytes:
    flags = 0x02  # clean session
    tail = _utf8(client_id)
    if username is not None:
        flags |= 0x80
        tail += _utf8(username)
    if password is not None:
        flags |= 0x40
        tail += _utf8(password)
    var = _utf8("MQTT") + bytes([4, flags]) + keepalive.to_bytes(2, "big")
    return encode_packet(CONNECT, 0, var + tail)


def encode_publish(topic: str, payload: bytes, qos: int = 0, packet_id: int = 1) -> bytes:
    var = _utf8(topic)
    if qos:
        var += packet_id.to_bytes(2, "big")
    return encode_packet(PUBLISH, qos << 1, var + payload)


def decode_publish(flags: int, body: bytes) -> tuple[str, bytes, int, int]:
    qos = (flags >> 1) & 0x03
    tlen = int.from_bytes(body[:2], "big")
    topic = body[2: 2 + tlen].decode()
    off = 2 + tlen
    packet_id = 0
    if qos:
        packet_id = int.from_bytes(body[off: off + 2], "big")
        off += 2
    return topic, body[off:], qos, packet_id


def encode_subscribe(packet_id: int, topics: list[tuple[str, int]]) -> bytes:
    payload = packet_id.to_bytes(2, "big")
    for topic, qos in topics:
        payload += _utf8(topic) + bytes([qos])
    return encode_packet(SUBSCRIBE, 0x02, payload)


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT wildcard matching: ``+`` one level, ``#`` trailing multi-level."""
    pp, tp = pattern.split("/"), topic.split("/")
    for i, seg in enumerate(pp):
        if seg == "#":
            return True
        if i >= len(tp):
            return False
        if seg != "+" and seg != tp[i]:
            return False
    return len(pp) == len(tp)


class MqttClient:
    """Minimal asyncio MQTT 3.1.1 client (QoS 0/1/2).

    QoS 2 implements both halves of the exactly-once handshake
    (reference parity: MqttInboundEventReceiver.java:111-120 maps
    EXACTLY_ONCE): outbound PUBLISH -> PUBREC -> PUBREL -> PUBCOMP, and
    inbound PUBLISH(qos2) deduplicated by packet id until the sender's
    PUBREL releases it."""

    def __init__(self, host: str, port: int, client_id: str = "sitewhere-tpu",
                 username: str | None = None, password: str | None = None,
                 keepalive: int = 60):
        self.host, self.port = host, port
        self.client_id = client_id
        self.username, self.password = username, password
        self.keepalive = keepalive
        self.on_message: Callable[[str, bytes], Any] | None = None
        self.on_disconnect: Callable[[], Any] | None = None
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._packet_id = 0
        self._task: asyncio.Task | None = None
        self._acks: dict[int, asyncio.Future] = {}
        self._ping_task: asyncio.Task | None = None
        self._inbound_qos2: set[int] = set()   # pids seen, awaiting PUBREL
        self._closing = False

    def _next_id(self) -> int:
        self._packet_id = self._packet_id % 0xFFFF + 1
        return self._packet_id

    async def connect(self) -> None:
        # fresh session state (clean-session connect; also reused by the
        # receiver's reconnect path)
        self._closing = False
        self._acks.clear()
        self._inbound_qos2.clear()
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        self._writer.write(encode_connect(self.client_id, self.keepalive,
                                          self.username, self.password))
        await self._writer.drain()
        ptype, _, body = await read_packet(self._reader)
        if ptype != CONNACK or body[1] != 0:
            raise ConnectionError(f"MQTT connect refused: {body!r}")
        self._task = asyncio.create_task(self._read_loop())
        if self.keepalive:
            self._ping_task = asyncio.create_task(self._ping_loop())

    async def _ping_loop(self) -> None:
        while True:
            await asyncio.sleep(max(self.keepalive - 5, 5))
            self._writer.write(encode_packet(PINGREQ, 0, b""))
            await self._writer.drain()

    async def _read_loop(self) -> None:
        try:
            while True:
                ptype, flags, body = await read_packet(self._reader)
                if ptype == PUBLISH:
                    topic, payload, qos, pid = decode_publish(flags, body)
                    deliver = True
                    if qos == 1:
                        self._writer.write(
                            encode_packet(PUBACK, 0, pid.to_bytes(2, "big"))
                        )
                        await self._writer.drain()
                    elif qos == 2:
                        # exactly-once receive: a redelivered PUBLISH with
                        # the same pid (sender never saw our PUBREC) must
                        # not reach the application twice
                        deliver = pid not in self._inbound_qos2
                        self._inbound_qos2.add(pid)
                        self._writer.write(
                            encode_packet(PUBREC, 0, pid.to_bytes(2, "big"))
                        )
                        await self._writer.drain()
                    if deliver and self.on_message is not None:
                        res = self.on_message(topic, payload)
                        if asyncio.iscoroutine(res):
                            await res
                elif ptype == PUBREL:
                    pid = int.from_bytes(body[:2], "big")
                    self._inbound_qos2.discard(pid)
                    self._writer.write(
                        encode_packet(PUBCOMP, 0, pid.to_bytes(2, "big")))
                    await self._writer.drain()
                elif ptype in (PUBACK, PUBREC, PUBCOMP, SUBACK, UNSUBACK):
                    pid = int.from_bytes(body[:2], "big")
                    fut = self._acks.pop(pid, None)
                    if fut is not None and not fut.done():
                        fut.set_result(body)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            if not self._closing and self.on_disconnect is not None:
                res = self.on_disconnect()
                if asyncio.iscoroutine(res):
                    try:
                        await res
                    except Exception:   # reconnect failures are the
                        pass            # scheduler's problem, not ours

    async def subscribe(self, topic: str, qos: int = 0) -> None:
        pid = self._next_id()
        fut = asyncio.get_running_loop().create_future()
        self._acks[pid] = fut
        self._writer.write(encode_subscribe(pid, [(topic, qos)]))
        await self._writer.drain()
        await asyncio.wait_for(fut, 10)

    async def publish(self, topic: str, payload: bytes, qos: int = 0) -> None:
        pid = self._next_id() if qos else 0
        if qos:
            fut = asyncio.get_running_loop().create_future()
            self._acks[pid] = fut
        self._writer.write(encode_publish(topic, payload, qos, pid))
        await self._writer.drain()
        if qos == 1:
            await asyncio.wait_for(fut, 10)          # PUBACK
        elif qos == 2:
            await asyncio.wait_for(fut, 10)          # PUBREC
            fut2 = asyncio.get_running_loop().create_future()
            self._acks[pid] = fut2
            self._writer.write(
                encode_packet(PUBREL, 0x02, pid.to_bytes(2, "big")))
            await self._writer.drain()
            await asyncio.wait_for(fut2, 10)         # PUBCOMP

    async def disconnect(self) -> None:
        self._closing = True
        for t in (self._ping_task, self._task):
            if t is not None:
                t.cancel()
        if self._writer is not None:
            try:
                self._writer.write(encode_packet(DISCONNECT, 0, b""))
                await self._writer.drain()
            except ConnectionError:
                pass
            self._writer.close()


class MqttBroker:
    """Embedded MQTT broker (QoS 0/1 fan-out, wildcard subscriptions) — the
    analog of the reference's embedded ActiveMQ broker receiver
    (sources/activemq/ActiveMqBrokerEventReceiver.java), and the test/load
    harness for MQTT paths."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._server: asyncio.AbstractServer | None = None
        # writer -> list of subscription patterns
        self._subs: dict[asyncio.StreamWriter, list[str]] = {}

    @property
    def bound_port(self) -> int:
        assert self._server is not None and self._server.sockets
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)

    async def stop(self) -> None:
        # close live client connections BEFORE wait_closed(): in Python 3.12
        # Server.wait_closed() blocks until every connection handler returns
        for w in list(self._subs):
            w.close()
        self._subs.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            ptype, _, _ = await read_packet(reader)
            if ptype != CONNECT:
                writer.close()
                return
            writer.write(encode_packet(CONNACK, 0, b"\x00\x00"))
            await writer.drain()
            self._subs[writer] = []
            # per-connection exactly-once inbox: PUBLISH(qos2) parks here
            # until its PUBREL; redeliveries with the same pid overwrite
            # (never fan out twice)
            pending_qos2: dict[int, tuple[str, bytes]] = {}
            while True:
                ptype, flags, body = await read_packet(reader)
                if ptype == PUBLISH:
                    topic, payload, qos, pid = decode_publish(flags, body)
                    if qos == 1:
                        writer.write(encode_packet(PUBACK, 0, pid.to_bytes(2, "big")))
                        await writer.drain()
                        await self._fanout(topic, payload)
                    elif qos == 2:
                        pending_qos2[pid] = (topic, payload)
                        writer.write(encode_packet(PUBREC, 0, pid.to_bytes(2, "big")))
                        await writer.drain()
                    else:
                        await self._fanout(topic, payload)
                elif ptype == PUBREL:
                    pid = int.from_bytes(body[:2], "big")
                    parked = pending_qos2.pop(pid, None)
                    writer.write(encode_packet(PUBCOMP, 0, pid.to_bytes(2, "big")))
                    await writer.drain()
                    if parked is not None:
                        await self._fanout(*parked)
                elif ptype == SUBSCRIBE:
                    pid = int.from_bytes(body[:2], "big")
                    off, grants = 2, []
                    while off < len(body):
                        tlen = int.from_bytes(body[off: off + 2], "big")
                        topic = body[off + 2: off + 2 + tlen].decode()
                        qos = body[off + 2 + tlen]
                        off += 3 + tlen
                        self._subs[writer].append(topic)
                        grants.append(min(qos, 2))
                    writer.write(
                        encode_packet(SUBACK, 0, pid.to_bytes(2, "big") + bytes(grants))
                    )
                    await writer.drain()
                elif ptype == PINGREQ:
                    writer.write(encode_packet(PINGRESP, 0, b""))
                    await writer.drain()
                elif ptype == DISCONNECT:
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._subs.pop(writer, None)
            writer.close()

    async def _fanout(self, topic: str, payload: bytes) -> None:
        pkt = encode_publish(topic, payload, 0, 0)
        for w, patterns in list(self._subs.items()):
            if any(topic_matches(p, topic) for p in patterns):
                try:
                    w.write(pkt)
                    await w.drain()
                except ConnectionError:
                    self._subs.pop(w, None)


class MqttEventReceiver(InboundEventReceiver):
    """Subscribe to a broker topic and submit payloads to the event source
    (reference: sources/mqtt/MqttInboundEventReceiver.java). A dropped
    connection schedules reconnect attempts with exponential backoff and
    re-subscribes — the reference receiver's scheduled-reconnect behavior."""

    def __init__(self, host: str, port: int, topic: str = "sitewhere/input/#",
                 qos: int = 0, client_id: str = "sw-ingest",
                 username: str | None = None, password: str | None = None,
                 reconnect_initial_s: float = 0.2,
                 reconnect_max_s: float = 30.0):
        super().__init__(f"mqtt:{topic}")
        self.topic, self.qos = topic, qos
        self.client = MqttClient(host, port, client_id, username, password)
        self.reconnect_initial_s = reconnect_initial_s
        self.reconnect_max_s = reconnect_max_s
        self.reconnects = 0            # successful re-connections (metrics)
        self._stopping = False
        self._reconnect_task: asyncio.Task | None = None

    async def on_start(self) -> None:
        self.client.on_message = lambda topic, payload: self.submit(
            payload, {"topic": topic}
        )
        self.client.on_disconnect = self._schedule_reconnect
        await self.client.connect()
        await self.client.subscribe(self.topic, self.qos)

    def _schedule_reconnect(self) -> None:
        if self._stopping or (
            self._reconnect_task is not None and not self._reconnect_task.done()
        ):
            return
        self._reconnect_task = asyncio.get_running_loop().create_task(
            self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        delay = self.reconnect_initial_s
        while not self._stopping:
            await asyncio.sleep(delay)
            try:
                await self.client.connect()
                await self.client.subscribe(self.topic, self.qos)
                self.reconnects += 1
                logger.info("mqtt receiver %s reconnected", self.name)
                return
            except asyncio.CancelledError:
                raise
            except Exception:
                # any handshake failure (refused, half-open CONNACK ->
                # IncompleteReadError/IndexError, timeout) just backs off;
                # a dead reconnect loop would strand the receiver forever
                delay = min(delay * 2, self.reconnect_max_s)

    async def on_stop(self) -> None:
        self._stopping = True
        if self._reconnect_task is not None:
            self._reconnect_task.cancel()
        await self.client.disconnect()
