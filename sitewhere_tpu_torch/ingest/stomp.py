"""Native STOMP 1.2: frame codec, asyncio client, embedded broker, and the
ActiveMQ-equivalent receivers (port of ``sitewhere_tpu/ingest/stomp.py``;
plain Python on the port's ``ingest/sources.py``).

The reference has two ActiveMQ ingestion modes: an *embedded broker* started
inside the receiver with a transport connector and a consumer pool on a named
queue (sources/activemq/ActiveMqBrokerEventReceiver.java:67-95 — broker name
and queue name are required config, JMX/shutdown hooks disabled), and a
*client* that attaches to a remote broker and runs N competing consumers on
a queue (sources/activemq/ActiveMqClientEventReceiver.java:64-155). ActiveMQ
speaks OpenWire/JMS; the open text protocol it also ships is STOMP, so this
package implements STOMP 1.2 here — queue destinations get point-to-point
round-robin delivery (JMS queue semantics, competing consumers), topic
destinations get fan-out (JMS topic semantics).

Legacy-compat receiver: frames submit one payload at a time through
``InboundEventSource``. New high-rate device transports should front
the batched persistent-connection edge (``ingest/wire_edge.py``);
sources kept on this receiver inherit the manager's shared
``WireBatcher`` (batched arena submission) when their decoder declares
a ``wire_tag``.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from collections import deque
from typing import Any, Callable

from sitewhere_tpu_torch.ingest.sources import InboundEventReceiver

logger = logging.getLogger(__name__)

_ESCAPES = {"\\": "\\\\", "\r": "\\r", "\n": "\\n", ":": "\\c"}
_UNESCAPES = {"\\\\": "\\", "\\r": "\r", "\\n": "\n", "\\c": ":"}


def _escape(s: str) -> str:
    return "".join(_ESCAPES.get(c, c) for c in s)


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append(_UNESCAPES.get(s[i: i + 2], s[i + 1]))
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def encode_frame(command: str, headers: dict[str, str], body: bytes = b"") -> bytes:
    lines = [command]
    hdrs = dict(headers)
    if body:
        hdrs.setdefault("content-length", str(len(body)))
    for k, v in hdrs.items():
        lines.append(f"{_escape(k)}:{_escape(v)}")
    return ("\n".join(lines) + "\n\n").encode() + body + b"\x00"


async def read_frame(reader: asyncio.StreamReader) -> tuple[str, dict[str, str], bytes]:
    # skip heart-beat newlines between frames
    while True:
        first = await reader.readexactly(1)
        if first not in (b"\n", b"\r"):
            break
    line = first + (await reader.readuntil(b"\n"))
    command = line.decode().strip()
    headers: dict[str, str] = {}
    while True:
        raw = (await reader.readuntil(b"\n")).decode().rstrip("\r\n")
        if not raw:
            break
        key, _, val = raw.partition(":")
        headers.setdefault(_unescape(key), _unescape(val))
    if "content-length" in headers:
        n = int(headers["content-length"])
        body = await reader.readexactly(n)
        await reader.readexactly(1)  # trailing NUL
    else:
        body = (await reader.readuntil(b"\x00"))[:-1]
    return command, headers, body


class _Dest:
    def __init__(self, name: str):
        self.name = name
        self.queue = name.startswith("/queue/")
        # (body, passthrough headers) buffered while no subscriber (queues)
        self.pending: deque[tuple[bytes, dict[str, str]]] = deque()
        # (writer, subscription id) in subscribe order
        self.subs: deque[tuple[asyncio.StreamWriter, str]] = deque()


class StompBroker:
    """Embedded STOMP broker: /queue/* point-to-point round-robin with
    buffering, /topic/* fan-out (the BrokerService analog of
    ActiveMqBrokerEventReceiver.java:76-95)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 broker_name: str = "sitewhere"):
        self.host, self.port = host, port
        self.broker_name = broker_name
        self._server: asyncio.AbstractServer | None = None
        self.dests: dict[str, _Dest] = {}
        self._writers: set[asyncio.StreamWriter] = set()

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

    async def _send_to(self, dest: _Dest, body: bytes,
                       headers: dict[str, str]) -> None:
        msg_headers = {"destination": dest.name,
                       "message-id": headers.get("message-id", "m-0"),
                       "subscription": ""}
        passthrough = {k: v for k, v in headers.items()
                       if k not in ("destination", "content-length", "receipt")}
        if dest.queue:
            while dest.subs:
                writer, sub_id = dest.subs[0]
                if writer.is_closing():
                    dest.subs.popleft()
                    continue
                dest.subs.rotate(-1)
                try:
                    writer.write(encode_frame(
                        "MESSAGE", {**msg_headers, **passthrough,
                                    "subscription": sub_id}, body))
                    await writer.drain()
                    return
                except ConnectionError:
                    # the failing writer was rotated to the back; remove it
                    # specifically, not whoever is now at the front
                    dest.subs = deque(
                        (w, s) for w, s in dest.subs if w is not writer)
            dest.pending.append((body, passthrough))
        else:
            for writer, sub_id in list(dest.subs):
                try:
                    writer.write(encode_frame(
                        "MESSAGE", {**msg_headers, **passthrough,
                                    "subscription": sub_id}, body))
                    await writer.drain()
                except ConnectionError:
                    pass

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        msg_ids = itertools.count(1)
        try:
            while True:
                command, headers, body = await read_frame(reader)
                if command in ("CONNECT", "STOMP"):
                    writer.write(encode_frame("CONNECTED", {
                        "version": "1.2", "server": self.broker_name}))
                elif command == "SUBSCRIBE":
                    name = headers["destination"]
                    dest = self.dests.setdefault(name, _Dest(name))
                    dest.subs.append((writer, headers.get("id", "0")))
                    while dest.queue and dest.pending and dest.subs:
                        p_body, p_headers = dest.pending.popleft()
                        await self._send_to(
                            dest, p_body,
                            {**p_headers, "message-id": f"m-{next(msg_ids)}"})
                elif command == "UNSUBSCRIBE":
                    sub_id = headers.get("id", "0")
                    for dest in self.dests.values():
                        dest.subs = deque(
                            (w, s) for w, s in dest.subs
                            if not (w is writer and s == sub_id))
                elif command == "SEND":
                    name = headers["destination"]
                    dest = self.dests.setdefault(name, _Dest(name))
                    await self._send_to(
                        dest, body,
                        {**headers, "message-id": f"m-{next(msg_ids)}"})
                elif command == "DISCONNECT":
                    if "receipt" in headers:
                        writer.write(encode_frame(
                            "RECEIPT", {"receipt-id": headers["receipt"]}))
                        await writer.drain()
                    break
                if command != "DISCONNECT":
                    await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            self._writers.discard(writer)
            for dest in self.dests.values():
                dest.subs = deque((w, s) for w, s in dest.subs if w is not writer)
            writer.close()


class StompClient:
    """Minimal asyncio STOMP 1.2 client."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self.on_message: Callable[[str, dict[str, str], bytes], Any] | None = None
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._task: asyncio.Task | None = None
        self._sub_ids = itertools.count(1)

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        self._writer.write(encode_frame("CONNECT", {
            "accept-version": "1.2", "host": self.host}))
        await self._writer.drain()
        command, headers, _ = await read_frame(self._reader)
        if command != "CONNECTED":
            raise ConnectionError(f"STOMP connect refused: {command} {headers}")
        self._task = asyncio.create_task(self._read_loop())

    async def _read_loop(self) -> None:
        try:
            while True:
                command, headers, body = await read_frame(self._reader)
                if command == "MESSAGE" and self.on_message is not None:
                    res = self.on_message(headers.get("destination", ""),
                                          headers, body)
                    if asyncio.iscoroutine(res):
                        await res
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            pass

    async def subscribe(self, destination: str) -> str:
        sub_id = f"sub-{next(self._sub_ids)}"
        self._writer.write(encode_frame("SUBSCRIBE", {
            "id": sub_id, "destination": destination, "ack": "auto"}))
        await self._writer.drain()
        return sub_id

    async def send(self, destination: str, body: bytes,
                   headers: dict[str, str] | None = None) -> None:
        self._writer.write(encode_frame(
            "SEND", {"destination": destination, **(headers or {})}, body))
        await self._writer.drain()

    async def disconnect(self) -> None:
        if self._task is not None:
            self._task.cancel()
        if self._writer is not None:
            try:
                self._writer.write(encode_frame("DISCONNECT", {}))
                await self._writer.drain()
            except ConnectionError:
                pass
            self._writer.close()
            self._writer = None


class ActiveMqBrokerEventReceiver(InboundEventReceiver):
    """Embedded-broker receiver: starts a broker and consumes a queue on it
    (reference: sources/activemq/ActiveMqBrokerEventReceiver.java:67-95 —
    broker name and queue name are required)."""

    def __init__(self, broker_name: str, queue_name: str,
                 host: str = "127.0.0.1", port: int = 0,
                 num_consumers: int = 3):
        if not broker_name:
            raise ValueError("Broker name must be configured.")
        if not queue_name:
            raise ValueError("Queue name must be configured.")
        super().__init__(f"activemq-broker:{queue_name}")
        self.broker = StompBroker(host, port, broker_name)
        self.queue_name = queue_name
        self.num_consumers = num_consumers
        self._clients: list[StompClient] = []

    @property
    def bound_port(self) -> int:
        return self.broker.bound_port

    async def on_start(self) -> None:
        await self.broker.start()
        for _ in range(self.num_consumers):
            client = StompClient("127.0.0.1", self.broker.bound_port)
            client.on_message = lambda dest, headers, body: self.submit(
                body, {"destination": dest})
            await client.connect()
            await client.subscribe(f"/queue/{self.queue_name}")
            self._clients.append(client)

    async def on_stop(self) -> None:
        for client in self._clients:
            await client.disconnect()
        self._clients.clear()
        await self.broker.stop()


class ActiveMqClientEventReceiver(InboundEventReceiver):
    """Remote-broker receiver: N competing consumers on a queue (reference:
    sources/activemq/ActiveMqClientEventReceiver.java:64-155)."""

    def __init__(self, host: str, port: int, queue_name: str,
                 num_consumers: int = 3):
        if not queue_name:
            raise ValueError("Queue name must be configured.")
        super().__init__(f"activemq-client:{queue_name}")
        self.host, self.port = host, port
        self.queue_name = queue_name
        self.num_consumers = num_consumers
        self._clients: list[StompClient] = []

    async def on_start(self) -> None:
        for _ in range(self.num_consumers):
            client = StompClient(self.host, self.port)
            client.on_message = lambda dest, headers, body: self.submit(
                body, {"destination": dest})
            await client.connect()
            await client.subscribe(f"/queue/{self.queue_name}")
            self._clients.append(client)

    async def on_stop(self) -> None:
        for client in self._clients:
            await client.disconnect()
        self._clients.clear()
