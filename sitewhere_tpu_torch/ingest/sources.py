"""Inbound event sources: receivers + decoder + deduplicator (port of
``sitewhere_tpu/ingest/sources.py``; plain Python, the engine is the
port's).

``InboundEventSource`` binds N protocol receivers to one decoder and an
optional deduplicator (reference: sources/InboundEventSource.java:35-298 —
onEncodedEventReceived -> decodePayload -> dedup -> forward, with decode,
failure and duplicate counters); ``EventSourcesManager`` owns the
forward path and splits decoded requests into event-create and
device-registration flows, with a failed-decode dead letter
(sources/manager/EventSourcesManager.java:38-260).

Receivers are asyncio servers and clients (TCP socket, WebSocket, REST
polling, in-memory). ``websockets`` and ``aiohttp`` are imported only
when their receiver starts, so a machine without them runs the others.
The ``batcher`` argument is this package's
``ingest/wire_edge.WireBatcher`` (``add(payload, tenant=, binary=,
on_durable=)`` and ``flush()``): sources with a batchable decoder hand it
raw payloads, one engine call an arrival window. MQTT, CoAP, AMQP, STOMP
and EventHub receivers live in their own modules on this one.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable

from sitewhere_tpu_torch.ingest.decoders import EventDecoder
from sitewhere_tpu_torch.ingest.dedup import Deduplicator
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, EventDecodeException, RequestType
from sitewhere_tpu_torch.utils.lifecycle import LifecycleComponent

logger = logging.getLogger(__name__)


class InboundEventReceiver(LifecycleComponent):
    """Base protocol receiver; concrete receivers call ``submit``."""

    def __init__(self, name: str | None = None, required: bool = True):
        super().__init__(name, required)
        self.source: "InboundEventSource | None" = None

    def bind(self, source: "InboundEventSource") -> None:
        self.source = source

    def submit(self, payload: bytes, metadata: dict[str, Any] | None = None,
               on_durable: Callable[[], Any] | None = None) -> int:
        assert self.source is not None, "receiver not bound to a source"
        return self.source.on_encoded_event_received(payload, metadata or {},
                                                     on_durable=on_durable)


class InboundEventSource(LifecycleComponent):
    """One event source: receivers -> decoder -> dedup -> manager."""

    def __init__(
        self,
        source_id: str,
        decoder: EventDecoder,
        receivers: list[InboundEventReceiver] | None = None,
        deduplicator: Deduplicator | None = None,
        tenant: str = "default",
        batcher=None,
    ):
        super().__init__(f"event-source:{source_id}")
        self.source_id = source_id
        self.decoder = decoder
        self.deduplicator = deduplicator
        self.tenant = tenant
        self.manager: "EventSourcesManager | None" = None
        self.receivers = receivers or []
        for r in self.receivers:
            r.bind(self)
            self.add_child(r)
        # batched arena submission (this package's
        # ingest/wire_edge.WireBatcher): when the decoder declares a
        # wire_tag the raw payload skips host-side decode and rides the
        # engine's batch-ingest facade, one engine call per arrival window
        # instead of one lock acquisition per event. A host-side deduplicator forces the per-payload path —
        # dedup needs the decoded alternate id (the wire edge's own
        # socket endpoints dedup by byte scan instead).
        self.batcher = batcher
        self._wire_tag = getattr(decoder, "wire_tag", None)
        if batcher is not None and deduplicator is not None:
            raise ValueError(
                "batched submission and a host-side deduplicator are "
                "mutually exclusive; drop one of them")
        # Prometheus-analog counters (InboundEventSource.java:50-59)
        self.decoded_count = 0
        self.failed_count = 0
        self.duplicate_count = 0
        self.batched_count = 0

    def on_encoded_event_received(self, payload: bytes, metadata: dict[str, Any],
                                  on_durable: Callable[[], Any] | None = None) -> int:
        """Forward one raw payload; returns number of requests forwarded.

        Batched mode (``batcher`` set + batchable decoder): the payload is
        appended to the shared arrival window by reference and decoded by
        the engine's native scanner inside the staging arena — decode
        failures are then counted by the engine's batch summary rather
        than this source's ``failed_count``/dead letter.

        ``on_durable`` fires once the payload's batch has cleared the WAL
        durability gate (batched mode; it runs on the flusher thread — the
        receiver marshals back to its own loop). On the per-payload path
        the forward is synchronous, so the callback fires before return."""
        assert self.manager is not None, "source not attached to a manager"
        if self.batcher is not None and self._wire_tag is not None:
            if isinstance(payload, str):
                payload = payload.encode()
            self.batcher.add(payload, tenant=self.tenant,
                             binary=self._wire_tag == "binary",
                             on_durable=on_durable)
            self.batched_count += 1
            return 1
        metadata = {**metadata, "source_id": self.source_id}
        try:
            requests = self.decoder.decode(payload, metadata)
        except EventDecodeException as e:
            self.failed_count += 1
            self.manager.on_decode_failed(self.source_id, payload, metadata, e)
            if on_durable is not None:
                on_durable()
            return 0
        forwarded = 0
        for req in requests:
            if req.tenant == "default":
                req.tenant = self.tenant
            if self.deduplicator is not None and self.deduplicator.is_duplicate(req):
                self.duplicate_count += 1
                continue
            self.decoded_count += 1
            self.manager.on_decoded_request(self.source_id, req)
            forwarded += 1
        if on_durable is not None:
            on_durable()
        return forwarded


class EventSourcesManager(LifecycleComponent):
    """Owns all sources for a tenant engine; routes decoded requests.

    ``on_event_request`` receives event-create requests (the decoded-events
    Kafka topic analog) and ``on_registration_request`` receives registration
    requests (the device-registration topic analog). Failed decodes land in a
    bounded in-memory dead letter, mirroring the failed-decode topic."""

    def __init__(
        self,
        on_event_request: Callable[[DecodedRequest], None],
        on_registration_request: Callable[[DecodedRequest], None] | None = None,
        dead_letter_capacity: int = 4096,
        batcher=None,
    ):
        super().__init__("event-sources-manager")
        self.sources: dict[str, InboundEventSource] = {}
        self._on_event = on_event_request
        self._on_register = on_registration_request
        self.failed_decodes: list[tuple[str, bytes, str]] = []
        self.dead_letter_capacity = dead_letter_capacity
        # shared batched-submit accumulator (this package's
        # ingest/wire_edge.WireBatcher): newly added sources with a
        # batchable decoder and no host-side deduplicator inherit it, so
        # CoAP/polling/in-memory receivers pay one engine call per arrival
        # window, not one per event
        self.batcher = batcher

    def add_source(self, source: InboundEventSource) -> InboundEventSource:
        if source.source_id in self.sources:
            raise ValueError(f"duplicate source id {source.source_id!r}")
        self.sources[source.source_id] = source
        source.manager = self
        if (self.batcher is not None and source.batcher is None
                and source._wire_tag is not None
                and source.deduplicator is None):
            source.batcher = self.batcher
        self.add_child(source)
        return source

    async def on_stop(self) -> None:
        """Drain the shared arrival window so every accepted payload
        reaches the engine before the sources report stopped."""
        if self.batcher is not None:
            self.batcher.flush()

    def on_decoded_request(self, source_id: str, req: DecodedRequest) -> None:
        if req.type is RequestType.REGISTER_DEVICE and self._on_register is not None:
            self._on_register(req)
        else:
            self._on_event(req)

    def on_decode_failed(self, source_id: str, payload: bytes,
                         metadata: dict, error: Exception) -> None:
        if len(self.failed_decodes) < self.dead_letter_capacity:
            self.failed_decodes.append((source_id, payload, str(error)))
        logger.warning("decode failed on %s: %s", source_id, error)


# --- concrete receivers ------------------------------------------------------


class InMemoryEventReceiver(InboundEventReceiver):
    """Direct-submit receiver for tests, benchmarks, and embedded use."""

    def __init__(self, name: str = "inmemory"):
        super().__init__(name)


class SocketEventReceiver(InboundEventReceiver):
    """Raw TCP socket receiver (reference: sources/socket/
    SocketInboundEventReceiver.java + interaction handlers). Framing modes:
    ``read_all`` (one payload per connection), ``length_prefixed`` (u32 BE
    length frames), ``newline`` (one payload per line)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 framing: str = "read_all"):
        super().__init__(f"socket:{port}")
        if framing not in ("read_all", "length_prefixed", "newline"):
            raise ValueError(f"unknown framing {framing!r}")
        self.host, self.port, self.framing = host, port, framing
        self._server: asyncio.AbstractServer | None = None

    @property
    def bound_port(self) -> int:
        assert self._server is not None and self._server.sockets
        return self._server.sockets[0].getsockname()[1]

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        meta = {"remote": str(peer)}
        try:
            if self.framing == "read_all":
                payload = await reader.read(-1)
                if payload:
                    self.submit(payload, meta)
            elif self.framing == "length_prefixed":
                while True:
                    header = await reader.readexactly(4)
                    n = int.from_bytes(header, "big")
                    payload = await reader.readexactly(n)
                    self.submit(payload, meta)
            else:  # newline
                while True:
                    line = await reader.readline()
                    if not line:
                        break
                    line = line.strip()
                    if line:
                        self.submit(line, meta)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def on_start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)

    async def on_stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


class WebSocketEventReceiver(InboundEventReceiver):
    """WebSocket receiver for binary or text payloads (reference:
    sources/websocket/{Binary,String}WebSocketEventReceiver.java)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__(f"websocket:{port}")
        self.host, self.port = host, port
        self._server = None

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return next(iter(self._server.sockets)).getsockname()[1]

    async def _handle(self, ws) -> None:
        async for message in ws:
            payload = message.encode() if isinstance(message, str) else message
            self.submit(payload, {"remote": str(ws.remote_address)})

    async def on_start(self) -> None:
        import websockets

        self._server = await websockets.serve(self._handle, self.host, self.port)

    async def on_stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


class PollingRestReceiver(InboundEventReceiver):
    """Poll a REST endpoint on an interval and submit the response body
    (reference: sources/rest/PollingRestInboundEventReceiver.java)."""

    def __init__(self, url: str, interval_s: float = 10.0,
                 headers: dict[str, str] | None = None):
        super().__init__(f"rest-poll:{url}")
        self.url = url
        self.interval_s = interval_s
        self.headers = headers or {}
        self._task: asyncio.Task | None = None

    async def _poll_loop(self) -> None:
        import aiohttp

        async with aiohttp.ClientSession() as session:
            while True:
                try:
                    async with session.get(self.url, headers=self.headers) as resp:
                        body = await resp.read()
                        if resp.status == 200 and body:
                            self.submit(body, {"url": self.url})
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    logger.warning("poll %s failed: %s", self.url, e)
                await asyncio.sleep(self.interval_s)

    async def on_start(self) -> None:
        self._task = asyncio.create_task(self._poll_loop())

    async def on_stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
