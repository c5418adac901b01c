"""Persistent-connection wire edge: socket frames straight into staging arenas
(port of ``sitewhere_tpu/ingest/wire_edge.py``; plain Python and asyncio over
the port's engines).

The reference fronts MQTT and broker-style sources as its primary ingest
protocols (SURVEY.md §2.1). Receivers that hand payloads to the engine one
``submit()`` at a time pay one decode, one engine-lock acquisition and one
``process()`` per event; this module is the batched persistent-connection
edge in front of the engine's batch-ingest facade:

* ``WireBatcher`` — the shared batched-submit accumulator. Frames from any
  number of connections append to one deque; an adaptive flush (size OR
  deadline, whichever first) drains the arrival window into ONE
  ``engine.ingest_json_batch`` / ``ingest_binary_batch`` call per
  (tenant, wire-format) run. The engine's native scanner decodes the
  payload list straight into a pooled pinned ``StagingArena`` (the
  slot-routed scatter when the engine is an ``SpmdEngine``: the batcher
  calls the same inherited facade), so the edge adds **zero per-frame host
  copies**: payload bytes are held by reference from socket read to arena
  scan.
* ``WireEdge`` — asyncio listeners speaking MQTT 3.1.1 (server side of
  ``ingest/mqtt.py``'s codec), a length-prefixed binary/JSON TCP protocol
  ("SWP"), and optionally websocket frames, all feeding per-connection-shard
  ``WireBatcher`` instances.

The flusher thread drives the card. Its engine calls (and those of
``flush()`` from an executor thread) run under the CUDA device and the
stream that were current on the thread that built the batcher, so the
step's copies and kernels, and the engine's dispatch fence, land on the
stream the caller's own reads are ordered after. An engine on the CPU
needs neither.

Durability and backpressure contracts (the part that must not be wrong):

* **WAL-before-ack.** An MQTT PUBACK/PUBCOMP or SWP cumulative ack is
  released only after the frame's batch has passed the WAL durability
  watermark (``IngestLog.wait_durable`` on the engine's newest append
  ticket, the same fsync-before-dispatch gate the engine uses). A client
  that saw an ack can never lose that frame to a crash; a frame lost to a
  crash was never acked, and MQTT QoS 1 redelivery (DUP) re-offers it.
* **Admission at the edge, never inside the engine.** Each arriving frame
  consults ``utils/qos.admit_or_raise`` — the shared admission helper —
  before touching the batcher. A ``ShedError`` maps to protocol-native
  backpressure: MQTT withholds the PUBACK (and optionally disconnects, so
  the client's redelivery backs off); SWP sends an explicit shed code with
  a Retry-After; websocket mirrors SWP. Replay paths never pass through
  here, so durable events can never be shed.
* **At-most-once per (tenant, deviceToken, alternateId) across
  redeliveries.** QoS 1 redelivery (PUBACK lost in transit) must not
  double-ingest. The edge keeps a bounded ring over the dedup triples of
  STAGED frames (byte-scan extraction, no JSON decode), keyed exactly like
  ``AlternateIdDeduplicator`` so tenants/devices reusing an alternateId
  stay distinct. The ring commits only at staging (``on_staged``), never
  at admission: a frame that sheds or stalls after admission leaves no
  ring entry, so its redelivery is re-admitted rather than acked as a
  duplicate of an ingest that never happened. A true duplicate is not
  re-ingested, and its ack rides the next durability point.
* **Acks are written by the event loop only.** The flusher thread hands
  every writer-touching callback to the loop (``_call_on_loop``):
  ``StreamWriter`` is not thread-safe.

Conservation terms (``utils/conservation.py`` "wire" stage): every frame
gets exactly one edge disposition —

    frames_received == frames_admitted + frames_shed
                       + frames_invalid + frames_duplicate
    frames_admitted == rows_submitted + frames_stalled + pending

``rows_submitted`` then flows into the staging-balance equation via the
ordinary batch-ingest path. All series scrape as ``swtpu_wire_*`` and are
deliberately NOT ``engine.metrics()`` keys (dispatch-shape equality pin).

SWP framing contract (documented for client implementors):

    client -> server   handshake line  b"SWTP1 <tenant> <json|binary>\\n"
    client -> server   frames          [u32 BE length][payload]
                       length 0 = flush hint (ack pending frames promptly)
    server -> client   0x06 [u32 BE n]  cumulative ack: n admitted frames
                                        from this connection are DURABLE
    server -> client   0x15 [u32 BE retry_after_ms]  frame shed, resend
    server -> client   0x19 [u32 BE max_frame_bytes] protocol error /
                                        oversized frame; connection closes

Without the ``websockets`` library the edge logs a warning and runs
without the websocket listener, as the JAX package's edge does.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import logging
import struct
import threading
import time
from typing import Any, Callable

import torch

from sitewhere_tpu_torch.utils.qos import ShedError, admit_or_raise

logger = logging.getLogger(__name__)

# SWP (SiteWhere-TPU wire protocol) server->client codes
SWP_MAGIC = b"SWTP1"
SWP_ACK = 0x06          # cumulative durable-frame ack
SWP_SHED = 0x15         # admission shed / arena stall: resend after delay
SWP_ERR = 0x19          # protocol error or oversized frame; closing


def _scan_string_field(payload: bytes, key: bytes) -> str | None:
    """Best-effort string-field extraction from a raw JSON payload via a
    byte scan — no decode, no copy of the payload. Returns None when the key
    is absent or anything about the value looks unusual (ambiguity must
    never block ingest; the engine-side decode is the arbiter)."""
    idx = payload.find(key)
    if idx < 0:
        return None
    i = idx + len(key)
    n = len(payload)
    while i < n and payload[i] in b" \t\r\n":
        i += 1
    if i >= n or payload[i] != 0x3A:          # ':'
        return None
    i += 1
    while i < n and payload[i] in b" \t\r\n":
        i += 1
    if i >= n or payload[i] != 0x22:          # '"'
        return None
    i += 1
    out = bytearray()
    while i < n:
        b = payload[i]
        if b == 0x5C:                          # backslash escape
            if i + 1 >= n:
                return None
            out.append(payload[i + 1])
            i += 2
            continue
        if b == 0x22:
            try:
                return out.decode()
            except UnicodeDecodeError:
                return None
        out.append(b)
        i += 1
    return None


def extract_alternate_id(payload: bytes) -> str | None:
    return _scan_string_field(payload, b'"alternateId"')


def extract_device_token(payload: bytes) -> str | None:
    return _scan_string_field(payload, b'"deviceToken"')


class AltIdRing:
    """Bounded FIFO membership ring over the dedup keys of STAGED frames —
    ``(tenant, device_token, alternate_id)``, the same triple
    ingest/dedup.AlternateIdDeduplicator uses, byte-scanned rather than
    built from a DecodedRequest. Keys enter the ring only once their frame
    has actually staged (``on_staged``), never at admission: a frame that
    sheds or stalls after admission left no trace here, so its redelivery
    is admitted like a first offer instead of being acked as a duplicate
    of an ingest that never happened.

    Thread-safe: ``seen`` runs on the event-loop thread, ``add`` on the
    batcher's flusher thread."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._seen: set = set()
        self._order: collections.deque = collections.deque()

    def seen(self, key) -> bool:
        with self._lock:
            return key in self._seen

    def add(self, key) -> None:
        with self._lock:
            if key in self._seen:
                return
            self._seen.add(key)
            self._order.append(key)
            while len(self._order) > self.capacity:
                self._seen.discard(self._order.popleft())


def _card_streams(engine) -> list:
    """The streams current, on the calling thread, on every CUDA device
    ``engine`` dispatches to (its shards' ``mesh``, else its ``device``);
    the engine's own device first. Empty for an engine off the card or a
    facade with no device."""
    devs = list(getattr(engine, "mesh", None) or [])
    dev = getattr(engine, "device", None)
    if dev is not None:
        devs.insert(0, dev)
    cards = []
    for d in devs:
        if getattr(d, "type", None) == "cuda" and d not in cards:
            cards.append(d)
    return [torch.cuda.current_stream(d) for d in cards]


def _on_streams(streams: list) -> contextlib.AbstractContextManager:
    """Make ``streams`` current on this thread (and the first one's device
    the current device) for the length of the ``with`` block."""
    if not streams:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    for s in reversed(streams):
        stack.enter_context(torch.cuda.stream(s))
    return stack


class WireBatcher:
    """Arrival-window frame accumulator -> batched arena submission.

    Thread-safe: connection handlers (event-loop thread) append frames;
    a dedicated flusher thread drains the window into the engine whenever
    the size threshold is reached OR the oldest frame's deadline expires —
    whichever first. The engine call happens OFF the socket loop, so a
    slow dispatch never stalls frame reception; backpressure is the arena
    pool's own recycle gate (surfaced as ``ShedError`` -> per-frame
    ``on_stall``).

    Also the batched-submit API ``ingest/sources.py`` routes through
    (CoAP/polling/in-memory receivers stop paying one engine-lock
    acquisition per event).

    Engine calls run under the CUDA streams current on the thread that
    built the batcher (``_card_streams``), whichever thread flushes: the
    step's work and its fence land where that thread's readers wait.
    """

    def __init__(self, engine, flush_rows: int = 256,
                 flush_interval_s: float = 0.005, auto: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self._streams = _card_streams(engine)
        self.flush_rows = max(1, int(flush_rows))
        self.flush_interval_s = float(flush_interval_s)
        self._clock = clock
        self._cond = threading.Condition(threading.Lock())
        # pending: (payload, tenant, binary, on_durable, on_stall,
        # on_staged).
        # A deque because the intake fast path appends WITHOUT the
        # condition lock: deque.append is a single atomic op under the
        # GIL, and the flusher drains by popleft-until-empty, so a frame
        # appended mid-drain is either included or left for the next
        # window — never lost. Only the window-arming frame (which must
        # stamp the deadline and wake the flusher) and frames at/past
        # the size threshold take the lock; frames 2..N-1 of a window
        # pay one append + one length check.
        self._pending: collections.deque[tuple] = collections.deque()
        self._armed = False          # an open window's deadline is armed
        self._barriers: list[Callable[[], None]] = []
        self._first_arrival: float | None = None
        self._closed = False
        # counters (all guarded by _cond)
        self.rows_submitted = 0
        self.frames_stalled = 0
        self.flushes_size = 0
        self.flushes_deadline = 0
        self.flushes_drain = 0
        self.flush_rows_sum = 0
        # one submit at a time: keeps ack release ordered with ingest order
        self._submit_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        if auto:
            self._thread = threading.Thread(
                target=self._run, name="swtpu-wire-flush", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- intake
    def add(self, payload: bytes, tenant: str = "default",
            binary: bool = False,
            on_durable: Callable[[], None] | None = None,
            on_stall: Callable[[ShedError], None] | None = None,
            on_staged: Callable[[], None] | None = None) -> None:
        """Append one admitted frame to the current arrival window.

        ``on_staged`` fires (flusher thread) the moment the frame's run
        has successfully entered the engine — before the durability wait,
        never on a shed/stalled run. It is the dedup-ring commit point:
        ids recorded here belong to frames that really were ingested.

        Lock-free fast path: the deque append is atomic under the GIL,
        so mid-window frames never touch the condition lock. Only the
        window-arming frame (stamps the deadline, wakes the flusher) and
        frames at/past the size threshold take it. The flusher clears
        ``_armed`` under the lock BEFORE re-checking the deque in its
        wait loop, so a frame whose adder observes the stale armed flag
        is always seen by that re-check — no lost wakeup.
        """
        if self._closed:
            raise RuntimeError("wire batcher closed")
        q = self._pending
        q.append((payload, tenant, binary, on_durable, on_stall, on_staged))
        if not self._armed or len(q) >= self.flush_rows:
            with self._cond:
                if not self._armed:
                    self._armed = True
                    self._first_arrival = self._clock()
                self._cond.notify_all()

    def add_barrier(self, callback: Callable[[], None]) -> None:
        """Fire ``callback`` after the next durability point — the ack hook
        for duplicate frames that must not re-ingest but whose sender still
        needs its (lost) ack re-sent."""
        with self._cond:
            if self._closed:
                raise RuntimeError("wire batcher closed")
            if not self._armed:
                self._armed = True
                self._first_arrival = self._clock()
            self._barriers.append(callback)
            self._cond.notify_all()

    @property
    def pending(self) -> int:
        return len(self._pending)

    # -------------------------------------------------------------- flush
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._closed:
                    if self._pending or self._barriers:
                        if len(self._pending) >= self.flush_rows:
                            self.flushes_size += 1
                            break
                        fa = self._first_arrival
                        if fa is None:
                            # adder raced past its arming step; treat the
                            # window as opening now
                            fa = self._first_arrival = self._clock()
                            self._armed = True
                        remaining = fa + self.flush_interval_s - self._clock()
                        if remaining <= 0:
                            self.flushes_deadline += 1
                            break
                        self._cond.wait(remaining)
                    else:
                        # disarm, then re-check: a frame whose adder saw a
                        # stale armed flag (and skipped the notify) is
                        # caught here; any frame appended after this
                        # disarm sees armed == False and notifies
                        self._armed = False
                        self._first_arrival = None
                        if self._pending or self._barriers:
                            continue
                        self._cond.wait()
                else:
                    return
            self._flush_once()

    def flush(self) -> int:
        """Synchronous drain (shutdown, tests, explicit checkpoints).
        Returns frames submitted by THIS call."""
        with self._cond:
            if self._pending or self._barriers:
                self.flushes_drain += 1
        return self._flush_once()

    def _flush_once(self) -> int:
        with self._submit_lock:
            with self._cond:
                # disarm FIRST, then drain by popleft: an adder appending
                # concurrently either lands in this batch or re-arms and
                # gets the next window
                self._armed = False
                self._first_arrival = None
                barriers, self._barriers = self._barriers, []
            batch: list[tuple] = []
            q = self._pending
            while True:
                try:
                    batch.append(q.popleft())
                except IndexError:
                    break
            if not batch and not barriers:
                return 0
            with _on_streams(self._streams):
                staged = self._submit(batch)
            self._wait_durable()
            # acks ONLY for frames whose run actually staged — stalled
            # frames keep their acks withheld so the senders redeliver
            for _, _, _, on_durable, _, _ in staged:
                if on_durable is not None:
                    self._safe_cb(on_durable)
            for cb in barriers:
                self._safe_cb(cb)
            return len(staged)

    def _submit(self, batch: list[tuple]) -> list[tuple]:
        """One engine call per (tenant, wire-format) run, preserving frame
        arrival order (per-connection ordering is a store-parity
        requirement). The payload list is handed to the batch-ingest facade
        by reference — the native scanner fills the staging arena straight
        from these buffers (zero per-frame host copies). Returns the
        frames that staged (their acks may be released)."""
        staged: list[tuple] = []
        i = 0
        while i < len(batch):
            j = i
            tenant, binary = batch[i][1], batch[i][2]
            while (j < len(batch) and batch[j][1] == tenant
                   and batch[j][2] == binary):
                j += 1
            run = batch[i:j]
            payloads = [f[0] for f in run]
            try:
                if binary:
                    self.engine.ingest_binary_batch(payloads, tenant=tenant)
                else:
                    self.engine.ingest_json_batch(payloads, tenant=tenant)
                staged.extend(run)
                with self._cond:
                    self.rows_submitted += len(run)
                    self.flush_rows_sum += len(run)
                # staged hooks fire only now: a frame that sheds/stalls
                # above never reaches them (dedup-ring commit point)
                for f in run:
                    if f[5] is not None:
                        self._safe_cb(f[5])
            except ShedError as e:
                # arena-stall shed surfaced by the ingest path; the frames
                # were never staged — withhold their acks so the senders
                # redeliver, and tell SWP clients explicitly
                with self._cond:
                    self.frames_stalled += len(run)
                for f in run:
                    if f[4] is not None:
                        self._safe_cb(lambda cb=f[4]: cb(e))
            except Exception:
                logger.exception("wire batch submit failed "
                                 "(%d frames, tenant=%s)", len(run), tenant)
                with self._cond:
                    self.frames_stalled += len(run)
            i = j
        return staged

    def _wait_durable(self) -> None:
        """WAL-before-ack: gate ack release on the newest append ticket.
        The ticket is read AFTER our appends (happens-before via the engine
        lock inside the batch call), so it covers every frame this flush
        submitted; waiting on a later concurrent ticket is merely
        conservative. No-op without a WAL or with inline (non-group) commit
        — the inline path flushes synchronously on append."""
        wal = getattr(self.engine, "wal", None)
        if wal is None:
            return
        try:
            wal.wait_durable(getattr(self.engine, "_wal_last_seq", 0))
        except Exception:
            # a poisoned WAL means NOTHING further may be acked; frames
            # stay unacked (clients redeliver elsewhere/later) and the
            # engine's own dispatch gate raises loudly on its next batch
            logger.exception("wire ack durability gate failed")

    @staticmethod
    def _safe_cb(cb: Callable) -> None:
        try:
            cb()
        except Exception:
            logger.exception("wire ack callback failed")

    def close(self) -> None:
        """Final drain, then stop the flusher thread."""
        self.flush()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def counters(self) -> dict[str, int]:
        with self._cond:
            pending = len(self._pending)
            flushes = (self.flushes_size + self.flushes_deadline
                       + self.flushes_drain)
            return {
                "rows_submitted": self.rows_submitted,
                "frames_stalled": self.frames_stalled,
                "pending": pending,
                "flushes_size": self.flushes_size,
                "flushes_deadline": self.flushes_deadline,
                "flushes_drain": self.flushes_drain,
                "flushes": flushes,
                "flush_rows_sum": self.flush_rows_sum,
            }


@dataclasses.dataclass(frozen=True)
class WireEdgeConfig:
    """Operator knobs for one wire edge (see README "Persistent-connection
    wire edge" for the full contract)."""

    host: str = "127.0.0.1"
    mqtt_port: int | None = 0        # 0 = ephemeral; None = listener off
    tcp_port: int | None = None      # SWP length-prefixed listener
    ws_port: int | None = None       # websocket listener (needs websockets)
    flush_rows: int = 256            # arrival-window size threshold
    flush_interval_s: float = 0.005  # arrival-window deadline
    n_shards: int = 1                # connection shards (one batcher each)
    max_frame_bytes: int = 1 << 20   # oversized-frame rejection
    keepalive_grace: float = 1.5     # disconnect after grace * keepalive
    handshake_timeout_s: float = 10.0
    idle_timeout_s: float = 300.0    # SWP/ws idle disconnect
    tenant_in_topic: bool = True     # MQTT topic swtpu/<tenant>/... routing
    default_tenant: str = "default"
    shed_disconnect: bool = True     # drop MQTT conn on shed (backs off
                                     # the client's redelivery loop)
    dedup_capacity: int = 65536      # alternate-id ring per edge


class _Conn:
    """Per-connection state shared by the protocol handlers."""

    __slots__ = ("writer", "proto", "tenant", "binary", "shard",
                 "frames_in", "acked", "_ack_dirty", "qos2_parked",
                 "qos2_inflight", "alive")

    def __init__(self, writer, proto: str, shard: int):
        self.writer = writer
        self.proto = proto
        self.tenant = "default"
        self.binary = False
        self.shard = shard
        self.frames_in = 0
        self.acked = 0              # SWP cumulative durable ack counter
        self._ack_dirty = False
        self.qos2_parked: dict[int, tuple[str, bytes]] = {}
        # pids released by PUBREL whose ingest outcome is still pending
        # (staging, or shed awaiting re-park) — a retransmitted PUBREL
        # for one of these must NOT be treated as a completed duplicate
        self.qos2_inflight: set[int] = set()
        self.alive = True


class WireEdge:
    """Persistent-connection ingest edge bound to one engine.

    ``await edge.start()`` inside a running event loop; connections shard
    round-robin onto ``n_shards`` :class:`WireBatcher` accumulators. The
    edge registers itself on ``engine.wire_edges`` so the conservation
    ledger and the ``swtpu_wire_*`` scrape exporter can find it."""

    def __init__(self, engine, config: WireEdgeConfig | None = None):
        self.engine = engine
        self.cfg = config or WireEdgeConfig()
        self.batchers = [
            WireBatcher(engine, flush_rows=self.cfg.flush_rows,
                        flush_interval_s=self.cfg.flush_interval_s)
            for _ in range(max(1, self.cfg.n_shards))
        ]
        self._lock = threading.Lock()
        self._conns: set[_Conn] = set()
        self._servers: list = []
        self._ws_server = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._next_shard = 0
        self._dedup = AltIdRing(self.cfg.dedup_capacity)
        # edge-disposition counters (conservation "wire" stage; _lock)
        self.frames_received = 0
        self.frames_admitted = 0
        self.frames_shed = 0
        self.frames_invalid = 0
        self.frames_duplicate = 0
        self.backpressure_events = 0
        self.keepalive_timeouts = 0
        self.connections_opened = 0
        self.connections_peak = 0

    # ---------------------------------------------------------- lifecycle
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        if self.cfg.mqtt_port is not None:
            srv = await asyncio.start_server(
                self._handle_mqtt, self.cfg.host, self.cfg.mqtt_port)
            self._servers.append(srv)
        if self.cfg.tcp_port is not None:
            srv = await asyncio.start_server(
                self._handle_swp, self.cfg.host, self.cfg.tcp_port)
            self._servers.append(srv)
        if self.cfg.ws_port is not None:
            try:
                import websockets
            except ImportError:
                logger.warning("websocket listener disabled: websockets "
                               "library unavailable")
            else:
                self._ws_server = await websockets.serve(
                    self._handle_ws, self.cfg.host, self.cfg.ws_port)
        edges = getattr(self.engine, "wire_edges", None)
        if edges is None:
            edges = self.engine.wire_edges = []
        edges.append(self)

    async def stop(self) -> None:
        for srv in self._servers:
            srv.close()
            await srv.wait_closed()
        self._servers.clear()
        if self._ws_server is not None:
            self._ws_server.close()
            await self._ws_server.wait_closed()
            self._ws_server = None
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.alive = False
            try:
                conn.writer.close()
            except Exception:
                pass
        # final drain so every admitted frame reaches the engine (and its
        # ack, if the connection is still up, goes out before teardown)
        for b in self.batchers:
            await asyncio.get_running_loop().run_in_executor(None, b.close)
        edges = getattr(self.engine, "wire_edges", None)
        if edges and self in edges:
            edges.remove(self)

    def kill(self) -> None:
        """Abrupt teardown for crash drills: close sockets, do NOT drain
        batchers — pending (unacked) frames are dropped exactly as a
        process crash would drop them. Acked frames are already durable."""
        for srv in self._servers:
            srv.close()
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.alive = False
            try:
                conn.writer.close()
            except Exception:
                pass
        edges = getattr(self.engine, "wire_edges", None)
        if edges and self in edges:
            edges.remove(self)

    # ------------------------------------------------------------- ports
    def _port_of(self, index: int) -> int:
        srv = self._servers[index]
        return srv.sockets[0].getsockname()[1]

    @property
    def mqtt_port(self) -> int:
        assert self.cfg.mqtt_port is not None
        return self._port_of(0)

    @property
    def tcp_port(self) -> int:
        assert self.cfg.tcp_port is not None
        return self._port_of(1 if self.cfg.mqtt_port is not None else 0)

    @property
    def ws_port(self) -> int:
        assert self._ws_server is not None
        return self._ws_server.sockets[0].getsockname()[1]

    # ------------------------------------------------------- registration
    def _register(self, writer, proto: str) -> _Conn:
        with self._lock:
            shard = self._next_shard % len(self.batchers)
            self._next_shard += 1
            conn = _Conn(writer, proto, shard)
            self._conns.add(conn)
            self.connections_opened += 1
            self.connections_peak = max(self.connections_peak,
                                        len(self._conns))
        return conn

    def _unregister(self, conn: _Conn) -> None:
        conn.alive = False
        with self._lock:
            self._conns.discard(conn)

    # ------------------------------------------------------ frame intake
    def _on_frame(self, conn: _Conn, payload: bytes, tenant: str,
                  binary: bool,
                  on_durable: Callable[[], None] | None,
                  on_shed: Callable[[ShedError], None] | None) -> None:
        """One frame's edge disposition: exactly one of admitted / shed /
        duplicate (invalid frames are counted by the framing layer and
        never reach here). Runs on the event-loop thread; everything here
        is O(1) bookkeeping — the engine work happens on the flusher."""
        with self._lock:
            self.frames_received += 1
            conn.frames_in += 1
        alt = extract_alternate_id(payload) if not binary else None
        dedup_key = None
        if alt is not None:
            # the repo's established dedup triple (AlternateIdDeduplicator):
            # two tenants/devices reusing the same alternateId are distinct
            dedup_key = (tenant, extract_device_token(payload) or "", alt)
        if dedup_key is not None and self._dedup.seen(dedup_key):
            with self._lock:
                self.frames_duplicate += 1
            # the key is in the ring only if the original frame STAGED, so
            # re-ack at the next durability point: that point covers the
            # original, and the sender's lost ack is regenerated without a
            # second ingest
            if on_durable is not None:
                self.batchers[conn.shard].add_barrier(on_durable)
            return
        try:
            admit_or_raise(self.engine, tenant, 1)
        except ShedError as e:
            with self._lock:
                self.frames_shed += 1
                self.backpressure_events += 1
            if on_shed is not None:
                on_shed(e)
            return
        with self._lock:
            self.frames_admitted += 1
        # the dedup key commits only when the frame stages (flusher
        # thread): a shed/stalled run leaves no ring entry, so the
        # client's redelivery is re-admitted instead of being acked as
        # a duplicate of an ingest that never happened
        on_staged = None
        if dedup_key is not None:
            on_staged = (lambda ring=self._dedup, k=dedup_key: ring.add(k))
        self.batchers[conn.shard].add(payload, tenant, binary,
                                      on_durable=on_durable,
                                      on_stall=self._stall_cb(conn, on_shed),
                                      on_staged=on_staged)

    def _stall_cb(self, conn: _Conn, on_shed):
        if on_shed is None:
            return None

        def cb(err: ShedError) -> None:
            with self._lock:
                self.backpressure_events += 1
            on_shed(err)
        return cb

    def _count_invalid(self) -> None:
        # invalid frames never reach _on_frame, so they get BOTH their
        # received and invalid increments here — every frame the edge saw
        # has exactly one disposition and the wire-frames conservation
        # equation balances even when malformed traffic arrives
        with self._lock:
            self.frames_received += 1
            self.frames_invalid += 1

    def _call_on_loop(self, fn: Callable[[], None]) -> Callable[[], None]:
        """Wrap a writer-touching callback so the flusher thread hands it
        to the event loop (StreamWriter is not thread-safe)."""
        loop = self._loop

        def cb() -> None:
            try:
                loop.call_soon_threadsafe(fn)
            except RuntimeError:
                # loop already closed (post-kill drain): the socket this
                # ack was headed for is gone — drop it silently
                pass
        return cb

    # ------------------------------------------------------- MQTT server
    def _mqtt_tenant(self, topic: str) -> str:
        if self.cfg.tenant_in_topic:
            parts = topic.split("/")
            if len(parts) >= 2 and parts[0] == "swtpu":
                return parts[1]
        return self.cfg.default_tenant

    async def _handle_mqtt(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        from sitewhere_tpu_torch.ingest.mqtt import (
            CONNACK, CONNECT, DISCONNECT, FrameTooLarge, PINGREQ, PINGRESP,
            PUBACK, PUBCOMP, PUBLISH, PUBREC, PUBREL, SUBACK, SUBSCRIBE,
            UNSUBACK, UNSUBSCRIBE, decode_connect, decode_publish,
            encode_packet, read_packet_limited)

        conn = self._register(writer, "mqtt")
        keepalive = 0
        try:
            ptype, _, body = await asyncio.wait_for(
                read_packet_limited(reader, self.cfg.max_frame_bytes),
                self.cfg.handshake_timeout_s)
            if ptype != CONNECT:
                self._count_invalid()
                return
            _client_id, keepalive = decode_connect(body)
            writer.write(encode_packet(CONNACK, 0, b"\x00\x00"))
            await writer.drain()
            timeout = (keepalive * self.cfg.keepalive_grace
                       if keepalive else None)
            while True:
                try:
                    ptype, flags, body = await asyncio.wait_for(
                        read_packet_limited(reader,
                                            self.cfg.max_frame_bytes),
                        timeout)
                except asyncio.TimeoutError:
                    # keepalive contract (MQTT 3.1.1 [MQTT-3.1.2-24]):
                    # silence past 1.5x the negotiated keepalive means the
                    # client is gone — close so its session can redeliver
                    with self._lock:
                        self.keepalive_timeouts += 1
                    return
                if ptype == PUBLISH:
                    topic, payload, qos, pid = decode_publish(flags, body)
                    tenant = self._mqtt_tenant(topic)
                    self._mqtt_frame(conn, writer, payload, tenant, qos, pid)
                elif ptype == PUBREL:
                    pid = int.from_bytes(body[:2], "big")
                    parked = conn.qos2_parked.pop(pid, None)
                    if parked is not None:
                        self._qos2_release(conn, writer, pid, parked)
                    elif pid in conn.qos2_inflight:
                        # outcome pending (staging, or shed racing its
                        # re-park): neither PUBCOMP nor a second ingest —
                        # the client's next PUBREL retransmission sees
                        # the settled state
                        pass
                    else:
                        # true duplicate PUBREL (the frame completed and
                        # its PUBCOMP was lost): just re-complete
                        self._mqtt_ack(conn, writer, PUBCOMP, pid)()
                elif ptype == PINGREQ:
                    writer.write(encode_packet(PINGRESP, 0, b""))
                    await writer.drain()
                elif ptype == SUBSCRIBE:
                    pid = body[:2]
                    n_topics = max(1, body[2:].count(b"\x00") // 2)
                    writer.write(encode_packet(SUBACK, 0,
                                               pid + b"\x00" * n_topics))
                    await writer.drain()
                elif ptype == UNSUBSCRIBE:
                    writer.write(encode_packet(UNSUBACK, 0, body[:2]))
                    await writer.drain()
                elif ptype == DISCONNECT:
                    return
        except FrameTooLarge:
            self._count_invalid()
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            self._unregister(conn)
            try:
                writer.close()
            except Exception:
                pass

    def _mqtt_frame(self, conn: _Conn, writer, payload: bytes, tenant: str,
                    qos: int, pid: int) -> None:
        from sitewhere_tpu_torch.ingest.mqtt import PUBACK, PUBREC, encode_packet

        if qos == 2:
            # exactly-once first half: park until PUBREL releases it. A
            # redelivered PUBLISH with the same pid replaces the parked
            # copy — never a second ingest.
            conn.qos2_parked[pid] = (tenant, payload)
            writer.write(encode_packet(PUBREC, 0, pid.to_bytes(2, "big")))
            return
        on_durable = None
        if qos == 1:
            on_durable = self._call_on_loop(
                self._mqtt_ack(conn, writer, PUBACK, pid))
        self._on_frame(conn, payload, tenant, binary=False,
                       on_durable=on_durable,
                       on_shed=self._mqtt_shed(conn, writer))

    def _qos2_release(self, conn: _Conn, writer, pid: int,
                      parked: tuple[str, bytes]) -> None:
        """Exactly-once second half: a PUBREL released the parked frame.
        The pid is tracked in ``qos2_inflight`` until its outcome settles:

        * staged + durable -> PUBCOMP, pid forgotten (later PUBRELs are
          true duplicates and just re-complete);
        * shed at admission or arena stall -> PUBCOMP withheld and the
          payload goes BACK to the parked map, so the client's PUBREL
          retransmission re-releases it through admission. A PUBCOMP can
          therefore never complete a frame that was not ingested.
        """
        from sitewhere_tpu_torch.ingest.mqtt import PUBCOMP

        tenant, payload = parked
        conn.qos2_inflight.add(pid)
        comp = self._mqtt_ack(conn, writer, PUBCOMP, pid)

        def done() -> None:
            conn.qos2_inflight.discard(pid)
            comp()

        def reoffer(err: ShedError) -> None:
            # admission shed runs on the loop thread, arena stall on the
            # flusher thread — marshal so every qos2 map mutation happens
            # on the loop thread (same thread as the PUBREL handler)
            def _repark() -> None:
                conn.qos2_inflight.discard(pid)
                conn.qos2_parked.setdefault(pid, (tenant, payload))
            try:
                self._loop.call_soon_threadsafe(_repark)
            except RuntimeError:
                pass             # loop closed mid-teardown

        self._on_frame(conn, payload, tenant, binary=False,
                       on_durable=self._call_on_loop(done),
                       on_shed=reoffer)

    def _mqtt_ack(self, conn: _Conn, writer, ptype: int, pid: int):
        from sitewhere_tpu_torch.ingest.mqtt import encode_packet

        def send() -> None:
            if not conn.alive:
                return
            try:
                writer.write(encode_packet(ptype, 0, pid.to_bytes(2, "big")))
                conn.acked += 1
            except Exception:
                pass
        return send

    def _mqtt_shed(self, conn: _Conn, writer):
        """MQTT 3.1.1 has no NACK: backpressure = withhold the PUBACK so
        the sender's in-flight window stalls, and (by default) disconnect
        so its redelivery loop backs off before re-offering with DUP."""
        def on_shed(err: ShedError) -> None:
            if self.cfg.shed_disconnect and conn.alive:
                conn.alive = False
                loop = self._loop

                def _close():
                    try:
                        writer.close()
                    except Exception:
                        pass
                loop.call_soon_threadsafe(_close)
        return on_shed

    # -------------------------------------------------------- SWP server
    async def _handle_swp(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        conn = self._register(writer, "swp")
        try:
            line = await asyncio.wait_for(reader.readline(),
                                          self.cfg.handshake_timeout_s)
            parts = line.split()
            if (len(parts) != 3 or parts[0] != SWP_MAGIC
                    or parts[2] not in (b"json", b"binary")):
                self._count_invalid()
                writer.write(self._swp_rec(SWP_ERR, self.cfg.max_frame_bytes))
                await writer.drain()
                return
            conn.tenant = parts[1].decode()
            conn.binary = parts[2] == b"binary"
            while True:
                hdr = await asyncio.wait_for(reader.readexactly(4),
                                             self.cfg.idle_timeout_s)
                (length,) = struct.unpack("!I", hdr)
                if length == 0:
                    # flush hint: drain this connection's shard promptly
                    batcher = self.batchers[conn.shard]
                    self._loop.run_in_executor(None, batcher.flush)
                    continue
                if length > self.cfg.max_frame_bytes:
                    self._count_invalid()
                    writer.write(self._swp_rec(SWP_ERR,
                                               self.cfg.max_frame_bytes))
                    await writer.drain()
                    return
                payload = await reader.readexactly(length)
                self._swp_frame(conn, writer, payload)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                ConnectionError):
            pass
        finally:
            self._unregister(conn)
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    def _swp_rec(code: int, value: int) -> bytes:
        return struct.pack("!BI", code, value & 0xFFFFFFFF)

    def _swp_frame(self, conn: _Conn, writer, payload: bytes) -> None:
        def ack() -> None:
            if not conn.alive:
                return
            conn.acked += 1
            try:
                writer.write(self._swp_rec(SWP_ACK, conn.acked))
            except Exception:
                pass

        def shed(err: ShedError) -> None:
            retry_ms = int(max(0.0, err.retry_after_s) * 1000)

            def _send():
                if not conn.alive:
                    return
                try:
                    writer.write(self._swp_rec(SWP_SHED, retry_ms))
                except Exception:
                    pass
            self._loop.call_soon_threadsafe(_send)

        self._on_frame(conn, payload, conn.tenant, binary=conn.binary,
                       on_durable=self._call_on_loop(ack), on_shed=shed)

    # -------------------------------------------------- websocket server
    async def _handle_ws(self, ws) -> None:
        """Websocket frames ride the SWP contract: first message is the
        handshake line, every further message is one frame; acks and shed
        codes come back as binary messages."""
        writer = _WsWriter(ws, self._loop)
        conn = self._register(writer, "ws")
        try:
            first = await asyncio.wait_for(ws.recv(),
                                           self.cfg.handshake_timeout_s)
            if isinstance(first, str):
                first = first.encode()
            parts = first.split()
            if (len(parts) != 3 or parts[0] != SWP_MAGIC
                    or parts[2] not in (b"json", b"binary")):
                self._count_invalid()
                await ws.send(self._swp_rec(SWP_ERR,
                                            self.cfg.max_frame_bytes))
                return
            conn.tenant = parts[1].decode()
            conn.binary = parts[2] == b"binary"
            async for message in ws:
                payload = (message.encode()
                           if isinstance(message, str) else message)
                if len(payload) > self.cfg.max_frame_bytes:
                    self._count_invalid()
                    await ws.send(self._swp_rec(SWP_ERR,
                                                self.cfg.max_frame_bytes))
                    return
                self._swp_frame(conn, writer, payload)
        except Exception:
            pass
        finally:
            self._unregister(conn)

    # ------------------------------------------------------------ reports
    def snapshot(self) -> dict[str, int]:
        """One internally consistent counter snapshot (edge lock), plus the
        shard batchers' totals — the conservation ledger's "wire" stage and
        the ``swtpu_wire_*`` exporter both read exactly this."""
        with self._lock:
            out = {
                "frames_received": self.frames_received,
                "frames_admitted": self.frames_admitted,
                "frames_shed": self.frames_shed,
                "frames_invalid": self.frames_invalid,
                "frames_duplicate": self.frames_duplicate,
                "backpressure_events": self.backpressure_events,
                "keepalive_timeouts": self.keepalive_timeouts,
                "connections_live": len(self._conns),
                "connections_peak": self.connections_peak,
                "connections_opened": self.connections_opened,
            }
        rows = stalled = pending = flushes = rows_sum = 0
        for b in self.batchers:
            c = b.counters()
            rows += c["rows_submitted"]
            stalled += c["frames_stalled"]
            pending += c["pending"]
            flushes += c["flushes"]
            rows_sum += c["flush_rows_sum"]
        out.update({
            "rows_submitted": rows,
            "frames_stalled": stalled,
            "pending": pending,
            "flushes": flushes,
            "flush_rows_sum": rows_sum,
            "flush_occupancy_pct": round(
                100.0 * rows_sum / (flushes * self.cfg.flush_rows), 1)
            if flushes else 0.0,
        })
        return out


class _WsWriter:
    """Duck-typed StreamWriter facade so websocket connections share the
    SWP frame/ack path. ``write`` schedules the async send; ``close``
    schedules the websocket close."""

    def __init__(self, ws, loop):
        self._ws = ws
        self._loop = loop

    def write(self, data: bytes) -> None:
        # only ever called on the event-loop thread (ack callbacks are
        # marshalled there via call_soon_threadsafe)
        asyncio.ensure_future(self._send(bytes(data)))

    async def _send(self, data: bytes) -> None:
        try:
            await self._ws.send(data)
        except Exception:
            pass

    def close(self) -> None:
        asyncio.ensure_future(self._ws.close())


def aggregate_wire_snapshot(engine) -> dict[str, Any] | None:
    """Combine the snapshots of every edge attached to ``engine`` — the
    shape the conservation ledger, the REST status route, and the scrape
    exporter share. None when no edge is (or ever was) attached.

    Counters sum; the two non-additive fields get their own rules:
    ``connections_peak`` is a max (per-edge peaks are not concurrent),
    and ``flush_occupancy_pct`` is recomputed as a flush-capacity-weighted
    mean (total flushed rows over total flush capacity) — summing
    percentages would report 160% for two edges at 80%."""
    edges = getattr(engine, "wire_edges", None)
    if not edges:
        return None
    total: dict[str, Any] = {}
    rows_sum = cap_sum = 0
    for edge in list(edges):
        snap = edge.snapshot()
        rows_sum += snap.get("flush_rows_sum", 0)
        cap_sum += snap.get("flushes", 0) * edge.cfg.flush_rows
        for key, val in snap.items():
            if key == "connections_peak":
                total[key] = max(total.get(key, 0), val)
            elif key == "flush_occupancy_pct":
                continue
            else:
                total[key] = total.get(key, 0) + val
    total["flush_occupancy_pct"] = (
        round(100.0 * rows_sum / cap_sum, 1) if cap_sum else 0.0)
    return total
