"""Flight recorder: fixed-size, lock-light ring of batch-lifecycle records
(a copy of ``sitewhere_tpu/utils/flight.py``).

The reference reconstructs a message's journey from Istio/Zipkin spans and
per-stage Prometheus histograms (SURVEY.md §5.1); the engine's
batch path is a single process, so a hosted tracer would cost more than
the stages it measures. Instead every ingest batch gets ONE preallocated
record slot carrying monotonic timestamps for each lifecycle stage:

    ingest -> decode -> arena fill -> WAL append -> commit -> dispatch
           -> device-ready -> readback

``device_ready`` is harvested opportunistically, only where the host has
already observed the work complete: a CUDA launch returns at once, so a
mark at enqueue would read as a zero device time. The engine stamps it
at the dispatch-depth wait (the fence it synchronizes on), at the arena
recycle (ingest/arena.ArenaPool, whose ticket is the dispatch's CUDA
event), and ``drain()`` backfills it with ``readback`` for records no
wait observed first — none of them adds a host<->device sync. Records are dicts + a couple of lists —
marking a stage is one monotonic clock read and one dict store under the
GIL, no lock on the hot path (the ring lock covers only slot allocation
and index maintenance).

Trace ids are W3C-shaped (utils/tracing.py) and shared across ranks: a
forwarded sub-batch's owner-side record carries the SAME trace id as the
sender's, so ``get_trace(<id>)`` resolves the full cross-rank journey
from any rank once a cluster fans it out.
"""

from __future__ import annotations

import threading
import time

from sitewhere_tpu_torch.utils.tracing import new_trace_id, trace_id_of

# canonical stage ordering for rendering (records carry only the stages
# their path actually visited). ``wal_durable`` is the group-commit
# durability watermark: the moment the dispatch gate observed the
# batch's WAL records fsync'd.
STAGE_ORDER = ("decode", "arena_fill", "wal_append", "commit",
               "wal_durable", "dispatch", "device_ready", "readback")

# read-path lifecycle (kind="query" records): id resolution under the
# engine lock, the coalesced device program (including any wait to join a
# micro-batch), then host-side row formatting — all outside the lock
QUERY_STAGE_ORDER = ("lookup", "device", "format", "archive")


def query_stage_durations(stages_us: dict) -> dict:
    """Per-stage DURATIONS (ms) for one query record — the read-path
    sibling of :func:`stage_durations`, shared by bench.py's query
    breakdown so "device time" always means the same interval:

      lookup_ms   start -> lookup (mirror sync + string->id resolution,
                  the only part that holds the engine lock)
      device_ms   lookup -> device (coalesce wait + fused program +
                  result readback)
      format_ms   device -> format (host row formatting)

    Stages a record never visited yield None."""
    def delta(a, b):
        if a is None or b is None:
            return None
        return max(0.0, (b - a) / 1000.0)

    return {
        "lookup_ms": delta(0.0, stages_us.get("lookup")),
        "device_ms": delta(stages_us.get("lookup"),
                           stages_us.get("device")),
        "format_ms": delta(stages_us.get("device"),
                           stages_us.get("format")),
    }


def stage_durations(stages_us: dict) -> dict:
    """Per-stage DURATIONS (ms) from one record's cumulative ``stagesUs``
    offsets — the shared harvesting rule behind bench.py's per-stage
    breakdown and the stage-time autotuner, so both always agree on what
    "decode time" means:

      decode_ms        start -> decode mark (the native scan)
      wal_ms           decode/arena_fill -> wal_append (framing + buffer
                       or inline flush)
      dispatch_wait_ms commit -> dispatch (arena fill residency, the
                       durability gate, and any dispatch-depth wait)
      device_ms        dispatch -> device_ready (transfer + step)

    Stages a record never visited yield None."""
    def delta(a, b):
        if a is None or b is None:
            return None
        return max(0.0, (b - a) / 1000.0)

    decode = stages_us.get("decode")
    wal_from = stages_us.get("arena_fill", decode)
    return {
        "decode_ms": delta(0.0, decode),
        "wal_ms": delta(wal_from, stages_us.get("wal_append")),
        "dispatch_wait_ms": delta(stages_us.get("commit"),
                                  stages_us.get("dispatch")),
        "device_ms": delta(stages_us.get("dispatch"),
                           stages_us.get("device_ready")),
    }


class FlightRecord:
    """One batch's lifecycle. Stage marks are idempotent-overwrite (a
    multi-chunk ingest keeps the LAST completion per stage); ``meta``
    carries counts and path annotations."""

    __slots__ = ("trace_id", "kind", "tenant", "rank", "n_payloads",
                 "t0_unix_ms", "t0_ns", "stages", "meta", "harvested")

    def __init__(self, trace_id: str | None, kind: str, tenant: str,
                 rank: int, n_payloads: int):
        self.trace_id = trace_id
        self.kind = kind
        self.tenant = tenant
        self.rank = rank
        self.n_payloads = n_payloads
        self.t0_unix_ms = int(time.time() * 1000)
        self.t0_ns = time.perf_counter_ns()
        self.stages: dict[str, int] = {}
        self.meta: dict[str, object] = {}
        # consumed-once marker for the scrape-time SLO harvest (never
        # serialized; a record stays readable via recent()/records_of)
        self.harvested = False

    def mark(self, stage: str) -> None:
        self.stages[stage] = time.perf_counter_ns()

    def add(self, key: str, value) -> None:
        self.meta[key] = value

    def add_counts(self, summary: dict) -> None:
        for k in ("decoded", "failed", "staged", "spilled", "persisted"):
            v = summary.get(k)
            if v:
                self.meta[k] = v

    def to_dict(self) -> dict:
        """JSON-able view: per-stage offsets in microseconds from record
        creation (monotonic), plus identity and counts. Snapshots the
        stage dict first (C-level copy, atomic under the GIL): a scrape
        may read a record the ingest thread is still marking."""
        stages = dict(self.stages)
        meta = dict(self.meta)
        return {"traceId": self.trace_id, "kind": self.kind,
                "tenant": self.tenant, "rank": self.rank,
                "payloads": self.n_payloads, "startedMs": self.t0_unix_ms,
                "stagesUs": {name: round((ns - self.t0_ns) / 1000.0, 1)
                             for name, ns in stages.items()},
                **meta}


class _NullRecord:
    """No-op record handed out while the recorder is disabled — the hot
    path stays branch-free (mark/add are called unconditionally)."""

    trace_id = None
    stages: dict = {}
    meta: dict = {}

    def mark(self, stage: str) -> None:
        pass

    def add(self, key: str, value) -> None:
        pass

    def add_counts(self, summary: dict) -> None:
        pass

    def to_dict(self) -> dict:
        return {}


NULL_RECORD = _NullRecord()


class FlightRecorder:
    """Fixed-capacity ring of FlightRecords with a trace-id index.

    ``begin`` allocates a slot (evicting the oldest) under a short lock;
    everything after that is lock-free record mutation. ``bind`` exposes
    the batch's record to nested layers (the WAL append lives three
    frames below the ingest entry point) via a thread-local.
    """

    def __init__(self, capacity: int = 1024, rank: int = 0,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError("flight recorder needs capacity >= 1")
        self.capacity = capacity
        self.rank = rank
        self.enabled = enabled
        self._ring: list[FlightRecord | None] = [None] * capacity
        self._head = 0
        self._by_id: dict[str, list[FlightRecord]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self.dropped = 0    # records evicted before ever being read

    # ------------------------------------------------------------ record
    def begin(self, kind: str, tenant: str = "default", n_payloads: int = 0,
              traceparent: str | None = None) -> FlightRecord:
        """Start a record. ``traceparent`` (or the bound context's) names
        the trace this batch belongs to — a forwarded batch's owner-side
        record JOINS the sender's trace instead of opening a new one."""
        if not self.enabled:
            return NULL_RECORD
        tid = trace_id_of(traceparent) or new_trace_id(self.rank)
        rec = FlightRecord(tid, kind, tenant, self.rank, n_payloads)
        with self._lock:
            old = self._ring[self._head]
            if old is not None:
                peers = self._by_id.get(old.trace_id)
                if peers is not None:
                    try:
                        peers.remove(old)
                    except ValueError:
                        pass
                    if not peers:
                        del self._by_id[old.trace_id]
                self.dropped += 1
            self._ring[self._head] = rec
            self._head = (self._head + 1) % self.capacity
            self._by_id.setdefault(tid, []).append(rec)
        return rec

    def bind(self, rec):
        """Context manager making ``rec`` this thread's current record."""
        recorder = self

        class _Bind:
            def __enter__(self):
                self.prev = getattr(recorder._local, "rec", None)
                recorder._local.rec = rec
                return rec

            def __exit__(self, *exc):
                recorder._local.rec = self.prev

        return _Bind()

    def current(self) -> FlightRecord | _NullRecord:
        rec = getattr(self._local, "rec", None)
        return rec if rec is not None else NULL_RECORD

    # ------------------------------------------------------------- query
    def records_of(self, trace_id: str) -> list[dict]:
        with self._lock:
            recs = list(self._by_id.get(trace_id, ()))
        return [r.to_dict() for r in recs]

    def recent(self, limit: int = 50, kind: str | None = None) -> list[dict]:
        """Newest-first records (bounded by ``limit``). ``kind`` filters
        ("ingest", "query", ...) while scanning the WHOLE ring for
        matches — a burst of query records must not dilute an ingest-
        stage consumer's window (the autotuner steers by these) down to
        nothing before the limit is reached."""
        out = []
        with self._lock:
            i = (self._head - 1) % self.capacity
            for _ in range(self.capacity):
                rec = self._ring[i]
                if rec is not None and (kind is None or rec.kind == kind):
                    out.append(rec)
                    if len(out) >= limit:
                        break
                i = (i - 1) % self.capacity
        return [r.to_dict() for r in out]

    def harvest_completed(self, kind: str = "ingest",
                          terminal: str = "device_ready") -> list:
        """Records of ``kind`` whose ``terminal`` stage has been marked
        and that were never harvested before — marked-and-returned
        atomically under the ring lock, so the scrape-time SLO exporter
        observes every completed lifecycle EXACTLY once regardless of
        which scrape surface (local, federated, RPC) gets there first.
        Returns the live FlightRecord objects (the caller reads stage
        nanos directly; to_dict would round them to microseconds).

        The ring is the retention window: a record evicted between two
        scrapes is lost to the histogram — the SLO plane SAMPLES at
        scrape cadence, it is not an exact event count."""
        out = []
        with self._lock:
            for rec in self._ring:
                if (rec is not None and rec.kind == kind
                        and not rec.harvested and terminal in rec.stages):
                    rec.harvested = True
                    out.append(rec)
        return out

    def __len__(self) -> int:
        with self._lock:
            return sum(1 for r in self._ring if r is not None)

    def dump_error(self, logger) -> None:
        """Emit the recent lifecycle records on a pipeline error — the
        post-mortem the operator would otherwise reconstruct from logs."""
        try:
            import json

            recs = self.recent(16)
            logger.error("pipeline error — last %d flight records: %s",
                         len(recs), json.dumps(recs, default=str))
        except Exception:       # the dump must never mask the real error
            logger.exception("flight recorder dump failed")
