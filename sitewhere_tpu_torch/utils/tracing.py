"""Tracing / profiling hooks + the hierarchical span plane (port of
``sitewhere_tpu/utils/tracing.py``).

The reference defers tracing to the Istio mesh and measures stages with
Prometheus histograms (SURVEY.md §5.1). Here: lightweight host-side stage
spans feeding the metrics histograms, a wrapper around the PyTorch
profiler for device traces (a Chrome trace, viewable in Perfetto), and the
``traceparent`` context that the flight recorder (utils/flight.py) and
the cluster RPC use to follow one batch across ranks (the Dapper-style
trace-context propagation the reference gets from Istio headers).

Trace ids are W3C-traceparent shaped (``00-<32 hex>-<16 hex>-01``) so a
future OTLP exporter can forward them unchanged. The CURRENT traceparent
lives in a :mod:`contextvars` variable — per-thread AND per-asyncio-task,
so the RPC server can bind it around a handler without cross-talk between
multiplexed calls.

Span plane — three layers, one trace-id namespace:

* :class:`SpanTracer` — a fixed-size, lock-light ring of completed
  :class:`Span` records, one tracer per engine (exactly like the flight
  recorder). Spans carry trace id, span id, parent span id, rank, thread
  and tags. Sampling is HEAD-based and seeded-deterministic (a pure hash
  of the trace id decides at span end, so all of one trace's spans agree)
  with a TAIL-based always-keep for the slowest decile of each span name
  — a latency outlier survives even at aggressive sample rates.
* Timeline export — :func:`timeline_events` converts this rank's view of
  one trace (live tracer spans PLUS spans derived from flight-recorder
  lifecycle records, whose stage marks already timestamp
  decode→WAL→dispatch→device at zero extra hot-path cost) into
  Chrome-trace-event JSON that loads directly in Perfetto /
  chrome://tracing. ``pid`` is the rank, so the cluster facade can
  stitch per-rank event lists into ONE multi-rank timeline.
* :func:`profile_threads` — a wall-clock sampling profiler over the
  named engine threads (WAL commit thread, replica senders, forward
  retry pump, decode workers, ...), folded-stack output
  (flamegraph.pl-compatible); :func:`debug_bundle` snapshots config,
  recent flights, slowest traces, metrics exposition and
  WAL/archive/replication/QoS posture into one JSON document.

None of this touches ``engine.metrics()`` — the dispatch-shape equality
pin stays intact; span state lives on the tracer only.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
import zlib

from sitewhere_tpu_torch.utils.metrics import REGISTRY

_STAGE_HIST = REGISTRY.histogram(
    "swtpu_stage_seconds", "host pipeline stage latency"
)

_local = threading.local()

# ------------------------------------------------------------ traceparent
_TRACEPARENT: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "swtpu_traceparent", default=None)
_SPAN_SEQ = itertools.count(1)


def new_trace_id(rank: int = 0) -> str:
    """A 32-hex trace id: rank + wall-clock ns + in-process sequence —
    unique across ranks and restarts without coordination (the forward-id
    recipe of parallel/cluster._next_fid, in W3C shape)."""
    return (f"{rank & 0xFFFF:04x}"
            f"{time.time_ns() & 0xFFFFFFFFFFFFFFFF:016x}"
            f"{next(_SPAN_SEQ) & 0xFFFFFFFFFFFF:012x}")


def new_traceparent(rank: int = 0, trace_id: str | None = None) -> str:
    """A W3C-style traceparent header value for a (possibly new) trace."""
    tid = trace_id or new_trace_id(rank)
    span = f"{(next(_SPAN_SEQ) ^ (rank << 48)) & 0xFFFFFFFFFFFFFFFF:016x}"
    return f"00-{tid}-{span}-01"


def trace_id_of(traceparent: str | None) -> str | None:
    """The 32-hex trace id inside a traceparent; None on malformed input
    (a peer shipping garbage must not poison the recorder index)."""
    if not traceparent:
        return None
    parts = traceparent.split("-")
    if len(parts) >= 2 and len(parts[1]) == 32:
        return parts[1]
    return None


def current_traceparent() -> str | None:
    """The traceparent bound to this thread/task, or None."""
    return _TRACEPARENT.get()


@contextlib.contextmanager
def bind_traceparent(traceparent: str | None):
    """Bind ``traceparent`` for the enclosed block (no-op on None, so an
    unpropagated call keeps whatever context it inherited)."""
    if traceparent is None:
        yield
        return
    token = _TRACEPARENT.set(traceparent)
    try:
        yield
    finally:
        _TRACEPARENT.reset(token)


@contextlib.contextmanager
def stage(name: str, **labels):
    """Span for one pipeline stage; nests (child spans record their own
    stage label), observations land in the shared histogram."""
    t0 = time.perf_counter()
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()
        _STAGE_HIST.observe(time.perf_counter() - t0, stage=name, **labels)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and, on a CUDA build, the
    card) of the enclosed block and write it as a Chrome trace file,
    ``trace.json``, under ``log_dir``."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Decorator: trace a function as a stage span + a profiler range
    (``torch.profiler.record_function``)."""
    import functools

    import torch

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with stage(name), torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


# ==========================================================================
# Span plane
# ==========================================================================

# monotonic -> wall-clock anchor, taken ONCE at import: spans stamp cheap
# perf_counter_ns on the hot path and the exporter adds the anchor, so
# every span of a process shares one consistent clock (flight records
# anchor per record with time.time(); both land on the same wall axis)
_WALL_ANCHOR_NS = time.time_ns() - time.perf_counter_ns()


def _wall_us(perf_ns: int) -> float:
    return (perf_ns + _WALL_ANCHOR_NS) / 1000.0


class Span:
    """One completed (or in-flight) traced operation. ``t0_ns``/``t1_ns``
    are perf_counter_ns stamps; ``end()`` closes the span through its
    tracer (which applies the sampling verdict). Usable as a context
    manager: ``with tracer.begin("forward.hop", dst=3): ...``."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "rank",
                 "thread", "t0_ns", "t1_ns", "tags", "_tracer")

    def __init__(self, trace_id: str, span_id: str, parent_id: str | None,
                 name: str, rank: int, thread: str, t0_ns: int,
                 tags: dict | None, tracer: "SpanTracer | None"):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.rank = rank
        self.thread = thread
        self.t0_ns = t0_ns
        self.t1_ns = None
        self.tags = tags or {}
        self._tracer = tracer

    def annotate(self, **tags) -> None:
        self.tags.update(tags)

    def end(self, **tags) -> None:
        if tags:
            self.tags.update(tags)
        if self._tracer is not None:
            self._tracer.end(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.tags.setdefault("error", repr(exc))
        self.end()

    @property
    def dur_us(self) -> float:
        t1 = self.t1_ns if self.t1_ns is not None else time.perf_counter_ns()
        return max(0.0, (t1 - self.t0_ns) / 1000.0)

    def to_dict(self) -> dict:
        return {"traceId": self.trace_id, "spanId": self.span_id,
                "parentId": self.parent_id, "name": self.name,
                "rank": self.rank, "thread": self.thread,
                "startUs": round(_wall_us(self.t0_ns), 1),
                "durUs": round(self.dur_us, 1),
                "tags": dict(self.tags)}


class _NullSpan:
    """No-op span handed out while the tracer is disabled or sampling
    dropped the trace at begin() — hot paths stay branch-free."""

    trace_id = None
    span_id = None
    parent_id = None
    tags: dict = {}

    def annotate(self, **tags) -> None:
        pass

    def end(self, **tags) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass

    def to_dict(self) -> dict:
        return {}


NULL_SPAN = _NullSpan()


class SpanTracer:
    """Fixed-capacity ring of completed spans with a trace-id index —
    the span-level sibling of utils/flight.FlightRecorder.

    Head-based sampling is a seeded pure hash of the TRACE id (``sample``
    = keep fraction): deterministic, coordination-free, and consistent
    across every span (and every rank — same seed) of one trace. The
    tail-keep pass overrides a head-drop for spans in the slowest decile
    of their name's recent duration distribution, so the records an
    operator actually hunts (the p99 outliers) always survive. Both
    verdicts apply at ``end()``; begin/annotate are dict writes under the
    GIL, and the ring lock covers only slot insertion."""

    TAIL_WINDOW = 128          # recent durations kept per span name
    TAIL_REFRESH = 32          # recompute the decile threshold every N

    def __init__(self, capacity: int = 4096, rank: int = 0,
                 enabled: bool = True, sample: float = 1.0, seed: int = 0):
        if capacity < 1:
            raise ValueError("span tracer needs capacity >= 1")
        self.capacity = capacity
        self.rank = rank
        self.enabled = enabled
        self.sample = float(sample)
        self.seed = int(seed)
        self._ring: list[Span | None] = [None] * capacity
        self._head = 0
        self._by_id: dict[str, list[Span]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        # per-name tail-keep state: (recent durations us, cached p90,
        # observations since refresh) — mutated under the GIL only; a
        # stale threshold costs one extra kept/dropped span, never a crash
        self._tail: dict[str, list] = {}
        self.recorded = 0          # spans inserted into the ring
        self.sampled_out = 0       # spans dropped by the head+tail verdict
        self.dropped = 0           # ring evictions

    # ---------------------------------------------------------- sampling
    def head_sampled(self, trace_id: str | None) -> bool:
        """Deterministic head-based verdict for one trace id."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0 or not trace_id:
            return False
        h = zlib.crc32(trace_id.encode()) ^ (self.seed * 0x9E3779B1
                                             & 0xFFFFFFFF)
        return ((h & 0xFFFFFFFF) / 2**32) < self.sample

    def _tail_keep(self, name: str, dur_us: float) -> bool:
        """True when ``dur_us`` lands in the slowest decile of this span
        name's recent distribution (always True until enough history)."""
        st = self._tail.get(name)
        if st is None:
            st = self._tail[name] = [[], None, 0]
        window, p90, since = st
        window.append(dur_us)
        if len(window) > self.TAIL_WINDOW:
            del window[:len(window) - self.TAIL_WINDOW]
        st[2] = since + 1
        if p90 is None or st[2] >= self.TAIL_REFRESH:
            srt = sorted(window)
            p90 = st[1] = srt[max(0, (len(srt) * 9) // 10 - 1)]
            st[2] = 0
        if len(window) < 16:
            return True            # not enough history to call a decile
        # STRICT: a uniform distribution (every duration == p90) must not
        # defeat head-sampling by tail-keeping everything
        return dur_us > p90

    # ------------------------------------------------------------ record
    def begin(self, name: str, traceparent: str | None = None,
              trace_id: str | None = None, parent_id: str | None = None,
              **tags) -> Span | _NullSpan:
        """Open a span. Trace id resolution: explicit ``trace_id``, then
        ``traceparent`` (explicit or the bound context's), then a fresh
        id. Parent defaults to this thread's innermost open span."""
        if not self.enabled:
            return NULL_SPAN
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        tid = trace_id or trace_id_of(traceparent or current_traceparent())
        if stack:
            # nested span: inherit the enclosing span's trace (and
            # parent) unless the caller pinned them explicitly
            if tid is None:
                tid = stack[-1].trace_id
            if parent_id is None:
                parent_id = stack[-1].span_id
        if tid is None:
            tid = new_trace_id(self.rank)
        span = Span(tid, f"{next(_SPAN_SEQ) & 0xFFFFFFFFFFFFFFFF:016x}",
                    parent_id, name, self.rank,
                    threading.current_thread().name,
                    time.perf_counter_ns(), tags, self)
        stack.append(span)
        return span

    def end(self, span: Span) -> None:
        span.t1_ns = time.perf_counter_ns()
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack is not None:
            try:
                stack.remove(span)
            except ValueError:
                pass               # ended on a different thread — fine
        # short-circuit like record(): at sample=1.0 (the default) the
        # head verdict keeps everything and the tail-window bookkeeping
        # (append/trim/periodic sort) would be pure wasted hot-path work
        if self.head_sampled(span.trace_id) \
                or self._tail_keep(span.name, span.dur_us):
            self._insert(span)
        else:
            self.sampled_out += 1

    def record(self, name: str, t0_ns: int, t1_ns: int, *,
               trace_id: str | None, parent_id: str | None = None,
               thread: str | None = None, **tags) -> str | None:
        """Insert a retroactive span (explicit perf_counter_ns interval) —
        the seam for work measured on a thread that has no span context
        (shard decode workers, replica senders). Sampling applies exactly
        like end(). Returns the span id, or None when dropped/disabled."""
        if not self.enabled:
            return None
        tid = trace_id or new_trace_id(self.rank)
        span = Span(tid, f"{next(_SPAN_SEQ) & 0xFFFFFFFFFFFFFFFF:016x}",
                    parent_id, name, self.rank,
                    thread or threading.current_thread().name,
                    t0_ns, tags, None)
        span.t1_ns = t1_ns
        if self.head_sampled(tid) or self._tail_keep(name, span.dur_us):
            self._insert(span)
            return span.span_id
        self.sampled_out += 1
        return None

    def _insert(self, span: Span) -> None:
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
            self._ring[self._head] = span
            self._head = (self._head + 1) % self.capacity
            self._by_id.setdefault(span.trace_id, []).append(span)
            self.recorded += 1

    # ------------------------------------------------------------- query
    def spans_of(self, trace_id: str) -> list[dict]:
        with self._lock:
            spans = list(self._by_id.get(trace_id, ()))
        return [s.to_dict() for s in spans]

    def recent(self, limit: int = 100, name: str | None = None) -> list[dict]:
        out = []
        with self._lock:
            i = (self._head - 1) % self.capacity
            for _ in range(self.capacity):
                s = self._ring[i]
                if s is not None and (name is None or s.name == name):
                    out.append(s)
                    if len(out) >= limit:
                        break
                i = (i - 1) % self.capacity
        return [s.to_dict() for s in out]

    def __len__(self) -> int:
        with self._lock:
            return sum(1 for s in self._ring if s is not None)


# --------------------------------------------------------------------------
# Chrome-trace-event timeline export
# --------------------------------------------------------------------------

# flight-record stage marks -> child-span intervals, per record kind.
# Each entry: (span name, start stage or None for record start, end
# stage[, require stage]). Stages a record never visited produce no
# span (same tolerance as utils/flight.stage_durations); an entry with
# a 4th element only applies to records that visited the require stage
# — the SPMD ingest path marks "route" between WAL append and the arena
# scatter (decode -> wal_append -> route -> arena_fill -> commit), so
# its spans key on it, while the single-chip entries self-suppress on
# SPMD records because their start refs resolve AFTER their ends.
# An SPMD record's root event also carries the dispatch skew tags
# ("shard_rows", "skew") the router stamps per dispatch — the Perfetto
# straggler-attribution breadcrumbs.
_FLIGHT_SPANS = {
    "ingest": (("decode", None, "decode"),
               ("arena_fill", "decode", "arena_fill"),
               ("wal_append", ("arena_fill", "decode"), "wal_append"),
               ("commit", ("wal_append", "arena_fill", "decode"), "commit"),
               ("spmd.wal", "decode", "wal_append", "route"),
               ("spmd.route", ("wal_append", "decode"), "route", "route"),
               ("spmd.scatter", "route", "arena_fill", "route"),
               ("spmd.commit", "arena_fill", "commit", "route"),
               ("wal_gate", "commit", "wal_durable"),
               ("dispatch_wait", ("wal_durable", "commit"), "dispatch"),
               ("device", "dispatch", "device_ready"),
               ("readback", "device_ready", "readback")),
    "query": (("lookup", None, "lookup"),
              ("device", "lookup", "device"),
              ("format", "device", "format"),
              ("archive_merge", "format", "archive")),
    "route": (("partition", None, "commit"),
              ("forward", "commit", "dispatch")),
}


def _flight_events(record: dict) -> list[dict]:
    """One flight record -> chrome trace events: a root X event spanning
    the whole lifecycle plus one child X event per visited stage
    interval. The record's ``stagesUs`` offsets are monotonic
    microseconds from ``startedMs`` (wall)."""
    stages = record.get("stagesUs") or {}
    base_us = record.get("startedMs", 0) * 1000.0
    kind = record.get("kind", "ingest")
    rank = record.get("rank", 0)
    tid = f"flight:{kind}"
    args = {k: v for k, v in record.items()
            if k not in ("stagesUs",) and not isinstance(v, (dict, list))}
    end = max(stages.values(), default=0.0)
    events = [{"name": kind, "cat": "flight", "ph": "X",
               "ts": base_us, "dur": end, "pid": rank, "tid": tid,
               "args": args}]

    def resolve(ref):
        if ref is None:
            return 0.0
        if isinstance(ref, tuple):
            for r in ref:
                v = stages.get(r)
                if v is not None:
                    return v
            return None
        return stages.get(ref)

    for entry in _FLIGHT_SPANS.get(kind, ()):
        name, start_ref, end_ref = entry[:3]
        if len(entry) > 3 and entry[3] not in stages:
            continue        # span only for records that visited the gate
        t1 = stages.get(end_ref)
        if t1 is None:
            continue
        t0 = resolve(start_ref)
        if t0 is None or t1 < t0:
            continue
        events.append({"name": f"{kind}.{name}", "cat": "flight",
                       "ph": "X", "ts": base_us + t0, "dur": t1 - t0,
                       "pid": rank, "tid": tid,
                       "args": {"traceId": record.get("traceId")}})
    return events


def _span_event(d: dict) -> dict:
    return {"name": d["name"], "cat": "span", "ph": "X",
            "ts": d["startUs"], "dur": d["durUs"], "pid": d["rank"],
            "tid": d.get("thread") or "span",
            "args": {"traceId": d["traceId"], "spanId": d["spanId"],
                     "parentId": d["parentId"], **d.get("tags", {})}}


def timeline_events(engine, trace_id: str) -> list[dict]:
    """This rank's Chrome-trace events for one trace id: flight-recorder
    lifecycle records (decode/WAL/dispatch/device intervals, derived at
    export time — the ingest hot path pays nothing new) merged with the
    live spans the tracer recorded (forward hops, replica send/apply,
    shard decode, query rounds, scheduler fires)."""
    events: list[dict] = []
    flight = getattr(engine, "flight", None)
    if flight is not None:
        for rec in flight.records_of(trace_id):
            events.extend(_flight_events(rec))
    tracer = getattr(engine, "tracer", None)
    if tracer is not None:
        events.extend(_span_event(d) for d in tracer.spans_of(trace_id))
    return events


def finish_timeline(trace_id: str, events: list[dict]) -> dict:
    """Wrap merged per-rank events into the document Perfetto loads
    directly: process metadata names each rank, threads sort stably, and
    events order by timestamp. String ``tid``/``pid`` values are mapped
    to stable small ints (chrome://tracing requires numerics) with
    ``thread_name``/``process_name`` metadata carrying the labels."""
    pids = sorted({e.get("pid", 0) for e in events}, key=str)
    pid_no = {p: i for i, p in enumerate(pids)}
    tid_no: dict[tuple, int] = {}
    out: list[dict] = []
    for p in pids:
        out.append({"name": "process_name", "ph": "M", "pid": pid_no[p],
                    "tid": 0, "args": {"name": f"rank {p}"}})
    for e in sorted(events, key=lambda e: e.get("ts", 0)):
        key = (e.get("pid", 0), str(e.get("tid", "span")))
        n = tid_no.get(key)
        if n is None:
            n = tid_no[key] = len([k for k in tid_no if k[0] == key[0]]) + 1
            out.append({"name": "thread_name", "ph": "M",
                        "pid": pid_no[key[0]], "tid": n,
                        "args": {"name": key[1]}})
        e = dict(e)
        e["pid"] = pid_no[key[0]]
        e["tid"] = n
        out.append(e)
    return {"traceId": trace_id, "displayTimeUnit": "ms",
            "traceEvents": out}


# --------------------------------------------------------------------------
# Wall-clock sampling thread profiler
# --------------------------------------------------------------------------

def _fold_frame(frame) -> list[str]:
    """One thread's stack, root-first, as ``module.function`` entries."""
    parts: list[str] = []
    while frame is not None:
        code = frame.f_code
        mod = frame.f_globals.get("__name__", "?")
        parts.append(f"{mod}.{code.co_name}")
        frame = frame.f_back
    parts.reverse()
    return parts


def profile_threads(seconds: float, interval_s: float = 0.01,
                    thread_filter=None) -> dict:
    """Sample every live thread's Python stack for ``seconds`` at
    ``interval_s`` cadence and fold the samples per thread name —
    ``{"thread;root;...;leaf": count}`` plus the flamegraph.pl-compatible
    text (``folded``). Pure wall-clock observation: no sys.settrace, no
    interpreter slowdown beyond the sampling thread's own GIL turns, so
    it is safe to point at a production engine. ``thread_filter`` (a
    predicate over thread names) narrows to specific engine threads; the
    sampling thread itself is always excluded."""
    import sys
    from collections import Counter

    me = threading.get_ident()
    counts: Counter = Counter()
    samples = 0
    deadline = time.perf_counter() + max(0.0, seconds)
    while True:
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            name = names.get(ident, f"tid-{ident}")
            if thread_filter is not None and not thread_filter(name):
                continue
            counts[";".join([name] + _fold_frame(frame))] += 1
        samples += 1
        remaining = deadline - time.perf_counter()
        if remaining <= 0:
            break
        time.sleep(min(interval_s, remaining))
    folded = "\n".join(f"{stack} {n}" for stack, n
                       in sorted(counts.items()))
    return {"seconds": seconds, "intervalS": interval_s,
            "samples": samples, "threads": sorted(
                {s.split(";", 1)[0] for s in counts}),
            "stacks": dict(counts), "folded": folded}


# --------------------------------------------------------------------------
# Debug bundle
# --------------------------------------------------------------------------

def _slowest_traces(engine, top: int = 8) -> list[dict]:
    """The slowest completed ingest lifecycles currently in the flight
    ring, each with its rank-local timeline — the offline-triage payload
    scripts/trace2perfetto.py converts."""
    flight = getattr(engine, "flight", None)
    if flight is None:
        return []
    done = []
    for rec in flight.recent(limit=flight.capacity, kind="ingest"):
        end = (rec.get("stagesUs") or {}).get("device_ready")
        if end is not None and rec.get("traceId"):
            done.append((end, rec))
    done.sort(key=lambda t: -t[0])
    out = []
    for e2e_us, rec in done[:top]:
        tid = rec["traceId"]
        out.append({"traceId": tid, "e2eMs": round(e2e_us / 1000.0, 3),
                    "tenant": rec.get("tenant"),
                    "events": timeline_events(engine, tid)})
    return out


def debug_bundle(engine) -> dict:
    """One self-contained JSON document for offline triage: config,
    host/device counters, the strict-0.0.4 metrics exposition, recent
    flight records, the slowest traces (with rank-local timelines),
    recent spans, and WAL/archive/replication/forward/QoS posture.
    Everything here is a read-side snapshot — no engine lock is taken
    beyond what the individual surfaces already take."""
    import dataclasses

    from sitewhere_tpu_torch.utils.metrics import (REGISTRY,
                                             export_engine_metrics)

    bundle: dict = {
        "generatedMs": int(time.time() * 1000),
        "rank": getattr(engine, "rank", 0),
    }
    cfg = getattr(engine, "config", None)
    if cfg is not None and dataclasses.is_dataclass(cfg):
        bundle["config"] = dataclasses.asdict(cfg)
    try:
        export_engine_metrics(engine)
        bundle["prometheus"] = REGISTRY.expose_text()   # strict 0.0.4,
        #                                                 no exemplars
    except Exception as e:                # a scrape failure must not
        bundle["prometheus"] = None       # take the bundle down with it
        bundle["prometheusError"] = repr(e)
    try:
        bundle["metrics"] = engine.metrics()
    except Exception as e:
        bundle["metrics"] = {"error": repr(e)}
    flight = getattr(engine, "flight", None)
    if flight is not None:
        bundle["flights"] = flight.recent(64)
        bundle["flightDropped"] = flight.dropped
    bundle["slowestTraces"] = _slowest_traces(engine)
    tracer = getattr(engine, "tracer", None)
    if tracer is not None:
        bundle["spans"] = tracer.recent(128)
        bundle["spanStats"] = {"recorded": tracer.recorded,
                               "sampledOut": tracer.sampled_out,
                               "dropped": tracer.dropped,
                               "capacity": tracer.capacity,
                               "sample": tracer.sample}
    wal = getattr(engine, "wal", None)
    if wal is not None:
        bundle["wal"] = {"groupCommit": wal.group_commit,
                         "fsyncs": getattr(wal, "fsyncs", None),
                         "commitGroups": getattr(wal, "commit_groups",
                                                 None)}
    arch = getattr(engine, "archive", None)
    if arch is not None:
        bundle["archive"] = {
            **arch.disk_usage(),
            "rows": arch.total_rows(),
            "lostRows": arch.lost_rows,
            "expiredRows": arch.expired_rows,
            "corruptSegments": arch.corrupt_segments,
            "queries": arch.queries,
            "plannerCalls": arch.planner_calls,
        }
    try:
        from sitewhere_tpu_torch.parallel.replication import (
            cluster_health_payload)

        bundle["replication"] = cluster_health_payload(engine)
    except Exception:
        pass
    fq = getattr(engine, "forward_queue", None)
    if fq is not None:
        bundle["forward"] = fq.metrics()
    # elastic placement: the installed map epoch, per-range handoff
    # state, and the guard counters
    pm = getattr(engine, "placement", None)
    if pm is not None:
        try:
            bundle["placement"] = pm.payload()
        except Exception as e:
            bundle["placement"] = {"error": repr(e)}
    qos = getattr(engine, "qos", None)
    if qos is not None:
        bundle["qos"] = {"shedThreshold": qos.shed_threshold,
                         "bucketFill": qos.bucket_fill()}
    # conservation plane: the rank-local flow ledger +
    # verdict — one bundle answers "where are my events" without
    # another round trip. Never takes the bundle down with it.
    try:
        from sitewhere_tpu_torch.utils.conservation import conservation_payload

        bundle["conservation"] = conservation_payload(engine)
    except Exception as e:
        bundle["conservation"] = {"error": repr(e)}
    # shard heat & skew plane: per-shard flow, the heat maps, and the
    # skew posture — a non-SPMD engine answers {"spmd": False}. Never
    # takes the bundle down with it.
    try:
        from sitewhere_tpu_torch.utils.shardobs import spmd_heat_payload

        bundle["spmd"] = spmd_heat_payload(engine)
    except Exception as e:
        bundle["spmd"] = {"error": repr(e)}
    # device plane: the memory-ledger breakdown (a PEEK —
    # high-watermarks stay armed for the next scrape) plus per-family
    # compile posture, so one bundle answers "what is resident and what
    # has been retracing" without another round trip
    try:
        from sitewhere_tpu_torch.utils.devicewatch import device_memory_payload

        bundle["device"] = device_memory_payload(engine)
    except Exception as e:          # never take the bundle down with it
        bundle["device"] = {"error": repr(e)}
    return bundle
