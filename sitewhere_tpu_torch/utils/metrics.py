"""Metrics: counters/gauges/histograms with Prometheus text exposition.

The reference creates Prometheus metrics through its framework — per-tenant
labeled counters (InboundEventSource.java:50-59, EventPersistenceMapper.java:
46-47) and histograms (DeviceLookupMapper.java:34-36,
DeviceStatePersistenceMapper.java:55-60) scraped from each microservice.
Here one in-process registry covers the host services, the engine exports
its device-side counters into it, and a scrape serves the standard text
format.

Port of ``sitewhere_tpu/utils/metrics.py``: the registry core (a copy),
the instruments and exporters of the planes the port has (query, archive,
analytics, SLO, QoS, rules, the memory half of the device plane, the
conservation ledger, the SPMD store, the cluster's forward hop, the
replica feed and placement) and the federated exposition. Series names
and label keys are the JAX package's, letter for letter. The port's
``REGISTRY`` is its own process-global object.
"""

from __future__ import annotations

import bisect
import itertools
import threading
import time
from typing import Iterator

# process-unique engine labels ("e0", "e1", ...) scoping one engine's
# series on the process-global registry — the SLO harvest (and anything
# else steering per-engine) writes under ``engine=<label>`` so
# in-process multi-engine tests and loopback cluster ranks can never
# read each other's tenants
_ENGINE_LABELS = itertools.count()


def next_engine_label() -> str:
    return f"e{next(_ENGINE_LABELS)}"

_DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0,
)

# log-bucketed ladder for end-to-end SLO latency (seconds): a 1-2.5-5
# decade scale from 1ms to 30s, wide enough that open-loop queueing
# delay under overload still lands in a finite bucket
E2E_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0,
)


# Prometheus text-format label escaping: backslash first (escaping the
# escapes), then quote and newline — a label value containing any of the
# three must not corrupt the line structure of the exposition
_LABEL_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _escape_label(value) -> str:
    s = str(value)
    if "\\" in s or '"' in s or "\n" in s:
        for raw, esc in _LABEL_ESCAPES.items():
            s = s.replace(raw, esc)
    return s


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _LabeledSeries:
    """Shared labeled-value storage behind Counter and Gauge. NOT a metric
    kind itself: Counter and Gauge expose disjoint APIs (a counter only
    increases; a gauge moves freely), so neither inherits the other."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def value(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def expose(self, exemplars: bool = False) -> Iterator[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.kind}"
        with self._lock:       # snapshot: a concurrent write mid-iteration
            items = sorted(self._values.items())
        for key, val in items:
            yield f"{self.name}{_fmt_labels(dict(key))} {val}"


class Counter(_LabeledSeries):
    """Monotonically increasing count. There is deliberately no ``set``:
    a sample that can move backwards is a Gauge, and Prometheus rate()
    over a counter that decreased reads as a counter reset."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease; use a gauge")
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_LabeledSeries):
    """Point-in-time sample: settable, and inc/dec move it either way."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def retain(self, keys: set, **scope) -> None:
        """Drop series not written by the current export — a drained
        queue's age gauge or a dead rank's counters must disappear, not
        freeze at their last sample. ``scope`` label filters limit the
        sweep to one writer's series (e.g. ``engine="e0"``) so exporters
        sharing a gauge never retain-away each other's samples."""
        with self._lock:
            for key in [k for k in self._values if k not in keys]:
                if scope and any(dict(key).get(a) != v
                                 for a, v in scope.items()):
                    continue
                del self._values[key]


class Histogram:
    def __init__(self, name: str, help_text: str,
                 buckets: tuple[float, ...] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = buckets
        self._lock = threading.Lock()
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}
        # last exemplar per (series, bucket index): OpenMetrics-style
        # trace links on the bucket lines (bucket len(buckets) = +Inf)
        self._exemplars: dict[tuple, dict[int, tuple[str, float]]] = {}

    def observe(self, value: float, **labels) -> None:
        self.observe_n(value, 1, **labels)

    def observe_n(self, value: float, count: int = 1,
                  exemplar: str | None = None, **labels) -> None:
        """Record ``count`` observations of ``value`` in one update — the
        scrape-time harvest path observes one flight record per BATCH,
        weighted by its payload count, so per-tenant quantiles weight
        events, not batches, without 10^3 bisects per record. ``exemplar``
        (a trace id) sticks to the bucket the value fell in and is served
        on exemplar-aware expositions."""
        if count <= 0:
            return
        key = tuple(sorted(labels.items()))
        with self._lock:
            if key not in self._counts:
                self._counts[key] = [0] * len(self.buckets)
                self._sums[key] = 0.0
                self._totals[key] = 0
            idx = bisect.bisect_left(self.buckets, value)
            if idx < len(self.buckets):
                self._counts[key][idx] += count
            self._sums[key] += value * count
            self._totals[key] += count
            if exemplar is not None:
                self._exemplars.setdefault(key, {})[idx] = (exemplar, value)

    def time(self, **labels):
        """Context manager measuring a stage duration — the per-stage latency
        histograms of the reference's pipeline mappers."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0, **labels)

        return _Timer()

    def count(self, **labels) -> int:
        """Total observations for one series — lets tests and controllers
        assert on event COUNTS (e.g. "fewer WAL fsyncs than batches")
        without parsing the exposition text."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._totals.get(key, 0)

    def _matching_keys(self, labels: dict) -> list[tuple]:
        want = {k: str(v) for k, v in labels.items()}
        return [key for key in self._totals
                if all(k in dict(key) and str(dict(key)[k]) == v
                       for k, v in want.items())]

    def count_where(self, **labels) -> int:
        """Total observations summed over every series whose label set
        CONTAINS ``labels`` — the aggregate view for series that carry
        scoping labels (the SLO histogram's ``engine=e<n>``): a test
        asserting "every ingested event observed once" sums across
        engines with ``count_where(tenant=...)``."""
        with self._lock:
            return sum(self._totals[k] for k in self._matching_keys(labels))

    def quantile_where(self, q: float, **labels) -> float | None:
        """:meth:`quantile` over the MERGED bucket counts of every series
        matching the ``labels`` subset — one per-tenant quantile across
        in-process ranks whose observations landed under different
        ``engine`` labels."""
        with self._lock:
            keys = self._matching_keys(labels)
            if not keys:
                return None
            counts = [0] * len(self.buckets)
            total = 0
            for k in keys:
                for i, c in enumerate(self._counts[k]):
                    counts[i] += c
                total += self._totals[k]
        return self._quantile_from(q, counts, total)

    def _quantile_from(self, q: float, counts, total) -> float | None:
        """The histogram_quantile interpolation rule over one (possibly
        merged) bucket-count vector — shared by :meth:`quantile` and
        :meth:`quantile_where` so the two readings can never diverge."""
        if not counts or not total:
            return None
        target = q * total
        acc = 0
        for i, c in enumerate(counts):
            if c and acc + c >= target:
                lo = self.buckets[i - 1] if i else 0.0
                hi = self.buckets[i]
                frac = min(1.0, max(0.0, (target - acc) / c))
                return lo + (hi - lo) * frac
            acc += c
        return self.buckets[-1]

    def quantile(self, q: float, **labels) -> float | None:
        """Bucket-quantile estimate: locate the bounding bucket, then
        linearly interpolate within it — the standard
        ``histogram_quantile`` rule, so SLO summaries and the autotuner
        can read a p99 straight from the exposition buckets without any
        raw-sample retention. Values beyond the last finite bucket clamp
        to that bound (the +Inf bucket has no width to interpolate
        into); None until a series observes."""
        return self._quantile_from(q, *self.snapshot(**labels))

    def snapshot(self, **labels) -> tuple[list[int], int]:
        """One series' bucket counts and total observations, copied: the
        baseline that :meth:`quantile_since` reads a later window
        against."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            return (list(self._counts.get(key) or [0] * len(self.buckets)),
                    self._totals.get(key, 0))

    def quantile_since(self, q: float, before: tuple[list[int], int],
                       **labels) -> float | None:
        """:meth:`quantile` over only the observations the series took
        since ``before`` (its :meth:`snapshot`): the window of one leg in
        a process whose other work observes into the same series."""
        counts, total = self.snapshot(**labels)
        return self._quantile_from(q, [c - b for c, b in zip(counts, before[0])],
                                   total - before[1])

    def expose(self, exemplars: bool = False) -> Iterator[str]:
        """Prometheus text exposition. ``exemplars`` appends OpenMetrics
        trace-id exemplars to the bucket lines — only the federated
        cluster scrape asks for them; the plain text-format endpoint
        stays strictly 0.0.4-parseable."""
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:       # snapshot: observe() mutates these in place
            keys = sorted(self._counts)
            counts = {k: list(self._counts[k]) for k in keys}
            sums = dict(self._sums)
            totals = dict(self._totals)
            exm = ({k: dict(v) for k, v in self._exemplars.items()}
                   if exemplars else {})

        def _ex(key, idx) -> str:
            ex = exm.get(key, {}).get(idx)
            if ex is None:
                return ""
            tid, val = ex
            return f' # {{trace_id="{_escape_label(tid)}"}} {val:.9g}'

        for key in keys:
            labels = dict(key)
            acc = 0
            for i, (bound, c) in enumerate(zip(self.buckets, counts[key])):
                acc += c
                le = dict(labels, le=repr(bound))
                yield (f"{self.name}_bucket{_fmt_labels(le)} {acc}"
                       f"{_ex(key, i)}")
            inf = dict(labels, le="+Inf")
            yield (f"{self.name}_bucket{_fmt_labels(inf)} {totals[key]}"
                   f"{_ex(key, len(self.buckets))}")
            yield f"{self.name}_sum{_fmt_labels(labels)} {sums[key]}"
            yield f"{self.name}_count{_fmt_labels(labels)} {totals[key]}"


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_text), Counter)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_text), Gauge)

    def histogram(self, name: str, help_text: str = "",
                  buckets: tuple[float, ...] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, lambda: Histogram(name, help_text, buckets), Histogram)

    def _get(self, name, build, kind):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = build()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} already registered as {type(m).__name__}")
            return m

    def expose_text(self, exemplars: bool = False) -> str:
        with self._lock:       # snapshot the registry: a concurrent
            metrics = list(self._metrics.values())   # register() mid-scrape
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.expose(exemplars=exemplars))
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()


# batch-size buckets for the shared-scan query coalescer (counts, not
# seconds — the default latency buckets would squash every batch into the
# first bucket)
QUERY_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


def query_metrics(registry: MetricsRegistry | None = None) -> dict:
    """The ``swtpu_query_*`` instruments for the batched read path — one
    definition so the engine's QueryBatcher, bench.py, and tests always
    agree on names and bucket layouts:

      swtpu_query_latency_seconds   end-to-end query_events latency
                                    (lookup + coalesce wait + device +
                                    formatting + archive merge)
      swtpu_query_batch_size        predicates fused per device program
      swtpu_queries_total           query_events calls served
      swtpu_query_programs_total    device programs launched (the
                                    amortization ratio vs queries_total)
    """
    reg = registry or REGISTRY
    return {
        "latency": reg.histogram(
            "swtpu_query_latency_seconds",
            "end-to-end engine query latency in seconds"),
        "batch": reg.histogram(
            "swtpu_query_batch_size",
            "event queries coalesced into one device program",
            buckets=QUERY_BATCH_BUCKETS),
        "queries": reg.counter(
            "swtpu_queries_total", "event queries served"),
        "programs": reg.counter(
            "swtpu_query_programs_total",
            "batched query device programs launched"),
    }


def _safe_size(path) -> int:
    try:
        return path.stat().st_size
    except OSError:
        return 0


def archive_metrics(registry: MetricsRegistry | None = None) -> dict:
    """The ``swtpu_archive_*`` gauges for the historical retention tier. Registered here — NOT in engine.metrics(), whose dict is
    pinned equal across dispatch shapes — exactly like the query and
    replication instruments. All gauges, synced at scrape time from the
    archive's own counters (the archive mutates under the engine lock;
    the scrape must never take it):

      swtpu_archive_segments            live segment files on disk
      swtpu_archive_rows                rows held by the archive tier
      swtpu_archive_bytes               bytes in live segment files
      swtpu_archive_queries_total       pushdown scans served
      swtpu_archive_segments_considered_total
                                        segments admitted by the eviction
                                        cap (what a full scan would open)
      swtpu_archive_segments_pruned_total
                                        ...of which zone maps/blooms
                                        pruned without decoding
      swtpu_archive_segments_decoded_total
                                        unique segments actually decoded
                                        (pruned + decoded + shortcut ==
                                        considered per round)
      swtpu_archive_count_shortcut_total
                                        provably-full-match segments
                                        counted from stats alone
      swtpu_archive_cache_hits_total / swtpu_archive_cache_loads_total
                                        LRU segment-decode cache traffic
      swtpu_archive_corrupt_segments    files quarantined (rebuild+decode)
      swtpu_archive_lost_rows / swtpu_archive_expired_rows
                                        rows wrapped before spool / rows
                                        expired by retention policy
    """
    reg = registry or REGISTRY
    return {
        "segments": reg.gauge(
            "swtpu_archive_segments", "live archived segment files"),
        "rows": reg.gauge(
            "swtpu_archive_rows", "rows held by the archive tier"),
        "bytes": reg.gauge(
            "swtpu_archive_bytes", "bytes on disk in live segments"),
        "queries": reg.gauge(
            "swtpu_archive_queries_total", "archive pushdown scans served"),
        "considered": reg.gauge(
            "swtpu_archive_segments_considered_total",
            "segments admitted by the eviction cap across all scans"),
        "pruned": reg.gauge(
            "swtpu_archive_segments_pruned_total",
            "segments pruned by zone maps/bloom filters without decoding"),
        "decoded": reg.gauge(
            "swtpu_archive_segments_decoded_total",
            "unique segments decoded per scan, summed"),
        "count_shortcuts": reg.gauge(
            "swtpu_archive_count_shortcut_total",
            "provably-full-match segments counted from stats alone"),
        "planner_calls": reg.gauge(
            "swtpu_archive_planner_calls_total",
            "segment-planner planning passes served (a batcher round's "
            "archive requests share exactly one)"),
        "cache_hits": reg.gauge(
            "swtpu_archive_cache_hits_total",
            "segment-decode cache calls served without touching disk"),
        "cache_loads": reg.gauge(
            "swtpu_archive_cache_loads_total",
            "segment-decode cache np.load file opens"),
        "corrupt": reg.gauge(
            "swtpu_archive_corrupt_segments",
            "segment files quarantined as corrupt (at index rebuild or "
            "first decode)"),
        "lost_rows": reg.gauge(
            "swtpu_archive_lost_rows",
            "ring rows overwritten before they could spill"),
        "expired_rows": reg.gauge(
            "swtpu_archive_expired_rows",
            "archived rows expired by retention policy"),
    }


def analytics_metrics(registry: MetricsRegistry | None = None) -> dict:
    """The ``swtpu_analytics_*`` gauges for the fleet-scale historical
    scoring tier. Registered here — NOT in engine.metrics()
    (dispatch-shape equality) — like every plane before it; all synced
    at scrape time from the AnalyticsManager's own counters (committed
    under the manager lock, read without the engine lock):

      swtpu_analytics_jobs_total          jobs, labeled by terminal state
                                          (started|completed|cancelled|
                                          failed)
      swtpu_analytics_rounds_total        planner-batched streaming
                                          rounds executed
      swtpu_analytics_segments_streamed_total
                                          archive segments decoded into
                                          scoring rounds
      swtpu_analytics_bytes_streamed_total
                                          archive->device planner-cost
                                          bytes streamed (decode cost of
                                          compressed columns included)
      swtpu_analytics_rows_streamed_total measurement rows surviving the
                                          host predicate filter
      swtpu_analytics_windows_total       device windows, labeled by
                                          conservation sink (planned|
                                          scored|skipped_underfilled|
                                          cancelled)
      swtpu_analytics_alerts_total        score alerts, labeled
                                          emitted|suppressed
      swtpu_analytics_rollup_spilled_windows_total
                                          rollup ring windows aged out to
                                          the rollup archive
    """
    reg = registry or REGISTRY
    return {
        "jobs": reg.gauge(
            "swtpu_analytics_jobs_total",
            "historical scoring jobs, labeled by state"),
        "rounds": reg.gauge(
            "swtpu_analytics_rounds_total",
            "planner-batched archive streaming rounds executed"),
        "segments": reg.gauge(
            "swtpu_analytics_segments_streamed_total",
            "archive segments decoded into scoring rounds"),
        "bytes": reg.gauge(
            "swtpu_analytics_bytes_streamed_total",
            "archive->device planner-cost bytes streamed"),
        "rows": reg.gauge(
            "swtpu_analytics_rows_streamed_total",
            "measurement rows surviving the host predicate filter"),
        "windows": reg.gauge(
            "swtpu_analytics_windows_total",
            "device windows, labeled by conservation sink"),
        "alerts": reg.gauge(
            "swtpu_analytics_alerts_total",
            "historical score alerts, labeled emitted|suppressed"),
        "rollup_spilled": reg.gauge(
            "swtpu_analytics_rollup_spilled_windows_total",
            "rollup ring windows aged out to the rollup archive"),
    }

def slo_metrics(registry: MetricsRegistry | None = None) -> dict:
    """The SLO latency plane: per-tenant end-to-end ingest
    latency harvested from flight-recorder lifecycle records at SCRAPE
    time — the ingest hot path never pays an extra device sync for it.
    Kept OUT of engine.metrics() (dispatch-shape equality) like the
    query and replication instruments.

      swtpu_ingest_e2e_seconds   wire->state latency per tenant
                                 (log-bucketed; slowest-decile
                                 observations carry trace-id exemplars
                                 resolving via ``Engine.get_trace``)
    """
    reg = registry or REGISTRY
    return {
        "ingest_e2e": reg.histogram(
            "swtpu_ingest_e2e_seconds",
            "per-tenant ingest wire->state latency harvested from "
            "flight records at scrape time",
            buckets=E2E_LATENCY_BUCKETS),
    }


def qos_metrics(registry: MetricsRegistry | None = None) -> dict:
    """Overload-discipline instruments. Kept OUT of
    engine.metrics() (dispatch-shape equality) like the query /
    replication / archive instruments. Every series carries an
    ``engine`` label (the controller's autotuner-style ``e<n>`` tag) —
    the REGISTRY is process-global, so in-process cluster ranks and
    multi-engine tests would otherwise merge counters and
    last-writer-win each other's gauges.

      swtpu_qos_admitted_total   events admitted, per tenant (live)
      swtpu_qos_shed_total       events shed, per tenant + reason
                                 ("rate" | "saturated" | "stall"; live)
      swtpu_qos_bucket_fill      token-bucket balance per tenant (scrape)
      swtpu_qos_saturated        1 while backlog >= shed threshold
      swtpu_qos_shed_threshold   current saturation threshold (rows)
      swtpu_qos_wfq_vtime        weighted-fair virtual time per tenant,
                                 labeled by resource (ingest | query)
    """
    reg = registry or REGISTRY
    return {
        "admitted": reg.counter(
            "swtpu_qos_admitted_total",
            "events admitted by per-tenant admission control"),
        "shed": reg.counter(
            "swtpu_qos_shed_total",
            "events shed by admission control, per tenant and reason"),
        "fill": reg.gauge(
            "swtpu_qos_bucket_fill",
            "admission token-bucket balance per tenant"),
        "saturated": reg.gauge(
            "swtpu_qos_saturated",
            "1 while the engine backlog exceeds the shed threshold"),
        "threshold": reg.gauge(
            "swtpu_qos_shed_threshold",
            "staged-row backlog beyond which ingest sheds"),
        "wfq_vtime": reg.gauge(
            "swtpu_qos_wfq_vtime",
            "weighted-fair virtual time per tenant and resource"),
    }


def rules_metrics(registry: MetricsRegistry | None = None) -> dict:
    """Streaming-rules CEP tier instruments. Kept OUT of
    engine.metrics() (dispatch-shape equality) like the query / qos /
    replication instruments; the partition-invariant ``rule_fires``
    counter IS in metrics() — these cover the host-side lifecycle.

      swtpu_rules_swaps_total           rule-set installs/hot-reloads
      swtpu_rules_reload_errors_total   rejected rule-set documents
                                        (the active set kept serving)
      swtpu_rules_alerts_total          alert events emitted through
                                        the ingest pipeline
      swtpu_rules_suppressed_total      fires suppressed by the
                                        rule+group+window dedup key
                                        (replay / standby promotion)
    """
    reg = registry or REGISTRY
    return {
        "swaps": reg.counter(
            "swtpu_rules_swaps_total",
            "rule-set installs and hot-reload swaps"),
        "reload_errors": reg.counter(
            "swtpu_rules_reload_errors_total",
            "rule-set documents rejected at validate/compile time"),
        "alerts": reg.counter(
            "swtpu_rules_alerts_total",
            "rule alert events emitted through the ingest pipeline"),
        "suppressed": reg.counter(
            "swtpu_rules_suppressed_total",
            "rule fires suppressed by the dedup key (replay/standby)"),
    }


def devicewatch_metrics(registry: MetricsRegistry | None = None) -> dict:
    """The memory half of the device-plane instruments, kept out of
    ``engine.metrics()`` (dispatch-shape equality) like every plane. The
    ``swtpu_device_mem_*`` gauges carry the exporting engine's
    ``engine=e<n>`` label because each engine owns its own stores. The
    compile and retrace series (``swtpu_xla_*``) have nothing to watch in
    eager torch and are not registered.

      swtpu_device_exec_seconds      device execution time per family,
                                     harvested from flight records at
                                     scrape time (no hot-path syncs)
      swtpu_device_mem_bytes         memory-ledger component sizes
      swtpu_device_mem_hwm           high-watermarks (reset on scrape)
    """
    reg = registry or REGISTRY
    return {
        "exec": reg.histogram(
            "swtpu_device_exec_seconds",
            "device execution time per program family, harvested from "
            "flight records at scrape time"),
        "mem": reg.gauge(
            "swtpu_device_mem_bytes",
            "memory-ledger component bytes (ring store, arenas, segment "
            "cache, live arrays), per engine"),
        "mem_hwm": reg.gauge(
            "swtpu_device_mem_hwm",
            "memory-ledger high-watermarks since the last scrape "
            "(reset on scrape), per engine"),
    }


def replication_metrics(registry: MetricsRegistry | None = None) -> dict:
    """The ``swtpu_replication_*`` instruments for the event-plane
    replica feed. Registered here — NOT in engine.metrics(),
    whose dict is pinned equal across dispatch shapes — exactly like the
    query instruments:

      swtpu_replication_published_total   WAL appends published to the feed
      swtpu_replication_applied_total     feed batches applied into standbys
      swtpu_replication_failover_reads_total  reads served from a standby
      swtpu_replication_fireovers_total   schedule fire-over takeovers
      swtpu_replication_lag_batches       publish-to-apply lag (gauge)
      swtpu_replication_stale_ms          standby staleness watermark,
                                          labeled per LEADER rank (one
                                          series per peer this rank
                                          stands by for — a single
                                          lagging follower must be
                                          visible, not averaged away)
    """
    reg = registry or REGISTRY
    return {
        "published": reg.counter(
            "swtpu_replication_published_total",
            "ingest batches published to the replica feed"),
        "applied": reg.counter(
            "swtpu_replication_applied_total",
            "replica feed batches applied into standby stores"),
        "failover_reads": reg.counter(
            "swtpu_replication_failover_reads_total",
            "reads served from a follower standby during owner outage"),
        "fireovers": reg.counter(
            "swtpu_replication_fireovers_total",
            "schedule fire-over takeovers for dead owners"),
        "lag": reg.gauge(
            "swtpu_replication_lag_batches",
            "replica feed publish-to-ack lag in batches"),
        "stale": reg.gauge(
            "swtpu_replication_stale_ms",
            "standby staleness watermark in milliseconds, per leader "
            "rank this rank follows"),
    }


def placement_metrics(registry: MetricsRegistry | None = None) -> dict:
    """Elastic-placement instruments. Kept OUT of
    engine.metrics() (dispatch-shape equality) like every plane before
    it; the federated scrape re-labels them per rank:

      swtpu_placement_epoch            the rank's installed map epoch
                                       (a lagging rank is visible as a
                                       lower epoch than its peers)
      swtpu_placement_moves_total      handoffs by terminal state,
                                       labeled started|completed|aborted
      swtpu_placement_redirects_total  fenced-write + stale-sender 473
                                       redirects served by this rank's
                                       owner-side guard, labeled by kind
      swtpu_placement_fenced_slots     slots currently fenced here
                                       (nonzero only mid-handoff)
    """
    reg = registry or REGISTRY
    return {
        "epoch": reg.gauge(
            "swtpu_placement_epoch",
            "installed placement map epoch on this rank"),
        "moves": reg.counter(
            "swtpu_placement_moves_total",
            "placement handoffs by state (started/completed/aborted)"),
        "redirects": reg.counter(
            "swtpu_placement_redirects_total",
            "fenced-write and stale-sender ownership redirects served"),
        "fenced": reg.gauge(
            "swtpu_placement_fenced_slots",
            "slots currently fenced on this rank (mid-handoff only)"),
    }


def export_placement_metrics(engine, registry: MetricsRegistry | None
                             = None) -> None:
    """Scrape-time export of the placement posture gauges (the move /
    redirect counters increment live on their paths)."""
    pm = getattr(engine, "placement", None)
    if pm is None:
        return
    inst = placement_metrics(registry)
    inst["epoch"].set(pm.epoch)
    inst["fenced"].set(len(pm.fenced_slots()))


def cluster_metrics_instruments(registry: MetricsRegistry | None
                                = None) -> dict:
    """Cluster data-plane instruments:

      swtpu_forward_hop_seconds    sender-observed cross-rank forward
                                   RPC latency, labeled by destination
                                   rank (the forwarded-hop p99 the bench
                                   cluster leg reports)
      swtpu_cluster_scrapes_total  federated metric scrapes served
    """
    reg = registry or REGISTRY
    return {
        "forward_hop": reg.histogram(
            "swtpu_forward_hop_seconds",
            "cross-rank ingest forward RPC latency (sender-observed)",
            buckets=E2E_LATENCY_BUCKETS),
        "scrapes": reg.counter(
            "swtpu_cluster_scrapes_total",
            "federated cluster metric scrapes served"),
    }


def spmd_metrics(registry: MetricsRegistry | None = None) -> dict:
    """The multi-shard engine's instruments, kept out of
    ``engine.metrics()`` (its keys are pinned equal to the single-card
    engine's). Gauges synced at scrape from the router's host mirrors
    and the per-shard counter grids; every series carries the exporting
    engine's ``engine=e<n>`` label, the per-lane ones a ``shard`` label:

      swtpu_spmd_shards              shards of the engine
      swtpu_shard_staged_rows        staged ingest rows per shard lane
      swtpu_shard_staged_rows_hwm    its high-watermark since the last
                                     scrape (reset on scrape)
      swtpu_shard_devices            devices registered per shard
      swtpu_shard_assignments        assignments created per shard
      swtpu_shard_flow_rows          the per-shard flow breakdown, by
                                     shard and lane (processed | accepted
                                     | invalid | dedup_dropped |
                                     geofence_hit | routed_rows |
                                     dispatched_rows | backlog_rows)
      swtpu_shard_heat               decayed-EWMA events/s per (shard,
                                     tenant)
      swtpu_slot_heat_topk           the hottest placement slots' EWMA
                                     events/s, by slot
      swtpu_spmd_skew                the last dispatch's max/mean
                                     routed-rows imbalance (1.0 balanced)
      swtpu_spmd_skew_hwm            the worst skew since the last scrape
      swtpu_spmd_skew_sustained_total  sustained-skew escalations (two
                                     consecutive audits over the
                                     threshold)
    """
    reg = registry or REGISTRY
    return {
        "shards": reg.gauge("swtpu_spmd_shards",
                            "shards in the engine's SPMD device mesh"),
        "staged": reg.gauge("swtpu_shard_staged_rows",
                            "staged ingest rows per shard lane (pre-dispatch)"),
        "staged_hwm": reg.gauge(
            "swtpu_shard_staged_rows_hwm",
            "per-shard staged-rows high-water mark since last scrape "
            "(reset on scrape)"),
        "devices": reg.gauge("swtpu_shard_devices",
                             "devices registered per shard (local id high-water mark)"),
        "assignments": reg.gauge(
            "swtpu_shard_assignments",
            "assignments created per shard (local id high-water mark)"),
        "flow": reg.gauge(
            "swtpu_shard_flow_rows",
            "per-shard flow breakdown from the unfolded device counter "
            "grid + host route table, per shard + lane"),
        "heat": reg.gauge("swtpu_shard_heat",
                          "decayed-EWMA events/s per (shard, tenant)"),
        "slot_heat": reg.gauge("swtpu_slot_heat_topk",
                               "EWMA events/s of the hottest placement slots"),
        "skew": reg.gauge("swtpu_spmd_skew",
                          "per-dispatch max/mean routed-rows imbalance index"),
        "skew_hwm": reg.gauge(
            "swtpu_spmd_skew_hwm",
            "worst dispatch skew since last scrape (reset on scrape)"),
        "skew_sustained": reg.counter(
            "swtpu_spmd_skew_sustained_total",
            "sustained-skew escalations (two-consecutive-audit confirmation)"),
    }


def export_spmd_metrics(engine, registry: MetricsRegistry | None = None) -> None:
    """Scrape-time export of the per-shard posture of an engine with shard
    lanes (the multi-shard ``SpmdEngine``); a single-card engine exports
    nothing."""
    bufs = getattr(engine, "_shard_bufs", None)
    if bufs is None:
        return
    inst = spmd_metrics(registry)
    lbl = getattr(engine, "metrics_label", "e?")
    inst["shards"].set(len(bufs), engine=lbl)
    devices = getattr(engine, "_next_local_device", None)
    assigns = getattr(engine, "_next_local_assignment", None)
    take_hwm = getattr(engine, "take_shard_staged_hwm", None)
    hwms = take_hwm() if callable(take_hwm) else None
    for s, buf in enumerate(bufs):
        inst["staged"].set(len(buf), engine=lbl, shard=str(s))
        if hwms is not None:
            inst["staged_hwm"].set(hwms[s], engine=lbl, shard=str(s))
        if devices is not None:
            inst["devices"].set(devices[s], engine=lbl, shard=str(s))
        if assigns is not None:
            inst["assignments"].set(assigns[s], engine=lbl, shard=str(s))
    # the scrape is the heat harvest and the skew audit cadence
    sf = getattr(engine, "shard_flow", None)
    if callable(sf):
        for row in sf()["perShard"]:
            s = str(row["shard"])
            for lane, n in row.items():
                if lane != "shard":
                    inst["flow"].set(n, engine=lbl, shard=s, lane=lane)
    harvest = getattr(engine, "harvest_shard_heat", None)
    if callable(harvest):
        from sitewhere_tpu_torch.utils.shardobs import heat_map_doc

        tracker = harvest()
        written = set()
        for s, cells in heat_map_doc(tracker, engine.tenants).items():
            for tenant, eps in cells.items():
                labels = {"engine": lbl, "shard": s, "tenant": tenant}
                inst["heat"].set(eps, **labels)
                written.add(tuple(sorted(labels.items())))
        inst["heat"].retain(written, engine=lbl)
        written = set()
        for slot, eps in tracker.top_slots():
            labels = {"engine": lbl, "slot": str(slot)}
            inst["slot_heat"].set(eps, **labels)
            written.add(tuple(sorted(labels.items())))
        inst["slot_heat"].retain(written, engine=lbl)
        inst["skew"].set(tracker.skew_index, engine=lbl)
        inst["skew_hwm"].set(tracker.take_skew_hwm(), engine=lbl)
        if tracker.audit_skew():
            inst["skew_sustained"].inc(engine=lbl)


def export_engine_metrics(engine, registry: MetricsRegistry | None = None,
                          tenant: str = "all") -> None:
    """Push the engine's device-side counters into the registry (scrape-time
    sync; the device counters are the source of truth). Per-tenant event
    counts export labeled, mirroring the reference's buildLabels() tenant
    labeling on every metric."""
    reg = registry or REGISTRY
    metrics = engine.metrics()
    by_rank = metrics.pop("by_rank", None)

    def _numeric(items):
        return ((n, v) for n, v in items
                if isinstance(v, (int, float)) and not isinstance(v, bool))

    written: dict[str, set] = {}

    def _set(name: str, value, **labels) -> None:
        g = reg.gauge(f"swtpu_engine_{name}", f"engine counter {name}")
        g.set(value, **labels)
        written.setdefault(g.name, set()).add(
            tuple(sorted(labels.items())))

    for name, value in _numeric(metrics.items()):
        labels = {"tenant": tenant}
        if by_rank is not None:
            labels["rank"] = "all"   # cluster-merged series
        _set(name, value, **labels)
    if by_rank is not None:
        # per-rank series: the "which rank is hot" view the reference
        # gets from scraping each microservice replica separately
        for rank, rank_metrics in by_rank.items():
            for name, value in _numeric(rank_metrics.items()):
                _set(name, value, tenant=tenant, rank=str(rank))
    # conditional keys (a drained queue's age) and dead ranks must
    # DISAPPEAR from the exposition, not freeze at their last sample
    for mname, metric in list(reg._metrics.items()):
        if mname.startswith("swtpu_engine_") and isinstance(metric, Gauge):
            metric.retain(written.get(mname, set()))
    g = reg.gauge("swtpu_tenant_events",
                  "persisted event count per tenant and type")
    current: set[tuple] = set()
    for ten, counts in engine.tenant_metrics().items():
        for etype, n in counts.items():
            if n:
                g.set(n, tenant=ten, type=etype)
                current.add(tuple(sorted({"tenant": ten,
                                          "type": etype}.items())))
    # a tenant that went quiet (devices deactivated) must scrape as 0, not
    # freeze at its last nonzero sample
    with g._lock:
        stale = [k for k in g._values if k not in current]
    for key in stale:
        g.set(0, **dict(key))
    export_observability_metrics(engine, reg)
    export_placement_metrics(engine, reg)
    export_spmd_metrics(engine, reg)
    export_wire_metrics(engine, reg)


def export_wire_metrics(engine, registry: MetricsRegistry | None = None) -> None:
    """Scrape-time export of the persistent-connection wire edge:
    connection gauges, per-disposition frame totals, arrival-window
    flush occupancy, and backpressure events. Sampled from the attached
    edges' own counter snapshots — like every plane, these series are
    deliberately NOT ``engine.metrics()`` keys (dispatch-shape equality
    pin); an engine with no edge attached (``ingest/wire_edge.WireEdge``)
    exports nothing."""
    eng = getattr(engine, "local", engine)
    if not getattr(eng, "wire_edges", None):
        return
    from sitewhere_tpu_torch.ingest.wire_edge import aggregate_wire_snapshot

    snap = aggregate_wire_snapshot(eng)
    if snap is None:
        return
    reg = registry or REGISTRY
    reg.gauge("swtpu_wire_connections_live",
              "persistent connections currently attached to the wire "
              "edge").set(snap["connections_live"])
    reg.gauge("swtpu_wire_connections_peak",
              "peak concurrent persistent connections").set(
                  snap["connections_peak"])
    reg.gauge("swtpu_wire_connections_opened_total",
              "persistent connections accepted since edge start").set(
                  snap["connections_opened"])
    frames = reg.gauge("swtpu_wire_frames_total",
                       "wire frames by edge disposition")
    for disp in ("admitted", "shed", "invalid", "duplicate"):
        frames.set(snap[f"frames_{disp}"], disposition=disp)
    frames.set(snap["frames_received"], disposition="received")
    reg.gauge("swtpu_wire_rows_submitted_total",
              "frames handed to the batched arena-ingest path").set(
                  snap["rows_submitted"])
    reg.gauge("swtpu_wire_frames_stalled_total",
              "admitted frames shed by arena stall (acks withheld)").set(
                  snap["frames_stalled"])
    reg.gauge("swtpu_wire_pending_frames",
              "frames buffered in open arrival windows").set(
                  snap["pending"])
    reg.gauge("swtpu_wire_flushes_total",
              "arrival-window flushes (size, deadline, or drain)").set(
                  snap["flushes"])
    reg.gauge("swtpu_wire_flush_occupancy_pct",
              "mean flushed rows as % of the size threshold — low means "
              "the deadline fires first (latency-bound windows)").set(
                  snap["flush_occupancy_pct"])
    reg.gauge("swtpu_wire_backpressure_total",
              "protocol-level backpressure signals sent (PUBACK "
              "withheld / SWP shed codes)").set(
                  snap["backpressure_events"])
    reg.gauge("swtpu_wire_keepalive_timeouts_total",
              "connections dropped for keepalive silence").set(
                  snap["keepalive_timeouts"])


def export_observability_metrics(engine, registry: MetricsRegistry | None
                                 = None) -> None:
    """Scrape-time export of the observability planes: the device-side
    per-tenant pipeline counter grid (computed inside the step — no extra
    host<->device syncs on the ingest path; the grid is read back here,
    on the scrape path, like every other device counter), host gauges for
    arena-pool occupancy and in-flight dispatch depth, a cluster rank's
    spill queue, forward registry and replica feed, the flight recorder
    and span tracer, the SLO harvest, the conservation ledger, the
    memory ledger and the QoS plane."""
    reg = registry or REGISTRY

    tpc = getattr(engine, "tenant_pipeline_counters", None)
    if callable(tpc):
        for ten, lanes in tpc().items():
            for lane, n in lanes.items():
                reg.gauge(f"swtpu_pipeline_{lane}",
                          f"device-side per-tenant {lane} event count "
                          "(computed in the jit step)").set(n, tenant=ten)

    # CEP-tier cadence-dependent counters: the
    # missed/late/oob fires live in rule_counters() — deliberately OUT
    # of engine.metrics() (dispatch-shape equality) — so until now a
    # pending-ring overflow was invisible unless you polled the Python
    # API. Scrape-time sync, like every other device-counter export;
    # an engine without an installed rule set exports nothing.
    rc = getattr(engine, "rule_counters", None)
    if callable(rc):
        counters = rc()
        for key, name, help_text in (
                ("ruleFires", "swtpu_rules_fires_total",
                 "distinct rule fire keys detected on device"),
                ("ruleMissedFires", "swtpu_rules_missed_total",
                 "rule fires dropped by pending-ring overflow"),
                ("ruleLateEvents", "swtpu_rules_late_total",
                 "events older than their rule window carry"),
                ("ruleOobGroups", "swtpu_rules_oob_groups_total",
                 "rule matches whose group id exceeded the group table"),
                ("rulesActive", "swtpu_rules_active",
                 "rules in the installed set"),
                ("rollupLateEvents", "swtpu_rollup_late_total",
                 "events older than their rollup slot's window"),
                ("rollupsActive", "swtpu_rollups_active",
                 "continuous rollups in the installed set")):
            if key in counters:
                reg.gauge(name, help_text).set(counters[key])

    pool = getattr(engine, "_arena_pool", None)
    if pool is not None:
        reg.gauge("swtpu_arena_pool_arenas",
                  "staging arenas in the ingest pool").set(pool.n_arenas)
        reg.gauge("swtpu_arena_pool_free",
                  "staging arenas currently fillable").set(pool.free_count)
        reg.gauge("swtpu_arena_pool_inflight",
                  "staging arenas tied to in-flight dispatches").set(
                      pool.inflight_count)
        reg.gauge("swtpu_arena_pool_waits",
                  "times ingest blocked on arena recycle").set(pool.waits)
        # capacity headroom: worst occupancy since
        # the last scrape, not just "now" — RESET on scrape, so each
        # sample reads "worst case this scrape window"
        take_hwm = getattr(pool, "take_occupancy_hwm", None)
        if take_hwm is not None:
            reg.gauge("swtpu_arena_pool_occupancy_hwm",
                      "max arenas simultaneously out of the free pool "
                      "since the last scrape (reset on scrape)").set(
                          take_hwm())
    take_backlog = getattr(engine, "take_backlog_hwm", None)
    if take_backlog is not None:
        reg.gauge("swtpu_staged_backlog_hwm_rows",
                  "max staged-row ingest backlog since the last scrape "
                  "(reset on scrape)").set(take_backlog())

    pending = getattr(engine, "_pending_outs", None)
    if pending is not None:
        reg.gauge("swtpu_dispatch_inflight",
                  "device programs dispatched but not yet drained").set(
                      len(pending))

    arch = getattr(engine, "archive", None)
    if arch is not None:
        inst = archive_metrics(reg)
        inst["segments"].set(len(arch.segments))
        inst["rows"].set(arch.total_rows())
        inst["bytes"].set(sum(
            _safe_size(arch.dir / s.path) for s in list(arch.segments)))
        inst["queries"].set(arch.queries)
        inst["considered"].set(arch.plan_considered)
        inst["pruned"].set(arch.plan_pruned)
        inst["decoded"].set(arch.plan_decoded)
        inst["count_shortcuts"].set(arch.count_shortcuts)
        inst["planner_calls"].set(arch.planner_calls)
        inst["cache_hits"].set(arch.cache.hits)
        inst["cache_loads"].set(arch.cache.loads)
        inst["corrupt"].set(arch.corrupt_segments)
        inst["lost_rows"].set(arch.lost_rows)
        inst["expired_rows"].set(arch.expired_rows)

    # fleet analytics tier: the scoring-job manager's own
    # counter snapshot — one consistent read under its lock, never the
    # engine lock
    aj = getattr(engine, "analytics_jobs", None)
    if aj is not None:
        inst = analytics_metrics(reg)
        s = aj.ledger_stage()
        for state in ("started", "completed", "cancelled", "failed"):
            inst["jobs"].set(s[f"jobs_{state}"], state=state)
        inst["rounds"].set(s["rounds"])
        inst["segments"].set(s["segments"])
        inst["bytes"].set(s["bytes"])
        inst["rows"].set(s["rows"])
        for sink in ("planned", "scored", "skipped_underfilled",
                     "cancelled"):
            inst["windows"].set(s[sink], sink=sink)
        inst["alerts"].set(s["alerts_emitted"], disposition="emitted")
        inst["alerts"].set(s["alerts_suppressed"],
                           disposition="suppressed")
        hc = getattr(engine, "host_counters", None) or {}
        inst["rollup_spilled"].set(hc.get("rollup_windows_spilled", 0))

    fq = getattr(engine, "forward_queue", None)
    if fq is not None:
        fm = fq.metrics()
        reg.gauge("swtpu_spill_queue_depth",
                  "cross-rank forward batches spilled to disk").set(
                      fm.get("forward_queue_depth", 0))
        oldest = fm.get("forward_queue_oldest_ms")
        if oldest is not None:
            reg.gauge("swtpu_spill_queue_oldest_ms",
                      "age of the oldest spilled forward").set(oldest)

    sreg = getattr(engine, "spill_registry", None)
    if sreg is not None:
        sm = sreg.metrics()
        reg.gauge("swtpu_forward_dedup_horizon_age_ms",
                  "age of the forward dedup eviction watermark (-1 = "
                  "nothing evicted yet)").set(
                      sm["forward_dedup_horizon_age_ms"])
        reg.gauge("swtpu_forward_dedup_entries",
                  "forward ids the dedup registry currently holds").set(
                      sm["forward_dedup_entries"])

    feed = getattr(engine, "replica_feed", None)
    applier = getattr(engine, "replica_applier", None)
    if feed is not None or applier is not None:
        inst = replication_metrics(reg)
        if feed is not None:
            fm = feed.metrics()
            inst["lag"].set(fm.get("replica_feed_max_lag_batches", 0))
        if applier is not None:
            # one series PER LEADER this rank stands by for (not a
            # global max): a single lagging follower must show up on
            # the scrape before a failover read hits it
            written: set[tuple] = set()
            for leader, ms in applier.stale_by_leader().items():
                labels = {"leader": str(leader)}
                inst["stale"].set(ms, **labels)
                written.add(tuple(sorted(labels.items())))
            inst["stale"].retain(written)

    flight = getattr(engine, "flight", None)
    if flight is not None:
        reg.gauge("swtpu_flight_records",
                  "batch lifecycle records held by the flight "
                  "recorder").set(len(flight))

    # span plane: scrape-time sync of the tracer's own counters, kept
    # out of engine.metrics() (dispatch-shape equality pin)
    tracer = getattr(engine, "tracer", None)
    if tracer is not None:
        reg.gauge("swtpu_span_records",
                  "completed spans held by the span tracer").set(
                      len(tracer))
        reg.gauge("swtpu_spans_recorded_total",
                  "spans inserted into the tracer ring").set(
                      tracer.recorded)
        reg.gauge("swtpu_spans_sampled_out_total",
                  "spans dropped by the head+tail sampling verdict").set(
                      tracer.sampled_out)

    # SLO latency plane: drain completed ingest lifecycles the
    # recorder accumulated since the last scrape into the per-tenant e2e
    # histogram (the SLO autotuner shares the same drain via
    # harvest_slo — both feed ONE histogram, so exactly-once totals hold
    # no matter which consumer drains first)
    harvest_slo(engine, reg)

    # conservation plane: the flow ledger's host counters + the
    # background auditor's verdict
    from sitewhere_tpu_torch.utils.conservation import (
        export_conservation_metrics)

    export_conservation_metrics(engine, reg)

    # device plane: the memory ledger and the query-path device-time
    # harvest
    from sitewhere_tpu_torch.utils.devicewatch import export_devicewatch

    export_devicewatch(engine, reg)

    # overload-discipline plane: admission-bucket balances,
    # saturation state, and the weighted-fair virtual clocks — the
    # admitted/shed counters are incremented LIVE by the controller;
    # only balances/clocks are sampled here at scrape time
    qos = getattr(engine, "qos", None)
    if qos is not None:
        inst = qos_metrics(reg)
        lbl = getattr(qos, "label", "e?")
        fill = inst["fill"]
        current: set[tuple] = set()
        for tenant, tokens in qos.bucket_fill().items():
            fill.set(tokens, tenant=tenant, engine=lbl)
            current.add(tuple(sorted({"tenant": tenant,
                                      "engine": lbl}.items())))
        fill.retain(current, engine=lbl)
        inst["threshold"].set(qos.shed_threshold, engine=lbl)
        vt = inst["wfq_vtime"]
        keep: set[tuple] = set()
        gate = getattr(engine, "_wfq_gate", None)
        if gate is not None:
            for tenant, v in gate.vtimes().items():
                vt.set(v, tenant=tenant, resource="ingest", engine=lbl)
                keep.add(tuple(sorted({"tenant": tenant,
                                       "resource": "ingest",
                                       "engine": lbl}.items())))
        picker = getattr(getattr(engine, "_query_batcher", None),
                         "_wfq", None)
        if picker is not None:
            for tenant, v in picker.vtimes().items():
                vt.set(v, tenant=tenant, resource="query", engine=lbl)
                keep.add(tuple(sorted({"tenant": tenant,
                                       "resource": "query",
                                       "engine": lbl}.items())))
        vt.retain(keep, engine=lbl)


def harvest_slo(engine, registry: MetricsRegistry | None = None) -> None:
    """Drain completed ingest lifecycles into the per-tenant e2e SLO
    histogram — each record observed exactly once, weighted by its
    payload count, with a trace-id exemplar when the batch landed in the
    slowest decile of its tenant's series (a p99 spike on the scrape
    then links straight to ``Engine.get_trace``). Shared by the
    scrape exporter and the SLO autotuner.

    Every series carries the harvesting engine's ``engine=e<n>`` label:
    the registry is process-global, so without the scope one in-process
    engine's ``decide_slo`` would steer on another engine's
    default-tenant p99. Aggregate
    readers sum across engines via ``count_where``/``quantile_where``."""
    reg = registry or REGISTRY
    harvest = getattr(engine, "slo_harvest", None)
    if callable(harvest):
        hist = slo_metrics(reg)["ingest_e2e"]
        # device-plane sibling: the dispatch->device_ready
        # interval of the SAME records feeds the per-family device
        # execution-time histogram. It rides THIS drain because the
        # records are consume-once — a second consumer would see nothing
        exec_hist = devicewatch_metrics(reg)["exec"]
        lbl = getattr(engine, "metrics_label", "e?")
        for rec in harvest():
            end = rec.stages.get("device_ready")
            if end is None:
                continue
            secs = max(0.0, (end - rec.t0_ns) / 1e9)
            ex = None
            if rec.trace_id is not None:
                q90 = hist.quantile(0.9, tenant=rec.tenant, engine=lbl)
                if q90 is None or secs >= q90:
                    ex = rec.trace_id
            hist.observe_n(secs, max(1, int(rec.n_payloads)),
                           exemplar=ex, tenant=rec.tenant, engine=lbl)
            disp = rec.stages.get("dispatch")
            if disp is not None and end >= disp:
                exec_hist.observe((end - disp) / 1e9, family="ingest")


# --------------------------------------------------------------------------
# Federated cluster exposition: every rank's registry merged
# into ONE rank-labeled payload served from any rank.
# --------------------------------------------------------------------------
def _inject_rank_label(line: str, rank) -> str:
    """Prepend ``rank="<rank>"`` to one sample line's label set without
    reparsing the rest of the line: the existing label body may contain
    escaped quotes and the tail may carry an OpenMetrics exemplar, both
    of which survive verbatim. The closing-brace scan honors quoted
    strings so a ``}`` inside a label VALUE never truncates the set."""
    i, n = 0, len(line)
    while i < n and line[i] not in "{ ":
        i += 1
    name = line[:i]
    rl = f'rank="{_escape_label(rank)}"'
    if i < n and line[i] == "{":
        j, in_str, esc = i + 1, False, False
        while j < n:
            ch = line[j]
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = not in_str
            elif ch == "}" and not in_str:
                break
            j += 1
        if j >= n:
            raise ValueError(f"unterminated label set: {line!r}")
        body = line[i + 1:j]
        sep = "," if body else ""
        return f"{name}{{{rl}{sep}{body}}}{line[j + 1:]}"
    return f"{name}{{{rl}}}{line[i:]}"


def federate_expositions(parts: dict) -> str:
    """Merge per-rank Prometheus expositions into ONE lint-clean payload:
    every sample gains a ``rank`` label, HELP/TYPE comments are deduped
    across ranks (first rank's text wins; a TYPE that genuinely differs
    between ranks is a code bug and fails loudly), and families stay
    contiguous. ``parts`` maps rank -> that rank's exposition text."""
    families: dict[str, dict] = {}
    order: list[str] = []
    for rank in sorted(parts, key=str):
        current: str | None = None
        for line in parts[rank].splitlines():
            if not line:
                continue
            if line.startswith("# HELP "):
                name = line.split(maxsplit=3)[2]
                fam = families.get(name)
                if fam is None:
                    fam = families[name] = {"help": line, "type": None,
                                            "samples": []}
                    order.append(name)
                current = name
                continue
            if line.startswith("# TYPE "):
                p = line.split()
                name = p[2]
                fam = families.get(name)
                if fam is None:
                    fam = families[name] = {"help": f"# HELP {name} ",
                                            "type": None, "samples": []}
                    order.append(name)
                if fam["type"] is None:
                    fam["type"] = line
                elif fam["type"] != line:
                    raise ValueError(
                        f"metric {name!r} exposed with conflicting types "
                        f"across ranks: {fam['type']!r} vs {line!r}")
                current = name
                continue
            if line.startswith("#"):
                continue           # other comments don't federate
            if current is None:
                raise ValueError(
                    f"rank {rank!r} sample before any HELP/TYPE: {line!r}")
            families[current]["samples"].append(
                _inject_rank_label(line, rank))
    lines: list[str] = []
    for name in order:
        fam = families[name]
        lines.append(fam["help"])
        if fam["type"] is not None:
            lines.append(fam["type"])
        lines.extend(fam["samples"])
    return "\n".join(lines) + "\n"


def federated_exposition(engine) -> str:
    """The cluster-shaped exposition of one engine: a clustered engine
    fans out to every rank (``ClusterEngine.cluster_metrics``); a
    single-node engine serves its own registry under
    ``rank="0"`` — with the ``swtpu_cluster_rank_up`` availability
    series, so alerts written against the clustered payload hold on any
    topology."""
    fn = getattr(engine, "cluster_metrics", None)
    if fn is not None:
        return fn()
    export_engine_metrics(engine)
    rank = getattr(engine, "rank", 0)
    text = federate_expositions({rank: REGISTRY.expose_text(exemplars=True)})
    return (text
            + "# HELP swtpu_cluster_rank_up 1 if the rank answered the "
              "federated scrape\n"
              "# TYPE swtpu_cluster_rank_up gauge\n"
            + f'swtpu_cluster_rank_up{{rank="{_escape_label(rank)}"}} 1\n')


# an exemplar suffix as THIS module emits it: labels then a float value,
# anchored at end of line — anchoring (rather than splitting on " # {")
# keeps a label VALUE that happens to contain '# {' intact
_EXEMPLAR_SUFFIX_RE = None


def strip_exemplars(text: str) -> str:
    """Drop OpenMetrics exemplar suffixes from an exposition — the
    Prometheus 0.0.4 text parser rejects a trailing ``# {...}`` on a
    sample line, so surfaces serving ``text/plain`` must shed them."""
    global _EXEMPLAR_SUFFIX_RE
    if _EXEMPLAR_SUFFIX_RE is None:
        import re

        _EXEMPLAR_SUFFIX_RE = re.compile(
            r' # \{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"\} [^ ]+$')
    return "\n".join(_EXEMPLAR_SUFFIX_RE.sub("", line)
                     for line in text.splitlines()) + "\n"
