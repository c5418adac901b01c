"""Overload discipline: per-tenant admission control + weighted-fair
scheduling (a copy of ``sitewhere_tpu/utils/qos.py``).

The reference platform isolates tenants structurally — every tenant gets
its own engine and database, so one tenant's flood can only sink its own
pipeline. The device-resident engine deliberately shares everything (one
arena pool, one WAL, one device step, one query batcher) for throughput,
which re-creates the classic shared-resource tail problem (Dean &
Barroso, "The Tail at Scale"): nothing stops an abusive tenant from
inflating every other tenant's p99. This module is the enforcement
plane:

  * :class:`TokenBucket` / :class:`AdmissionController` — seeded,
    deterministic per-tenant token-bucket admission, applied at the
    ingest EDGES (REST, RPC, cluster forward handlers, loadgen) and
    NEVER inside the engine's own ingest methods: WAL replay and the
    replication applier must be able to re-apply durable events
    unconditionally, or recovery/standby byte-parity would break.
    Shedding is explicit — HTTP ``429`` + ``Retry-After`` at the REST
    edge, a typed ``RpcError(code=429)`` app-reject at the RPC edge (so
    ``ForwardQueue.retry_once`` classifies it as an application reject
    and never head-of-line-stalls behind it), and a typed
    :class:`ShedError` everywhere in between.
  * :class:`WeightedFairGate` — weighted-fair queuing of the ingest
    critical section (the contended resource behind ``ArenaPool``
    slots): per-tenant virtual-time deficit counters order which
    tenant's batch gets the next turn, so a flood of one tenant's
    batches can no longer starve everyone parked behind it in lock
    order. Uncontended turns are a couple of dict ops.
  * :class:`WFQPicker` — the same virtual-time rule applied to
    ``QueryBatcher`` round membership (today first-come): under read
    contention a tenant's share of fused-program slots follows its
    weight, not its arrival burstiness.

Determinism: every admission decision is a pure function of (config,
clock readings, call sequence). The controller takes an injectable
``clock`` callable; :class:`ManualClock` lets tests and chaos harnesses
replay an admission trace exactly.

All QoS telemetry lives in the Prometheus REGISTRY
(``swtpu_qos_*``, utils/metrics.qos_metrics) and is kept OUT of
``engine.metrics()`` — the full-metrics-dict equality across dispatch
shapes is a tested parity property.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time

# one label per controller (same scheme as the autotuner's gauges): the
# metrics REGISTRY is process-global, so without an engine label two
# QoS-enabled engines in one process (in-process cluster ranks, tests)
# would merge counters and last-writer-win each other's gauges
_QOS_IDS = itertools.count()


class ShedError(RuntimeError):
    """A load-shed refusal (typed, carries the retry hint). Raised at
    admission edges and by the arena-stall translation; the REST layer
    maps it to ``429`` + ``Retry-After``, the RPC server to a
    ``code=429`` error frame."""

    def __init__(self, message: str, tenant: str | None = None,
                 retry_after_s: float = 0.05, reason: str = "shed"):
        super().__init__(message)
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)
        self.reason = reason


class ManualClock:
    """Deterministic clock for admission tests/chaos replay: time moves
    only when the harness says so."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def advance(self, dt: float) -> None:
        self.t += float(dt)

    def __call__(self) -> float:
        return self.t


class TokenBucket:
    """One tenant's admission budget: ``rate`` tokens/s refill up to
    ``capacity``. Pure arithmetic over clock readings — no wall-clock
    reads of its own, so a replayed clock replays the decisions."""

    __slots__ = ("rate", "capacity", "tokens", "t_last")

    def __init__(self, rate_eps: float, burst_s: float, now: float):
        self.rate = float(rate_eps)
        self.capacity = max(1.0, self.rate * float(burst_s))
        self.tokens = self.capacity
        self.t_last = float(now)

    def take(self, n: int, now: float) -> tuple[bool, float]:
        """Try to take ``n`` tokens at clock reading ``now``; returns
        (admitted, seconds_until_enough_tokens). A request larger than
        ``capacity`` can never accumulate ``n`` tokens, so it admits
        against a FULL bucket and drives the balance negative — the debt
        throttles what follows, preserving the long-run rate. Refusing
        it outright would hand the caller a retry hint that waiting can
        never satisfy (a 429 loop at the REST edge, a forward spill that
        redelivers forever)."""
        if now > self.t_last:
            self.tokens = min(self.capacity,
                              self.tokens + (now - self.t_last) * self.rate)
        self.t_last = max(self.t_last, now)
        need = min(float(n), self.capacity)
        if self.tokens >= need:
            self.tokens -= n
            return True, 0.0
        return False, (need - self.tokens) / self.rate


@dataclasses.dataclass
class Admission:
    """One admission decision. ``reason`` on a shed: "rate" (tenant over
    its token bucket) or "saturated" (engine backlog over the shed
    threshold)."""

    admitted: bool
    retry_after_s: float = 0.0
    reason: str | None = None


class AdmissionController:
    """Per-tenant token-bucket admission + engine-saturation shedding.

    ``tenant_rates`` maps tenant -> admitted events/s (a tenant absent
    from the map gets ``default_rate_eps``; 0 = no per-tenant cap).
    ``shed_threshold`` is a staged-row backlog bound: while
    ``backlog_fn()`` is at or above it, EVERY tenant sheds with reason
    "saturated" — the global overload valve the SLO autotuner steers.
    Decisions are counted live into ``swtpu_qos_admitted_total`` /
    ``swtpu_qos_shed_total{reason}`` so shed visibility never depends on
    a scrape ordering."""

    def __init__(self, *, tenant_rates: dict | None = None,
                 default_rate_eps: float = 0.0, burst_s: float = 2.0,
                 shed_threshold: int = 0, backlog_fn=None,
                 clock=time.monotonic, min_retry_after_s: float = 0.05,
                 label: str | None = None):
        from sitewhere_tpu_torch.utils.metrics import qos_metrics

        self.label = label or f"e{next(_QOS_IDS)}"
        self.tenant_rates = dict(tenant_rates or {})
        self.default_rate_eps = float(default_rate_eps)
        self.burst_s = float(burst_s)
        self.shed_threshold = int(shed_threshold)
        self._backlog_fn = backlog_fn
        self._clock = clock
        self.min_retry_after_s = float(min_retry_after_s)
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}
        # conservation accounting: ``offered_events`` counts
        # at admit() ENTRY, independently of the verdict, so the edge
        # equation offered == admitted + edge-sheds is falsifiable —
        # never derived from its own right-hand side. ``shed_noted``
        # counts sheds recorded via note_shed (e.g. an arena stall AFTER
        # admission): those events were already offered-and-admitted, so
        # the checker subtracts them from the edge shed total.
        self.offered_events = 0
        self.admitted_events = 0
        self.shed_events = 0
        self.shed_noted = 0
        self.shed_by_tenant: dict[str, int] = {}
        self._metrics = qos_metrics()

    def _rate_for(self, tenant: str) -> float:
        if tenant in self.tenant_rates:
            return float(self.tenant_rates[tenant])
        return self.default_rate_eps

    def _count_shed(self, tenant: str, n: int, reason: str) -> None:
        self.shed_events += n
        self.shed_by_tenant[tenant] = self.shed_by_tenant.get(tenant, 0) + n
        self._metrics["shed"].inc(n, tenant=tenant, reason=reason,
                                  engine=self.label)

    def admit(self, tenant: str, n: int = 1) -> Admission:
        """Decide on ``n`` events for ``tenant``. Saturation is checked
        first (it protects every tenant's tail), then the tenant's own
        bucket; a shed never consumes tokens."""
        tenant = tenant or "default"
        n = max(1, int(n))
        with self._lock:
            self.offered_events += n
            now = self._clock()
            if self.shed_threshold and self._backlog_fn is not None:
                saturated = self._backlog_fn() >= self.shed_threshold
                self._metrics["saturated"].set(1.0 if saturated else 0.0,
                                               engine=self.label)
                if saturated:
                    self._count_shed(tenant, n, "saturated")
                    return Admission(False, self.min_retry_after_s,
                                     "saturated")
            rate = self._rate_for(tenant)
            if rate > 0:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = TokenBucket(
                        rate, self.burst_s, now)
                ok, wait = bucket.take(n, now)
                if not ok:
                    self._count_shed(tenant, n, "rate")
                    return Admission(
                        False, max(self.min_retry_after_s, wait), "rate")
            self.admitted_events += n
            self._metrics["admitted"].inc(n, tenant=tenant,
                                          engine=self.label)
            return Admission(True)

    def note_shed(self, tenant: str, n: int, reason: str) -> None:
        """Count a shed decided elsewhere (e.g. an arena stall translated
        by the engine) so the ``swtpu_qos_shed_total`` ledger stays the
        one place sheds are visible."""
        with self._lock:
            self.shed_noted += max(1, int(n))
            self._count_shed(tenant or "default", max(1, int(n)), reason)

    def bucket_fill(self) -> dict[str, float]:
        """Current token balance per tenant (refreshed to the current
        clock reading) — the scrape-time gauge source."""
        with self._lock:
            now = self._clock()
            out = {}
            for tenant, b in self._buckets.items():
                if now > b.t_last:
                    b.tokens = min(b.capacity,
                                   b.tokens + (now - b.t_last) * b.rate)
                    b.t_last = now
                out[tenant] = b.tokens
            return out


def admit_or_raise(engine, tenant: str, n: int = 1) -> None:
    """Edge helper: consult ``engine.qos`` (None = QoS off) and raise a
    typed :class:`ShedError` on refusal. The REST/RPC layers translate
    the error to their wire form (429 + Retry-After)."""
    qos = getattr(engine, "qos", None)
    if qos is None:
        return
    d = qos.admit(tenant or "default", n)
    if not d.admitted:
        raise ShedError(
            f"tenant {tenant!r} shed ({d.reason}): retry after "
            f"{d.retry_after_s:.3f}s", tenant=tenant,
            retry_after_s=d.retry_after_s, reason=d.reason or "shed")


class WeightedFairGate:
    """Weighted-fair turn-taking over one exclusive resource (the
    engine's ingest critical section — the path that acquires
    ``ArenaPool`` slots and staging-buffer room).

    Virtual-time rule: each granted turn charges its tenant
    ``cost / weight`` virtual seconds; a waiter proceeds only when no
    OTHER tenant is waiting with a smaller virtual time. A tenant
    arriving after idling is clamped to the gate's current virtual
    clock, so silence never banks priority. Under saturation (every
    tenant always has a waiter) grant throughput converges to the
    weight ratio — 2:1 weights serve ~2:1 events — while an uncontended
    turn is granted immediately."""

    def __init__(self, weights: dict | None = None,
                 default_weight: float = 1.0):
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        self._cv = threading.Condition()
        self._vtime: dict[str, float] = {}
        self._vnow = 0.0
        self._waiting: dict[str, int] = {}
        self._busy = False
        self.grants: dict[str, int] = {}   # tenant -> granted cost units

    def weight(self, tenant: str) -> float:
        return max(1e-9, float(self.weights.get(tenant,
                                                self.default_weight)))

    def _prior_waiter(self, tenant: str) -> bool:
        mine = self._vtime[tenant]
        for t, n in self._waiting.items():
            if t != tenant and n > 0 and self._vtime[t] < mine:
                return True
        return False

    @contextlib.contextmanager
    def turn(self, tenant: str, cost: float = 1.0):
        tenant = tenant or "default"
        cost = max(1.0, float(cost))
        with self._cv:
            # late arrival after idling starts at the current virtual
            # clock — it may not cash in its silence as priority
            self._vtime[tenant] = max(self._vtime.get(tenant, 0.0),
                                      self._vnow)
            self._waiting[tenant] = self._waiting.get(tenant, 0) + 1
            while self._busy or self._prior_waiter(tenant):
                self._cv.wait()
            self._waiting[tenant] -= 1
            if not self._waiting[tenant]:
                del self._waiting[tenant]
            self._busy = True
            self._vnow = self._vtime[tenant]
            self._vtime[tenant] += cost / self.weight(tenant)
            self.grants[tenant] = self.grants.get(tenant, 0) + int(cost)
        try:
            yield
        finally:
            with self._cv:
                self._busy = False
                self._cv.notify_all()

    def vtimes(self) -> dict[str, float]:
        with self._cv:
            return dict(self._vtime)


class WFQPicker:
    """Weighted-fair round membership for the query batcher: given the
    queued entries (each a dict carrying ``"tenant"``), select up to
    ``k`` in virtual-time order, FIFO within a tenant. Single-threaded
    (the batcher calls it under its own mutex); virtual time persists
    across rounds so a backlogged tenant's share follows its weight over
    time, not per round."""

    def __init__(self, weights: dict | None = None,
                 default_weight: float = 1.0):
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        self._vtime: dict[str, float] = {}
        self._vnow = 0.0

    def weight(self, tenant: str) -> float:
        return max(1e-9, float(self.weights.get(tenant,
                                                self.default_weight)))

    def pick(self, entries: list, k: int) -> tuple[list, list]:
        """(selected, rest) — ``rest`` keeps arrival order."""
        queues: dict[str, list] = {}
        for e in entries:
            queues.setdefault(e.get("tenant") or "default", []).append(e)
        for t in queues:
            self._vtime[t] = max(self._vtime.get(t, 0.0), self._vnow)
        selected: list = []
        chosen: set[int] = set()
        while len(selected) < k and queues:
            t = min(queues, key=lambda q: (self._vtime[q], q))
            e = queues[t].pop(0)
            selected.append(e)
            chosen.add(id(e))
            self._vnow = self._vtime[t]
            self._vtime[t] += 1.0 / self.weight(t)
            if not queues[t]:
                del queues[t]
        rest = [e for e in entries if id(e) not in chosen]
        return selected, rest

    def vtimes(self) -> dict[str, float]:
        return dict(self._vtime)
