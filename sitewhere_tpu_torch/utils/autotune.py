"""Stage-time autotuner: steer ingest knobs toward the measured bottleneck
(a copy of ``sitewhere_tpu/utils/autotune.py``).

The flight recorder already timestamps every batch's lifecycle
(decode -> WAL -> commit -> dispatch -> device-ready) at near-zero cost;
this controller closes the loop. Every ``interval`` dispatches it takes
the MEDIAN per-stage durations over the recent record window
(utils/flight.stage_durations — the same harvesting rule bench.py
reports) and nudges ONE knob toward the dominant stage:

  decode dominates      -> widen the sharded-decode worker fan-out
  device dominates      -> deepen ``dispatch_depth`` (host/device overlap)
  dispatch overhead     -> double ``scan_chunk`` (amortize per-dispatch
     dominates             cost; opt-in — a chunk change recompiles the
                           arena scan program and rebuilds the pool)

with hysteresis (raise thresholds ~4x above the lower thresholds) so a
noisy window cannot ping-pong a knob. One change per evaluation keeps
every adjustment attributable. Decisions are kept on the controller
(``decisions``) and exported as gauges so an operator can see WHAT the
tuner believes and WHY without attaching a debugger:

  swtpu_autotune_ingest_workers / _dispatch_depth / _scan_chunk
  swtpu_autotune_adjustments (counter, labeled by knob + direction)

Every series carries a per-controller ``engine`` label (process-wide
creation index): several autotuned engines in one process must not
clobber each other's telemetry.
"""

from __future__ import annotations

import itertools
import statistics

from sitewhere_tpu_torch.utils.flight import stage_durations
from sitewhere_tpu_torch.utils.metrics import REGISTRY

_ENGINE_IDS = itertools.count()

G_WORKERS = REGISTRY.gauge(
    "swtpu_autotune_ingest_workers",
    "Sharded-decode worker fan-out chosen by the stage-time autotuner")
G_DEPTH = REGISTRY.gauge(
    "swtpu_autotune_dispatch_depth",
    "dispatch_depth chosen by the stage-time autotuner")
G_CHUNK = REGISTRY.gauge(
    "swtpu_autotune_scan_chunk",
    "scan_chunk chosen by the stage-time autotuner")
C_ADJUST = REGISTRY.counter(
    "swtpu_autotune_adjustments",
    "Autotuner knob adjustments, labeled by knob and direction")
G_SHED = REGISTRY.gauge(
    "swtpu_autotune_shed_threshold",
    "QoS saturation shed threshold chosen by the SLO autotuner")
G_P99 = REGISTRY.gauge(
    "swtpu_autotune_p99_ms",
    "worst per-tenant ingest-e2e p99 the SLO autotuner last observed")


def decide(stats: dict, current: dict, bounds: dict) -> list[tuple]:
    """Pure decision rule: (median stage durations, current knob values,
    knob bounds) -> ordered [(knob, new_value, reason)] proposals. Pure
    so tests can pin the policy without fabricating an engine. The
    caller applies at most the first proposal."""
    decode = stats.get("decode_ms") or 0.0
    wal = stats.get("wal_ms") or 0.0
    wait = stats.get("dispatch_wait_ms") or 0.0
    device = stats.get("device_ms") or 0.0
    host = decode + wal
    out = []
    workers = current["ingest_workers"]
    depth = current["dispatch_depth"]
    chunk = current["scan_chunk"]
    if (decode > device and decode > wal + wait
            and workers < bounds["max_workers"]):
        out.append(("ingest_workers", workers + 1,
                    f"decode {decode:.2f}ms dominates device "
                    f"{device:.2f}ms"))
    if workers > 1 and decode < 0.25 * device:
        out.append(("ingest_workers", workers - 1,
                    f"decode {decode:.2f}ms << device {device:.2f}ms; "
                    "shed shard overhead"))
    if device > 1.5 * max(host, 1e-9) and depth < bounds["max_depth"]:
        out.append(("dispatch_depth", depth + 1,
                    f"device {device:.2f}ms > host {host:.2f}ms; "
                    "overlap more programs"))
    if depth > 1 and device < 0.25 * max(host, 1e-9):
        out.append(("dispatch_depth", depth - 1,
                    f"device {device:.2f}ms << host {host:.2f}ms; "
                    "shed queue latency"))
    if wait > 2.0 * max(device, 1e-9) and chunk < bounds["max_chunk"]:
        out.append(("scan_chunk", chunk * 2,
                    f"dispatch wait {wait:.2f}ms > 2x device "
                    f"{device:.2f}ms; amortize dispatch"))
    if chunk > 1 and wait < 0.25 * max(device, 1e-9):
        out.append(("scan_chunk", max(1, chunk // 2),
                    f"dispatch wait {wait:.2f}ms << device "
                    f"{device:.2f}ms; shed chunk latency"))
    return out


def decide_slo(p99_ms: float | None, target_ms: float, stats: dict,
               current: dict, bounds: dict) -> list[tuple]:
    """Pure SLO policy: steer toward a per-tenant ingest-e2e
    p99 TARGET instead of raw throughput. Proposals only fire outside
    the hysteresis dead band [0.5x, 1.25x] around the target, so scrape
    noise cannot ping-pong a knob.

    Violating (p99 > 1.25x target) — relieve the measured bottleneck
    first (the same stage attribution as the throughput policy: decode
    dominance widens fan-out, device dominance overlaps programs, a
    latency-costly scan chunk halves), then TIGHTEN the shed threshold
    (shed earlier: trade goodput for tail). Comfortable (p99 < 0.5x
    target) — RELAX the shed threshold back toward bounds so goodput
    recovers once the tail is safe. One change per evaluation, like the
    throughput policy; the caller applies the first proposal."""
    out: list[tuple] = []
    if p99_ms is None or target_ms is None or target_ms <= 0:
        return out
    decode = stats.get("decode_ms") or 0.0
    wal = stats.get("wal_ms") or 0.0
    wait = stats.get("dispatch_wait_ms") or 0.0
    device = stats.get("device_ms") or 0.0
    host = decode + wal
    workers = current.get("ingest_workers", 1)
    depth = current.get("dispatch_depth", 1)
    chunk = current.get("scan_chunk", 1)
    shed = current.get("shed_threshold")
    why = f"p99 {p99_ms:.1f}ms vs target {target_ms:.1f}ms"
    if p99_ms > 1.25 * target_ms:
        if (decode > device and decode > wal + wait
                and workers < bounds["max_workers"]):
            out.append(("ingest_workers", workers + 1,
                        f"{why}: decode {decode:.2f}ms dominates; "
                        "widen fan-out"))
        if (device > 1.5 * max(host, 1e-9)
                and depth < bounds["max_depth"]):
            out.append(("dispatch_depth", depth + 1,
                        f"{why}: device {device:.2f}ms dominates; "
                        "overlap programs"))
        if chunk > 1:
            out.append(("scan_chunk", max(1, chunk // 2),
                        f"{why}: scan chunk adds K-1 batches of "
                        "latency; halve it"))
        if shed is not None and shed > bounds.get("min_shed", 1):
            out.append(("shed_threshold",
                        max(bounds.get("min_shed", 1), shed // 2),
                        f"{why}: shed earlier to protect the tail"))
    elif p99_ms < 0.5 * target_ms:
        if shed is not None and shed < bounds.get("max_shed", shed):
            out.append(("shed_threshold",
                        min(bounds["max_shed"], shed * 2),
                        f"{why}: tail is safe; admit more"))
    return out


class StageTimeAutotuner:
    """Periodic controller over one engine's ingest knobs.

    ``note_dispatch()`` is the engine's per-dispatch hook (called under
    the engine lock — applying a knob re-enters the same RLock). Knob
    application goes through ``engine.set_ingest_tuning``, the single
    choke point that knows how to rebuild what each knob invalidates.
    ``adapt_scan_chunk`` stays opt-in: a chunk change recompiles the
    arena scan step and reallocates the pinned arenas — only a
    deployment that can afford mid-run recompiles should allow it."""

    MIN_SAMPLES = 8

    def __init__(self, engine, interval: int = 64, window: int = 128,
                 max_workers: int | None = None, max_depth: int = 4,
                 max_chunk: int = 8, adapt_scan_chunk: bool = False):
        self.engine = engine
        self.interval = max(1, interval)
        self.window = window
        sharder = getattr(engine, "_sharder", None)
        self.max_workers = (max_workers if max_workers is not None
                            else (sharder.n_workers if sharder else 1))
        self.max_depth = max_depth
        self.max_chunk = max_chunk
        self.adapt_scan_chunk = adapt_scan_chunk
        self.decisions: list[dict] = []
        self._since = 0
        self.evaluations = 0
        self.label = f"e{next(_ENGINE_IDS)}"
        # SLO objective: with a p99 target configured, the
        # controller steers toward the target (decide_slo) instead of
        # raw throughput, and additionally owns the QoS shed threshold
        self.slo_target_ms = getattr(engine.config,
                                     "slo_p99_target_ms", None)
        # per-series (bucket counts, total) snapshot from the previous
        # evaluation — slo_p99_ms() steers on the delta, never the
        # cumulative-forever histogram
        self._slo_prev: dict[tuple, tuple[list[int], int]] = {}
        bc = max(1, getattr(engine.config, "batch_capacity", 1))
        self.min_shed = bc
        self.max_shed = 64 * bc * max(1, getattr(engine.config,
                                                 "scan_chunk", 1))

    def current(self) -> dict:
        eng = self.engine
        sharder = getattr(eng, "_sharder", None)
        out = {
            "ingest_workers": (sharder.active_workers if sharder else 1),
            "dispatch_depth": max(1, eng.config.dispatch_depth),
            "scan_chunk": max(1, eng.config.scan_chunk),
        }
        qos = getattr(eng, "qos", None)
        out["shed_threshold"] = (qos.shed_threshold if qos is not None
                                 else None)
        return out

    def note_dispatch(self) -> None:
        self._since += 1
        if self._since < self.interval:
            return
        self._since = 0
        self.evaluate()

    def window_stats(self) -> dict | None:
        """Median per-stage durations over recent ingest records; None
        until the window holds enough samples to trust."""
        durs = [stage_durations(r.get("stagesUs", {}))
                for r in self.engine.flight.recent(self.window,
                                                   kind="ingest")]
        if len(durs) < self.MIN_SAMPLES:
            return None
        out = {}
        for key in ("decode_ms", "wal_ms", "dispatch_wait_ms", "device_ms"):
            vals = [d[key] for d in durs if d[key] is not None]
            out[key] = statistics.median(vals) if vals else None
        return out

    def slo_p99_ms(self) -> float | None:
        """Worst per-tenant ingest-e2e p99 (ms) over the WINDOW since
        the previous evaluation, read off the registry's SLO histogram
        (``swtpu_ingest_e2e_seconds``) and restricted to THIS engine's
        tenants — the registry is process-global. Windowing matters:
        the histogram is cumulative-forever, so a lifetime quantile
        would let one early overload (jit warmup, a single burst) pin
        the reading above target for the rest of the process and
        ratchet the shed threshold to its floor with no way to observe
        recovery — each evaluation therefore diffs the bucket counts
        against its previous snapshot and interpolates the quantile
        from the delta (same bounding-bucket rule as
        ``Histogram.quantile``; overflow clamps to the last finite
        bound). ``None`` when the window saw no observations — the
        policy then holds rather than acting on stale data. Harvests
        pending flight records first through the same consume-once
        drain the scrape exporter uses; both feed ONE histogram, so
        exactly-once totals hold regardless of who drains first.

        Scope: the
        harvest stamps every series with the harvesting engine's
        ``engine=e<n>`` label (metrics.harvest_slo), and this reader
        keeps ONLY its own engine's series — two SLO-targeted engines in
        one process no longer share the default-tenant reading, so one
        rank's steering can never act on another rank's tenants (pinned
        by a two-engine test in tests/test_qos.py)."""
        from sitewhere_tpu_torch.utils.metrics import harvest_slo, slo_metrics

        harvest_slo(self.engine)
        hist = slo_metrics()["ingest_e2e"]
        with hist._lock:
            snap = {k: (list(v), hist._totals.get(k, 0))
                    for k, v in hist._counts.items()}
        mine = getattr(self.engine, "metrics_label", None)
        worst = None
        for key, (counts, total) in snap.items():
            labels = dict(key)
            tenant = labels.get("tenant")
            if tenant is None or labels.get("engine") != mine:
                continue
            prev_counts, prev_total = self._slo_prev.get(
                key, ([0] * len(counts), 0))
            self._slo_prev[key] = (counts, total)
            delta = [c - p for c, p in zip(counts, prev_counts)]
            n = total - prev_total
            if n <= 0:
                continue
            target = 0.99 * n
            acc = 0
            q = hist.buckets[-1]
            for i, c in enumerate(delta):
                if c and acc + c >= target:
                    lo = hist.buckets[i - 1] if i else 0.0
                    hi = hist.buckets[i]
                    frac = min(1.0, max(0.0, (target - acc) / c))
                    q = lo + (hi - lo) * frac
                    break
                acc += c
            if worst is None or q > worst:
                worst = q
        return worst * 1000.0 if worst is not None else None

    def evaluate(self) -> dict | None:
        """One control step: measure, decide, apply at most one change,
        export gauges. With an SLO target the decision rule is
        ``decide_slo`` (p99-vs-target with hysteresis, shed threshold
        included); otherwise the throughput rule ``decide``. Returns the
        applied decision (or None)."""
        self.evaluations += 1
        stats = self.window_stats()
        applied = None
        p99_ms = None
        if self.slo_target_ms is not None:
            p99_ms = self.slo_p99_ms()
            if p99_ms is not None:
                G_P99.set(p99_ms, engine=self.label)
        if stats is not None:
            cur = self.current()
            bounds = {"max_workers": self.max_workers,
                      "max_depth": self.max_depth,
                      "max_chunk": self.max_chunk,
                      "min_shed": self.min_shed,
                      "max_shed": self.max_shed}
            if self.slo_target_ms is not None:
                proposals = decide_slo(p99_ms, self.slo_target_ms,
                                       stats, cur, bounds)
            else:
                proposals = decide(stats, cur, bounds)
            for knob, value, reason in proposals:
                if knob == "scan_chunk" and not self.adapt_scan_chunk:
                    continue
                self.engine.set_ingest_tuning(**{knob: value})
                applied = {"knob": knob, "from": cur[knob], "to": value,
                           "reason": reason, "stats": stats,
                           "p99_ms": p99_ms}
                self.decisions.append(applied)
                del self.decisions[:-64]
                C_ADJUST.inc(engine=self.label, knob=knob,
                             direction="up" if value > (cur[knob] or 0)
                             else "down")
                break
        cur = self.current()
        G_WORKERS.set(cur["ingest_workers"], engine=self.label)
        G_DEPTH.set(cur["dispatch_depth"], engine=self.label)
        G_CHUNK.set(cur["scan_chunk"], engine=self.label)
        if cur.get("shed_threshold") is not None:
            G_SHED.set(cur["shed_threshold"], engine=self.label)
        return applied
