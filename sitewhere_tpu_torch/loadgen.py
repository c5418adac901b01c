"""Load generator (port of ``sitewhere_tpu/loadgen.py``: the closed-loop
load of the wire-ingest path, the open-loop part and the persistent-
connection wire mode, and the REST load).

* ``run_engine_load`` generates the canonical DeviceRequest measurement
  JSON and drives the engine's native host path — payload bytes -> native
  decode -> staging arena -> fused step -> device state — reporting
  throughput and per-batch latency percentiles.
* ``build_open_loop_schedule`` / ``run_open_loop``: seeded per-tenant
  Poisson arrivals (with the noisy-neighbour knob), replayed on the clock
  against an engine, the generator acting as the QoS admission edge; the
  result is each tenant's latency from scheduled arrival to visible
  state. ``schedule_fingerprint`` pins a schedule byte for byte.
* ``build_wire_schedule`` / ``run_wire_load``: N live MQTT connections
  against a ``WireEdge``, each publishing its own seeded frames at QoS 1
  (every publish awaits its WAL-durable PUBACK);
  ``wire_schedule_fingerprint`` pins the frames.
* ``run_rest_load``: N concurrent workers posting M measurements each to
  the REST gateway over the port's own HTTP client.
* ``main``: ``python -m sitewhere_tpu_torch.loadgen [--open-loop]
  [--shards N] [--device cuda|cpu]`` builds an ``Engine`` (or an
  ``SpmdEngine``) on the card unless asked for the CPU.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import time

import numpy as np


def generate_measurements_message(token: str, seq: int,
                                  name: str = "engine.temperature",
                                  value: float | None = None) -> bytes:
    """Canonical JSON measurement DeviceRequest."""
    payload = {
        "deviceToken": token,
        "type": "DeviceMeasurement",
        "request": {
            "name": name,
            "value": value if value is not None else round(20.0 + (seq % 80) * 0.5, 2),
            "eventDate": None,
            "updateState": True,
            "metadata": {"seq": str(seq)},
        },
    }
    return json.dumps(payload).encode()


@dataclasses.dataclass
class LoadStats:
    events_sent: int
    events_decoded: int
    events_failed: int
    wall_s: float
    events_per_s: float
    latency_p50_ms: float
    latency_p99_ms: float
    latency_max_ms: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _percentiles(lat_ms: list[float]) -> tuple[float, float, float]:
    arr = np.asarray(lat_ms)
    return (float(np.percentile(arr, 50)), float(np.percentile(arr, 99)),
            float(arr.max()))


def batch_maker(n_devices: int, batch_size: int, seed: int = 0):
    """``make(b)``: batch ``b`` of :func:`run_engine_load`'s stream, its
    devices drawn from one seeded generator. Called in the order the load
    calls it (the warm-up batches ``0..W-1``, then ``0..N-1``), it gives
    the load's payloads."""
    rng = np.random.default_rng(seed)
    toks = [f"lg-{i}" for i in range(n_devices)]

    def make_batch(b: int) -> list[bytes]:
        picks = rng.integers(0, n_devices, batch_size)
        return [generate_measurements_message(toks[d], b * batch_size + i)
                for i, d in enumerate(picks)]

    return make_batch


def run_engine_load(engine, n_batches: int = 50, batch_size: int = 4096,
                    n_devices: int = 10_000, seed: int = 0,
                    warmup_batches: int = 3,
                    pipelined: bool = False) -> LoadStats:
    """Drive the full host path: JSON bytes -> native decode -> staged ->
    fused step -> device state.

    pipelined=False — per-batch latency = submit -> flush return (state
    merged and visible on the host).
    pipelined=True — steady-state throughput: batches dispatch without a
    readback (the engine bounds outstanding dispatches by its
    ``dispatch_depth``); a batch's latency runs from its submit to the
    return of the call that dispatched its last row, and the timed window
    ends at a readback-free ``barrier()``.
    """
    make_batch = batch_maker(n_devices, batch_size, seed)
    for w in range(warmup_batches):          # interners and allocator warm
        engine.ingest_json_batch(make_batch(w))
        if not pipelined:
            engine.flush()
    if pipelined:
        engine.barrier()
    else:
        engine.flush()

    # payloads are built first, so the generator stays out of the timing
    prebuilt = [make_batch(b) for b in range(n_batches)]
    latencies: list[float] = []
    decoded = failed = 0
    submits: list[float] = []
    t0 = time.perf_counter()
    for payloads in prebuilt:
        s0 = time.perf_counter()
        res = engine.ingest_json_batch(payloads)
        if pipelined:
            submits.append(s0)
            if engine.staged_count:
                engine.flush_async()
            if engine.staged_count == 0:
                done = time.perf_counter()
                latencies.extend((done - s) * 1e3 for s in submits)
                submits.clear()
        else:
            engine.flush()                    # state merged on return
            latencies.append((time.perf_counter() - s0) * 1e3)
        decoded += res["decoded"]
        failed += res["failed"]
    if pipelined:
        engine.barrier()                      # the tail, no readback
        done = time.perf_counter()
        latencies.extend((done - s) * 1e3 for s in submits)
    wall = time.perf_counter() - t0
    p50, p99, mx = _percentiles(latencies)
    sent = n_batches * batch_size
    return LoadStats(sent, decoded, failed, wall, sent / wall, p50, p99, mx)


@dataclasses.dataclass
class TenantLoad:
    """One tenant's arrival process and workload mix."""

    tenant: str
    rate_eps: float                    # mean event arrival rate (Poisson)
    n_devices: int = 64
    device_prefix: str | None = None   # default "<tenant>-dev"
    query_every: int = 0               # one query per N ingest frames
    mutate_every: int = 0              # one entity mutation per N frames
    history_every: int = 0             # one HISTORICAL query per N frames:
                                       # a date range ending history_age_ms
                                       # in the past, so an archive-primed
                                       # engine serves it from the tiered
                                       # (ring + disk) read path
    history_age_ms: int = 60_000       # how far behind "now" the range ends
    analytics_every: int = 0           # one historical SCORING JOB per N
                                       # frames: a deterministic
                                       # marker, mirror of history_every —
                                       # the schedule stays a pure function
                                       # of the spec (the generator resolves
                                       # it against engine.analytics_jobs
                                       # at fire time; engines without the
                                       # manager skip it), and with the
                                       # knob OFF the schedule is
                                       # byte-identical to pre-knob runs
    abusive_mult: float = 1.0          # noisy-neighbor knob:
                                       # during burst windows the tenant
                                       # offers rate_eps * abusive_mult.
                                       # Extra arrivals come from a
                                       # SEPARATE seeded stream, so a
                                       # schedule with the knob OFF stays
                                       # byte-identical to pre-knob runs
    abusive_period_s: float = 0.0      # burst window period; 0 (with
                                       # mult > 1) = the whole horizon
    abusive_burst_s: float = 0.0       # burst length within each period
    abusive_device: int | None = None  # hotspot knob: pin
                                       # every EXTRA (abusive-stream)
                                       # event onto this one device
                                       # index, concentrating the burst
                                       # on a single placement slot /
                                       # shard lane so the heat plane
                                       # has a known-hot target. None
                                       # (default) keeps the extra
                                       # stream's device picks from the
                                       # base RNG — byte-identical to
                                       # pre-knob schedules
    rule_trigger_eps: float = 0.0      # rule-trigger traffic:
                                       # a SEPARATE seeded Poisson stream
                                       # of threshold-crossing
                                       # measurements (value =
                                       # rule_value on rule_channel)
                                       # superimposed on the base load —
                                       # same additivity/fingerprint
                                       # discipline as the abusive knob:
                                       # with the knob OFF (rate 0) the
                                       # schedule is byte-identical to a
                                       # pre-knob run
    rule_period_s: float = 0.0         # trigger burst period; 0 (with
                                       # eps > 0) = the whole horizon
    rule_burst_s: float = 0.0          # burst length within each period
    rule_channel: str = "engine.temperature"   # channel the crossings hit
    rule_value: float = 96.5           # crossing value (exactly f32-
                                       # representable so sum-rollup
                                       # parity is rounding-order-free)


@dataclasses.dataclass(frozen=True)
class OpenLoopSpec:
    """A complete, seed-determined load description: same spec + same
    seed => byte-identical payload stream and identical arrival
    schedule (pinned by tests/test_loadgen.py)."""

    tenants: tuple
    duration_s: float = 1.0
    frame_size: int = 64               # events per ingest submission
    seed: int = 0


@dataclasses.dataclass
class ScheduledOp:
    """One scheduled action. ``t_s`` is the arrival offset from schedule
    start; ingest frames also carry each event's OWN arrival offset so
    latency is measured per event, from the moment it notionally hit
    the wire — not from whenever the backlogged generator got to it."""

    t_s: float
    kind: str                          # "ingest" | "query" | "mutate"
    tenant: str
    payloads: list | None = None
    arrivals: tuple | None = None
    query: dict | None = None
    mutate: tuple | None = None        # (op, token, metadata)
    analytics: dict | None = None      # AnalyticsJobSpec kwargs


_KIND_ORDER = {"ingest": 0, "query": 1, "mutate": 2, "analytics": 3}


def build_open_loop_schedule(spec: OpenLoopSpec) -> list[ScheduledOp]:
    """Deterministic open-loop schedule: per-tenant Poisson arrivals
    (seeded per tenant index), events grouped into frames of
    ``frame_size`` (a frame departs when its LAST event has arrived),
    with query and entity-mutation ops interleaved at each tenant's
    configured cadence. Pure function of the spec — no wall clock, no
    global RNG."""
    ops: list[ScheduledOp] = []
    for ti, tl in enumerate(spec.tenants):
        rng = np.random.default_rng([spec.seed, ti])
        prefix = tl.device_prefix or f"{tl.tenant}-dev"
        if tl.rate_eps <= 0:
            continue
        # draw inter-arrival gaps in chunks until past the horizon
        gaps: list[np.ndarray] = []
        total = 0.0
        while total < spec.duration_s:
            g = rng.exponential(1.0 / tl.rate_eps,
                                size=max(64, int(tl.rate_eps * 0.25) or 64))
            gaps.append(g)
            total += float(g.sum())
        arr = np.cumsum(np.concatenate(gaps))
        arr = arr[arr < spec.duration_s]
        if tl.abusive_mult > 1.0:
            # noisy-neighbor bursts: superimpose an EXTRA Poisson stream
            # at rate * (mult - 1), thinned to the burst windows — the
            # union of Poisson processes is Poisson at the summed rate,
            # so inside a window the tenant offers rate * mult. The
            # extra stream draws from its own seeded generator: the base
            # stream's draws (and every other tenant's schedule) are
            # untouched, keeping non-abusive fingerprints stable.
            xrng = np.random.default_rng([spec.seed, ti, 0xAB])
            xrate = tl.rate_eps * (tl.abusive_mult - 1.0)
            xgaps: list[np.ndarray] = []
            xtotal = 0.0
            while xtotal < spec.duration_s:
                g = xrng.exponential(
                    1.0 / xrate, size=max(64, int(xrate * 0.25) or 64))
                xgaps.append(g)
                xtotal += float(g.sum())
            xarr = np.cumsum(np.concatenate(xgaps))
            xarr = xarr[xarr < spec.duration_s]
            if tl.abusive_period_s > 0 and tl.abusive_burst_s > 0:
                xarr = xarr[(xarr % tl.abusive_period_s)
                            < tl.abusive_burst_s]
            # stable argsort == np.sort(kind="stable") on the times,
            # while also carrying WHICH rows came from the extra stream
            # (the hotspot knob needs the provenance; the merged arrival
            # array is byte-identical either way)
            n_base = len(arr)
            both = np.concatenate([arr, xarr])
            order = np.argsort(both, kind="stable")
            arr = both[order]
            abusive_at = order >= n_base
        else:
            abusive_at = None
        picks = rng.integers(0, tl.n_devices, len(arr))
        if abusive_at is not None and tl.abusive_device is not None:
            # hotspot: the extra stream's events all land on one device
            # (one slot, one shard). picks is drawn BEFORE this with the
            # same count either way, so base-stream devices — and every
            # abusive_device=None schedule — keep their fingerprints
            picks = picks.copy()
            picks[abusive_at] = int(tl.abusive_device) % tl.n_devices
        is_rule = np.zeros(len(arr), bool)
        if tl.rule_trigger_eps > 0:
            # rule-trigger traffic: threshold-crossing
            # measurements from their OWN seeded stream, merged after the
            # base draws — the base stream's draws (and every other
            # tenant's schedule) are untouched, so a schedule with the
            # knob OFF keeps its pre-knob fingerprint (the abusive-knob
            # additivity discipline)
            rrng = np.random.default_rng([spec.seed, ti, 0x51])
            rgaps: list[np.ndarray] = []
            rtotal = 0.0
            while rtotal < spec.duration_s:
                g = rrng.exponential(
                    1.0 / tl.rule_trigger_eps,
                    size=max(64, int(tl.rule_trigger_eps * 0.25) or 64))
                rgaps.append(g)
                rtotal += float(g.sum())
            rarr = np.cumsum(np.concatenate(rgaps))
            rarr = rarr[rarr < spec.duration_s]
            if tl.rule_period_s > 0 and tl.rule_burst_s > 0:
                rarr = rarr[(rarr % tl.rule_period_s) < tl.rule_burst_s]
            rpicks = rrng.integers(0, tl.n_devices, len(rarr))
            order = np.argsort(np.concatenate([arr, rarr]), kind="stable")
            arr = np.concatenate([arr, rarr])[order]
            picks = np.concatenate([picks, rpicks])[order]
            is_rule = np.concatenate(
                [is_rule, np.ones(len(rarr), bool)])[order]
        mut_registered: set[str] = set()
        n_frames = 0
        for lo in range(0, len(arr), spec.frame_size):
            hi = min(lo + spec.frame_size, len(arr))
            payloads = [generate_measurements_message(
                f"{prefix}-{int(picks[k])}", ti * 10_000_000 + k,
                **({"name": tl.rule_channel, "value": tl.rule_value}
                   if is_rule[k] else {}))
                for k in range(lo, hi)]
            frame_t = float(arr[hi - 1])
            ops.append(ScheduledOp(
                t_s=frame_t, kind="ingest", tenant=tl.tenant,
                payloads=payloads,
                arrivals=tuple(float(a) for a in arr[lo:hi])))
            n_frames += 1
            if tl.query_every and n_frames % tl.query_every == 0:
                variant = (n_frames // tl.query_every) % 3
                if variant == 0:
                    q = {"limit": 20}
                elif variant == 1:
                    q = {"device_token":
                         f"{prefix}-{int(picks[lo])}", "limit": 20}
                else:
                    q = {"since_ms": 0, "limit": 20}
                ops.append(ScheduledOp(t_s=frame_t, kind="query",
                                       tenant=tl.tenant, query=q))
            if tl.history_every and n_frames % tl.history_every == 0:
                # deterministic MARKER, not a concrete range: the schedule
                # is a pure function of the spec (no wall clock), so the
                # generator resolves the range against the engine's epoch at
                # fire time — "everything up to history_age_ms ago", which
                # on an archive-primed engine lands beyond the ring
                hv = (n_frames // tl.history_every) % 2
                q = {"history_age_ms": tl.history_age_ms, "limit": 20}
                if hv == 1:
                    q["device_token"] = f"{prefix}-{int(picks[lo])}"
                ops.append(ScheduledOp(t_s=frame_t, kind="query",
                                       tenant=tl.tenant, query=q))
            if tl.analytics_every and n_frames % tl.analytics_every == 0:
                # deterministic scoring-job MARKER, the
                # history_every mirror: a pure function of the spec — the
                # generator resolves it into an archive->device batched
                # scoring job at fire time. emit=False keeps the measured
                # ingest stream closed (scores don't feed back into the
                # event counts the run asserts on); the name pins the
                # job's dedup-key lineage per marker
                j = n_frames // tl.analytics_every
                a = {"window": 8, "min_fill": 1, "batch_devices": 8,
                     "emit": False, "name": f"lg-{tl.tenant}-{j}"}
                ops.append(ScheduledOp(t_s=frame_t, kind="analytics",
                                       tenant=tl.tenant, analytics=a))
            if tl.mutate_every and n_frames % tl.mutate_every == 0:
                j = n_frames // tl.mutate_every
                token = f"{prefix}-m{j % 8}"
                if token not in mut_registered:
                    mut_registered.add(token)
                    mut = ("register", token, None)
                else:
                    mut = ("update", token, {"rev": str(j)})
                ops.append(ScheduledOp(t_s=frame_t, kind="mutate",
                                       tenant=tl.tenant, mutate=mut))
    ops.sort(key=lambda op: (op.t_s, op.tenant, _KIND_ORDER[op.kind]))
    return ops


def schedule_fingerprint(schedule: list[ScheduledOp]) -> str:
    """SHA-256 over the canonical byte form of a schedule — the
    determinism pin (same seed => same fingerprint) and the provenance
    field the bench records next to its measured numbers."""
    h = hashlib.sha256()
    for op in schedule:
        h.update(f"{op.kind}|{op.tenant}|{op.t_s!r}\n".encode())
        for p in op.payloads or ():
            h.update(p)
        for a in op.arrivals or ():
            h.update(repr(a).encode())
        if op.query is not None:
            h.update(json.dumps(op.query, sort_keys=True).encode())
        if op.mutate is not None:
            h.update(repr(op.mutate).encode())
        if op.analytics is not None:
            h.update(json.dumps(op.analytics, sort_keys=True).encode())
    return h.hexdigest()


def _pcts(lat_ms: list[float]) -> dict:
    if not lat_ms:
        return {"p50_ms": None, "p99_ms": None, "p999_ms": None,
                "max_ms": None}
    a = np.asarray(lat_ms)
    return {"p50_ms": round(float(np.percentile(a, 50)), 3),
            "p99_ms": round(float(np.percentile(a, 99)), 3),
            "p999_ms": round(float(np.percentile(a, 99.9)), 3),
            "max_ms": round(float(a.max()), 3)}


@dataclasses.dataclass
class OpenLoopResult:
    """Per-tenant SLO view of one open-loop run. For each tenant,
    ``per_tenant[t]`` carries two latency families:

      e2e_*      scheduled arrival -> visible in device state. THE SLO
                 number: includes queueing delay whenever the engine
                 (or the generator) fell behind the arrival process.
      service_*  submit -> visible. The engine-side span comparable to
                 the flight-recorder-harvested swtpu_ingest_e2e_seconds
                 histogram (same start edge as the batch's flight
                 record). e2e == service when the run kept pace.

    With QoS enabled on the engine (``engine.qos``), the generator acts as
    the admission EDGE: shed frames are counted per tenant (``shed`` in
    ``per_tenant``, ``shed_events`` in total) and never submitted —
    ``events`` is the ADMITTED count, the denominator of any
    zero-admitted-loss check.
    """

    wall_s: float
    events: int
    events_per_s: float
    offered_eps: float
    queries: int
    query_p99_ms: float | None
    history_queries: int
    history_p99_ms: float | None
    scoring_jobs: int
    scoring_p50_ms: float | None
    scoring_p99_ms: float | None
    mutations: int
    max_lateness_s: float
    per_tenant: dict
    shed_events: int = 0
    # span/trace coverage: fraction of a sample of this run's
    # ingest trace ids that still resolve on the engine (flight records
    # or spans) after the run — the observability plane's own SLO. None
    # when the run ingested nothing.
    trace_coverage: float | None = None
    # programs compiled per family during the run, in the JAX package's
    # result; eager torch compiles none per shape, so always None here
    compile_counts: dict | None = None
    # ingest-path provenance: host_counters deltas over the
    # run — ``arena_rows`` (rows scattered zero-copy into staging
    # arenas) vs ``staged_copy_rows`` (rows that took a per-row host
    # copy)
    ingest_path: dict | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def run_open_loop(engine, schedule: list[ScheduledOp], *,
                  checkpoint_frames: int = 4,
                  time_scale: float = 1.0) -> OpenLoopResult:
    """Replay a schedule against a live engine (anything with
    ingest_json_batch / query_events / flush). Ops fire at their
    scheduled time; a late generator fires immediately and the lateness
    lands in the measured latency (open loop). Completion checkpoints
    every ``checkpoint_frames`` ingest frames call ``engine.flush()``."""
    pending: list[tuple[str, list[float], float]] = []
    per: dict[str, tuple[list, list]] = {}
    qlat: list[float] = []
    hlat: list[float] = []
    alat: list[float] = []
    epoch = getattr(engine, "epoch", None)
    # the generator is an ingest EDGE: with QoS on, every frame faces the
    # engine's admission controller here — shed frames count per tenant
    # and are never submitted (the client saw an explicit 429)
    qos = getattr(engine, "qos", None)
    shed: dict[str, int] = {}
    trace_sample: list[str] = []   # first few ingest trace ids: span
    #                                coverage is checked after the run
    mutations = 0
    max_late = 0.0
    frames = 0
    events = 0
    hc0 = dict(getattr(engine, "host_counters", None) or {})
    t0 = time.perf_counter()

    def checkpoint():
        nonlocal frames
        frames = 0
        if not pending:
            return
        engine.flush()
        t_done = time.perf_counter()
        for tenant, arrivals, submit in pending:
            e2e, svc = per.setdefault(tenant, ([], []))
            e2e.extend((t_done - a) * 1e3 for a in arrivals)
            svc.extend([(t_done - submit) * 1e3] * len(arrivals))
        pending.clear()

    for op in schedule:
        target = t0 + op.t_s * time_scale
        now = time.perf_counter()
        if now < target:
            time.sleep(target - now)
        else:
            max_late = max(max_late, now - target)
        if op.kind == "ingest":
            if qos is not None:
                d = qos.admit(op.tenant, len(op.payloads))
                if not d.admitted:
                    shed[op.tenant] = (shed.get(op.tenant, 0)
                                       + len(op.payloads))
                    continue
            submit = time.perf_counter()
            summary = engine.ingest_json_batch(op.payloads, op.tenant)
            tid = (summary or {}).get("trace_id")
            if tid and len(trace_sample) < 16:
                trace_sample.append(tid)
            pending.append((op.tenant,
                            [t0 + a * time_scale for a in op.arrivals],
                            submit))
            events += len(op.payloads)
            frames += 1
            if frames >= checkpoint_frames:
                checkpoint()
        elif op.kind == "query":
            q = dict(op.query)
            age = q.pop("history_age_ms", None)
            if age is not None:
                # resolve the historical marker at fire time: a range from
                # the beginning of history (unbounded start — backfilled
                # events can sit at negative epoch-relative ms) to ``age``
                # before now — older than the ring on any archive-primed
                # run, so the tiered read path serves it
                now_rel = (int(epoch.now_ms()) if epoch is not None
                           else 0)
                q["until_ms"] = now_rel - int(age)
            t1 = time.perf_counter()
            engine.query_events(**q)
            (hlat if age is not None
             else qlat).append((time.perf_counter() - t1) * 1e3)
        elif op.kind == "analytics":
            # archive->device scoring-job marker: resolved
            # against the engine's job manager at fire time; engines
            # without the manager (or without an archive to stream from)
            # skip it, so plain-store schedules replay unchanged
            aj = getattr(engine, "analytics_jobs", None)
            if aj is not None and getattr(engine, "archive", None) is not None:
                t1 = time.perf_counter()
                aj.run_job(dict(op.analytics, tenant=op.tenant))
                alat.append((time.perf_counter() - t1) * 1e3)
        else:
            kind, token, md = op.mutate
            if kind == "register":
                engine.register_device(token, tenant=op.tenant)
            else:
                try:
                    engine.update_device(token, metadata=md)
                except KeyError:
                    engine.register_device(token, tenant=op.tenant)
            mutations += 1
    checkpoint()
    wall = time.perf_counter() - t0
    # span/trace coverage: every sampled ingest trace id must
    # still resolve to a non-empty timeline (flight-record intervals or
    # live spans) — the observability plane's own SLO, reported by the
    # bench cluster leg
    coverage = None
    get_tl = getattr(engine, "get_trace_timeline", None)
    if trace_sample and get_tl is not None:
        hits = 0
        for tid in trace_sample:
            try:
                doc = get_tl(tid)
            except Exception:
                continue
            if any(e.get("ph") == "X" for e in doc.get("traceEvents", ())):
                hits += 1
        coverage = round(hits / len(trace_sample), 3)
    horizon = max((op.t_s for op in schedule), default=0.0) * time_scale
    per_tenant = {}
    for tenant in sorted(set(per) | set(shed)):
        e2e, svc = per.get(tenant, ([], []))
        per_tenant[tenant] = {
            "events": len(e2e),
            "shed": shed.get(tenant, 0),
            **{f"e2e_{k}": v for k, v in _pcts(e2e).items()},
            **{f"service_{k}": v for k, v in _pcts(svc).items()},
        }
    hc1 = getattr(engine, "host_counters", None) or {}
    ingest_path = {k: int(hc1.get(k, 0)) - int(hc0.get(k, 0))
                   for k in ("arena_rows", "staged_copy_rows")}
    qp = _pcts(qlat)
    hp = _pcts(hlat)
    ap = _pcts(alat)
    return OpenLoopResult(
        wall_s=round(wall, 3), events=events,
        events_per_s=round(events / wall, 1) if wall else 0.0,
        offered_eps=round((events + sum(shed.values())) / horizon, 1)
        if horizon else 0.0,
        queries=len(qlat), query_p99_ms=qp["p99_ms"],
        history_queries=len(hlat), history_p99_ms=hp["p99_ms"],
        scoring_jobs=len(alat), scoring_p50_ms=ap["p50_ms"],
        scoring_p99_ms=ap["p99_ms"],
        mutations=mutations, max_lateness_s=round(max_late, 4),
        per_tenant=per_tenant, shed_events=sum(shed.values()),
        trace_coverage=coverage, compile_counts=None,
        ingest_path=ingest_path)


# ---------------------------------------------------------------------------
# Persistent-connection wire mode.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WireLoadSpec:
    """Seed-determined description of a connection-holding load: N live
    connections, each carrying its own deterministic frame list. Same
    spec + same seed => byte-identical frames per connection (the
    ``build_open_loop_schedule`` fingerprint discipline; existing
    open-loop schedules are untouched by this mode)."""

    n_connections: int = 1000
    frames_per_conn: int = 10
    n_devices: int = 256
    tenant: str = "default"
    device_prefix: str = "wl-dev"
    seed: int = 0


def build_wire_schedule(spec: WireLoadSpec) -> list[list[bytes]]:
    """Per-connection payload lists — a pure function of the spec (each
    connection draws from its own seeded stream, so connection counts can
    change without disturbing other connections' frames)."""
    out: list[list[bytes]] = []
    for c in range(spec.n_connections):
        rng = np.random.default_rng([spec.seed, c])
        picks = rng.integers(0, spec.n_devices, spec.frames_per_conn)
        out.append([
            generate_measurements_message(
                f"{spec.device_prefix}-{int(d)}", c * 1_000_000 + i)
            for i, d in enumerate(picks)
        ])
    return out


def wire_schedule_fingerprint(payload_lists: list[list[bytes]]) -> str:
    """SHA-256 over the canonical byte form — the determinism pin the
    bench records next to its measured wire numbers."""
    h = hashlib.sha256()
    for i, frames in enumerate(payload_lists):
        h.update(f"conn|{i}|{len(frames)}\n".encode())
        for p in frames:
            h.update(p)
    return h.hexdigest()


def _rss_bytes() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


@dataclasses.dataclass
class WireLoadResult:
    """One connection-holding run against a live wire edge. Connections
    stay OPEN for the whole run — ``per_connection_bytes`` is the RSS
    delta from before the connect wave to all-connected, divided by the
    connection count (client and server share the process in the bench,
    so the figure covers both ends of each connection)."""

    connections: int
    events: int
    acked: int
    wall_s: float
    events_per_s: float
    connect_s: float
    per_connection_bytes: float
    publish_p50_ms: float | None
    publish_p99_ms: float | None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


async def run_wire_load(host: str, port: int,
                        payload_lists: list[list[bytes]], *,
                        tenant: str = "default", qos: int = 1,
                        connect_wave: int = 100,
                        client_id_prefix: str = "wl") -> WireLoadResult:
    """Hold ``len(payload_lists)`` live MQTT connections against a wire
    edge and publish each connection's frames (QoS 1 by default: every
    publish awaits its WAL-durable PUBACK). Connections open in waves of
    ``connect_wave`` to keep the accept queue shallow, then ALL of them
    stay open while frames interleave across the full set — the
    persistent-connection contrast to one-request-per-event loads."""
    from sitewhere_tpu_torch.ingest.mqtt import MqttClient

    rss0 = _rss_bytes()
    t_conn = time.perf_counter()
    clients: list[MqttClient] = []
    for lo in range(0, len(payload_lists), connect_wave):
        wave = []
        for i in range(lo, min(lo + connect_wave, len(payload_lists))):
            c = MqttClient(host, port, client_id=f"{client_id_prefix}-{i}",
                           keepalive=0)
            clients.append(c)
            wave.append(c.connect())
        await asyncio.gather(*wave)
    connect_s = time.perf_counter() - t_conn
    per_conn = ((_rss_bytes() - rss0) / len(clients)) if clients else 0.0

    topic = f"swtpu/{tenant}/events"
    lat: list[float] = []
    acked = 0

    async def one_conn(c: MqttClient, frames: list[bytes]) -> None:
        nonlocal acked
        for p in frames:
            s0 = time.perf_counter()
            await asyncio.wait_for(c.publish(topic, p, qos=qos), 60)
            lat.append((time.perf_counter() - s0) * 1e3)
            if qos:
                acked += 1

    t0 = time.perf_counter()
    await asyncio.gather(*(one_conn(c, f)
                           for c, f in zip(clients, payload_lists)))
    wall = time.perf_counter() - t0
    await asyncio.gather(*(c.disconnect() for c in clients),
                         return_exceptions=True)
    events = sum(len(f) for f in payload_lists)
    pct = _pcts(lat)
    return WireLoadResult(
        connections=len(clients), events=events,
        acked=acked if qos else events,
        wall_s=round(wall, 3),
        events_per_s=round(events / wall, 1) if wall else 0.0,
        connect_s=round(connect_s, 3),
        per_connection_bytes=round(per_conn, 1),
        publish_p50_ms=pct["p50_ms"], publish_p99_ms=pct["p99_ms"])


async def run_rest_load(base_url: str, jwt: str, n_workers: int = 5,
                        msgs_per_worker: int = 100,
                        device_prefix: str = "rest-lg") -> LoadStats:
    """Wire-level driver: N concurrent workers x M posts each (the 5x100
    pattern of EventSourceTests.java:50-53) against /api/devices/{t}/events,
    over the port's own HTTP client (``web/http.py``: one keep-alive
    session, as the JAX package's ``aiohttp.ClientSession``)."""
    from sitewhere_tpu_torch.web.http import ClientSession

    latencies: list[float] = []
    failed = 0
    headers = {"Authorization": f"Bearer {jwt}"}

    async def worker(w: int, session: ClientSession):
        nonlocal failed
        token = f"{device_prefix}-{w}"
        for i in range(msgs_per_worker):
            body = json.loads(generate_measurements_message(token, i))
            s0 = time.perf_counter()
            r = await session.post(f"{base_url}/api/devices/{token}/events",
                                   json=body, headers=headers)
            if r.status != 201:
                failed += 1
            latencies.append((time.perf_counter() - s0) * 1e3)

    t0 = time.perf_counter()
    async with ClientSession() as session:
        await asyncio.gather(*(worker(w, session) for w in range(n_workers)))
    wall = time.perf_counter() - t0
    sent = n_workers * msgs_per_worker
    p50, p99, mx = _percentiles(latencies)
    return LoadStats(sent, sent - failed, failed, wall, sent / wall, p50, p99, mx)


def main(argv=None) -> None:
    import argparse

    from sitewhere_tpu_torch.engine import Engine, EngineConfig

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batches", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--devices", type=int, default=10_000)
    ap.add_argument("--open-loop", action="store_true",
                    help="seeded open-loop mixed workload instead of the "
                         "closed-loop batch load")
    ap.add_argument("--rate", type=float, default=5000.0,
                    help="open-loop arrival rate (events/s)")
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=0,
                    help="drive the multi-shard SpmdEngine with N shards "
                         "instead of a single engine (0 = single engine). "
                         "Wire frames go through the batch ingest edge "
                         "(arena scatter), never per-event staging; the "
                         "result's ingest_path counters pin it")
    ap.add_argument("--device", default="cuda",
                    help="where the engine's state lives (default: the card; "
                         "'cpu' only when asked for)")
    args = ap.parse_args(argv)

    cfg = EngineConfig(
        device_capacity=max(1 << 15, 1 << (args.devices - 1).bit_length()),
        token_capacity=1 << 17, assignment_capacity=1 << 17,
        store_capacity=1 << 18, batch_capacity=args.batch_size,
    )
    if args.shards:
        from sitewhere_tpu_torch.parallel.sharded import SpmdEngine

        engine = SpmdEngine(cfg, n_shards=args.shards, device=args.device)
    else:
        engine = Engine(cfg, device=args.device)
    if args.open_loop:
        # warm outside the measured schedule, so first-call costs do not
        # land in (and, open-loop, cascade through) every latency
        run_engine_load(engine, n_batches=1, batch_size=args.batch_size,
                        n_devices=min(args.devices, 4096),
                        warmup_batches=1)
        spec = OpenLoopSpec(
            tenants=(TenantLoad("default", args.rate,
                                n_devices=min(args.devices, 4096),
                                query_every=8, mutate_every=16),),
            duration_s=args.duration,
            frame_size=min(args.batch_size, 512), seed=args.seed)
        schedule = build_open_loop_schedule(spec)
        res = run_open_loop(engine, schedule)
        print(json.dumps({
            "schedule_fingerprint": schedule_fingerprint(schedule),
            **res.to_dict()}))
        return
    stats = run_engine_load(engine, args.batches, args.batch_size, args.devices)
    print(json.dumps(stats.to_dict()))


if __name__ == "__main__":
    main()
