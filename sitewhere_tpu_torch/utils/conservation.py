"""Event conservation ledger and audit plane (port of
``sitewhere_tpu/utils/conservation.py`` for the stages a single port engine
has).

* :class:`FlowLedger` — host-side flow counters at the two boundaries the
  engine itself controls: rows staged, and valid rows dispatched to the
  device. Every other stage is sampled from counters that already exist
  (the device-side tenant counter grid, WAL sequence tickets, the CEP
  harvest counters, the archive's spill cursors, the analytics jobs'
  window counters). Rows of ``Engine.ingest_event_batch`` count as staged
  and dispatched at once, through a device-side sum.
* :func:`build_ledger` — one mutually consistent snapshot of every stage,
  taken under the engine lock (reading the device counters waits for
  every dispatched step).
* :func:`check_conservation` — a pure function evaluating the equations
  over one snapshot; an equation whose stage is absent is skipped.
* :class:`ConservationAuditor` — a background thread auditing every
  ``interval_s``; an equation escalates (counter + loud log) only when it
  fails two audits in a row. Each audit reads device counters, which is
  a host sync: ``stats`` counts audits, syncs and seconds the way
  ``Engine.spool_stats`` counts the spooler's.
* :func:`conservation_metrics` / :func:`export_conservation_metrics` /
  :func:`conservation_payload` — the scrape and document surfaces.

The equations:

  edge-admission      offered == admitted + edge sheds (QoS engines;
                      offered counts at admit() entry, independently)

  staging-balance     staged_rows == dispatched_rows + backlog_rows
  device-processed    dispatched_rows == device ``processed`` delta
  device-disposition  accepted + invalid == processed (the tenant counter
                      grid partitions every valid row)
  wal-durability      0 <= durable_seq <= appended_seq
  rules-harvest       harvested == emitted + suppressed + skipped, and
                      device missed <= fires, pending >= 0
  archive-spill       spilled(part) <= ring_head(part), and ring_head -
                      spilled <= arena_capacity + lost_rows (rows wrapped
                      before spooling are legal only when the archive
                      counted them)
  spmd-shard-flow     per shard s (a multi-shard engine): accepted[s] +
                      invalid[s] == processed[s], and routed_rows[s] ==
                      dispatched_rows[s] + backlog_rows[s]; every
                      per-shard lane sums exactly to the device stage's
  analytics-windows   planned == scored + skipped_underfilled + cancelled
                      (every window a scoring batch plans lands in one
                      sink; the manager commits planned with its sinks
                      in one lock block, so there is no in-flight slack)
  wire-frames         frames_received == frames_admitted + frames_shed +
                      frames_invalid + frames_duplicate (every frame a
                      persistent connection delivers gets exactly one edge
                      disposition; received counts independently at frame
                      arrival, so the equation can fail)
  wire-rows           frames_admitted == rows_submitted + frames_stalled +
                      pending (admitted frames reach the batch-ingest facade
                      — and staging-balance from there — or are stall-shed
                      with their acks withheld; the arrival-window backlog
                      is the only slack)
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)

EQUATIONS = ("edge-admission", "staging-balance", "device-processed", "device-disposition",
             "wal-durability", "rules-harvest", "archive-spill",
             "spmd-shard-flow", "analytics-windows", "wire-frames", "wire-rows")


class FlowLedger:
    """Host-side flow counters for the boundaries nothing else counts.

    Every mutation site holds the engine lock, so no lock of its own;
    ``enabled`` toggles counting. ``rebase`` records the device counters
    a restored snapshot already carries, so a recovered engine's ledger
    balances over the rows it staged itself (WAL replay), not the
    pre-crash history."""

    __slots__ = ("enabled", "counters", "baseline", "device")

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.counters: dict[str, int] = {"staged_rows": 0,
                                         "dispatched_rows": 0}
        self.baseline: dict[str, int] = {}
        self.device: dict[str, torch.Tensor] = {}

    def add(self, key: str, n: int) -> None:
        if self.enabled and n:
            self.counters[key] = self.counters.get(key, 0) + int(n)

    def add_device(self, key: str, mask: torch.Tensor) -> None:
        """Count the true elements of ``mask`` without a host sync: the
        sum stays on ``mask``'s device until :meth:`value` reads it."""
        if self.enabled:
            n = mask.sum(dtype=torch.int64)
            self.device[key] = n if key not in self.device else self.device[key] + n

    def value(self, key: str) -> int:
        """``key``'s host count plus its device-side count."""
        dev = self.device.get(key)
        return self.counters.get(key, 0) + (int(dev) if dev is not None else 0)

    def rebase(self, engine) -> None:
        """Take the engine's device counters as the baseline: called after
        a snapshot restore, before any replay."""
        m = engine.metrics()
        base = {"processed": int(m.get("processed", 0)),
                "persisted": int(m.get("persisted", 0))}
        for lane, n in _grid_totals(engine).items():
            base[f"grid_{lane}"] = n
        self.baseline = base


def _grid_totals(eng) -> dict[str, int]:
    """Lane totals of the device-side tenant counter grid."""
    totals: dict[str, int] = {}
    for lanes in eng.tenant_pipeline_counters().values():
        for lane, n in lanes.items():
            totals[lane] = totals.get(lane, 0) + int(n)
    return totals


def _backlog_rows(eng) -> int:
    """Valid rows staged but not yet dispatched, field by field (the fill
    arena's failed-decode rows below the cursor never dispatch as valid).
    Caller holds the lock."""
    buf = eng._buf
    # the mesh engine stages every shard in one [S, B] buffer, its fair
    # queues count a shard each
    n = buf.total() if hasattr(buf, "total") else len(buf)
    n += int(np.sum(eng._fair_queued))
    fill = getattr(eng, "_arena_fill", None)
    if fill is not None:
        cursors = getattr(fill, "cursors", None)
        if cursors is not None:
            # the multi-shard arena: [S, rows] lanes, a cursor a shard
            n += sum(int(np.sum(fill.valid[s, :int(c)])) for s, c in enumerate(cursors))
        else:
            n += int(np.sum(fill.valid[:fill.cursor]))
    for b in getattr(eng, "_staged_batches", ()):
        n += int(np.sum(b.valid))
    # the multi-shard engine's per-shard router buffers
    n += sum(len(b) for b in getattr(eng, "_shard_bufs", ()))
    return n


def _rules_stage(eng, rules_manager) -> dict | None:
    """Device CEP counters and the manager's harvest accounting (each
    device read below is one host sync: ``_SYNCS_RULES`` and
    ``_SYNCS_ROLLUPS`` count them for the auditor)."""
    # a multi-shard engine's first shard says whether rules are installed,
    # without stacking every shard's state
    shards = getattr(eng, "shards", None)
    rs = shards[0].rules if shards else eng.state.rules
    if rs is None or (rs.rules is None and rs.rollups is None):
        return None
    rs = eng.state.rules
    out: dict = {}
    # a multi-shard engine's state is stacked on a leading shard axis: the
    # counters sum over it (a single engine's are 0-d)
    if rs.rules is not None:
        rb = rs.rules
        f, m, l, o = (int(x) for x in torch.stack(
            [rb.fires, rb.missed, rb.late, rb.oob]).reshape(4, -1).sum(1).tolist())
        pending = (rb.pend_w - rb.pend_h).clamp(max=rb.pend_key.shape[-1])
        out.update(fires=f, missed=m, late=l, oob=o,
                   pending=int(pending.sum()),
                   max_window_id=int(rb.acc_wid.max()))
    if rs.rollups is not None:
        wid = rs.rollups.wid.cpu().numpy()
        live = wid[wid > np.iinfo(np.int32).min]
        out["rollup_window_id"] = int(live.max()) if live.size else None
        out["rollup_late"] = int(rs.rollups.late.sum())
    if rules_manager is not None:
        # one read under the manager lock: poll() commits its four
        # counters in one block, so the equation sees pre- or post-poll
        # totals only
        with rules_manager._mu:
            out.update(harvested=int(rules_manager.fires_harvested),
                       emitted=int(rules_manager.alerts_emitted),
                       suppressed=int(rules_manager.alerts_suppressed),
                       skipped=int(rules_manager.harvest_skipped))
    return out


# device reads of _rules_stage: the counter stack, the pending sum and the
# window-id max of the rules; the window ids and the late count of the
# rollups
_SYNCS_RULES = 3
_SYNCS_ROLLUPS = 2


def build_ledger(engine, rules_manager=None) -> dict:
    """One mutually consistent flow-accounting snapshot of ``engine``.
    Reads the device counters (waiting for the dispatched steps), so it
    belongs on an audit cadence, never in the ingest loop. ``syncs`` in
    the result counts the device reads it made."""
    led: FlowLedger = engine.ledger
    with engine.lock:
        base = dict(led.baseline)
        m = engine.metrics()
        grid = _grid_totals(engine)
        syncs = 2
        stages: dict = {}
        qos = getattr(engine, "qos", None)
        if qos is not None:
            with qos._lock:
                stages["edge"] = {
                    # offered counts at admit() entry, never derived from
                    # admitted + shed, so the equation can fail
                    "offered": int(qos.offered_events),
                    "admitted": int(qos.admitted_events),
                    "shed": int(qos.shed_events),
                    # sheds noted after admission (an arena stall): those
                    # events were offered and admitted already
                    "shed_noted": int(qos.shed_noted),
                    "shed_by_tenant": dict(qos.shed_by_tenant)}
        # the persistent-connection wire edges (ingest/wire_edge): their
        # own counter snapshots. The edge and batcher locks are not the
        # engine lock, so a frame between its admission and its batcher
        # append can skew wire-rows for one audit (the auditor's
        # two-audit rule); a quiescent edge balances exactly
        if getattr(engine, "wire_edges", None):
            from sitewhere_tpu_torch.ingest.wire_edge import aggregate_wire_snapshot

            ws = aggregate_wire_snapshot(engine)
            if ws is not None:
                stages["wire"] = {k: ws[k] for k in (
                    "frames_received", "frames_admitted", "frames_shed",
                    "frames_invalid", "frames_duplicate", "rows_submitted",
                    "frames_stalled", "pending", "backpressure_events",
                    "connections_live", "connections_peak")}
        # rows of ingest_event_batch are staged and dispatched at once
        bulk = led.value("bulk_rows")
        syncs += "bulk_rows" in led.device
        ing = {"staged_rows": led.counters.get("staged_rows", 0) + bulk,
               "dispatched_rows": led.counters.get("dispatched_rows", 0) + bulk,
               "backlog_rows": _backlog_rows(engine),
               "counting": led.enabled}
        stages["ingest"] = ing
        stages["device"] = {
            "processed": int(m["processed"]) - base.get("processed", 0),
            "persisted": int(m["persisted"]) - base.get("persisted", 0),
            **{lane: n - base.get(f"grid_{lane}", 0)
               for lane, n in grid.items()},
        }
        # the multi-shard engine's per-shard breakdown of the device
        # stage; skipped under a restore baseline (the device stage is
        # baseline-subtracted, the per-shard grids are cumulative)
        sf = getattr(engine, "shard_flow", None)
        if callable(sf) and not base:
            stages["spmd"] = sf()
            syncs += 2
        wal = engine.wal
        if wal is not None:
            with wal._lock:
                appended, durable = int(wal._seq), int(wal._durable_seq)
            stages["wal"] = {"appended_seq": appended,
                             "durable_seq": durable,
                             "group_commit": bool(wal.group_commit)}
        arch = getattr(engine, "archive", None)
        if arch is not None:
            # the spooler's own heads and capacity: one definition for the
            # spooler and its checker
            heads = engine.ring_heads()
            acap = engine.ring_arena_capacity()
            syncs += 1
            stages["archive"] = {
                "parts": {str(p): {"head": h, "spilled": arch.spilled(p),
                                   "capacity": acap}
                          for p, h in heads.items()},
                "rows": arch.total_rows(),
                "lost_rows": int(arch.lost_rows),
                "expired_rows": int(arch.expired_rows),
            }
        rules = _rules_stage(engine, rules_manager)
        if rules is not None:
            stages["rules"] = rules
            syncs += (_SYNCS_RULES * ("fires" in rules)
                      + _SYNCS_ROLLUPS * ("rollup_late" in rules))
        jobs = getattr(engine, "analytics_jobs", None)
        if jobs is not None:
            # one read under the manager lock: pre- or post-batch totals
            stages["analytics"] = jobs.ledger_stage()

    watermarks: dict = {"dispatched_rows": ing["dispatched_rows"]}
    lag: dict = {"staged_backlog_rows": ing["backlog_rows"]}
    if "wal" in stages:
        w = stages["wal"]
        watermarks["wal_appended"] = w["appended_seq"]
        watermarks["wal_durable"] = w["durable_seq"]
        lag["wal_durable_lag"] = w["appended_seq"] - w["durable_seq"]
    if "archive" in stages:
        parts = stages["archive"]["parts"]
        watermarks["archive_spill"] = {p: v["spilled"] for p, v in parts.items()}
        lag["archive_spill_lag_rows"] = max(
            (v["head"] - v["spilled"] for v in parts.values()), default=0)
    if "rules" in stages and "rollup_window_id" in stages["rules"]:
        watermarks["rollup_window_id"] = stages["rules"]["rollup_window_id"]
    return {"generatedMs": int(time.time() * 1000), "rank": 0,
            "engine": getattr(engine, "metrics_label", "e?"),
            "stages": stages, "watermarks": watermarks, "lag": lag,
            "syncs": syncs}


@dataclasses.dataclass
class Violation:
    """One broken conservation equation: ``lhs`` and ``rhs`` are the
    evaluated sides, ``slack`` the tolerance the equation already granted
    when it still failed."""

    equation: str
    message: str
    lhs: float
    rhs: float
    slack: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def check_conservation(ledger: dict) -> list[Violation]:
    """Evaluate the conservation equations over one ledger snapshot. Pure:
    the same ledger always gives the same verdict."""
    out: list[Violation] = []

    def bad(eq: str, msg: str, lhs, rhs, slack: float = 0.0) -> None:
        out.append(Violation(eq, msg, float(lhs), float(rhs), float(slack)))

    st = ledger.get("stages", {})
    ing = st.get("ingest")
    dev = st.get("device", {})
    if ing and ing.get("counting"):
        staged = ing["staged_rows"]
        dispatched = ing["dispatched_rows"]
        backlog = ing["backlog_rows"]
        if staged != dispatched + backlog:
            bad("staging-balance",
                f"staged_rows {staged} != dispatched_rows {dispatched} "
                f"+ backlog {backlog}", staged, dispatched + backlog,
                slack=backlog)
        processed = dev.get("processed")
        if processed is not None and dispatched != processed:
            bad("device-processed",
                f"dispatched_rows {dispatched} != device processed "
                f"{processed}", dispatched, processed)
    edge = st.get("edge")
    if edge:
        edge_shed = edge["shed"] - edge.get("shed_noted", 0)
        if edge["offered"] != edge["admitted"] + edge_shed:
            bad("edge-admission",
                f"offered {edge['offered']} != admitted "
                f"{edge['admitted']} + edge shed {edge_shed} "
                f"(shed total {edge['shed']} incl. "
                f"{edge.get('shed_noted', 0)} post-admission)",
                edge["offered"], edge["admitted"] + edge_shed,
                slack=edge.get("shed_noted", 0))
        by_tenant = sum(edge.get("shed_by_tenant", {}).values())
        if by_tenant != edge["shed"]:
            bad("edge-admission",
                f"per-tenant sheds {by_tenant} != shed total "
                f"{edge['shed']}", by_tenant, edge["shed"])
    if "accepted" in dev and "invalid" in dev and "processed" in dev:
        lhs = dev["accepted"] + dev["invalid"]
        if lhs != dev["processed"]:
            bad("device-disposition",
                f"accepted {dev['accepted']} + invalid {dev['invalid']}"
                f" != processed {dev['processed']}", lhs, dev["processed"])
    wal = st.get("wal")
    if wal and not (0 <= wal["durable_seq"] <= wal["appended_seq"]):
        bad("wal-durability",
            f"durable_seq {wal['durable_seq']} outside "
            f"[0, appended_seq {wal['appended_seq']}]",
            wal["durable_seq"], wal["appended_seq"])
    sp = st.get("spmd")
    if sp:
        per = sp.get("perShard", [])
        for row in per:
            s = row["shard"]
            lhs = row["accepted"] + row["invalid"]
            if lhs != row["processed"]:
                bad("spmd-shard-flow",
                    f"shard {s}: accepted {row['accepted']} + invalid "
                    f"{row['invalid']} != processed {row['processed']}",
                    lhs, row["processed"])
            if sp.get("counting"):
                rhs = row["dispatched_rows"] + row["backlog_rows"]
                if row["routed_rows"] != rhs:
                    bad("spmd-shard-flow",
                        f"shard {s}: routed_rows {row['routed_rows']} != "
                        f"dispatched_rows {row['dispatched_rows']} + backlog "
                        f"{row['backlog_rows']}", row["routed_rows"], rhs,
                        slack=row["backlog_rows"])
        # the per-shard grids are the grid the device stage folds: every
        # lane sums exactly to its folded total
        for lane in ("processed", "accepted", "invalid", "dedup_dropped",
                     "geofence_hit"):
            if lane not in dev:
                continue
            total = sum(row.get(lane, 0) for row in per)
            if total != dev[lane]:
                bad("spmd-shard-flow",
                    f"per-shard {lane} sum {total} != device {lane} {dev[lane]}",
                    total, dev[lane])
        if sp.get("counting") and ing and ing.get("counting"):
            routed = sum(row["routed_rows"] for row in per)
            if routed != ing["staged_rows"]:
                bad("spmd-shard-flow",
                    f"per-shard routed sum {routed} != staged_rows "
                    f"{ing['staged_rows']}", routed, ing["staged_rows"])
    rules = st.get("rules")
    if rules:
        if "harvested" in rules:
            rhs = (rules.get("emitted", 0) + rules.get("suppressed", 0)
                   + rules.get("skipped", 0))
            if rules["harvested"] != rhs:
                bad("rules-harvest",
                    f"harvested {rules['harvested']} != emitted "
                    f"{rules.get('emitted', 0)} + suppressed "
                    f"{rules.get('suppressed', 0)} + skipped "
                    f"{rules.get('skipped', 0)}", rules["harvested"], rhs)
        if "fires" in rules and rules.get("missed", 0) > rules["fires"]:
            bad("rules-harvest",
                f"missed {rules['missed']} > fires {rules['fires']}",
                rules["missed"], rules["fires"])
        if rules.get("pending", 0) < 0:
            bad("rules-harvest",
                f"negative pending ring depth {rules['pending']}",
                rules["pending"], 0)
    arch = st.get("archive")
    if arch:
        lost = arch.get("lost_rows", 0)
        for p, v in arch.get("parts", {}).items():
            if v["spilled"] > v["head"]:
                bad("archive-spill",
                    f"part {p} spill cursor {v['spilled']} ahead of "
                    f"ring head {v['head']}", v["spilled"], v["head"])
            elif v["head"] - v["spilled"] > v["capacity"] + lost:
                bad("archive-spill",
                    f"part {p} unspilled backlog "
                    f"{v['head'] - v['spilled']} exceeds capacity "
                    f"{v['capacity']} + counted losses {lost}",
                    v["head"] - v["spilled"], v["capacity"] + lost,
                    slack=v["capacity"] + lost)
    an = st.get("analytics")
    if an and "planned" in an:
        rhs = (an.get("scored", 0) + an.get("skipped_underfilled", 0)
               + an.get("cancelled", 0))
        if an["planned"] != rhs:
            bad("analytics-windows",
                f"windows planned {an['planned']} != scored "
                f"{an.get('scored', 0)} + skipped_underfilled "
                f"{an.get('skipped_underfilled', 0)} + cancelled "
                f"{an.get('cancelled', 0)}", an["planned"], rhs)
    wire = st.get("wire")
    if wire:
        rhs = (wire.get("frames_admitted", 0) + wire.get("frames_shed", 0)
               + wire.get("frames_invalid", 0) + wire.get("frames_duplicate", 0))
        if wire.get("frames_received", 0) != rhs:
            bad("wire-frames",
                f"frames received {wire.get('frames_received', 0)} != "
                f"admitted {wire.get('frames_admitted', 0)} + shed "
                f"{wire.get('frames_shed', 0)} + invalid "
                f"{wire.get('frames_invalid', 0)} + duplicate "
                f"{wire.get('frames_duplicate', 0)}",
                wire.get("frames_received", 0), rhs)
        rhs = (wire.get("rows_submitted", 0) + wire.get("frames_stalled", 0)
               + wire.get("pending", 0))
        if wire.get("frames_admitted", 0) != rhs:
            bad("wire-rows",
                f"frames admitted {wire.get('frames_admitted', 0)} != "
                f"rows_submitted {wire.get('rows_submitted', 0)} + "
                f"stalled {wire.get('frames_stalled', 0)} + pending "
                f"{wire.get('pending', 0)}",
                wire.get("frames_admitted", 0), rhs, slack=wire.get("pending", 0))
    return out


def conservation_metrics(registry=None) -> dict:
    """The conservation plane's registry instruments, kept out of
    ``engine.metrics()`` (dispatch-shape equality) like every plane:

      swtpu_conservation_violation_total  confirmed violations, per
                                          equation (auditor-escalated)
      swtpu_conservation_violations       current violation count of
                                          the latest audit (gauge)
      swtpu_conservation_audits_total     audit passes run (gauge,
                                          scrape-synced)
      swtpu_flow_rows                     ledger flow counters, labeled
                                          by stage, per engine
      swtpu_flow_lag                      per-stage lag derived from
                                          the watermarks at scrape
    """
    from sitewhere_tpu_torch.utils.metrics import REGISTRY

    reg = registry or REGISTRY
    return {
        "violations_total": reg.counter(
            "swtpu_conservation_violation_total",
            "confirmed conservation-equation violations, per equation"),
        "violations": reg.gauge(
            "swtpu_conservation_violations",
            "violations in the most recent conservation audit"),
        "audits": reg.gauge(
            "swtpu_conservation_audits_total",
            "conservation audit passes run"),
        "flow": reg.gauge(
            "swtpu_flow_rows",
            "conservation ledger flow counters, per stage"),
        "lag": reg.gauge(
            "swtpu_flow_lag",
            "per-stage lag derived from the conservation watermarks"),
    }


def export_conservation_metrics(engine, registry=None) -> None:
    """Scrape-time export of the ledger's host-side counters and the
    auditor's posture. Builds no ledger (the device reads stay on the
    audit cadence): only the host counters and the latest verdict."""
    eng = getattr(engine, "local", engine)
    led = getattr(eng, "ledger", None)
    if led is None:
        return
    inst = conservation_metrics(registry)
    lbl = getattr(eng, "metrics_label", "e?")
    flow = inst["flow"]
    flow.set(led.counters.get("staged_rows", 0), stage="staged",
             engine=lbl)
    flow.set(led.counters.get("dispatched_rows", 0), stage="dispatched",
             engine=lbl)
    aud = getattr(eng, "conservation_auditor", None)
    if aud is not None:
        inst["violations"].set(len(aud.last_violations), engine=lbl)
        inst["audits"].set(aud.audits, engine=lbl)
        for k, v in (aud.last_ledger or {}).get("lag", {}).items():
            inst["lag"].set(v, stage=k, engine=lbl)


class ConservationAuditor:
    """Background invariant checker: builds a ledger and evaluates the
    equations every ``interval_s`` seconds. A violation escalates
    (counter + loud structured log) only when the same equation fails two
    consecutive audits: a counter update racing an audit can skew one
    read, so a single imbalance is a suspect, not a verdict.

    Each audit holds the engine lock while it reads the device counters,
    as the JAX auditor does (one ``build_ledger``); ``stats`` counts the
    audits, their device reads (host syncs) and their seconds."""

    def __init__(self, engine, rules_manager=None,
                 interval_s: float = 5.0, registry=None):
        self.engine = engine
        self.rules_manager = rules_manager
        self.interval_s = float(interval_s)
        self._registry = registry
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._suspect: set[str] = set()
        self.audits = 0
        self.confirmed_total = 0
        self.last_ledger: dict | None = None
        self.last_violations: list[dict] = []
        self.stats = {"audits": 0, "syncs": 0, "seconds": 0.0}
        # attach so the scrape exporter and the payload can find us
        getattr(engine, "local", engine).conservation_auditor = self

    def audit(self) -> tuple[dict, list[Violation]]:
        """One audit pass (also the synchronous entry tests use): returns
        (ledger, violations) and applies the two-read confirmation rule
        to the escalation side effects."""
        t0 = time.perf_counter()
        ledger = build_ledger(self.engine, self.rules_manager)
        violations = check_conservation(ledger)
        self.stats["audits"] += 1
        self.stats["syncs"] += ledger["syncs"]
        self.stats["seconds"] += time.perf_counter() - t0
        self.audits += 1
        self.last_ledger = ledger
        self.last_violations = [v.to_dict() for v in violations]
        now_suspect = {v.equation for v in violations}
        confirmed = [v for v in violations if v.equation in self._suspect]
        self._suspect = now_suspect - {v.equation for v in confirmed}
        if confirmed:
            inst = conservation_metrics(self._registry)
            for v in confirmed:
                self.confirmed_total += 1
                inst["violations_total"].inc(equation=v.equation)
                logger.error(
                    "CONSERVATION VIOLATION %s",
                    json.dumps({"equation": v.equation,
                                "message": v.message, "lhs": v.lhs,
                                "rhs": v.rhs, "slack": v.slack,
                                "rank": ledger.get("rank"),
                                "engine": ledger.get("engine")}))
        return ledger, violations

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.audit()
            except Exception:
                logger.exception("conservation audit pass failed")

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="swtpu-conservation",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def conservation_payload(engine, rules_manager=None) -> dict:
    """A fresh ledger + verdict, plus the background auditor's posture
    when one is attached."""
    ledger = build_ledger(engine, rules_manager)
    violations = check_conservation(ledger)
    out = {"ledger": ledger,
           "violations": [v.to_dict() for v in violations],
           "balanced": not violations}
    aud = getattr(getattr(engine, "local", engine),
                  "conservation_auditor", None)
    if aud is not None:
        out["auditor"] = {"audits": aud.audits,
                          "confirmedViolations": aud.confirmed_total,
                          "intervalS": aud.interval_s,
                          "running": aud.running}
    return out
