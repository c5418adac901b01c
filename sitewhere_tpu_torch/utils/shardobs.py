"""Shard heat and skew observability for the multi-shard engine (a copy of
``sitewhere_tpu/utils/shardobs.py``, which is numpy-only; the port keeps
its own so that it imports nothing of the JAX package).

The shards' steps run one after another within a dispatch, so one hot
shard sets the pace of every dispatch. This module is the host-side half
of the plane:

  * :class:`ShardHeatTracker` — decayed-EWMA events/s per
    (shard, tenant bucket) and per placement slot, computed from
    cumulative counter deltas at harvest time (the device-side tenant
    counter grid the step already keeps; reading it is one copy to the
    host), plus the per-dispatch imbalance index fed by the scatter
    path's per-shard row counts. Sustained skew escalates only after two
    consecutive audits over the threshold.
  * :func:`spmd_heat_payload` — the shard document: per-shard flow
    counters, the heat maps, the top-K hot slots and the skew posture.
    Engines without shards answer ``{"spmd": False}``.

Everything here stays out of ``engine.metrics()`` (its keys are pinned
equal to the single-card engine's); the Prometheus series live in
``utils/metrics`` ``spmd_metrics`` / ``export_spmd_metrics``. numpy and
the standard library only; the engine hands in plain host arrays.
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np

logger = logging.getLogger(__name__)

# EWMA half-life of the heat maps: a slot that goes quiet loses half its
# heat every HEAT_HALFLIFE_S seconds, so "hottest" means "hottest about
# now", not "hottest since boot"
HEAT_HALFLIFE_S = 10.0
# max/mean routed-rows imbalance that counts as a skew breach; the fused
# step is bulk-synchronous, so index k means the mesh runs at ~1/k of
# its balanced throughput while the breach lasts
SKEW_THRESHOLD = 4.0
TOP_K_SLOTS = 8


class ShardHeatTracker:
    """Host-side heat maps + skew posture for one SpmdEngine.

    All mutation sites hold the engine lock (harvest runs under it, the
    dispatch path already does), so no lock of its own; ``enabled``
    toggles the per-dispatch accounting (an overhead estimator
    flips it per batch, the conservation-ledger discipline).

    Determinism: the tracker never reads a clock — callers pass
    ``now_s`` (the engine's harvest seam defaults it to
    ``time.monotonic()``), so a seeded stream replayed with the same
    harvest times yields byte-identical heat maps (pinned by
    tests/test_shardobs.py)."""

    __slots__ = ("n_shards", "n_slots", "halflife_s", "skew_threshold",
                 "enabled", "heat_grid", "slot_heat", "skew_index",
                 "accept_skew", "dispatches", "harvests",
                 "sustained_total", "_skew_hwm", "_suspect", "_last_t",
                 "_last_events", "_last_slot_rows")

    def __init__(self, n_shards: int, n_slots: int,
                 halflife_s: float = HEAT_HALFLIFE_S,
                 skew_threshold: float = SKEW_THRESHOLD):
        self.n_shards = int(n_shards)
        self.n_slots = int(n_slots)
        self.halflife_s = float(halflife_s)
        self.skew_threshold = float(skew_threshold)
        self.enabled = True
        self.heat_grid: np.ndarray | None = None   # [S, T] eps EWMA
        self.slot_heat = np.zeros(self.n_slots)    # [n_slots] eps EWMA
        self.skew_index = 1.0        # last dispatch's max/mean routed rows
        self.accept_skew = 1.0       # last harvest's max/mean accepted delta
        self.dispatches = 0
        self.harvests = 0
        self.sustained_total = 0
        self._skew_hwm = 1.0
        self._suspect = False
        self._last_t: float | None = None
        self._last_events: np.ndarray | None = None
        self._last_slot_rows: np.ndarray | None = None

    # ------------------------------------------------------------ dispatch
    def note_dispatch(self, rows_per_shard) -> float:
        """Per-dispatch imbalance index from the scatter path's existing
        per-shard row counts: max/mean over ALL shard lanes — every chip
        waits for the fullest lane, so max/mean IS the stall factor a
        straggler imposes on the whole mesh."""
        rows = np.asarray(rows_per_shard, dtype=np.int64)
        total = int(rows.sum())
        skew = (float(rows.max()) * self.n_shards / total) if total else 1.0
        self.skew_index = skew
        if skew > self._skew_hwm:
            self._skew_hwm = skew
        self.dispatches += 1
        return skew

    # ------------------------------------------------------------- harvest
    def harvest(self, grid: np.ndarray, slot_rows: np.ndarray,
                now_s: float) -> None:
        """EWMA update from cumulative counter deltas. ``grid`` is the
        UNFOLDED device tenant-counter grid ``[S, T, lanes]`` (lanes in
        TENANT_COUNTER_LANES order); heat counts the rows the shard
        actually processed for the bucket — accepted + invalid, the two
        lanes that partition ``processed``. ``slot_rows`` is the host
        router's cumulative rows-routed-per-slot array. The first call
        primes the baselines and reports zero heat (a rate needs two
        samples)."""
        ev = (grid[..., 0] + grid[..., 3]).astype(np.int64)   # [S, T]
        slots = np.asarray(slot_rows, dtype=np.int64)
        self.harvests += 1
        if self._last_t is None or self._last_events is None:
            self.heat_grid = np.zeros(ev.shape)
            self._last_events = ev
            self._last_slot_rows = slots.copy()
            self._last_t = float(now_s)
            return
        dt = max(float(now_s) - self._last_t, 1e-9)
        alpha = 1.0 - 0.5 ** (dt / self.halflife_s)
        if self.heat_grid is None or self.heat_grid.shape != ev.shape:
            self.heat_grid = np.zeros(ev.shape)
            self._last_events = np.zeros(ev.shape, np.int64)
        d_ev = np.maximum(ev - self._last_events, 0)
        self.heat_grid = ((1.0 - alpha) * self.heat_grid
                          + alpha * (d_ev / dt))
        d_slot = np.maximum(slots - self._last_slot_rows, 0)
        self.slot_heat = ((1.0 - alpha) * self.slot_heat
                          + alpha * (d_slot / dt))
        acc = d_ev.sum(axis=1)                                 # [S]
        total = int(acc.sum())
        self.accept_skew = (float(acc.max()) * self.n_shards / total
                            if total else 1.0)
        self._last_events = ev
        self._last_slot_rows = slots.copy()
        self._last_t = float(now_s)

    # ------------------------------------------------------------- posture
    @property
    def skew_hwm(self) -> float:
        """Peek (no reset): worst dispatch imbalance since the last
        scrape took it."""
        return max(self._skew_hwm, self.skew_index)

    def take_skew_hwm(self, reset: bool = True) -> float:
        """Worst dispatch imbalance since the last take — RESET on
        scrape so each sample reads "worst case this scrape window"
        (as the arena high-watermark does)."""
        hwm = max(self._skew_hwm, self.skew_index)
        if reset:
            self._skew_hwm = self.skew_index
        return hwm

    def top_slots(self, k: int = TOP_K_SLOTS) -> list[tuple[int, float]]:
        """The K hottest placement slots, hottest first (quiet slots
        omitted) — the heat input ``placement.propose_moves`` feeds to
        ``decide_balance`` instead of guessing from rank-level p99."""
        order = np.argsort(-self.slot_heat, kind="stable")[:k]
        return [(int(s), float(self.slot_heat[s])) for s in order
                if self.slot_heat[s] > 0.0]

    def audit_skew(self) -> bool:
        """One skew audit (scrape-cadence). A breach must survive TWO
        consecutive audits before it escalates — a single hot dispatch
        between audits is a suspect, not a verdict (the
        conservation-auditor confirmation rule). Escalation returns
        True, bumps ``sustained_total``, and emits one loud structured
        log line; the caller owns the counter export."""
        breach = self.skew_index >= self.skew_threshold
        confirmed = breach and self._suspect
        self._suspect = breach and not confirmed
        if confirmed:
            self.sustained_total += 1
            logger.warning(
                "SPMD SKEW SUSTAINED %s",
                json.dumps({"skewIndex": round(self.skew_index, 3),
                            "threshold": self.skew_threshold,
                            "acceptSkew": round(self.accept_skew, 3),
                            "dispatches": self.dispatches}))
        return confirmed

    def skew_posture(self) -> dict:
        return {"index": round(self.skew_index, 4),
                "acceptIndex": round(self.accept_skew, 4),
                "hwm": round(self.skew_hwm, 4),
                "threshold": self.skew_threshold,
                "dispatches": self.dispatches,
                "sustained": self.sustained_total,
                "suspect": self._suspect}


def _bucket_names(tenants) -> dict[int, str]:
    """bucket index -> tenant name, the format_tenant_counter_grid
    naming rule (buckets past the named-tenant range label bucketN)."""
    from sitewhere_tpu_torch.pipeline import TENANT_COUNTER_BUCKETS

    return {tid % TENANT_COUNTER_BUCKETS: tenants.token(tid)
            for tid in range(min(len(tenants), TENANT_COUNTER_BUCKETS))}


def heat_map_doc(tracker: ShardHeatTracker, tenants) -> dict:
    """{shard: {tenant: eps}} from the tracker's heat grid (quiet cells
    omitted; bucket naming mirrors format_tenant_counter_grid)."""
    if tracker.heat_grid is None:
        return {}
    names = _bucket_names(tenants)
    out: dict[str, dict[str, float]] = {}
    hg = tracker.heat_grid
    for s, b in zip(*np.nonzero(hg > 0.0)):
        out.setdefault(str(int(s)), {})[
            names.get(int(b), f"bucket{int(b)}")] = round(
                float(hg[s, b]), 3)
    return out


def spmd_heat_payload(engine, now_s: float | None = None) -> dict:
    """The shard document (what the JAX package serves at ``GET
    /api/instance/spmd/heat`` and in the debug bundle's "spmd" section;
    the port has no server yet): per-shard flow counters, the
    (shard, tenant) heat map, top-K hot slots, and the skew posture.
    Duck-typed like every surface before it — an engine without a
    shard plane answers ``{"spmd": False}``."""
    eng = getattr(engine, "local", engine)
    flow = getattr(eng, "shard_flow", None)
    if not callable(flow):
        return {"spmd": False}
    doc: dict = {"spmd": True,
                 "rank": getattr(engine, "rank", 0),
                 "engine": getattr(eng, "metrics_label", "e?"),
                 "generatedMs": int(time.time() * 1000),
                 "flow": flow()}
    harvest = getattr(eng, "harvest_shard_heat", None)
    tracker = harvest(now_s) if callable(harvest) else None
    if tracker is not None:
        doc["heat"] = heat_map_doc(tracker, eng.tenants)
        doc["slots"] = {"topK": [{"slot": s, "eps": round(eps, 3)}
                                 for s, eps in tracker.top_slots()],
                        "nSlots": tracker.n_slots,
                        "halflifeS": tracker.halflife_s}
        doc["skew"] = tracker.skew_posture()
    return doc
