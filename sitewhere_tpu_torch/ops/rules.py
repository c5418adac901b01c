"""Fused streaming-rule + continuous-rollup update (the CEP tier; port of
``sitewhere_tpu/ops/rules.py``).

A rule set lowers into device-resident parameter tables + carried state
tensors that ride inside the fused ingest step. One stable two-key sort
per group scope orders the batch into (group, time) runs; everything else
is cumulative-max / cumsum prefixes, ``searchsorted`` run maps and
gathers:

  * per-group run bounds come from ``searchsorted`` over the sorted group
    column (groups are ascending, so each group's run is an interval);
  * "most recent selected row at-or-before me" (the sequence A-mark, the
    absence previous match, first-fire-of-key detection) is a global
    ``torch.cummax`` over selected row indices, guarded by the run/window
    start index — valid because within a run the sort makes timestamps
    ascending;
  * segmented count/sum prefixes are a global ``cumsum`` minus its value
    at the segment head (exact for ints; exact for float sums of
    exactly-representable partial sums);
  * pending fires are looked up by rank via ``searchsorted`` over the
    global new-key cumsum — up to K distinct fired keys per (rule, group)
    per batch land in the pending ring, oldest dropped and counted.

The per-rule ``layout`` (kind/scope/agg/ops) is plain Python structure the
update branches on; the table columns are tensors, so a parameter tweak
is a tensor swap.

Determinism contract (as in the JAX package): every update and fire
decision is a pure function of the event stream (event-time ``ts_ms``,
values, group ids) and is batch-partition invariant: the same stream cut
at different batch boundaries gives the same carried state and the same
fire key set. Sorted positions and ``searchsorted`` results are int64 in
torch; everything stored is int32 again.

The rollups' ``adds`` sum float32 values through a scatter with duplicate
indices. CUDA adds those in no fixed order, so the sums equal the CPU's
(and XLA's) only where every partial sum is exact; counts (``adds[..., 0]``)
are exact below 2**24.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sitewhere_tpu_torch.compat import (DEFAULT_DEVICE, INT32_MAX, INT32_MIN,
                                        flat_index, gather_fill, resolve_device,
                                        scatter_reduce_drop)
from sitewhere_tpu_torch.core.types import NULL_ID
from sitewhere_tpu_torch.ops.segment import lex_argsort

# rule kinds (threshold lowers to KIND_WINDOW in the model, so the update
# only knows three)
KIND_WINDOW = 0
KIND_SEQUENCE = 1
KIND_ABSENCE = 2

# group scopes
SCOPE_DEVICE = 0
SCOPE_AREA = 1
SCOPE_TENANT = 2

# comparison ops
OP_GT = 0
OP_GE = 1
OP_LT = 2
OP_LE = 3
NO_PRED = -1

# window aggregates
AGG_COUNT = 0
AGG_SUM = 1
AGG_MIN = 2
AGG_MAX = 3

F32_INF = float("inf")
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class RuleBlock:
    """R rules over G group slots. ``layout`` is the static per-rule
    structure; the table columns are runtime parameters; the state columns
    are the carried accumulators."""

    # static per-rule structure: ((kind, scope, agg, op_a, op_b), ...)
    layout: tuple

    # ------------------------------------------------ parameters, [R]
    active: torch.Tensor     # bool[R]
    etype: torch.Tensor      # int32[R] event-type filter (NULL_ID = any)
    tenant: torch.Tensor     # int32[R] tenant filter (NULL_ID = any)
    ch_a: torch.Tensor       # int32[R] predicate-A value channel
    val_a: torch.Tensor      # float32[R]
    ch_b: torch.Tensor       # int32[R] predicate-B channel (sequence /
    val_b: torch.Tensor      # float32[R]   window contributing filter)
    window_ms: torch.Tensor  # int32[R] window / pair horizon / deadline

    # ------------------------------------------------ carried state
    wm: torch.Tensor         # int32[] event-time watermark (max ts seen)
    acc_wid: torch.Tensor    # int32[R, G] window id being accumulated
    acc_cnt: torch.Tensor    # int32[R, G] (count/sum windows)
    acc_sum: torch.Tensor    # float32[R, G]
    mark_ts: torch.Tensor    # int32[R, G] seq: last pred-A ts; absence:
    #                          last matching ts (INT32_MIN = never)
    fired_key: torch.Tensor  # int32[R, G] newest fired key (dedup guard)
    # pending-fire ring per (rule, group): up to K un-harvested fires
    # survive between polls; overflow drops the oldest (counted in
    # ``missed``)
    pend_key: torch.Tensor   # int32[R, G, K]
    pend_val: torch.Tensor   # float32[R, G, K]
    pend_w: torch.Tensor     # int32[R, G] total fires written (ring cursor)
    pend_h: torch.Tensor     # int32[R, G] fires harvested
    fires: torch.Tensor      # int32[] distinct keys fired (partition-inv.)
    missed: torch.Tensor     # int32[] fires dropped (ring overflow)
    late: torch.Tensor       # int32[] events older than their window carry
    oob: torch.Tensor        # int32[] matches whose group id >= G

    @property
    def n_rules(self) -> int:
        return len(self.layout)

    @property
    def groups(self) -> int:
        return self.acc_wid.shape[1]

    @property
    def pend_depth(self) -> int:
        return self.pend_key.shape[2]

    @staticmethod
    def zeros(table: dict, layout: tuple, groups: int, pending: int = 4,
              device: str | torch.device = DEFAULT_DEVICE) -> "RuleBlock":
        """Fresh state for a lowered parameter table (``table`` maps the
        parameter field names to numpy arrays of length R ==
        len(layout))."""
        dev = resolve_device(device)
        r, g, k = len(layout), int(groups), max(1, int(pending))

        def col(name, dtype):
            return torch.tensor(np.asarray(table[name]), dtype=dtype, device=dev)

        def full(shape, fill, dtype=_I32):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        return RuleBlock(
            layout=tuple(tuple(int(x) for x in row) for row in layout),
            active=col("active", torch.bool),
            **{kk: col(kk, _I32) for kk in ("etype", "tenant", "ch_a", "ch_b",
                                             "window_ms")},
            val_a=col("val_a", torch.float32),
            val_b=col("val_b", torch.float32),
            wm=full((), INT32_MIN),
            acc_wid=full((r, g), INT32_MIN),
            acc_cnt=full((r, g), 0),
            acc_sum=full((r, g), 0.0, torch.float32),
            mark_ts=full((r, g), INT32_MIN),
            fired_key=full((r, g), INT32_MIN),
            pend_key=full((r, g, k), INT32_MIN),
            pend_val=full((r, g, k), 0.0, torch.float32),
            pend_w=full((r, g), 0),
            pend_h=full((r, g), 0),
            fires=full((), 0),
            missed=full((), 0),
            late=full((), 0),
            oob=full((), 0),
        )


@dataclasses.dataclass(frozen=True)
class RollupBlock:
    """P continuous rollups, each a [G, NB] ring of tumbling time-window
    aggregates of one value channel per device/area/tenant group. Stat
    lanes pack two-wide so each ring update is three scatter passes
    (newest window id, add(count, sum), max(max, -min))."""

    channel: torch.Tensor    # int32[P]
    scope: torch.Tensor      # int32[P] SCOPE_*
    etype: torch.Tensor      # int32[P] (NULL_ID = any)
    window_ms: torch.Tensor  # int32[P]
    wid: torch.Tensor        # int32[P, G, NB] window id held by each slot
    adds: torch.Tensor       # float32[P, G, NB, 2] (count, sum)
    exts: torch.Tensor       # float32[P, G, NB, 2] (max, -min)
    late: torch.Tensor       # int32[] events older than their slot's window

    # ---- named views (the read surface the manager and tests consume)
    @property
    def cnt(self) -> torch.Tensor:
        return self.adds[..., 0].to(_I32)

    @property
    def vsum(self) -> torch.Tensor:
        return self.adds[..., 1]

    @property
    def vmax(self) -> torch.Tensor:
        return self.exts[..., 0]

    @property
    def vmin(self) -> torch.Tensor:
        return -self.exts[..., 1]

    @property
    def n_rollups(self) -> int:
        return self.channel.shape[0]

    @property
    def groups(self) -> int:
        return self.wid.shape[1]

    @property
    def buckets(self) -> int:
        return self.wid.shape[2]

    @staticmethod
    def zeros(table: dict, groups: int, buckets: int,
              device: str | torch.device = DEFAULT_DEVICE) -> "RollupBlock":
        dev = resolve_device(device)
        p = len(table["channel"])
        g, nb = int(groups), int(buckets)
        return RollupBlock(
            **{k: torch.tensor(np.asarray(table[k]), dtype=_I32, device=dev)
               for k in ("channel", "scope", "etype", "window_ms")},
            wid=torch.full((p, g, nb), INT32_MIN, dtype=_I32, device=dev),
            adds=torch.zeros((p, g, nb, 2), dtype=torch.float32, device=dev),
            exts=torch.full((p, g, nb, 2), -F32_INF, dtype=torch.float32,
                            device=dev),
            late=torch.zeros((), dtype=_I32, device=dev),
        )


@dataclasses.dataclass(frozen=True)
class RulesState:
    """The CEP tier's slice of PipelineState (``state.rules``)."""

    rules: RuleBlock | None = None
    rollups: RollupBlock | None = None


# --------------------------------------------------------------------------
# update helpers
# --------------------------------------------------------------------------

def _cmp_static(v, op: int, ref):
    """Comparison with a static op code."""
    if op == OP_GT:
        return v > ref
    if op == OP_GE:
        return v >= ref
    if op == OP_LT:
        return v < ref
    return v <= ref


def _chans(batch, ch: torch.Tensor):
    """Per-rule value channels gathered in one pass: [B, R] values and
    populated-masks for a channel-index vector."""
    idx = ch.long()
    return batch.values[:, idx], batch.vmask[:, idx]


def _isum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=_I32)


def _last_at_or_before(sel, iota, guard_start):
    """For each row, the index of the newest selected row strictly before
    it within its segment (-1 when none): a global running max over
    selected indices, shifted one row and guarded by the segment-start
    index. Valid because rows are (group, ts)-sorted."""
    last = torch.cummax(torch.where(sel, iota, -1), 0).values
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    return torch.where(prev >= guard_start, prev, -1)


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[idx.long()]


class _ScopeView:
    """One (group, ts)-sorted view of the batch, shared by every rule of a
    scope: permutation, sorted group/ts columns, run-start indices and
    per-group run bounds (``searchsorted`` over the ascending groups)."""

    __slots__ = ("perm", "g_s", "ts_s", "live", "seg_start", "start_idx",
                 "lo", "ends", "has", "iota")

    def __init__(self, gcol, ts, groups):
        b = gcol.shape[0]
        dev = gcol.device
        (self.g_s, self.ts_s), perm = lex_argsort([gcol, ts])
        self.perm = perm.long()
        self.live = self.g_s < groups
        self.iota = torch.arange(b, dtype=_I32, device=dev)
        self.seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                    self.g_s[1:] != self.g_s[:-1]])
        self.start_idx = torch.cummax(
            torch.where(self.seg_start, self.iota, -1), 0).values
        gid = torch.arange(groups, dtype=_I32, device=dev)
        g_s = self.g_s.contiguous()
        self.lo = torch.searchsorted(g_s, gid, out_int32=True)
        self.ends = torch.searchsorted(g_s, gid, right=True, out_int32=True) - 1
        self.has = self.ends >= self.lo


def _ring_push_multi(pend_key, pend_val, pend_w, pend_h, fired_key,
                     sv: _ScopeView, new_key, key_e, val_e):
    """Push every distinct fired key (per group, run order, newest K kept)
    into the [G, K] pending ring — rank lookups via searchsorted over the
    global new-key cumsum; no scatters. Returns the updated ring +
    cursors + fired_key and the (fires, missed) deltas."""
    g, k = pend_key.shape
    dev = pend_key.device
    nk = new_key.to(_I32)
    c_glob = torch.cumsum(nk, 0, dtype=_I32)
    lo_safe = torch.where(sv.has, sv.lo, 0)
    end_safe = torch.where(sv.has, sv.ends, 0)
    base = torch.where(sv.has, _at(c_glob, lo_safe) - _at(nk, lo_safe), 0)
    c_g = torch.where(sv.has, _at(c_glob, end_safe) - base, 0)        # [G]
    kept = torch.clamp(c_g, max=k)
    # ranks (1-based within the run's new-key rows) of the kept fires
    jj = torch.arange(k, dtype=_I32, device=dev)[None, :]             # [1, K]
    want = jj < kept[:, None]
    target = base[:, None] + (c_g - kept)[:, None] + jj + 1
    rows = torch.searchsorted(c_glob, torch.where(want, target, -1).contiguous(),
                              out_int32=True)
    rows = torch.clamp(rows, 0, new_key.shape[0] - 1)
    keys_gk = _at(key_e, rows)
    vals_gk = _at(val_e, rows)
    slot = (pend_w[:, None] + jj) % k
    onehot = slot[:, :, None] == torch.arange(k, device=dev)[None, None, :]
    write = want[:, :, None] & onehot                                  # [G,K,K]
    hit = write.any(1)
    pend_key = torch.where(
        hit, torch.where(write, keys_gk[:, :, None], 0).sum(1, dtype=_I32),
        pend_key)
    pend_val = torch.where(
        hit, torch.where(write, vals_gk[:, :, None], 0.0).sum(1), pend_val)
    pending_before = torch.clamp(pend_w - pend_h, 0, k)
    missed = (_isum(torch.clamp(pending_before + kept - k, min=0))
              + _isum(c_g - kept))
    pend_w = pend_w + c_g
    last_key = torch.where(
        c_g > 0,
        keys_gk[torch.arange(g, device=dev), torch.clamp(kept - 1, min=0).long()],
        INT32_MIN)
    fired_key = torch.maximum(fired_key, last_key)
    return pend_key, pend_val, pend_w, fired_key, _isum(c_g), missed


def _pend_push_one(pend_key, pend_val, pend_w, pend_h, fire, key, val):
    """Append at most one fire per group (the absence trailing check)."""
    k = pend_key.shape[1]
    slot = pend_w % k
    onehot = slot[:, None] == torch.arange(k, device=pend_key.device)[None, :]
    write = fire[:, None] & onehot
    overflow = fire & (pend_w - pend_h >= k)
    return (torch.where(write, key[:, None], pend_key),
            torch.where(write, val[:, None], pend_val),
            pend_w + fire.to(_I32),
            _isum(overflow))


def _rules_block_update(rb: RuleBlock, batch, dev, area,
                        base_valid) -> RuleBlock:
    g = rb.groups
    ts = batch.ts_ms
    wm_new = torch.maximum(
        rb.wm, torch.where(batch.valid, ts, INT32_MIN).max())
    gcols = {SCOPE_DEVICE: dev, SCOPE_AREA: area,
             SCOPE_TENANT: batch.tenant_id}
    views: dict[int, _ScopeView] = {}
    new_state = {f: [] for f in ("acc_wid", "acc_cnt", "acc_sum",
                                 "mark_ts", "fired_key", "pend_key",
                                 "pend_val", "pend_w")}
    zero = torch.zeros((), dtype=_I32, device=ts.device)
    fires_n, missed_n, late_n, oob_n = zero, zero, zero, zero
    va_all, vma_all = _chans(batch, rb.ch_a)          # [B, R]
    vb_all, vmb_all = _chans(batch, rb.ch_b)

    for r, (kind, scope, agg, op_a, op_b) in enumerate(rb.layout):
        sv = views.get(scope)
        if sv is None:
            gc = gcols[scope]
            key = torch.where(base_valid & (gc >= 0) & (gc < g), gc, g)
            sv = views[scope] = _ScopeView(key, ts, g)
        win = torch.clamp(rb.window_ms[r], min=1)
        et_ok = (rb.etype[r] == NULL_ID) | (batch.etype == rb.etype[r])
        tn_ok = (rb.tenant[r] == NULL_ID) | (batch.tenant_id == rb.tenant[r])
        ev_ok = base_valid & et_ok & tn_ok & rb.active[r]
        v_a, vm_a = va_all[:, r], vma_all[:, r]
        # out-of-capacity groups: count matches that fell off the table
        oob_raw = ev_ok & vm_a & ((gcols[scope] < 0) | (gcols[scope] >= g))
        oob_n = oob_n + _isum(oob_raw)

        ts_s = sv.ts_s
        g_safe = torch.clamp(sv.g_s, max=g - 1).long()
        fired_row = torch.where(sv.live, rb.fired_key[r][g_safe], INT32_MAX)
        end_safe = torch.where(sv.has, sv.ends, 0)

        acc_wid_r, acc_cnt_r, acc_sum_r = (rb.acc_wid[r], rb.acc_cnt[r],
                                           rb.acc_sum[r])
        mark_r = rb.mark_ts[r]
        fired_r = rb.fired_key[r]

        if kind == KIND_WINDOW:
            m = ev_ok & vm_a
            if op_b != NO_PRED:   # contributing-event filter
                m = m & vmb_all[:, r] & _cmp_static(vb_all[:, r], op_b,
                                                    rb.val_b[r])
            m_s = m[sv.perm] & sv.live
            v_s = v_a[sv.perm]
            wid = ts_s // win
            prev_wid = torch.cat([wid[:1] - 1, wid[:-1]])
            wstart = sv.seg_start | (wid != prev_wid)
            wstart_idx = torch.cummax(
                torch.where(wstart, sv.iota, -1), 0).values
            cw = torch.where(sv.live, acc_wid_r[g_safe], INT32_MIN)
            join = (cw > INT32_MIN) & (wid == cw)
            late_n = late_n + _isum(m_s & (wid < cw))
            eff = m_s & (wid >= cw)
            wid_end = _at(wid, end_safe)
            if agg in (AGG_COUNT, AGG_SUM):
                x = (eff.to(_I32) if agg == AGG_COUNT
                     else torch.where(eff, v_s, 0.0))
                cx = torch.cumsum(x, 0, dtype=x.dtype)
                seg = cx - (_at(cx, wstart_idx) - _at(x, wstart_idx))  # inclusive
                acc = acc_cnt_r if agg == AGG_COUNT else acc_sum_r
                carry = torch.where(join, acc[g_safe], torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))
                tot = seg + carry
                totf = tot.to(torch.float32)
                fire = (eff & _cmp_static(totf, op_a, rb.val_a[r])
                        & (wid > fired_row))
                # first fire of a window: the exclusive total had not
                # crossed (carry-crossed windows fired a batch ago and are
                # blocked by the dedup guard)
                new_key = fire & ~_cmp_static(
                    (tot - x).to(torch.float32), op_a, rb.val_a[r])
                key_e, val_e = wid, totf
                # run-end accumulator (totals of the newest window)
                upd = sv.has & (wid_end >= acc_wid_r)
                tot_end = _at(tot, end_safe)
                if agg == AGG_COUNT:
                    acc_cnt_r = torch.where(upd, tot_end, acc_cnt_r)
                else:
                    acc_sum_r = torch.where(upd, tot_end, acc_sum_r)
                acc_wid_r = torch.where(upd, wid_end, acc_wid_r)
            else:
                # extremum windows (thresholds lower here): the running
                # max/min crosses exactly when some event crosses, so
                # fires are per-event with no accumulator at all
                cross = eff & _cmp_static(v_s, op_a, rb.val_a[r])
                fire = cross & (wid > fired_row)
                prior = _last_at_or_before(cross, sv.iota, wstart_idx)
                new_key = fire & (prior < 0)
                key_e, val_e = wid, v_s
                upd = sv.has & (wid_end >= acc_wid_r)
                acc_wid_r = torch.where(upd, wid_end, acc_wid_r)
        else:
            m_a = (ev_ok & vm_a
                   & _cmp_static(v_a, op_a, rb.val_a[r]))[sv.perm] & sv.live
            prev = _last_at_or_before(m_a, sv.iota, sv.start_idx)
            prev_ts = torch.where(prev >= 0, _at(ts_s, torch.clamp(prev, min=0)),
                                  torch.where(sv.live, mark_r[g_safe], INT32_MIN))
            if kind == KIND_SEQUENCE:
                m_b = (ev_ok & vmb_all[:, r]
                       & _cmp_static(vb_all[:, r], op_b,
                                     rb.val_b[r]))[sv.perm] & sv.live
                fire = (m_b & (prev_ts > INT32_MIN) & (ts_s >= prev_ts)
                        & (ts_s - prev_ts <= win))
                key_e = ts_s // win
            else:  # KIND_ABSENCE
                # a match after a silence longer than the deadline fires,
                # keyed by the silence-opening timestamp
                fire = (m_a & (prev_ts > INT32_MIN)
                        & (ts_s - prev_ts > win))
                key_e = prev_ts
            fire = fire & (key_e > fired_row)
            val_e = (ts_s - prev_ts).to(torch.float32)
            prev_f = _last_at_or_before(fire, sv.iota, sv.start_idx)
            new_key = fire & ((prev_f < 0)
                              | (_at(key_e, torch.clamp(prev_f, min=0)) != key_e))
            # mark = newest pred-A / matching timestamp (run-end gather)
            last_sel = torch.cummax(torch.where(m_a, sv.iota, -1), 0).values
            le = _at(last_sel, end_safe)
            in_run = sv.has & (le >= sv.lo)
            mark_r = torch.where(
                in_run, torch.maximum(mark_r, _at(ts_s, torch.clamp(le, min=0))),
                mark_r)

        pk, pv, pw, fired_r, f_n, m_n = _ring_push_multi(
            rb.pend_key[r], rb.pend_val[r], rb.pend_w[r], rb.pend_h[r],
            fired_r, sv, new_key, key_e, val_e)
        fires_n = fires_n + f_n
        missed_n = missed_n + m_n

        if kind == KIND_ABSENCE:
            # trailing: the watermark passed last_seen + deadline with no
            # new match (at most one per group per batch)
            trail = (rb.active[r] & (mark_r > INT32_MIN)
                     & (wm_new - mark_r > win) & (mark_r > fired_r))
            pk, pv, pw, over = _pend_push_one(
                pk, pv, pw, rb.pend_h[r], trail, mark_r,
                (wm_new - mark_r).to(torch.float32))
            fired_r = torch.where(trail, mark_r, fired_r)
            fires_n = fires_n + _isum(trail)
            missed_n = missed_n + over

        for f, v in (("acc_wid", acc_wid_r), ("acc_cnt", acc_cnt_r),
                     ("acc_sum", acc_sum_r), ("mark_ts", mark_r),
                     ("fired_key", fired_r), ("pend_key", pk),
                     ("pend_val", pv), ("pend_w", pw)):
            new_state[f].append(v)

    return dataclasses.replace(
        rb, wm=wm_new,
        **{f: torch.stack(v) for f, v in new_state.items()},
        fires=rb.fires + fires_n,
        missed=rb.missed + missed_n,
        late=rb.late + late_n,
        oob=rb.oob + oob_n)


def _rollup_block_update(ro: RollupBlock, batch, groups3,
                         base_valid) -> RollupBlock:
    p, g, nb = ro.wid.shape
    b = batch.capacity
    ts = batch.ts_ms
    dev = ts.device

    et_ok = ((ro.etype[None, :] == NULL_ID)
             | (batch.etype[:, None] == ro.etype[None, :]))
    v, vm = _chans(batch, ro.channel)                       # [B, P]
    g_bp = groups3[ro.scope.long()].T                       # [B, P]
    rel = base_valid[:, None] & et_ok & vm & (g_bp >= 0) & (g_bp < g)
    win = torch.clamp(ro.window_ms, min=1)[None, :]
    wid = ts[:, None] // win
    slot = wid % nb
    p_bp = torch.arange(p, dtype=_I32, device=dev)[None, :].expand(b, p)
    # a sentinel on the leading index drops irrelevant points
    pi = torch.where(rel, p_bp, p)
    gi = torch.clamp(g_bp, 0, g - 1)
    shape = (p, g, nb)
    # pass 1: the newest window id per touched slot wins the slot
    cell = flat_index((pi, gi, slot), shape).reshape(-1)
    wid_new = scatter_reduce_drop(ro.wid.reshape(-1), cell, wid.reshape(-1),
                                  "amax").view(shape)
    stale = wid_new != ro.wid
    adds0 = torch.where(stale[..., None], 0.0, ro.adds)
    exts0 = torch.where(stale[..., None], -F32_INF, ro.exts)
    # pass 2/3: events carrying the slot's (new) window id contribute;
    # older ones are late (counted, never mixed into a newer window)
    contrib = rel & (wid == gather_fill(wid_new.reshape(-1),
                                        cell.view(b, p), INT32_MIN))
    pc = torch.where(contrib, p_bp, p)
    cell = flat_index((pc, gi, slot), shape).reshape(-1)
    ones = torch.ones_like(v)
    rows = (p * g * nb, 2)
    return dataclasses.replace(
        ro,
        wid=wid_new,
        adds=scatter_reduce_drop(
            adds0.reshape(rows), cell,
            torch.stack([ones, v], -1).reshape(-1, 2), "sum").view(ro.adds.shape),
        exts=scatter_reduce_drop(
            exts0.reshape(rows), cell,
            torch.stack([v, -v], -1).reshape(-1, 2), "amax").view(ro.exts.shape),
        late=ro.late + _isum(rel & ~contrib))


def rules_update(rs: RulesState, batch, dev, found, registry) -> RulesState:
    """One batch through the CEP tier: called inside ``pipeline_step`` on
    the post-lookup view (``dev``/``found`` from ops/lookup), so rules and
    rollups see exactly the rows that persist."""
    if rs.rules is None and rs.rollups is None:
        return rs
    base_valid = batch.valid & found
    n_dev = registry.device_area.shape[0]
    dev_safe = torch.clamp(dev, 0, n_dev - 1).long()
    area = torch.where(found, registry.device_area[dev_safe], NULL_ID)

    rules = rs.rules
    if rules is not None:
        rules = _rules_block_update(rules, batch, dev, area, base_valid)

    rollups = rs.rollups
    if rollups is not None:
        groups3 = torch.stack([dev, area, batch.tenant_id])  # [3, B]
        rollups = _rollup_block_update(rollups, batch, groups3, base_valid)
    return RulesState(rules=rules, rollups=rollups)


def harvest_fires(rules_state: RulesState):
    """Drain the pending-fire rings (pure). Returns ``(new_rules_state,
    pend_key, pend_val, pend_w, pend_h)`` — the harvest cursor advances to
    the write cursor; the host reconstructs each group's ``min(w - h, K)``
    newest entries from the ring (oldest first at slots
    ``(w - n .. w - 1) % K``)."""
    rb = rules_state.rules
    if rb is None:
        z = torch.zeros((0, 0))
        return rules_state, z, z, z, z
    cleared = dataclasses.replace(rb, pend_h=rb.pend_w)
    return (dataclasses.replace(rules_state, rules=cleared),
            rb.pend_key, rb.pend_val, rb.pend_w, rb.pend_h)


def merge_shard_harvests(pend_key, pend_val, pend_w, pend_h,
                         layout, device_cap):
    """Fold a multi-shard engine's per-shard harvest (stacked
    ``[S, R, G, K]`` rings and ``[S, R, G]`` cursors) into the single-card
    decode layout, scope-aware per rule:

    * device scope — group ids are shard-local device ids and a device
      lives on exactly one shard, so shard ``s``'s ring for local group
      ``g`` lands whole at global group ``s * device_cap + g``;
    * area/tenant scope — group ids are global interner ids replicated on
      every shard, so the per-shard rings for one group fold into one:
      entries merge key-ascending, newest ``K`` kept, cursors rebuilt to
      the ring contract (``n = min(w - h, K)`` newest, oldest first at
      ``(w-n .. w-1) % K``).

    Host arrays in, host arrays out (numpy); output group axis is
    ``max(S * device_cap, G)``."""
    pk = np.asarray(pend_key)                   # [S, R, G, K]
    pv = np.asarray(pend_val)
    pw = np.asarray(pend_w)                     # [S, R, G]
    ph = np.asarray(pend_h)
    s_n, r_n, g_n, depth = pk.shape
    g_out = max(s_n * device_cap, g_n)
    mk = np.zeros((r_n, g_out, depth), pk.dtype)
    mv = np.zeros((r_n, g_out, depth), pv.dtype)
    mw = np.zeros((r_n, g_out), pw.dtype)
    mh = np.zeros((r_n, g_out), ph.dtype)

    def pending(s, r, g):
        """(key, val) pairs of shard s's un-harvested ring, oldest first."""
        n = min(int(pw[s, r, g] - ph[s, r, g]), depth)
        w = int(pw[s, r, g])
        return [(int(pk[s, r, g, (w - n + j) % depth]),
                 float(pv[s, r, g, (w - n + j) % depth]))
                for j in range(n)]

    for r, (_kind, scope, *_rest) in enumerate(layout):
        if scope == SCOPE_DEVICE:
            # whole-ring relocation: local device g -> s*device_cap + g
            span = min(g_n, device_cap)
            for s in range(s_n):
                lo = s * device_cap
                mk[r, lo:lo + span] = pk[s, r, :span]
                mv[r, lo:lo + span] = pv[s, r, :span]
                mw[r, lo:lo + span] = pw[s, r, :span]
                mh[r, lo:lo + span] = ph[s, r, :span]
        else:
            for g in range(g_n):
                entries = [e for s in range(s_n) for e in pending(s, r, g)]
                if not entries:
                    continue
                entries.sort(key=lambda e: e[0])
                keep = entries[-depth:]
                w = len(entries)
                for j, (k, v) in enumerate(keep):
                    slot = (w - len(keep) + j) % depth
                    mk[r, g, slot] = k
                    mv[r, g, slot] = v
                mw[r, g] = w
                mh[r, g] = w - len(keep)
    return mk, mv, mw, mh
