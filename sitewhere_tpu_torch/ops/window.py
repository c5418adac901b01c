"""Windowed device-state aggregation + merge (port of
``sitewhere_tpu/ops/window.py``).

One call merges one batch of events into the ``DeviceStateStore``:
  * recent-event rings (depth R=3, most-recent-first) per class are updated
    with a sort + rank-from-end + masked scatter, then a fixed-size row-wise
    top-R merge against the existing ring;
  * latest-per-channel measurement values use an argmax-scatter over
    (device, channel) segments — exact with duplicate timestamps (batch
    sequence breaks ties);
  * last-interaction / presence / per-type counters are max/set/add scatters.

``presence_sweep`` marks devices whose last interaction is too old MISSING.
"""

from __future__ import annotations

import dataclasses

import torch

from sitewhere_tpu_torch.compat import (INT32_MIN, gather_fill, scatter_drop,
                                        scatter_reduce_drop)
from sitewhere_tpu_torch.core.state import LOC_LANES, RECENT_DEPTH, DeviceStateStore
from sitewhere_tpu_torch.core.types import NUM_EVENT_TYPES, EventType, PresenceState
from sitewhere_tpu_torch.ops.segment import lex_argsort, segment_ranks

_NEG_SAFE_MIN = INT32_MIN + 1


def _flat_ring_scatter(n_devices: int, d_w: torch.Tensor, slot: torch.Tensor,
                       src: torch.Tensor, fill) -> torch.Tensor:
    """[N, R, ...] ring filled with ``fill``, rows (d_w, slot) set to
    ``src``; d_w == n_devices drops the row."""
    r_depth = RECENT_DEPTH
    flat = torch.where(d_w < n_devices, d_w * r_depth + slot,
                       n_devices * r_depth)
    base = torch.full((n_devices * r_depth,) + tuple(src.shape[1:]), fill,
                      dtype=src.dtype, device=src.device)
    return scatter_drop(base, flat, src).reshape(
        (n_devices, r_depth) + tuple(src.shape[1:]))


def _batch_recent_ring(
    n_devices: int,
    take: torch.Tensor,     # bool[B] rows of this event class
    dev: torch.Tensor,      # int32[B]
    ts: torch.Tensor,       # int32[B]
    seq: torch.Tensor,      # int32[B]
    lanes: list[torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """The up-to-R most recent events per device of this batch:
    (ring_valid[N,R], ring_ts[N,R], ring_lanes), slot 0 = newest."""
    dev_key = torch.where(take, dev, n_devices)  # invalid rows sort last
    sorted_keys, perm = lex_argsort([dev_key, ts, seq])
    p = perm.long()
    s_devkey = sorted_keys[0]
    _, rank_end = segment_ranks(s_devkey)
    live = (s_devkey < n_devices) & (rank_end < RECENT_DEPTH)
    d_w = torch.where(live, s_devkey, n_devices)
    # rank_end == 0 is the newest -> slot 0
    ring_valid = _flat_ring_scatter(n_devices, d_w, rank_end,
                                    torch.ones_like(live), False)
    ring_ts = _flat_ring_scatter(n_devices, d_w, rank_end, ts[p], INT32_MIN)
    ring_lanes = [_flat_ring_scatter(n_devices, d_w, rank_end, lane[p], 0)
                  for lane in lanes]
    return ring_valid, ring_ts, ring_lanes


def _merge_rings(
    new_valid: torch.Tensor, new_ts: torch.Tensor, new_lanes: list[torch.Tensor],
    old_valid: torch.Tensor, old_ts: torch.Tensor, old_lanes: list[torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """Row-wise top-R merge of batch ring + existing ring (most-recent-first).
    New entries win timestamp ties (they come first and the sort is
    stable)."""
    cat_valid = torch.cat([new_valid, old_valid], 1)   # [N, 2R]
    cat_ts = torch.cat([new_ts, old_ts], 1)
    # row-wise stable lexicographic sort: invalid last, then ts descending,
    # as two stable passes (least significant key first). Two keys, not one
    # packed int32: packing would collide real near-INT32_MIN timestamps
    # with the invalid sentinel.
    neg_ts = -torch.clamp(cat_ts, min=_NEG_SAFE_MIN)
    order = torch.sort(neg_ts, dim=1, stable=True).indices
    inval = torch.gather((~cat_valid).to(torch.int32), 1, order)
    order = torch.gather(order, 1, torch.sort(inval, dim=1, stable=True).indices)
    order = order[:, :RECENT_DEPTH]
    out_valid = torch.gather(cat_valid, 1, order)
    out_ts = torch.gather(cat_ts, 1, order)
    out_lanes = []
    for new_lane, old_lane in zip(new_lanes, old_lanes):
        cat = torch.cat([new_lane, old_lane], 1)
        idx = order.reshape(order.shape + (1,) * (cat.dim() - 2))
        out_lanes.append(torch.gather(
            cat, 1, idx.expand(order.shape + tuple(cat.shape[2:]))))
    return out_valid, out_ts, out_lanes


def merge_batch_state(
    state: DeviceStateStore,
    dev: torch.Tensor,      # int32[B] dense device id (found events only)
    found: torch.Tensor,    # bool[B]
    etype: torch.Tensor,    # int32[B]
    ts_ms: torch.Tensor,    # int32[B]
    seq: torch.Tensor,      # int32[B]
    values: torch.Tensor,   # float32[B, C]
    vmask: torch.Tensor,    # bool[B, C]
    aux: torch.Tensor,      # int32[B, AUX]
) -> DeviceStateStore:
    """Merge one batch of looked-up events into the device state store."""
    n = state.device_capacity
    c = values.shape[1]
    device = values.device
    dev_safe = torch.where(found, dev, n)  # out of bounds -> dropped

    # --- measurements -----------------------------------------------------
    take_m = found & (etype == int(EventType.MEASUREMENT))
    m_valid, m_ts, (m_vals, m_mask) = _batch_recent_ring(
        n, take_m, dev, ts_ms, seq, [values, vmask])
    rm_valid, rm_ts, (rm_vals, rm_mask) = _merge_rings(
        m_valid, m_ts, [m_vals, m_mask],
        state.recent_meas_valid, state.recent_meas_ms,
        [state.recent_meas, state.recent_meas_mask])

    # latest value per (device, channel): argmax-scatter with (ts, seq) key
    ch_take = take_m[:, None] & vmask                     # bool[B, C]
    chan = torch.arange(c, dtype=torch.int32, device=device)
    flat_seg = torch.where(ch_take, dev_safe[:, None] * c + chan[None, :],
                           n * c).reshape(-1)
    flat_ts = ts_ms[:, None].expand(ch_take.shape).reshape(-1)
    flat_seq = seq[:, None].expand(ch_take.shape).reshape(-1)
    flat_val = values.reshape(-1)
    flat_take = ch_take.reshape(-1)
    neg = torch.full((n * c,), INT32_MIN, dtype=torch.int32, device=device)
    k1 = torch.where(flat_take, flat_ts, INT32_MIN)
    max_ts = scatter_reduce_drop(neg, flat_seg, k1, "amax")
    on_max = flat_take & (flat_ts == gather_fill(max_ts, flat_seg, INT32_MIN))
    k2 = torch.where(on_max, flat_seq, INT32_MIN)
    max_seq = scatter_reduce_drop(neg, flat_seg, k2, "amax")
    winner = on_max & (flat_seq == gather_fill(max_seq, flat_seg, INT32_MIN))
    w_seg = torch.where(winner, flat_seg, n * c)
    # only overwrite when the batch value is at least as new as the stored one
    cand_val = scatter_drop(torch.zeros(n * c, dtype=torch.float32, device=device),
                            w_seg, flat_val).reshape(n, c)
    cand_ts = scatter_drop(neg, w_seg, flat_ts).reshape(n, c)
    newer = cand_ts >= state.meas_last_ms
    meas_last = torch.where(newer & (cand_ts > INT32_MIN), cand_val,
                            state.meas_last)
    meas_last_ms = torch.maximum(state.meas_last_ms, cand_ts)

    # --- locations --------------------------------------------------------
    # vmask lane 0 gates the ring: a LOCATION event without coordinates
    # counts in event_counts but records no (0, 0) row
    take_l = found & (etype == int(EventType.LOCATION)) & vmask[:, 0]
    l_valid, l_ts, (l_vals,) = _batch_recent_ring(
        n, take_l, dev, ts_ms, seq, [values[:, :LOC_LANES]])
    rl_valid, rl_ts, (rl_vals,) = _merge_rings(
        l_valid, l_ts, [l_vals],
        state.recent_loc_valid, state.recent_loc_ms, [state.recent_loc])

    # --- alerts -----------------------------------------------------------
    take_a = found & (etype == int(EventType.ALERT))
    a_valid, a_ts, (a_level, a_type) = _batch_recent_ring(
        n, take_a, dev, ts_ms, seq,
        [values[:, 0].to(torch.int32), aux[:, 0]])
    ra_valid, ra_ts, (ra_level, ra_type) = _merge_rings(
        a_valid, a_ts, [a_level, a_type],
        state.recent_alert_valid, state.recent_alert_ms,
        [state.recent_alert_level, state.recent_alert_type])

    # --- presence / interaction / counters --------------------------------
    last_inter = scatter_reduce_drop(
        state.last_interaction_ms, dev_safe,
        torch.where(found, ts_ms, INT32_MIN), "amax")
    # every in-bounds row writes PRESENT; PRESENT is the least presence
    # value, so a scatter-min of it gives the same state with a defined
    # winner for duplicate devices
    presence = scatter_reduce_drop(
        state.presence, dev_safe,
        torch.full_like(dev_safe, int(PresenceState.PRESENT)), "amin")
    et_safe = etype.clamp(0, NUM_EVENT_TYPES - 1)
    count_idx = torch.where(found, dev_safe * NUM_EVENT_TYPES + et_safe,
                            n * NUM_EVENT_TYPES)
    counts = scatter_reduce_drop(state.event_counts.reshape(-1), count_idx,
                                 found.to(torch.int32), "sum")

    return DeviceStateStore(
        last_interaction_ms=last_inter,
        presence=presence,
        meas_last=meas_last,
        meas_last_ms=meas_last_ms,
        recent_meas=rm_vals,
        recent_meas_mask=rm_mask,
        recent_meas_ms=rm_ts,
        recent_meas_valid=rm_valid,
        recent_loc=rl_vals,
        recent_loc_ms=rl_ts,
        recent_loc_valid=rl_valid,
        recent_alert_level=ra_level,
        recent_alert_type=ra_type,
        recent_alert_ms=ra_ts,
        recent_alert_valid=ra_valid,
        event_counts=counts.reshape(n, NUM_EVENT_TYPES),
    )


def presence_sweep(
    state: DeviceStateStore,
    device_active: torch.Tensor,        # bool[N] registered devices
    now_ms: torch.Tensor,               # int32[]
    missing_interval_ms: torch.Tensor,  # int32[]
) -> tuple[DeviceStateStore, torch.Tensor]:
    """Mark devices presence-MISSING when their last interaction is older
    than ``now_ms - missing_interval_ms`` (int32 arithmetic, as in the JAX
    op). Returns (state, newly_missing mask) so the host can notify once
    per transition."""
    seen = state.last_interaction_ms > INT32_MIN
    stale = seen & (state.last_interaction_ms < now_ms - missing_interval_ms)
    was_present = state.presence == int(PresenceState.PRESENT)
    newly_missing = device_active & stale & was_present
    presence = torch.where(device_active & stale,
                           torch.tensor(int(PresenceState.MISSING),
                                        dtype=torch.int32,
                                        device=state.presence.device),
                           state.presence)
    return dataclasses.replace(state, presence=presence), newly_missing
