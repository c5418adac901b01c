"""Rank-count elasticity from snapshots + archives, not WAL replay.

The plain ``reshard_cluster`` replayed every old rank's FULL WAL through
the new partitioner — O(all events ever), and it refused pruned WALs even
though pruning after a snapshot is a supported operation and long history
is supposed to live in the archive tier. The
reference's history lives in topology-agnostic storage that survives any
scaling event (InfluxDbDeviceEventManagement.java:63-161); this module is
that property for the cluster:

    new rank state   = re-partitioned old SNAPSHOTS     (O(live state))
    new rank archive = row-copied old ARCHIVES + rows
                       evicted during the re-pack       (no re-decode)
    + per-old-rank WAL TAILS replayed through the live
      new cluster (:func:`replay_wal_tails`)            (O(tail))

Ownership moves from ``token-hash % n_old`` to ``token-hash % n_new``:
every device, its registry/aggregate rows, its ring events, and its
archived history land at the new owner. Unlike the intra-engine
``reshard_snapshot`` (one shared interner space), ranks have PRIVATE
interner spaces — so every id-bearing column (tenant, device type, area,
customer, asset, alert type, alternate/originating event ids) is remapped
through STRING-level union tables built from the old manifests, and
measurement lanes are permuted per old rank into the union channel map.

Operate it like a topology change: drain, snapshot every rank, run
``migrate_cluster_snapshots``, start the new ranks from the produced
snapshot dirs (``run_rank(snapshot_dir=...)`` with fresh WALs), then
``replay_wal_tails`` the old post-snapshot WAL tails through the live
cluster. Pruned WALs are fine — snapshot + archive carry everything the
pruned span held.

Since live placement exists, this OFFLINE path is the DISASTER-RECOVERY
route, not the day-to-day one: live rank join/drain and tenant rebalancing run
through ``parallel/placement.py`` (epoch-fenced online handoff, zero
downtime). Reach for this module when the slot space itself must change
(``slots_per_rank`` regrets), when WALs were pruned past what an online
move may replay, or when the cluster is down anyway.
"""

from __future__ import annotations

import json
import logging
import pathlib
import types

import numpy as np

logger = logging.getLogger(__name__)

from sitewhere_tpu_torch.core.types import NULL_ID, EventType
from sitewhere_tpu_torch.parallel.cluster import owner_rank
from sitewhere_tpu_torch.parallel.reshard import _fill_like, _load

# interner-backed manifest lists shared by every target (string union)
_UNION_KINDS = ("tenants", "device_types", "alert_types", "areas",
                "customers", "assets", "event_ids", "channel_names")

# device_state leaves whose LAST axis is the channel-lane axis (recent_*
# slot axes are small ints too — identify lanes by NAME, never by shape)
_LANE_LEAVES = (".device_state.meas_last", ".device_state.meas_last_ms",
                ".device_state.recent_meas", ".device_state.recent_meas_mask")


def _remap(vals: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Translate interner-id VALUES through ``table``; NULL/out-of-range
    pass through as NULL."""
    v = vals.astype(np.int64)
    out = np.full(v.shape, NULL_ID, np.int64)
    ok = (v != NULL_ID) & (v >= 0) & (v < len(table))
    out[ok] = table[v[ok]]
    return out


def _permute_lanes(arr: np.ndarray, src: np.ndarray, dst: np.ndarray,
                   fill) -> np.ndarray:
    """Move channel-lane data (last axis) from old lanes to new lanes;
    unmapped lanes take the leaf's empty-row fill (INT32_MIN for ms
    lanes — a 0 would read as a live sample at the epoch base)."""
    out = np.full(arr.shape, fill, arr.dtype)
    if len(src):
        out[..., dst] = arr[..., src]
    return out


class _Maps:
    """Every remap table for ONE old rank."""

    def __init__(self):
        self.interner: dict[str, np.ndarray] = {}
        self.lane_src = np.zeros(0, np.int64)
        self.lane_dst = np.zeros(0, np.int64)
        # old (shard, local) -> target rank / new local / new shard
        self.dev_target: np.ndarray | None = None
        self.dev_new_local: np.ndarray | None = None
        self.dev_new_shard: np.ndarray | None = None
        self.asg_new_local: np.ndarray | None = None

    def remap_aux(self, aux: np.ndarray, etype: np.ndarray) -> np.ndarray:
        """aux lane semantics depend on the row's event type: lane 0 is an
        alert-type id for ALERT rows, an event-id-interner id for
        COMMAND_RESPONSE / STATE_CHANGE rows, and a raw invocation id for
        COMMAND_INVOCATION rows (passes through); lane 1 is always an
        alternate-id (event-id interner) when set."""
        out = aux.astype(np.int64).copy()
        et = etype.astype(np.int64)
        alert = et == int(EventType.ALERT)
        evid = ((et == int(EventType.COMMAND_RESPONSE))
                | (et == int(EventType.STATE_CHANGE)))
        out[alert, 0] = _remap(aux[alert, 0], self.interner["alert_types"])
        out[evid, 0] = _remap(aux[evid, 0], self.interner["event_ids"])
        out[:, 1] = _remap(aux[:, 1], self.interner["event_ids"])
        return out

    def remap_store_cols(self, cols: dict, so: int,
                         target: int) -> "tuple[dict | None, int]":
        """Remap one batch of ring/archive rows from old shard ``so``;
        returns (rows owned by ``target`` plus a ``__shard__`` column —
        or None when none land here, count of rows whose DEVICE no
        longer maps anywhere). The unmapped count is target-independent;
        callers tally it exactly once (target 0's pass)."""
        devs = cols[".store.device"].astype(np.int64)
        n_cap = self.dev_target.shape[1]
        ok = (devs != NULL_ID) & (devs >= 0) & (devs < n_cap)
        mapped = np.zeros(devs.shape, bool)
        mapped[ok] = self.dev_target[so, devs[ok]] != NULL_ID
        unmapped = int(np.sum(~mapped))
        here = np.zeros(devs.shape, bool)
        here[ok] = self.dev_target[so, devs[ok]] == target
        if not np.any(here):
            return None, unmapped
        sub = {k: v[here] for k, v in cols.items()}
        devs = devs[here]
        sub["__shard__"] = self.dev_new_shard[so, devs]
        sub[".store.device"] = self.dev_new_local[so, devs]
        asgs = sub[".store.assignment"].astype(np.int64)
        g_cap = self.asg_new_local.shape[1]
        oka = (asgs != NULL_ID) & (asgs >= 0) & (asgs < g_cap)
        new_a = np.full_like(asgs, NULL_ID)
        new_a[oka] = self.asg_new_local[so, asgs[oka]]
        sub[".store.assignment"] = new_a
        sub[".store.tenant"] = _remap(sub[".store.tenant"],
                                      self.interner["tenants"])
        sub[".store.area"] = _remap(sub[".store.area"],
                                    self.interner["areas"])
        sub[".store.customer"] = _remap(sub[".store.customer"],
                                        self.interner["customers"])
        sub[".store.asset"] = _remap(sub[".store.asset"],
                                     self.interner["assets"])
        sub[".store.aux"] = self.remap_aux(sub[".store.aux"],
                                           sub[".store.etype"])
        # LOCATION rows use values[0:3] positionally (lat/lon/elev), not
        # channel lanes — permute only the measurement rows
        et = sub[".store.etype"].astype(np.int64)
        is_meas = et == int(EventType.MEASUREMENT)
        for k, fill in ((".store.values", 0.0), (".store.vmask", False)):
            permuted = _permute_lanes(sub[k], self.lane_src,
                                      self.lane_dst, fill)
            sub[k] = np.where(is_meas[:, None], permuted, sub[k])
        return sub, unmapped


def migrate_cluster_snapshots(old_snap_dirs, n_ranks_new: int, out_root,
                              old_archive_dirs=None) -> dict:
    """Re-partition a cluster's snapshots (+ archives) for a NEW rank
    count. Writes ``out_root/rank-N/snapshot`` (+ ``archive``) per new
    rank; returns per-target stats."""
    out_root = pathlib.Path(out_root)
    olds = [_load(pathlib.Path(d)) for d in old_snap_dirs]
    r_old = len(olds)
    r_new = int(n_ranks_new)
    if old_archive_dirs is not None and len(old_archive_dirs) != r_old:
        raise ValueError("one archive dir per old rank")
    cfg = dict(olds[0][0]["config"])
    base = olds[0][0]["epoch_base_unix_s"]
    for host, _ in olds[1:]:
        strip = ("wal_dir", "archive_dir")
        if {k: v for k, v in host["config"].items() if k not in strip} != \
           {k: v for k, v in cfg.items() if k not in strip}:
            raise ValueError("old ranks carry heterogeneous engine configs")
        if abs(host["epoch_base_unix_s"] - base) > 1e-3:
            raise ValueError("old ranks disagree on the epoch base — "
                             "their timestamps live in different domains")
    s_sh = olds[0][0]["n_shards"]
    n_cap = cfg["device_capacity_per_shard"]
    g_cap = cfg["assignment_capacity_per_shard"]
    c_cap = cfg["store_capacity_per_shard"]
    t_cap = cfg["token_capacity_per_shard"]
    channels = cfg["channels"]

    # ---- string-union interner tables (identical on every target) -----
    union: dict[str, list[str]] = {k: [] for k in _UNION_KINDS}
    union_idx: dict[str, dict[str, int]] = {k: {} for k in _UNION_KINDS}
    maps = [_Maps() for _ in range(r_old)]
    for kind in _UNION_KINDS:
        for o, (host, _) in enumerate(olds):
            table = np.full(len(host[kind]), NULL_ID, np.int64)
            for i, s in enumerate(host[kind]):
                j = union_idx[kind].get(s)
                if j is None:
                    j = union_idx[kind][s] = len(union[kind])
                    union[kind].append(s)
                table[i] = j
            maps[o].interner[kind] = table
    # channel-lane permutation per old rank: lane = interner id % channels
    # on both sides; when old lanes collided, the FIRST claimant owns the
    # lane's data (the live engine has the same ambiguity)
    for o, (host, _) in enumerate(olds):
        seen: set[int] = set()
        src, dst = [], []
        for i, name in enumerate(host["channel_names"]):
            lane_o = i % channels
            if lane_o in seen:
                continue
            seen.add(lane_o)
            src.append(lane_o)
            dst.append(union_idx["channel_names"][name] % channels)
        maps[o].lane_src = np.asarray(src, np.int64)
        maps[o].lane_dst = np.asarray(dst, np.int64)

    # ---- token / device / assignment allocation ------------------------
    tokens_new: list[list[str]] = [[] for _ in range(r_new)]
    tok_gid_new: list[dict[str, int]] = [{} for _ in range(r_new)]
    next_dev = np.zeros((r_new, s_sh), np.int64)
    next_asg = np.zeros((r_new, s_sh), np.int64)
    token_device_new: list[dict[str, int]] = [{} for _ in range(r_new)]
    devices_new: list[dict] = [{} for _ in range(r_new)]
    assignments_new: list[dict] = [{} for _ in range(r_new)]
    device_slots_new: list[dict] = [{} for _ in range(r_new)]
    parents_dropped = 0
    for o, (host, _) in enumerate(olds):
        m = maps[o]
        m.dev_target = np.full((s_sh, n_cap), NULL_ID, np.int64)
        m.dev_new_local = np.full((s_sh, n_cap), NULL_ID, np.int64)
        m.dev_new_shard = np.full((s_sh, n_cap), NULL_ID, np.int64)
        m.asg_new_local = np.full((s_sh, g_cap), NULL_ID, np.int64)
        gid_target: dict[int, tuple[int, int]] = {}
        for gid, token in enumerate(host["tokens"]):
            t = owner_rank(token, r_new)
            new_gid = len(tokens_new[t])
            if new_gid >= s_sh * t_cap:
                raise ValueError(f"target rank {t} exceeds token "
                                 f"capacity {s_sh * t_cap}")
            tokens_new[t].append(token)
            tok_gid_new[t][token] = new_gid
            gid_target[gid] = (t, new_gid)
        gdid_map: dict[int, tuple[int, int]] = {}
        for gid_str, old_gdid in sorted(host["token_device"].items(),
                                        key=lambda kv: kv[1]):
            gid = int(gid_str)
            t, new_gid = gid_target[gid]
            sn = new_gid % s_sh
            dn = int(next_dev[t, sn])
            if dn >= n_cap:
                raise ValueError(f"target rank {t} shard {sn} exceeds "
                                 f"device capacity {n_cap}")
            next_dev[t, sn] += 1
            so, do = old_gdid % s_sh, old_gdid // s_sh
            m.dev_target[so, do] = t
            m.dev_new_local[so, do] = dn
            m.dev_new_shard[so, do] = sn
            new_gdid = dn * s_sh + sn
            gdid_map[old_gdid] = (t, new_gdid)
            token_device_new[t][str(new_gid)] = new_gdid
            info = host["devices"].get(str(old_gdid))
            if info is not None:
                devices_new[t][str(new_gdid)] = info
        gaid_map: dict[int, tuple[int, int]] = {}
        for gaid_str in sorted(host["assignments"], key=int):
            gaid = int(gaid_str)
            info = dict(host["assignments"][gaid_str])
            so, ao = gaid % s_sh, gaid // s_sh
            tok = info["device_token"]
            t = owner_rank(tok, r_new)
            new_gid = tok_gid_new[t].get(tok)
            if new_gid is None or str(new_gid) not in token_device_new[t]:
                continue   # device gone: drop the assignment
            sn = new_gid % s_sh
            an = int(next_asg[t, sn])
            if an >= g_cap:
                raise ValueError(f"target rank {t} shard {sn} exceeds "
                                 f"assignment capacity {g_cap}")
            next_asg[t, sn] += 1
            m.asg_new_local[so, ao] = an
            new_gaid = an * s_sh + sn
            gaid_map[gaid] = (t, new_gaid)
            info["id"] = new_gaid
            assignments_new[t][str(new_gaid)] = info
        for k, slots in host["device_slots"].items():
            mapped = gdid_map.get(int(k))
            if mapped is None:
                continue
            t, new_gdid = mapped
            device_slots_new[t][str(new_gdid)] = [
                gaid_map[a][1] if (a != NULL_ID and a in gaid_map
                                   and gaid_map[a][0] == t) else NULL_ID
                for a in slots]

    # ---- per-target assembly -------------------------------------------
    stats: dict = {"targets": []}
    ring_unmapped = 0
    n_arenas = olds[0][1][".store.cursor"].shape[-1]
    acap = c_cap // n_arenas
    data0 = olds[0][1]
    store_keys = [k for k in data0 if k.startswith(".store.")
                  and k not in (".store.cursor", ".store.epoch")]

    for t in range(r_new):
        snap_dir = out_root / f"rank-{t}" / "snapshot"
        snap_dir.mkdir(parents=True, exist_ok=True)
        arch_dir = out_root / f"rank-{t}" / "archive"
        out: dict[str, np.ndarray] = {}

        # ---- registry + device_state + token map ---------------------
        for key, arr0 in data0.items():
            if key in (".next_device", ".next_assignment") or \
               key.startswith(".metrics.") or key.startswith(".store."):
                continue
            if key.endswith("token_to_device"):
                new = np.full((s_sh, t_cap), NULL_ID, arr0.dtype)
                for gid_str, new_gdid in token_device_new[t].items():
                    gid = int(gid_str)
                    new[gid % s_sh, gid // s_sh] = new_gdid // s_sh
                out[key] = new
                continue
            fill = (False if arr0.dtype == np.bool_
                    else _fill_like(key, arr0))
            new = np.full((s_sh,) + arr0.shape[1:], fill, arr0.dtype)
            for o, (host, data) in enumerate(olds):
                m = maps[o]
                arr = data[key]
                if key.startswith(".registry.device") or \
                        key.startswith(".device_state."):
                    so, do = np.nonzero(m.dev_target == t)
                    if not len(so):
                        continue
                    sn = m.dev_new_shard[so, do]
                    dn = m.dev_new_local[so, do]
                    vals, dropped_p = _remap_device_column(
                        key, arr[so, do], so, do, m, t)
                    parents_dropped += dropped_p
                    new[sn, dn] = vals.astype(arr.dtype)
                elif key.startswith(".registry.assignment"):
                    so, ao = np.nonzero(m.asg_new_local != NULL_ID)
                    if not len(so):
                        continue
                    devs = data[".registry.assignment_device"][so, ao]\
                        .astype(np.int64)
                    okd = (devs != NULL_ID) & (devs >= 0) & (devs < n_cap)
                    here = np.zeros(len(so), bool)
                    here[okd] = m.dev_target[so[okd], devs[okd]] == t
                    so, ao, devs = so[here], ao[here], devs[here]
                    if not len(so):
                        continue
                    an = m.asg_new_local[so, ao]
                    sn = m.dev_new_shard[so, devs]
                    vals = arr[so, ao]
                    if key.endswith("assignment_device"):
                        vals = m.dev_new_local[so, devs]
                    elif key.endswith("assignment_area"):
                        vals = _remap(vals, m.interner["areas"])
                    elif key.endswith("assignment_customer"):
                        vals = _remap(vals, m.interner["customers"])
                    elif key.endswith("assignment_asset"):
                        vals = _remap(vals, m.interner["assets"])
                    new[sn, an] = vals.astype(arr.dtype)
                else:
                    raise ValueError(f"unhandled snapshot leaf {key!r}")
            out[key] = new

        # ---- ring rows: remap, merge by event time, re-pack ----------
        chunks: list[dict] = []
        for o, (host, data) in enumerate(olds):
            m = maps[o]
            for so in range(s_sh):
                for a in range(n_arenas):
                    cursor = int(data[".store.cursor"][so][a])
                    epoch = int(data[".store.epoch"][so][a])
                    local = (np.concatenate([np.arange(cursor, acap),
                                             np.arange(cursor)])
                             if epoch > 0 else np.arange(cursor))
                    order = a * acap + local
                    order = order[data[".store.valid"][so][order]]
                    if not len(order):
                        continue
                    cols = {k: data[k][so][order] for k in store_keys}
                    sub, unm = m.remap_store_cols(cols, so, t)
                    if t == 0:      # target-independent; count once
                        ring_unmapped += unm
                    if sub is not None:
                        chunks.append(sub)
        merged = None
        if chunks:
            merged = {k: np.concatenate([c[k] for c in chunks])
                      for k in chunks[0]}
            # event-time order decides ring priority on overflow (oldest
            # drop to the archive) — cross-source append order has no
            # global meaning, timestamps do
            order = np.argsort(merged[".store.ts_ms"].astype(np.int64),
                               kind="stable")
            merged = {k: v[order] for k, v in merged.items()}

        new_cursor = np.zeros((s_sh, n_arenas), np.int32)
        new_epoch = np.zeros((s_sh, n_arenas), np.int32)
        for k in store_keys:
            out[k] = np.zeros((s_sh,) + data0[k].shape[1:],
                              data0[k].dtype)
            if k in (".store.device", ".store.assignment",
                     ".store.tenant", ".store.area", ".store.customer",
                     ".store.asset", ".store.aux"):
                out[k][:] = NULL_ID
        dropped: dict[tuple[int, int], dict] = {}
        kept_rows: dict[tuple[int, int], dict] = {}
        if merged is not None:
            shards = merged.pop("__shard__")
            tenants = merged[".store.tenant"].astype(np.int64)
            arena_col = np.where(tenants >= 0, tenants % n_arenas, 0)
            for sn in range(s_sh):
                for a in range(n_arenas):
                    sel = (shards == sn) & (arena_col == a)
                    n = int(sel.sum())
                    if not n:
                        continue
                    sub = {k: v[sel] for k, v in merged.items()}
                    if n > acap:
                        dropped[(sn, a)] = {k: v[:n - acap]
                                            for k, v in sub.items()}
                        sub = {k: v[n - acap:] for k, v in sub.items()}
                        n = acap
                    kept_rows[(sn, a)] = sub
                    for k in store_keys:
                        out[k][sn, a * acap:a * acap + n] = sub[k]
                    new_cursor[sn, a] = n % acap
                    new_epoch[sn, a] = n // acap

        # ---- archive row-copy ----------------------------------------
        arch_stats = None
        if old_archive_dirs is not None:
            n_kept = {(sn, a): int(new_epoch[sn, a]) * acap
                      + int(new_cursor[sn, a])
                      for sn in range(s_sh) for a in range(n_arenas)}
            arch_stats = _migrate_cluster_archive(
                olds, maps, old_archive_dirs, arch_dir, target=t,
                s_sh=s_sh, n_arenas=n_arenas, acap=acap,
                dropped=dropped, kept_rows=kept_rows, n_kept=n_kept)
            for (sn, a), bump in arch_stats["epoch_bump"].items():
                new_epoch[sn, a] += bump
        out[".store.cursor"] = new_cursor
        out[".store.epoch"] = new_epoch

        # ---- counters + manifests ------------------------------------
        out[".next_device"] = next_dev[t].astype(
            data0[".next_device"].dtype)
        out[".next_assignment"] = next_asg[t].astype(
            data0[".next_assignment"].dtype)
        for key in data0:
            if key.startswith(".metrics."):
                # shard-axis fold only: the per-tenant counter grid keeps
                # its trailing [T, C] shape
                new = np.zeros((s_sh,) + data0[key].shape[1:],
                               data0[key].dtype)
                if t == 0:   # global totals, exact, attributed once
                    new[0] = sum(d[key].sum(axis=0) for _, d in olds)
                out[key] = new
        np.savez_compressed(snap_dir / "sharded_state.npz", **out)

        sharded_manifest = json.loads(
            (pathlib.Path(old_snap_dirs[0]) /
             "sharded_manifest.json").read_text())
        sharded_manifest["n_shards"] = s_sh
        (snap_dir / "sharded_manifest.json").write_text(
            json.dumps(sharded_manifest))

        host_new = {
            "format": 1,
            "config": dict(cfg, n_shards=s_sh, wal_dir=None,
                           archive_dir=(str(arch_dir)
                                        if old_archive_dirs is not None
                                        else None)),
            "n_shards": s_sh,
            "epoch_base_unix_s": base,
            "store_cursor": int((new_epoch.astype(np.int64) * acap
                                 + new_cursor).sum()),
            "next_device": [int(x) for x in next_dev[t]],
            "next_assignment": [int(x) for x in next_asg[t]],
            "tokens": tokens_new[t],
            "token_device": token_device_new[t],
            "devices": devices_new[t],
            "assignments": assignments_new[t],
            "device_slots": device_slots_new[t],
            # union interners: identical tables on every target keep the
            # remapped columns valid everywhere
            **{k: union[k] for k in _UNION_KINDS},
            # dead letters are rank-local diagnostics; they ride with
            # target 0 (duplicating them would double-count)
            "dead_letters": (sum((h["dead_letters"] for h, _ in olds),
                                 [])[-4096:] if t == 0 else []),
        }
        (snap_dir / "host_distributed.json").write_text(
            json.dumps(host_new))
        tstat = {"rank": t, "snapshot": str(snap_dir),
                 "devices": len(devices_new[t]),
                 "ring_rows": int(sum(
                     v[".store.ts_ms"].shape[0]
                     for v in kept_rows.values()))}
        if arch_stats is not None:
            tstat.update(archive=str(arch_dir),
                         archive_rows=arch_stats["migrated_rows"],
                         preserved_overflow_rows=arch_stats[
                             "preserved_overflow_rows"],
                         dropped_unmapped_rows=arch_stats[
                             "dropped_unmapped_rows"])
        stats["targets"].append(tstat)
    stats["cross_target_parents_dropped"] = parents_dropped
    stats["ring_unmapped_rows"] = ring_unmapped
    return stats


def _remap_device_column(key: str, vals: np.ndarray, so: np.ndarray,
                         do: np.ndarray, m: _Maps,
                         target: int) -> tuple[np.ndarray, int]:
    """Remap one gathered device-indexed column; returns (values,
    parents_dropped)."""
    if key.endswith("device_tenant"):
        return _remap(vals, m.interner["tenants"]), 0
    if key.endswith(".registry.device_type"):
        return _remap(vals, m.interner["device_types"]), 0
    if key.endswith("device_area"):
        return _remap(vals, m.interner["areas"]), 0
    if key.endswith("device_customer"):
        return _remap(vals, m.interner["customers"]), 0
    if key.endswith("recent_alert_type"):
        return _remap(vals, m.interner["alert_types"]), 0
    if key.endswith("device_assignments"):
        v = vals.astype(np.int64)
        out = np.full_like(v, NULL_ID)
        ok = (v != NULL_ID) & (v >= 0) & (v < m.asg_new_local.shape[1])
        sh = np.broadcast_to(so.reshape((-1, 1)), v.shape)
        out[ok] = m.asg_new_local[sh[ok], v[ok]]
        return out, 0
    if key.endswith("device_parent"):
        # the parent column is shard-local: it survives only when the
        # parent lands on the SAME target and SAME new shard as the child
        v = vals.astype(np.int64)
        out = np.full_like(v, NULL_ID)
        ok = (v != NULL_ID) & (v >= 0) & (v < m.dev_target.shape[1])
        child_shard = m.dev_new_shard[so, do]
        keep = np.zeros_like(ok)
        keep[ok] = ((m.dev_target[so[ok], v[ok]] == target)
                    & (m.dev_new_shard[so[ok], v[ok]] == child_shard[ok]))
        out[keep] = m.dev_new_local[so[keep], v[keep]]
        return out, int(np.sum(ok & ~keep))
    if key in _LANE_LEAVES:
        fill = (False if vals.dtype == np.bool_ else _fill_like(key, vals))
        return _permute_lanes(vals, m.lane_src, m.lane_dst, fill), 0
    return vals, 0


def _migrate_cluster_archive(olds, maps, old_archive_dirs, arch_dst,
                             *, target: int, s_sh: int, n_arenas: int,
                             acap: int, dropped: dict, kept_rows: dict,
                             n_kept: dict) -> dict:
    """Row-copy one target's share of every old rank's archive (plus the
    re-pack's overflow-dropped rows, plus an eager spill of the kept ring
    rows) into a fresh archive at ``arch_dst`` — the cross-rank analog of
    reshard._migrate_archive, with interner/lane remapping per source.
    Position order per new partition: archived history (old-rank-major,
    old write order), then overflow rows, then the epoch-bumped kept
    rows; gaps are registered so replay never counts phantom loss."""
    from sitewhere_tpu_torch.utils.archive import (_COLUMNS, EventArchive,
                                             mesh_topology)

    arch = EventArchive(pathlib.Path(arch_dst),
                        segment_rows=max(1, acap // 4),
                        topology=mesh_topology(s_sh, n_arenas))
    if arch.total_rows():
        raise ValueError(f"archive destination {arch_dst} is not empty")

    writers: dict[int, list] = {}
    next_pos: dict[int, int] = {}

    def emit(part: int, cols: dict) -> None:
        """Append remapped rows (store-key naming) to a partition,
        flushing full segments. Chunks are normalized (no __shard__,
        always a valid column) so cross-source concatenation is safe."""
        cols = {k: v for k, v in cols.items() if k != "__shard__"}
        n = int(cols[".store.ts_ms"].shape[0])
        if not n:
            return
        cols.setdefault(".store.valid", np.ones(n, bool))
        writers.setdefault(part, []).append(cols)
        pending = sum(int(c[".store.ts_ms"].shape[0])
                      for c in writers[part])
        while pending >= arch.segment_rows:
            pending = _flush(part, arch.segment_rows)

    def _flush(part: int, n: int) -> int:
        mergedc = {k: np.concatenate([c[k] for c in writers[part]])
                   for k in writers[part][0]}
        plain = {k.split(".")[-1]: v for k, v in mergedc.items()}
        arch.append_segment(part, next_pos.get(part, 0),
                            types.SimpleNamespace(
                                **{c: plain[c][:n] for c in _COLUMNS}))
        next_pos[part] = next_pos.get(part, 0) + n
        rest = {k: v[n:] for k, v in mergedc.items()}
        writers[part] = ([rest]
                         if rest[".store.ts_ms"].shape[0] else [])
        return sum(int(c[".store.ts_ms"].shape[0])
                   for c in writers[part])

    migrated = unmapped = 0
    for o, (host, data) in enumerate(olds):
        if old_archive_dirs[o] is None:
            continue
        src = pathlib.Path(old_archive_dirs[o])
        m = maps[o]
        old_cursor = np.asarray(data[".store.cursor"], np.int64)
        old_epoch = np.asarray(data[".store.epoch"], np.int64)
        from sitewhere_tpu_torch.utils.archive import _COLUMNS as AC
        for f in sorted(src.glob("seg-*.npz")):
            with np.load(f) as z:
                part, start = int(z["part"]), int(z["start"])
                so, a_old = part // n_arenas, part % n_arenas
                head = int(old_epoch[so, a_old] * acap
                           + old_cursor[so, a_old])
                boundary = max(0, head - acap)
                cols = {c: np.asarray(z[c]) for c in AC}
            n = cols["ts_ms"].shape[0]
            pos = start + np.arange(n)
            # rows at/above the boundary live in the (migrated) ring —
            # skipping them here keeps the two tiers non-overlapping
            keep = cols["valid"].astype(bool) & (pos < boundary)
            if not np.any(keep):
                continue
            sk = {f".store.{c}": cols[c][keep] for c in AC
                  if c != "valid"}
            sub, unm = m.remap_store_cols(sk, so, target)
            if target == 0:     # target-independent; count once
                unmapped += unm
            if sub is None:
                continue
            migrated += int(sub[".store.ts_ms"].shape[0])
            tenants = sub[".store.tenant"].astype(np.int64)
            arena_new = np.where(tenants >= 0, tenants % n_arenas, 0)
            parts_new = sub["__shard__"] * n_arenas + arena_new
            for p in np.unique(parts_new):
                sel = parts_new == p
                emit(int(p), {k: v[sel] for k, v in sub.items()})

    # re-pack overflow rows follow the archived history
    preserved = 0
    for (sn, a), cols in dropped.items():
        preserved += int(cols[".store.ts_ms"].shape[0])
        emit(sn * n_arenas + a, dict(cols))

    # seal history, compute epoch bumps, eager-spill the kept ring rows
    epoch_bump: dict[tuple[int, int], int] = {}
    all_parts = set(writers) | {sn * n_arenas + a
                                for sn, a in kept_rows}
    for p in sorted(all_parts):
        pending = sum(int(c[".store.ts_ms"].shape[0])
                      for c in writers.get(p, []))
        if pending:
            _flush(p, pending)
        h = next_pos.get(p, 0)
        key = (p // n_arenas, p % n_arenas)
        kept = n_kept.get(key, 0)
        # the ring+archive query merge caps archive reads at head - acap
        # = bump*acap + kept - acap; the bump lifts that cap past H so
        # the migrated tail stays visible even with a part-full ring
        bump = -(-(h + acap - kept) // acap) if h else 0
        epoch_bump[key] = bump
        arch.register_gap(p, h, bump * acap)
        ring = kept_rows.get(key)
        if ring is not None and kept:
            plain = {k.split(".")[-1]: v for k, v in ring.items()}
            plain["valid"] = np.ones(kept, bool)
            from sitewhere_tpu_torch.utils.archive import _COLUMNS as AC
            pos = 0
            while pos < kept:
                n = min(arch.segment_rows, kept - pos)
                arch.append_segment(
                    p, bump * acap + pos, types.SimpleNamespace(
                        **{c: plain[c][pos:pos + n] for c in AC}))
                pos += n
        else:
            arch._spilled[p] = bump * acap
    arch._save_index()
    return {"migrated_rows": migrated,
            "preserved_overflow_rows": preserved,
            "dropped_unmapped_rows": unmapped,
            "epoch_bump": epoch_bump}


def replay_wal_tails(cluster, old_snap_dirs, old_wal_dirs) -> int:
    """Replay each old rank's POST-SNAPSHOT WAL tail through the live
    (already migrated) cluster — the O(tail) finishing step. Unlike
    ``replay_wal_through``, a pruned WAL is fine here: everything at or
    below the snapshot watermark is already carried by the migrated
    snapshot + archive, so only records past the watermark replay (and a
    pruned-away span below it was, by definition, snapshot-covered).

    Fails LOUDLY BUT GRACEFULLY on bad inputs: every (snapshot, WAL)
    pair is validated BEFORE the first record replays, so a missing
    snapshot manifest or a missing/unreadable WAL directory raises with
    nothing applied — never mid-loop with earlier ranks' tails already
    in the new cluster (a half-applied migration the operator cannot
    safely re-run). A WAL directory that EXISTS but holds no segments
    (pruned to nothing after the snapshot — a supported state) is a
    zero-record tail: it logs a warning and replays nothing."""
    from sitewhere_tpu_torch.utils.checkpoint import replay_records
    from sitewhere_tpu_torch.utils.ingestlog import IngestLog

    # materialize ONCE: generator arguments must not be exhausted by the
    # length check (a silently-empty zip afterwards would be exactly the
    # dropped-tail failure this validation exists to prevent)
    old_snap_dirs = list(old_snap_dirs)
    old_wal_dirs = list(old_wal_dirs)
    if len(old_snap_dirs) != len(old_wal_dirs):
        raise ValueError(
            f"{len(old_snap_dirs)} snapshot dirs vs "
            f"{len(old_wal_dirs)} WAL dirs — one WAL tail per "
            "old rank")
    # validate EVERYTHING up front: a failure here strands nothing
    pairs = []
    for i, (snap_dir, wal_dir) in enumerate(zip(old_snap_dirs,
                                                old_wal_dirs)):
        manifest = pathlib.Path(snap_dir) / "host_distributed.json"
        try:
            host = json.loads(manifest.read_text())
        except OSError as e:
            raise ValueError(
                f"old rank {i}: snapshot manifest {manifest} "
                f"unreadable ({e}) — nothing was replayed") from e
        if wal_dir is None:
            raise ValueError(
                f"old rank {i}: WAL dir is None — pass the rank's WAL "
                "directory (an empty one is fine; a missing one is "
                "not). Nothing was replayed")
        wpath = pathlib.Path(wal_dir)
        if not wpath.is_dir():
            raise ValueError(
                f"old rank {i}: WAL dir {wpath} does not exist — a "
                "wrong path here would silently drop the rank's "
                "post-snapshot tail. Nothing was replayed")
        if not sorted(wpath.glob("segment-*.log")):
            logger.warning(
                "old rank %d: WAL dir %s holds no segments (pruned to "
                "nothing after the snapshot) — zero-record tail", i,
                wpath)
        pairs.append((host, wpath))

    total = 0
    for host, wpath in pairs:
        wal = IngestLog(wpath, readonly=True)
        try:
            total += replay_records(wal, cluster.ingest_json_batch,
                                    cluster.ingest_binary_batch,
                                    after_cursor=host["store_cursor"])
        finally:
            wal.close()
    cluster.flush()
    return total
