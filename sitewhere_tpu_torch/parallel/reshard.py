"""Elastic re-sharding: an N-shard snapshot rewritten for M shards (a
numpy-only copy of ``sitewhere_tpu/parallel/reshard.py``; it reads and
writes the snapshot format both packages share).

Every token's owner is a function of its interner id (``gid % n_shards``),
so changing the shard count moves each device, its assignments, its
aggregated state rows and its persisted events to the new owner: host-side
vectorized numpy scatters over the snapshot, no device needed. Restore the
result with ``parallel/distributed.restore_distributed``.

Notes:
  * Per-shard ring stores are re-packed in (old shard, append order); when
    a new shard's merged events exceed its ring capacity the OLDEST drop,
    as a live ring overwrites them.
  * Outbound feed offsets are per-ring positions and do not survive a
    reshard; consumers restart from the rebuilt rings (a consumer-group
    rebalance onto a new partition map).
  * Pair a reshard with a fresh WAL directory: the old WAL's watermark
    refers to the old cursor line and is kept in the host manifest, so
    recovery replays the same tail, but new watermarks must not be
    appended to the old log.
  * This offline route is for disaster recovery (the cluster is down, or
    pruned WALs rule out a replay-based catch-up).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from sitewhere_tpu_torch.core.types import NULL_ID


def _load(src: pathlib.Path) -> tuple[dict, dict]:
    host = json.loads((src / "host_distributed.json").read_text())
    data = dict(np.load(src / "sharded_state.npz"))
    return host, data


def reshard_snapshot(src_dir, dst_dir, n_shards_new: int,
                     archive_dir=None, archive_dst=None) -> dict:
    """Rewrite the snapshot at ``src_dir`` for ``n_shards_new`` shards into
    ``dst_dir``; returns the new host manifest.

    With ``archive_dir``/``archive_dst`` set, the long-term archive
    migrates WITH the topology (event history survives any scaling
    event): every archived row is re-partitioned under the new shard
    count (device →
    new shard via the same id maps as the live state, tenant → arena),
    written to ``archive_dst`` under the new topology stamp, and the new
    rings' epochs are bumped so migrated history occupies absolute
    positions [0, H) BELOW the live ring's positions — ring + archive
    stay non-overlapping, so queries never double-count. Ring rows that
    drop on arena overflow during the reshard are preserved into the
    archive instead of being lost."""
    src, dst = pathlib.Path(src_dir), pathlib.Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    if (archive_dir is None) != (archive_dst is None):
        raise ValueError("archive_dir and archive_dst go together")
    host, data = _load(src)
    s_old = host["n_shards"]
    m = n_shards_new
    cfg = host["config"]
    n_cap = cfg["device_capacity_per_shard"]
    g_cap = cfg["assignment_capacity_per_shard"]
    c_cap = cfg["store_capacity_per_shard"]
    t_cap = cfg["token_capacity_per_shard"]

    tokens: list[str] = host["tokens"]
    token_gid = {t: i for i, t in enumerate(tokens)}
    if len(tokens) > m * t_cap:
        raise ValueError(
            f"{len(tokens)} tokens exceed new global capacity {m * t_cap}")

    # ---- device map: old (shard, local) -> new (shard, local) -------------
    # New locals allocate in old-global-id order per new shard, so the
    # mapping is deterministic and dense.
    next_dev = np.zeros(m, np.int64)
    dev_old_s, dev_old_d, dev_new_s, dev_new_d = [], [], [], []
    dmap = np.full((s_old, n_cap), NULL_ID, np.int64)      # -> new local did
    dshard = np.full((s_old, n_cap), NULL_ID, np.int64)    # -> new shard
    gdid_map: dict[int, int] = {}                          # old gdid -> new
    for gid_str, old_gdid in sorted(host["token_device"].items(),
                                    key=lambda kv: kv[1]):
        gid = int(gid_str)
        so, do = old_gdid % s_old, old_gdid // s_old
        sn = gid % m
        dn = int(next_dev[sn])
        next_dev[sn] += 1
        if dn >= n_cap:
            raise ValueError(
                f"shard {sn} would exceed device capacity {n_cap}")
        dev_old_s.append(so)
        dev_old_d.append(do)
        dev_new_s.append(sn)
        dev_new_d.append(dn)
        dmap[so, do] = dn
        dshard[so, do] = sn
        gdid_map[old_gdid] = dn * m + sn
    dev_old_s = np.asarray(dev_old_s, np.int64)
    dev_old_d = np.asarray(dev_old_d, np.int64)
    dev_new_s = np.asarray(dev_new_s, np.int64)
    dev_new_d = np.asarray(dev_new_d, np.int64)

    # ---- assignment map (assignment shard == its device's new shard) ------
    next_asg = np.zeros(m, np.int64)
    asg_old_s, asg_old_a, asg_new_s, asg_new_a = [], [], [], []
    amap = np.full((s_old, g_cap), NULL_ID, np.int64)
    gaid_map: dict[int, int] = {}
    for gaid_str in sorted(host["assignments"], key=int):
        gaid = int(gaid_str)
        info = host["assignments"][gaid_str]
        so, ao = gaid % s_old, gaid // s_old
        gid = token_gid.get(info["device_token"])
        if gid is None:
            continue
        sn = gid % m
        an = int(next_asg[sn])
        next_asg[sn] += 1
        if an >= g_cap:
            raise ValueError(
                f"shard {sn} would exceed assignment capacity {g_cap}")
        asg_old_s.append(so)
        asg_old_a.append(ao)
        asg_new_s.append(sn)
        asg_new_a.append(an)
        amap[so, ao] = an
        gaid_map[gaid] = an * m + sn
    asg_old_s = np.asarray(asg_old_s, np.int64)
    asg_old_a = np.asarray(asg_old_a, np.int64)
    asg_new_s = np.asarray(asg_new_s, np.int64)
    asg_new_a = np.asarray(asg_new_a, np.int64)

    def remap_values(vals: np.ndarray, old_shard: np.ndarray,
                     table: np.ndarray) -> np.ndarray:
        """Translate shard-local id VALUES (e.g. assignment ids stored in
        device rows) through ``table[old_shard, value]``; NULL passes."""
        ok = vals != NULL_ID
        out = np.full_like(vals, NULL_ID)
        sh = np.broadcast_to(old_shard.reshape((-1,) + (1,) * (vals.ndim - 1)),
                             vals.shape)
        out[ok] = table[sh[ok], vals[ok]]
        return out

    out: dict[str, np.ndarray] = {}

    # ---- registry + device_state leaves -----------------------------------
    old_shard_col = np.arange(s_old)
    for key, arr in data.items():
        if key in (".next_device", ".next_assignment") or \
           key.startswith(".metrics.") or key.startswith(".store."):
            continue
        if key.endswith("token_to_device"):
            new = np.full((m, t_cap), NULL_ID, arr.dtype)
            gids = np.asarray([int(g) for g in host["token_device"]], np.int64)
            if len(gids):
                new_d = np.asarray(
                    [gdid_map[host["token_device"][str(g)]] // m
                     for g in gids], np.int64)
                new[gids % m, gids // m] = new_d.astype(arr.dtype)
            out[key] = new
            continue
        if key.startswith(".registry.device") or key.startswith(".device_state."):
            fill = (np.zeros((), arr.dtype) if arr.dtype == np.bool_
                    else _fill_like(key, arr))
            new = np.full((m,) + arr.shape[1:], fill, arr.dtype)
            vals = arr[dev_old_s, dev_old_d]
            if key.endswith("device_assignments"):
                vals = remap_values(vals.astype(np.int64), dev_old_s,
                                    amap).astype(arr.dtype)
            elif key.endswith("device_parent"):
                # parent column is shard-local; it survives only when the
                # parent moved to the same new shard as the child
                vals = vals.astype(np.int64)
                ok = vals != NULL_ID
                same = np.zeros_like(ok)
                same[ok] = dshard[dev_old_s[ok], vals[ok]] == dev_new_s[ok]
                moved = remap_values(vals, dev_old_s, dmap)
                vals = np.where(ok & same, moved, NULL_ID).astype(arr.dtype)
            new[dev_new_s, dev_new_d] = vals
            out[key] = new
            continue
        if key.startswith(".registry.assignment"):
            fill = _fill_like(key, arr)
            new = np.full((m,) + arr.shape[1:], fill, arr.dtype)
            vals = arr[asg_old_s, asg_old_a]
            if key.endswith("assignment_device"):
                vals = remap_values(vals.astype(np.int64), asg_old_s,
                                    dmap).astype(arr.dtype)
            new[asg_new_s, asg_new_a] = vals
            out[key] = new
            continue
        raise ValueError(f"unhandled snapshot leaf {key!r}")

    # ---- event ring re-pack ----------------------------------------------
    store_keys = [k for k in data if k.startswith(".store.")
                  and k not in (".store.cursor", ".store.epoch")]
    n_arenas = data[".store.cursor"].shape[-1]
    acap = c_cap // n_arenas
    rows_per_new: list[list[dict]] = [[] for _ in range(m)]
    for so in range(s_old):
        # linearize each arena's sub-ring in its own append order
        for a in range(n_arenas):
            cursor = int(data[".store.cursor"][so][a])
            epoch = int(data[".store.epoch"][so][a])
            local = (np.concatenate([np.arange(cursor, acap),
                                     np.arange(cursor)])
                     if epoch > 0 else np.arange(cursor))
            order = a * acap + local
            valid = data[".store.valid"][so][order]
            order = order[valid]
            if not len(order):
                continue
            devs = data[".store.device"][so][order].astype(np.int64)
            new_s = np.where(devs != NULL_ID, dshard[so, devs], NULL_ID)
            cols = {k: data[k][so][order] for k in store_keys}
            cols[".store.device"] = remap_values(devs, np.full_like(devs, so),
                                                 dmap)
            asgs = data[".store.assignment"][so][order].astype(np.int64)
            cols[".store.assignment"] = remap_values(
                asgs, np.full_like(asgs, so), amap)
            for sn in range(m):
                sel = new_s == sn
                if np.any(sel):
                    rows_per_new[sn].append(
                        {k: v[sel] for k, v in cols.items()})
    new_cursor = np.zeros((m, n_arenas), np.int32)
    new_epoch = np.zeros((m, n_arenas), np.int32)
    for k in store_keys:
        out[k] = np.zeros((m,) + data[k].shape[1:], data[k].dtype)
        if k in (".store.device", ".store.assignment", ".store.tenant",
                 ".store.area", ".store.customer", ".store.asset",
                 ".store.aux"):
            out[k][:] = NULL_ID
    # ring rows dropped on arena overflow and ring rows KEPT, per (new
    # shard, arena) — with an archive the dropped rows migrate to disk
    # instead of vanishing, and the kept rows are eagerly spilled so the
    # new archive starts at the live invariant (spilled ≈ head), giving
    # the spooler a full ring of slack before anything can be lost
    dropped: dict[tuple[int, int], dict] = {}
    kept_rows: dict[tuple[int, int], dict] = {}
    for sn in range(m):
        if not rows_per_new[sn]:
            continue
        merged = {k: np.concatenate([c[k] for c in rows_per_new[sn]])
                  for k in store_keys}
        # re-derive each row's arena from its tenant (content-addressed)
        tenants = merged[".store.tenant"].astype(np.int64)
        arenas = np.where(tenants >= 0, tenants % n_arenas, 0)
        for a in range(n_arenas):
            sel = arenas == a
            n = int(sel.sum())
            if not n:
                continue
            sub = {k: v[sel] for k, v in merged.items()}
            if n > acap:                   # arena overflow: oldest drop
                dropped[(sn, a)] = {k: v[:n - acap]
                                    for k, v in sub.items()}
                sub = {k: v[n - acap:] for k, v in sub.items()}
                n = acap
            kept_rows[(sn, a)] = sub
            for k in store_keys:
                out[k][sn, a * acap:a * acap + n] = sub[k]
            new_cursor[sn, a] = n % acap
            new_epoch[sn, a] = n // acap

    archive_stats = None
    if archive_dir is not None:
        n_kept = {(sn, a): int(new_epoch[sn, a]) * acap
                  + int(new_cursor[sn, a])
                  for sn in range(m) for a in range(n_arenas)}
        archive_stats = _migrate_archive(
            pathlib.Path(archive_dir), pathlib.Path(archive_dst), host, data,
            s_old=s_old, m=m, n_arenas=n_arenas, acap=acap,
            dmap=dmap, amap=amap, dshard=dshard, dropped=dropped,
            n_kept=n_kept, kept_rows=kept_rows)
        # bump each new partition's epoch so live ring positions continue
        # ABOVE the migrated history ([0, H) padded so that even a
        # part-full ring's query cap head - acap clears H)
        for (sn, a), bump in archive_stats["epoch_bump"].items():
            new_epoch[sn, a] += bump
    out[".store.cursor"] = new_cursor
    out[".store.epoch"] = new_epoch

    # ---- counters + metrics ----------------------------------------------
    out[".next_device"] = next_dev.astype(data[".next_device"].dtype)
    out[".next_assignment"] = next_asg.astype(data[".next_assignment"].dtype)
    for key in data:
        if key.startswith(".metrics."):
            # per-shard attribution doesn't survive a reshard; keep the
            # global totals exact by folding them onto shard 0 (summing
            # over the shard axis only — the packed per-tenant counter
            # grid keeps its [T, C] shape)
            arr = data[key]
            new = np.zeros((m,) + arr.shape[1:], arr.dtype)
            new[0] = arr.sum(axis=0)
            out[key] = new

    np.savez_compressed(dst / "sharded_state.npz", **out)

    # ---- manifests --------------------------------------------------------
    sharded_manifest = json.loads((src / "sharded_manifest.json").read_text())
    sharded_manifest["n_shards"] = m
    (dst / "sharded_manifest.json").write_text(json.dumps(sharded_manifest))

    host["n_shards"] = m
    # wal_dir is dropped: the resharded engine must NOT append watermarks
    # into the original live WAL (its cursor line no longer matches);
    # attach a fresh WAL explicitly after restore
    # archive_dir: the migrated destination when migrating, else the
    # ORIGINAL dir carries through (restore re-opens it and retires the
    # old-topology files — history parked, fresh spill continues)
    host["config"] = dict(cfg, n_shards=m, wal_dir=None,
                          archive_dir=(str(archive_dst)
                                       if archive_dst is not None
                                       else cfg.get("archive_dir")))
    if archive_stats is not None:
        host["archive_migration"] = {
            "migrated_rows": archive_stats["migrated_rows"],
            "preserved_overflow_rows":
                archive_stats["preserved_overflow_rows"],
            "dropped_unmapped_rows": archive_stats["dropped_unmapped_rows"],
        }
    host["next_device"] = [int(x) for x in next_dev]
    host["next_assignment"] = [int(x) for x in next_asg]
    host["token_device"] = {
        g: gdid_map[old] for g, old in host["token_device"].items()}
    host["devices"] = {
        str(gdid_map[int(k)]): v for k, v in host["devices"].items()
        if int(k) in gdid_map}
    new_assignments = {}
    for k, v in host["assignments"].items():
        if int(k) in gaid_map:
            v = dict(v, id=gaid_map[int(k)])
            new_assignments[str(gaid_map[int(k)])] = v
    host["assignments"] = new_assignments
    host["device_slots"] = {
        str(gdid_map[int(k)]): [gaid_map.get(a, NULL_ID) if a != NULL_ID
                                else NULL_ID for a in v]
        for k, v in host["device_slots"].items() if int(k) in gdid_map}
    (dst / "host_distributed.json").write_text(json.dumps(host))
    return host


def _migrate_archive(archive_src: pathlib.Path, archive_dst: pathlib.Path,
                     host: dict, data: dict, *, s_old: int, m: int,
                     n_arenas: int, acap: int, dmap: np.ndarray,
                     amap: np.ndarray, dshard: np.ndarray,
                     dropped: dict, n_kept: dict, kept_rows: dict) -> dict:
    """Re-partition archived history into the new topology (see
    reshard_snapshot). Sources, in position order per new partition:
    (a) archived rows strictly EVICTED from the old rings (pos <
    old head - acap — the same boundary the live ring+archive query merge
    uses, so ring-window duplicates are skipped); (b) ring rows dropped on
    arena overflow during the reshard; (c) the KEPT ring rows, eagerly
    spilled at their new ring positions so the new archive starts at the
    live invariant (spilled ≈ head). Device/assignment columns are
    rewritten to the new shard-local id spaces; each row's new partition
    is (device's new shard) * arenas + (tenant % arenas). Rows whose
    device no longer maps are dropped and counted. Streaming: one source
    segment in memory at a time, per-partition write buffers bounded at
    one output segment."""
    import types

    from sitewhere_tpu_torch.utils.archive import (_COLUMNS, EventArchive,
                                             mesh_topology)

    old_stamp = mesh_topology(s_old, n_arenas)
    arch = EventArchive(archive_dst, segment_rows=max(1, acap // 4),
                        topology=mesh_topology(m, n_arenas))
    if arch.total_rows():
        raise ValueError(f"archive_dst {archive_dst} is not empty")

    class _PartWriter:
        """Buffers remapped rows for one new partition and flushes full
        output segments — migration memory stays O(segment), never
        O(history)."""

        def __init__(self, part: int):
            self.part = part
            self.next_pos = 0
            self.pending: list[dict] = []
            self.pending_rows = 0

        def add(self, cols: dict) -> None:
            n = int(cols["ts_ms"].shape[0])
            if not n:
                return
            self.pending.append(cols)
            self.pending_rows += n
            while self.pending_rows >= arch.segment_rows:
                self._flush_one(arch.segment_rows)

        def _flush_one(self, n: int) -> None:
            merged = {c: np.concatenate([ch[c] for ch in self.pending])
                      for c in _COLUMNS}
            arch.append_segment(self.part, self.next_pos,
                                types.SimpleNamespace(
                                    **{c: merged[c][:n] for c in _COLUMNS}))
            self.next_pos += n
            rest = {c: merged[c][n:] for c in _COLUMNS}
            self.pending = ([rest] if rest["ts_ms"].shape[0] else [])
            self.pending_rows = int(rest["ts_ms"].shape[0])

        def finish(self) -> int:
            if self.pending_rows:
                self._flush_one(self.pending_rows)
            return self.next_pos

    writers: dict[int, _PartWriter] = {}

    def writer(part: int) -> _PartWriter:
        w = writers.get(part)
        if w is None:
            w = writers[part] = _PartWriter(part)
        return w

    # (a) stream the source segments — the glob sort is (part, start)
    # order, so per-target-partition rows arrive in old write order
    migrated = unmapped = 0
    old_cursor = np.asarray(data[".store.cursor"], np.int64)
    old_epoch = np.asarray(data[".store.epoch"], np.int64)
    for f in sorted(archive_src.glob("seg-*.npz")):
        with np.load(f) as z:
            stamp = (str(z["topology"]) if "topology" in z.files
                     else "") or None
            if stamp is not None and stamp != old_stamp:
                raise ValueError(
                    f"archive segment {f.name} carries topology {stamp!r}, "
                    f"expected {old_stamp!r} — wrong archive directory?")
            part, start = int(z["part"]), int(z["start"])
            so, a_old = part // n_arenas, part % n_arenas
            head = old_epoch[so, a_old] * acap + old_cursor[so, a_old]
            boundary = max(0, int(head) - acap)
            cols = {c: np.asarray(z[c]) for c in _COLUMNS}
        n = cols["ts_ms"].shape[0]
        pos = start + np.arange(n)
        keep = cols["valid"].astype(bool) & (pos < boundary)
        devs = cols["device"].astype(np.int64)
        in_range = (devs >= 0) & (devs < dmap.shape[1])
        sn = np.full(n, NULL_ID, np.int64)
        sn[in_range] = dshard[so, devs[in_range]]
        mapped = keep & (sn != NULL_ID)
        unmapped += int(np.sum(keep & ~(sn != NULL_ID)))
        if not np.any(mapped):
            continue
        idx = np.nonzero(mapped)[0]
        sub = {c: cols[c][idx] for c in _COLUMNS}
        sub["device"] = dmap[so, devs[idx]].astype(sub["device"].dtype)
        asgs = sub["assignment"].astype(np.int64)
        ok = (asgs != NULL_ID) & (asgs >= 0) & (asgs < amap.shape[1])
        new_asg = np.full_like(asgs, NULL_ID)
        new_asg[ok] = amap[so, asgs[ok]]
        sub["assignment"] = new_asg.astype(sub["assignment"].dtype)
        tenants = sub["tenant"].astype(np.int64)
        arena_new = np.where(tenants >= 0, tenants % n_arenas, 0)
        p_rows = sn[idx] * n_arenas + arena_new
        for p_new in np.unique(p_rows):
            sel = p_rows == p_new
            migrated += int(sel.sum())
            writer(int(p_new)).add({c: sub[c][sel] for c in _COLUMNS})

    # (b) overflow-dropped ring rows (already remapped by the re-pack)
    preserved = 0
    for (sn_i, a_i), cols in dropped.items():
        plain = {k.split(".")[-1]: v for k, v in cols.items()}
        plain["valid"] = np.ones(plain["ts_ms"].shape[0], bool)
        preserved += int(plain["ts_ms"].shape[0])
        writer(sn_i * n_arenas + a_i).add(plain)

    # seal history, compute bumps, then (c) eager-spill the kept rows
    epoch_bump: dict[tuple[int, int], int] = {}
    all_parts = set(writers) | {sn * n_arenas + a for sn, a in kept_rows}
    for p_new in sorted(all_parts):
        h = writers[p_new].finish() if p_new in writers else 0
        key = (p_new // n_arenas, p_new % n_arenas)
        # the ring+archive query merge caps archive reads at
        # head - acap = bump*acap + kept - acap; the bump must lift that
        # cap past H or the tail of the migrated history would be
        # invisible whenever the new ring is not full
        kept = n_kept.get(key, 0)
        bump = -(-(h + acap - kept) // acap) if h else 0
        epoch_bump[key] = bump
        # padding [H, bump*acap) never held data: register it so replay
        # consumers skip it without counting phantom lag_lost
        arch.register_gap(p_new, h, bump * acap)
        ring = kept_rows.get(key)
        if ring is not None:
            plain = {k.split(".")[-1]: v for k, v in ring.items()}
            plain["valid"] = np.ones(kept, bool)
            pos = 0
            while pos < kept:
                n = min(arch.segment_rows, kept - pos)
                arch.append_segment(
                    p_new, bump * acap + pos, types.SimpleNamespace(
                        **{c: plain[c][pos:pos + n] for c in _COLUMNS}))
                pos += n
        else:
            # no ring rows landed here: the watermark still must cover
            # the padding gap so the spooler never reads it
            arch._spilled[p_new] = bump * acap
    arch._save_index()
    return {"migrated_rows": migrated, "preserved_overflow_rows": preserved,
            "dropped_unmapped_rows": unmapped, "epoch_bump": epoch_bump}


def _fill_like(key: str, arr: np.ndarray):
    """Empty-row fill matching the zeros() initializers of the state
    dataclasses (NULL for id lanes, INT32_MIN for timestamp lanes)."""
    if arr.dtype == np.bool_:
        return False
    if arr.dtype == np.float32:
        return 0.0
    if key.endswith("_ms") or "last_interaction" in key:
        return np.iinfo(np.int32).min
    if "presence" in key or "event_counts" in key or "status" in key \
            or key.endswith("etype"):
        return 0
    return NULL_ID
