"""Long-term event retention: host-side spill of device ring segments to
disk (a copy of ``sitewhere_tpu/utils/archive.py``, numpy and stdlib only;
the on-disk format is the same, so either package reads an archive
directory the other wrote).

The reference retains FULL event history in an external time-series store
(InfluxDB/Cassandra/Warp10) and serves arbitrary date-range queries
(service-event-management/.../influxdb/InfluxDbDeviceEventManagement.java:63-161);
the device ring (core/store.py) is a fixed-capacity recency window. This module
is the retention tier between them: before a ring row can be overwritten,
its segment is spilled to an on-disk columnar file, and the engines'
``query_events`` transparently merges ring + archive so date ranges older
than the ring come back exactly like the reference's unbounded history.

Design:
- Spooling reads the ring with the SAME ``read_range`` program every time
  (fixed ``segment_rows`` chunk -> one compiled executable, no recompiles)
  and only at flush boundaries, never per event.
- A partition is one (shard, arena) sub-ring: spill order within a
  partition is the ring's write order, so a partition's segments tile
  absolute positions [0, spilled) contiguously.
- Segment files are columnar ``.npz`` (structure-of-arrays, like the ring
  itself). Every segment carries STATISTICS written at append time —
  per-column zone maps (min/max over valid rows for the time + id
  columns) and compact tenant/device/assignment bloom filters — persisted
  in the manifest and mirrored as small members inside the ``.npz``
  itself, so index rebuilds never decompress full columns and queries
  prune whole segments before touching rows (the archive analog of a
  time-series store's shard index + SSTable bloom filters).
- Queries PUSH DOWN: a :class:`SegmentPlanner` evaluates each predicate
  set against the zone maps + blooms and hands back only surviving
  segments newest-first; decoding stops early once the result page is
  provably complete, and only the columns the query touches are
  materialized. Results stay byte-identical to the full scan
  (:meth:`EventArchive.query_unpruned` keeps the unpruned reference
  implementation as the parity oracle).
- Crash safety: segments are written to a temp name and renamed; the
  manifest is rebuilt from the segment files when missing or stale; a
  truncated/corrupt segment file is QUARANTINED (renamed ``*.corrupt``)
  instead of aborting recovery — at index rebuild for files the
  manifest missed, and at first decode for files an intact manifest
  vouched for (rot behind the stats fast path), so one bad file never
  takes the read path down either way.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import zipfile
import zlib

import numpy as np

_COLUMNS = ("etype", "device", "assignment", "tenant", "area", "customer",
            "asset", "ts_ms", "received_ms", "values", "vmask", "aux",
            "valid")

# columns with zone maps (min/max over VALID rows). ``aux0``/``aux1`` are
# the two lanes of the 2-d ``aux`` column (the invocation/alternate-id
# lanes the query surface filters on).
_ZONE_COLUMNS = ("ts_ms", "received_ms", "etype", "device", "assignment",
                 "tenant", "area", "customer")
# columns that additionally carry a bloom filter: the high-cardinality id
# lanes where a min/max interval is too loose to prune (a segment touching
# devices {3, 9000} has a zone map spanning every device in between)
_BLOOM_COLUMNS = ("tenant", "device", "assignment")
_BLOOM_BITS = 1024                     # 128 bytes per column per segment
_BLOOM_WORDS = _BLOOM_BITS // 64
# everything stats computation needs (all predicate columns + validity) —
# deliberately NOT the payload columns (values/vmask), so a lazy backfill
# never decompresses the wide float lanes
_STATS_COLUMNS = ("valid", "ts_ms", "received_ms", "etype", "device",
                  "assignment", "tenant", "area", "customer", "aux")


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized) — the bloom hash kernel."""
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


_BLOOM_SALTS = (np.uint64(0x51_7C_C1_B7_27_22_0A_95),
                np.uint64(0x2545F4914F6CDD1D))


def _bloom_build(vals: np.ndarray) -> np.ndarray:
    """k=2 bloom bitset (uint64[_BLOOM_WORDS]) over integer column values.
    No false negatives by construction — the planner may only ever prune a
    segment the value provably never touched."""
    bits = np.zeros(_BLOOM_WORDS, np.uint64)
    if vals.size:
        v = vals.astype(np.int64).astype(np.uint64)
        for salt in _BLOOM_SALTS:
            h = _mix64(v ^ salt) % np.uint64(_BLOOM_BITS)
            np.bitwise_or.at(bits, (h >> np.uint64(6)).astype(np.int64),
                             np.uint64(1) << (h & np.uint64(63)))
    return bits


def _bloom_positions(value: int) -> list[tuple[int, np.uint64]]:
    """(word index, bit mask) pairs a value sets — shared by the scalar
    membership test and the planner's vectorized matrix test."""
    v = np.uint64(np.int64(value))
    out = []
    for salt in _BLOOM_SALTS:
        h = int(_mix64(np.asarray([v ^ salt], np.uint64))[0]) % _BLOOM_BITS
        out.append((h >> 6, np.uint64(1) << np.uint64(h & 63)))
    return out


def _compute_stats(cols: dict) -> dict:
    """Per-segment statistics over the VALID rows: zone maps for the
    time/id columns, blooms for the high-cardinality ids, and the valid
    row count (lets a provably-full-match segment contribute its total
    without being decoded at all). JSON-serializable (manifest round
    trip); blooms are hex-encoded little-endian uint64 words."""
    valid = np.asarray(cols["valid"], bool)
    idx = np.nonzero(valid)[0]
    st: dict = {"rows": int(idx.size), "z": {}, "bloom": {}}
    if not idx.size:
        return st
    for c in _ZONE_COLUMNS:
        v = np.asarray(cols[c])[idx]
        st["z"][c] = [int(v.min()), int(v.max())]
    aux = np.asarray(cols["aux"])[idx]
    st["z"]["aux0"] = [int(aux[:, 0].min()), int(aux[:, 0].max())]
    st["z"]["aux1"] = [int(aux[:, 1].min()), int(aux[:, 1].max())]
    for c in _BLOOM_COLUMNS:
        st["bloom"][c] = _bloom_build(
            np.asarray(cols[c])[idx]).tobytes().hex()
    return st


# --------------------------------------------------------------- codecs
# Per-column compression for spilled segments. A
# compressed segment stores ``<col>__packed`` uint8 blobs plus one
# ``codec_json`` member instead of the plain column members; the scalar
# stats members (seg_nrows/seg_ts_min/seg_ts_max/stats_json) stay plain,
# so index rebuilds and the planner never touch a codec. Decoding is
# exact (bit-for-bit round trip, pinned in tests): integer columns are
# delta-coded along axis 0, zigzagged, packed to the minimal uint width
# and deflated; bool columns packbits + deflate; float payloads deflate
# raw. All stdlib — no new dependencies.

_PACK_WIDTHS = ((np.uint8, 0xFF), (np.uint16, 0xFFFF),
                (np.uint32, 0xFFFFFFFF))


def _encode_column(a: np.ndarray) -> tuple[np.ndarray, dict]:
    """(uint8 blob, meta) for one column. Meta is JSON-serializable and
    self-contained: kind + dtype + shape (+ pack width for ints)."""
    a = np.ascontiguousarray(a)
    meta: dict = {"dtype": str(a.dtype), "shape": list(a.shape)}
    if a.dtype == np.bool_:
        meta["kind"] = "bits"
        raw = np.packbits(a.reshape(-1)).tobytes()
    elif np.issubdtype(a.dtype, np.integer):
        meta["kind"] = "delta"
        v = a.astype(np.int64)
        d = np.empty_like(v)
        d[:1] = v[:1]
        if v.shape[0] > 1:
            d[1:] = v[1:] - v[:-1]
        with np.errstate(over="ignore"):
            u = (d.astype(np.uint64) << np.uint64(1)) \
                ^ (d >> np.int64(63)).astype(np.uint64)
        hi = int(u.max()) if u.size else 0
        for w, cap in _PACK_WIDTHS:
            if hi <= cap:
                u = u.astype(w)
                break
        meta["width"] = u.dtype.itemsize
        raw = u.tobytes()
    else:
        meta["kind"] = "raw"
        raw = a.tobytes()
    blob = np.frombuffer(zlib.compress(raw, 6), np.uint8)
    return blob, meta


def _decode_column(blob: np.ndarray, meta: dict) -> np.ndarray:
    """Exact inverse of :func:`_encode_column`."""
    raw = zlib.decompress(np.ascontiguousarray(blob).tobytes())
    dtype = np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    kind = meta["kind"]
    if kind == "bits":
        n = int(np.prod(shape)) if shape else 1
        return np.unpackbits(np.frombuffer(raw, np.uint8),
                             count=n).astype(bool).reshape(shape)
    if kind == "delta":
        w = np.dtype(f"uint{8 * int(meta['width'])}")
        u = np.frombuffer(raw, w).astype(np.uint64)
        d = ((u >> np.uint64(1))
             ^ (np.uint64(0) - (u & np.uint64(1)))).astype(np.int64)
        d = d.reshape(shape)
        with np.errstate(over="ignore"):
            v = np.cumsum(d, axis=0, dtype=np.int64) if d.size else d
        return v.astype(dtype)
    return np.frombuffer(raw, dtype).reshape(shape)


def _segment_members(part: int, start: int, topology: "str | None",
                     cols: dict, count: int, ts_min: int, ts_max: int,
                     stats: dict, compress: bool) -> tuple[dict, dict]:
    """The np.savez member dict for one segment file (shared by
    :meth:`EventArchive.append_segment` and :meth:`EventArchive.compact`)
    plus the stats dict as persisted — stats gain ``bytes`` (decoded
    column bytes) and ``enc_bytes`` (on-disk encoded bytes), the
    planner's decompression-cost inputs."""
    raw_bytes = int(sum(np.asarray(v).nbytes for v in cols.values()))
    members: dict = {"part": np.int64(part), "start": np.int64(start),
                     "topology": np.str_(topology or ""),
                     "seg_nrows": np.int64(count),
                     "seg_ts_min": np.int64(ts_min),
                     "seg_ts_max": np.int64(ts_max)}
    if compress:
        codec: dict = {}
        enc = 0
        for c in _COLUMNS:
            blob, meta = _encode_column(np.asarray(cols[c]))
            members[c + "__packed"] = blob
            codec[c] = meta
            enc += int(blob.nbytes)
        members["codec_json"] = np.str_(json.dumps(codec))
        stats = dict(stats, bytes=raw_bytes, enc_bytes=enc)
    else:
        members.update(cols)
        stats = dict(stats, bytes=raw_bytes, enc_bytes=raw_bytes)
    members["stats_json"] = np.str_(json.dumps(stats))
    return members, stats


def mesh_topology(n_shards: int, arenas: int) -> str:
    """Canonical topology stamp of a mesh engine's archive — ONE producer
    for the stamp the engine writes, recovery matches, and migration
    rewrites."""
    return f"mesh/{n_shards}x{arenas}"


def single_topology(arenas: int) -> str:
    """Canonical topology stamp of a single-chip engine's archive."""
    return f"single/{arenas}"


@dataclasses.dataclass
class _Segment:
    part: int        # partition = shard * arenas + arena (0 for 1-ring)
    start: int       # absolute position of first row within the partition
    count: int
    ts_min: int
    ts_max: int
    path: str
    stats: dict | None = None   # zone maps + blooms + valid-row count;
                                # None on manifests written before the
                                # pushdown tier (back-filled lazily)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class SegmentCache:
    """Bounded LRU of decoded segment columns, keyed by segment path.

    Columns load LAZILY: predicate evaluation pulls only the columns the
    query touches (npz members decompress individually) and the row
    materialization that follows reuses the same entry. Shared by the
    planner-driven query path, by-id lookups (``get_row``), chunked replay
    (``read_rows``), and compaction, so none of them re-``np.load`` a file
    another caller just decoded. Entries die with their segment (expiry,
    compaction, retire, quarantine) via :meth:`retain`."""

    def __init__(self, max_segments: int = 8):
        self.max_segments = max(1, int(max_segments))
        self._entries: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self.hits = 0      # calls fully served from cache
        self.loads = 0     # np.load file opens (misses, counted per open)

    @property
    def nbytes(self) -> int:
        """Host bytes held by decoded segment columns — the memory
        ledger's segment-cache component. Counted at RESIDENT
        (decoded) size: a column decoded from a compressed segment costs
        its full numpy footprint, not its on-disk encoded size, so
        ``devicewatch_ledger_reconciles`` stays a true gate; raw byte
        buffers are counted by length."""
        total = 0
        for entry in self._entries.values():
            for col in entry.values():
                if hasattr(col, "nbytes"):
                    total += int(col.nbytes)
                elif isinstance(col, (bytes, bytearray, memoryview)):
                    total += len(col)
        return total

    def columns(self, directory: pathlib.Path, path: str,
                names: tuple) -> dict:
        entry = self._entries.get(path)
        if entry is not None:
            self._entries.move_to_end(path)
            missing = [c for c in names if c not in entry]
            if not missing:
                self.hits += 1
                return entry
        else:
            missing = list(names)
        with np.load(directory / path) as z:
            fresh = {}
            codec = None
            for c in missing:
                if c in z.files:
                    fresh[c] = np.asarray(z[c])
                    continue
                # compressed segment: the plain member is absent and the
                # column decodes from its packed blob — the ONE hook all
                # read paths (query/get_row/read_rows/compact) share, so
                # decoded columns land in the cache at resident size
                if codec is None:
                    codec = json.loads(str(z["codec_json"]))
                fresh[c] = _decode_column(np.asarray(z[c + "__packed"]),
                                          codec[c])
        self.loads += 1
        if entry is None:
            entry = self._entries[path] = {}
            self._entries.move_to_end(path)
            while len(self._entries) > self.max_segments:
                self._entries.popitem(last=False)
        entry.update(fresh)
        return entry

    def retain(self, live_paths: set) -> None:
        for p in list(self._entries):
            if p not in live_paths:
                del self._entries[p]


class SegmentPlanner:
    """Zone-map + bloom pruning over an archive's segment index.

    The planner keeps VECTORIZED per-column tables (one numpy row per
    segment, rebuilt only when the index generation changes), so Q
    concurrent queries in a batcher round share one planning pass: each
    predicate set reduces to a handful of numpy comparisons over the
    whole index instead of a per-segment Python loop. For every query it
    returns the surviving segments NEWEST-FIRST (by their valid-rows
    ts upper bound) together with a provably-full-match flag: a segment
    whose zone maps prove that EVERY valid row matches (and whose
    eviction cap covers it) can contribute its stored row count without
    being decoded at all once the result page is closed.

    Pruning is exact, never lossy: zone maps bound the valid rows, blooms
    have no false negatives, and a surviving segment still evaluates the
    full row-level mask — a bloom false positive costs one decode, never
    a wrong row."""

    _BIG = np.int64(2**62)

    def __init__(self, archive: "EventArchive"):
        self.archive = archive
        self._gen = -1
        # planning passes served (one per plan()/plan_batch() call, NOT
        # per predicate set): the batcher round batches its Q archive
        # requests into ONE call, so calls per round must be exactly 1 —
        # exported as swtpu_archive_planner_calls_total and pinned by
        # tests/test_archive_pushdown.py
        self.calls = 0

    # ---------------------------------------------------------- tables
    def _refresh(self) -> None:
        arch = self.archive
        if self._gen == arch._generation:
            return
        # capture the generation BEFORE snapshotting: if a concurrent
        # append lands mid-build we record the OLD generation, so the
        # next plan() rebuilds and sees the tail (never a stale table
        # stamped with a fresh generation)
        gen = arch._generation
        # lazy back-fill: segments adopted from a pre-pushdown manifest
        # carry no stats; compute them once (predicate columns only) and
        # persist, so the cost is paid on first plan, not every plan
        dirty = False
        # snapshot: back-fill can QUARANTINE an unreadable segment,
        # which removes it from arch.segments mid-walk
        for s in list(arch.segments):
            if s.stats is None:
                arch._ensure_stats(s)
                dirty = True
        if dirty:
            arch._save_index()
        # snapshot AGAIN: a concurrent spool (analytics job planning
        # while the ingest thread appends segments) must not grow the
        # list under the array builds below — the fresh tail is picked
        # up by the next generation bump
        segs = list(arch.segments)     # (part, start)-sorted == scan order
        n = len(segs)
        self._segs = segs
        self._part = np.fromiter((s.part for s in segs), np.int64, n)
        self._start = np.fromiter((s.start for s in segs), np.int64, n)
        self._count = np.fromiter((s.count for s in segs), np.int64, n)
        self._rows = np.fromiter(
            ((s.stats or {}).get("rows", -1) for s in segs), np.int64, n)
        known = self._rows >= 0
        self._known = known
        self._z = {}
        for c in _ZONE_COLUMNS + ("aux0", "aux1"):
            zmin = np.full(n, -self._BIG)
            zmax = np.full(n, self._BIG)
            for i, s in enumerate(segs):
                z = (s.stats or {}).get("z", {}).get(c)
                if z is not None:
                    zmin[i], zmax[i] = z
                elif known[i]:
                    # known stats with no zone entry = zero valid rows:
                    # an empty interval fails every predicate
                    zmin[i], zmax[i] = self._BIG, -self._BIG
            self._z[c] = (zmin, zmax)
        # newest-first bound on VALID rows' event time; unknown-stats
        # segments fall back to the all-rows bound (still an upper bound)
        zts_min, zts_max = self._z["ts_ms"]
        all_hi = np.fromiter((s.ts_max for s in segs), np.int64, n)
        all_lo = np.fromiter((s.ts_min for s in segs), np.int64, n)
        self._ts_hi = np.where(known, np.minimum(zts_max, all_hi), all_hi)
        self._ts_lo = np.where(known & (self._rows > 0),
                               np.maximum(zts_min, all_lo), all_lo)
        self._bloom = {}
        for c in _BLOOM_COLUMNS:
            mat = np.full((n, _BLOOM_WORDS), np.uint64(0xFFFFFFFFFFFFFFFF),
                          np.uint64)     # unknown = all bits = never prunes
            for i, s in enumerate(segs):
                h = (s.stats or {}).get("bloom", {}).get(c)
                if h is not None:
                    mat[i] = np.frombuffer(bytes.fromhex(h), np.uint64)
                elif known[i]:
                    mat[i] = 0           # zero valid rows: nothing matches
            self._bloom[c] = mat
        # per-segment decode-cost table: resident column bytes
        # plus, for compressed segments, the encoded bytes that must flow
        # through the codec — so a round packer budgeting by cost charges
        # decompression, not just materialization. Segments written
        # before cost stats existed fall back to a per-row estimate.
        self._cost = np.empty(n, np.int64)
        for i, s in enumerate(segs):
            st = s.stats or {}
            if "bytes" in st:
                self._cost[i] = (int(st["bytes"])
                                 + int(st.get("enc_bytes", st["bytes"])))
            else:
                self._cost[i] = s.count * 128
        self._gen = gen

    def cost_of(self, scan_order: int) -> int:
        """Decode cost (bytes) of the segment a plan row named by its
        ``scan_order`` index — valid until the index generation moves,
        i.e. for the plan the caller just received."""
        self._refresh()
        return int(self._cost[scan_order])

    # ------------------------------------------------------------ plan
    def plan(self, *, max_pos=None, device=None, etype=None, tenant=None,
             assignment=None, aux0=None, aux1=None, area=None,
             customer=None, since_ms=None, until_ms=None,
             device_parts=None, assignment_parts=None):
        """One predicate set -> ``(rows, considered)`` where ``rows`` is a
        newest-first list of ``(scan_order, segment, full_match, ts_hi,
        cap_covers)`` tuples and ``considered`` counts the segments the
        eviction cap admitted (what an unpruned scan would have opened)."""
        self.calls += 1
        self._refresh()
        return self._plan_refreshed(
            max_pos=max_pos, device=device, etype=etype, tenant=tenant,
            assignment=assignment, aux0=aux0, aux1=aux1, area=area,
            customer=customer, since_ms=since_ms, until_ms=until_ms,
            device_parts=device_parts, assignment_parts=assignment_parts)

    def plan_batch(self, requests: list, *, max_pos=None) -> list:
        """Evaluate N predicate sets in ONE planner call: the table refresh —
        the expensive half when the index generation moved (stats
        back-fill, vectorized column tables) —
        runs once for the whole batch, and ``calls`` counts the batch as
        a single planning pass. ``requests`` are filter-kwarg dicts (the
        keys :meth:`plan` accepts, minus ``max_pos``, which is shared —
        one batcher round has one snapshot cursor capture). Returns one
        ``(rows, considered)`` per request, each identical to what a
        standalone :meth:`plan` would return."""
        self.calls += 1
        self._refresh()
        return [self._plan_refreshed(max_pos=max_pos, **req)
                for req in requests]

    def _plan_refreshed(self, *, max_pos=None, device=None, etype=None,
                        tenant=None, assignment=None, aux0=None, aux1=None,
                        area=None, customer=None, since_ms=None,
                        until_ms=None, device_parts=None,
                        assignment_parts=None):
        n = len(self._segs)
        if not n:
            return [], 0
        if max_pos is not None:
            caps = np.fromiter((max_pos.get(int(p), 0) for p in self._part),
                               np.int64, n)
            eligible = self._start < caps
            cap_covers = caps >= self._start + self._count
        else:
            eligible = np.ones(n, bool)
            cap_covers = np.ones(n, bool)
        considered = int(eligible.sum())
        alive = eligible.copy()
        # a known-empty segment (zero valid rows) contributes nothing
        alive &= ~self._known | (self._rows > 0)
        full = alive & self._known & (self._rows > 0) & cap_covers

        def eq(col: str, v) -> None:
            nonlocal alive, full
            if v is None:
                return
            v = int(v)
            zmin, zmax = self._z[col]
            alive &= (zmin <= v) & (v <= zmax)
            full &= (zmin == v) & (zmax == v)
            mat = self._bloom.get(col)
            if mat is not None:
                hit = np.ones(n, bool)
                for w, mask in _bloom_positions(v):
                    hit &= (mat[:, w] & mask) != 0
                alive &= hit

        eq("device", device)
        eq("etype", etype)
        eq("tenant", tenant)
        eq("assignment", assignment)
        eq("aux0", aux0)
        eq("aux1", aux1)
        eq("area", area)
        eq("customer", customer)
        if since_ms is not None:
            alive &= self._ts_hi >= int(since_ms)
            full &= self._ts_lo >= int(since_ms)
        if until_ms is not None:
            alive &= self._ts_lo <= int(until_ms)
            full &= self._ts_hi <= int(until_ms)
        # shard-scoped id namespaces (mesh): a filter bound to one shard's
        # partitions contributes zero rows everywhere else
        if device is not None and device_parts is not None:
            alive &= np.isin(self._part, list(device_parts))
        if assignment is not None and assignment_parts is not None:
            alive &= np.isin(self._part, list(assignment_parts))
        order = np.nonzero(alive)[0]
        if order.size:
            order = order[np.lexsort((order, -self._ts_hi[order]))]
        return ([(int(i), self._segs[i], bool(full[i]),
                  int(self._ts_hi[i]), bool(cap_covers[i]))
                 for i in order], considered)


class EventArchive:
    """Directory of spilled ring segments + a queryable index.

    A partition is one independent sub-ring feeding this archive (an
    arena for a single-chip engine; (shard, arena) flattened for the
    mesh); each keeps its own spill watermark. ``topology`` labels the
    exact engine shape writing the archive (see __init__)."""

    def __init__(self, directory: str | pathlib.Path, segment_rows: int = 4096,
                 max_rows_per_part: int | None = None,
                 topology: str | None = None,
                 max_age_ms: int | None = None,
                 cache_segments: int = 8,
                 compress: bool = False):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_rows = int(segment_rows)
        # per-column compression for NEWLY written segments (existing
        # files are read as-is either way — the decode hook keys off each
        # file's own members, so mixed archives work)
        self.compress = bool(compress)
        # partition-topology stamp: segment `part` indices are only
        # meaningful for the exact engine layout that wrote them — after an
        # elastic reshard (or a single<->mesh migration with equal
        # partition COUNTS) the same integers would resolve to the WRONG
        # shard/arena and shard-local device ids shift, so the stamp is a
        # full shape label (e.g. "mesh/8x1"), and any mismatch retires the
        # old data instead of misreading it
        self.topology = topology
        # retention policy (reference: per-assignment
        # INFLUX_RETENTION_POLICY override, InfluxDbDeviceEventManagement):
        # None = unbounded history; otherwise each partition keeps at most
        # this many archived rows and the OLDEST whole segments expire.
        # The newest archived rows duplicate the ring window (spill is
        # eager), so the queryable history beyond the ring is roughly
        # max_rows_per_part - arena_capacity: size the cap ABOVE the ring
        self.max_rows_per_part = max_rows_per_part
        # time-based retention (the closer Influx analog): a segment whose
        # NEWEST event is older than the partition's newest event minus
        # max_age_ms expires wholesale. Event-time based (ts_ms domain),
        # so replayed/backfilled history ages consistently
        self.max_age_ms = max_age_ms
        self.expired_rows = 0
        self.segments: list[_Segment] = []
        self.lost_rows = 0   # rows overwritten before they could spill
        # per-partition segments sorted by start (bisect lookups) + the
        # LRU segment-decode cache shared by queries, by-id lookups and
        # chunked replay (one decode per segment per working set, not per
        # call)
        self._by_part: dict[int, list[_Segment]] = {}
        self.cache = SegmentCache(max_segments=cache_segments)
        # monotone spill watermark per partition, independent of segment
        # PRESENCE: retention may expire the tail segment (backfilled event
        # times), and a watermark derived from surviving segments would
        # regress below the ring head — making the spooler re-spill and
        # re-expire the same rows forever
        self._spilled: dict[int, int] = {}
        # registered gaps: position ranges that NEVER held data (topology
        # migration pads history up to an arena boundary) — replay must
        # not count them as lost rows
        self._gaps: dict[int, list[list[int]]] = {}
        # pushdown accounting (exported as swtpu_archive_* gauges at
        # scrape time; the bench's pruning proof reads them directly)
        self.queries = 0            # pushdown query() calls
        self.plan_considered = 0    # segments the eviction cap admitted
        self.plan_pruned = 0        # ...of which zone maps/blooms pruned
        self.plan_decoded = 0       # unique segments decoded per query
        self.count_shortcuts = 0    # full-match segments counted w/o decode
        self.corrupt_segments = 0   # files quarantined (rebuild or decode)
        self._generation = 0        # bumped on every index mutation; the
                                    # planner rebuilds its tables on change
        self._planner = SegmentPlanner(self)
        self._load_index()

    # ------------------------------------------------------------- index
    def _manifest_path(self) -> pathlib.Path:
        return self.dir / "index.json"

    def _load_index(self) -> None:
        # a crash mid-write leaves a *.npz.tmp — never adopted (the glob
        # below requires the final .npz name), just swept away here
        for stray in self.dir.glob("*.npz.tmp"):
            stray.unlink()
        manifest = self._manifest_path()
        known: dict[str, _Segment] = {}
        if manifest.exists():
            m = json.loads(manifest.read_text())
            stamped = m.get("topology", m.get("parts"))
            if (self.topology is not None and stamped is not None
                    and str(stamped) != self.topology):
                self._retire(str(stamped))
            else:
                for e in m.get("segments", []):
                    known[e["path"]] = _Segment(**e)
                self._spilled = {int(k): int(v)
                                 for k, v in m.get("spilled", {}).items()}
                self._gaps = {int(k): [[int(lo), int(hi)] for lo, hi in v]
                              for k, v in m.get("gaps", {}).items()}
        # adopt any segment file the manifest missed (crash between the
        # segment rename and the manifest rewrite) — but NEVER a file whose
        # own topology stamp disagrees (a manifest-less dir must not smuggle
        # old-topology partition indices past the retire check). A file
        # that cannot be read at all (truncated by a crash, bit rot) is
        # QUARANTINED — renamed aside and counted — so one bad segment
        # never takes the rest of the archive down with it.
        for f in sorted(self.dir.glob("seg-*.npz")):
            if f.name in known:
                self.segments.append(known[f.name])
                continue
            try:
                with np.load(f) as z:
                    # an archive opened with topology=None stamps
                    # np.str_(""); treat that like a missing stamp (same
                    # semantics as a null manifest stamp) so such segments
                    # are adopted, not retired, by a topology-aware open
                    seg_topo = (str(z["topology"]) if "topology" in z.files
                                else "") or None
                    if (self.topology is not None and seg_topo is not None
                            and seg_topo != self.topology):
                        pass  # retired below, outside the np.load handle
                    else:
                        seg_topo = None
                        if "seg_nrows" in z.files:
                            # stats members written at append time: the
                            # rebuild touches only scalars + the compact
                            # stats blob, never a full column
                            count = int(z["seg_nrows"])
                            ts_min = int(z["seg_ts_min"])
                            ts_max = int(z["seg_ts_max"])
                            stats = json.loads(str(z["stats_json"]))
                        else:
                            # pre-pushdown file: full-column fallback and
                            # the lazy stats back-fill in one read
                            ts = z["ts_ms"]
                            count = int(ts.shape[0])
                            ts_min = int(ts.min()) if ts.size else 0
                            ts_max = int(ts.max()) if ts.size else 0
                            stats = _compute_stats(
                                {c: np.asarray(z[c])
                                 for c in _STATS_COLUMNS})
                        self.segments.append(_Segment(
                            part=int(z["part"]), start=int(z["start"]),
                            count=count, ts_min=ts_min, ts_max=ts_max,
                            path=f.name, stats=stats))
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile) as err:
                self._quarantine(f, err)
                continue
            if seg_topo is not None:
                self._retire(seg_topo, files=[f])
        self.segments.sort(key=lambda s: (s.part, s.start))
        self._drop_covered()
        self._reindex()

    def _quarantine(self, f: pathlib.Path, err: Exception) -> None:
        """Move an unreadable segment file aside (``<name>.corrupt`` —
        outside the ``seg-*.npz`` recovery glob) so the rest of the
        archive keeps serving; the loss is counted and logged LOUDLY, and
        the file is preserved for offline forensics."""
        import logging

        target = f.with_name(f.name + ".corrupt")
        n = 0
        while target.exists():
            n += 1
            target = f.with_name(f"{f.name}.corrupt{n}")
        f.rename(target)
        self.corrupt_segments += 1
        logging.getLogger(__name__).warning(
            "archive: QUARANTINED corrupt segment %s -> %s (%s: %s); "
            "its rows are unavailable until repaired, the rest of the "
            "archive keeps serving", f.name, target.name,
            type(err).__name__, err)

    def _drop_corrupt(self, seg: "_Segment", err: Exception) -> None:
        """Quarantine a segment that failed to DECODE after adoption — a
        manifest-listed file is trusted at :meth:`_load_index` without
        being opened (that's the point of the stats fast path), so
        truncation/bit rot behind an intact manifest only surfaces at
        first decode. The file moves aside, the segment leaves the index
        (generation bump makes planners rebuild), and the caller serves
        on without its rows instead of failing every query that plans
        over it."""
        try:
            self.segments.remove(seg)
        except ValueError:
            return   # already dropped (repeated failure on a stale ref)
        f = self.dir / seg.path
        if f.exists():
            self._quarantine(f, err)
        else:
            self.corrupt_segments += 1   # vanished from under us: still
                                         # counted, nothing to rename
        self._reindex()
        self._save_index()

    def _cols_or_drop(self, seg: "_Segment", names: tuple) -> dict | None:
        """Decode ``names`` columns of ``seg`` via the shared cache;
        an unreadable file is quarantined (:meth:`_drop_corrupt`) and
        ``None`` returned so one rotten segment never takes the whole
        read path down."""
        try:
            return self.cache.columns(self.dir, seg.path, names)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as err:
            self._drop_corrupt(seg, err)
            return None

    def _ensure_stats(self, seg: _Segment) -> None:
        """Back-fill zone maps + blooms for a segment adopted from a
        pre-pushdown manifest (predicate columns only, via the shared
        decode cache). An unreadable segment quarantines instead."""
        cols = self._cols_or_drop(seg, _STATS_COLUMNS)
        if cols is not None:
            seg.stats = _compute_stats(cols)

    def _drop_covered(self) -> None:
        """Delete segment files whose row range is fully covered by a
        larger segment of the same partition — the leftovers of a
        compaction that crashed between the merged-segment rename and the
        source deletes (merged files exactly cover their sources, so
        covered == superseded)."""
        keep: list[_Segment] = []
        end: dict[int, int] = {}
        for s in sorted(self.segments,
                        key=lambda s: (s.part, s.start, -s.count)):
            if s.start + s.count <= end.get(s.part, 0):
                (self.dir / s.path).unlink(missing_ok=True)
                continue
            end[s.part] = max(end.get(s.part, 0), s.start + s.count)
            keep.append(s)
        self.segments = keep

    def _reindex(self) -> None:
        self._by_part = {}
        for s in self.segments:
            self._by_part.setdefault(s.part, []).append(s)
        for segs in self._by_part.values():
            segs.sort(key=lambda s: s.start)
        self._generation += 1
        # decode-cache entries die with their segment (expiry, compaction,
        # retire, quarantine, test surgery on .segments)
        self.cache.retain({s.path for s in self.segments})

    def _retire(self, old_topology: str,
                files: "list[pathlib.Path] | None" = None) -> None:
        """Move different-topology archive files aside (never delete
        history: the operator may migrate it offline). Runs before any
        index adoption, so the live archive never carries them."""
        import logging

        tag = old_topology.replace("/", "-")
        retired = self.dir / f"retired-{tag}"
        n = 0
        while retired.exists():
            n += 1
            retired = self.dir / f"retired-{tag}-{n}"
        retired.mkdir()
        if files is None:
            files = list(self.dir.glob("seg-*.npz")) + [self._manifest_path()]
        for f in files:
            if f.exists():
                f.rename(retired / f.name)
        logging.getLogger(__name__).warning(
            "archive topology changed (%s -> %s): previous history moved "
            "to %s; spill starts fresh",
            old_topology, self.topology, retired)

    def _save_index(self) -> None:
        tmp = self._manifest_path().with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"topology": self.topology,
             "spilled": self._spilled,
             "gaps": self._gaps,
             "segments": [s.to_json() for s in self.segments]}))
        tmp.replace(self._manifest_path())

    def spilled(self, part: int) -> int:
        """Next absolute position of ``part`` the spooler should write —
        monotone even after retention expires the newest-position
        segment."""
        ends = max((s.start + s.count for s in self._by_part.get(part, ())),
                   default=0)
        return max(self._spilled.get(part, 0), ends)

    def total_rows(self) -> int:
        return sum(s.count for s in self.segments)

    def register_gap(self, part: int, lo: int, hi: int) -> None:
        """Record [lo, hi) of ``part`` as positions that never held data
        (migration padding) — replay skips them without loss accounting."""
        if hi > lo:
            self._gaps.setdefault(part, []).append([int(lo), int(hi)])

    def gap_rows(self, part: int, lo: int, hi: int) -> int:
        """Rows of [lo, hi) covered by registered never-written gaps."""
        return sum(max(0, min(hi, g_hi) - max(lo, g_lo))
                   for g_lo, g_hi in self._gaps.get(part, ()))

    # ------------------------------------------------------------- write
    def append_segment(self, part: int, start: int, sl) -> None:
        """Persist one contiguous ring slice (a ``StoreSlice`` already on
        host). Idempotent: re-spooling an existing (part, start) range —
        e.g. after WAL replay — is a no-op. Zone maps + blooms are
        computed HERE, once, while the columns are already in memory —
        queries and index rebuilds only ever read them back."""
        name = f"seg-p{part:04d}-o{start:014d}-n{sl.ts_ms.shape[0]}.npz"
        path = self.dir / name
        end = start + int(sl.ts_ms.shape[0])
        self._spilled[part] = max(self._spilled.get(part, 0), end)
        if path.exists():
            return
        cols = {c: np.asarray(getattr(sl, c)) for c in _COLUMNS}
        ts = cols["ts_ms"]
        count = int(ts.shape[0])
        ts_min = int(ts.min()) if ts.size else 0
        ts_max = int(ts.max()) if ts.size else 0
        stats = _compute_stats(cols)
        members, stats = _segment_members(
            part, start, self.topology, cols, count, ts_min, ts_max,
            stats, self.compress)
        # temp name must NOT match the seg-*.npz recovery glob (write via a
        # file handle — np.savez would append .npz to a bare path)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **members)
        tmp.replace(path)
        self.segments.append(_Segment(
            part=part, start=start, count=count,
            ts_min=ts_min, ts_max=ts_max, path=name, stats=stats))
        self.segments.sort(key=lambda s: (s.part, s.start))
        self._reindex()
        self._expire(part)
        self._save_index()

    def _expire(self, part: int) -> None:
        """Apply the retention policies: drop this partition's OLDEST whole
        segments while it exceeds ``max_rows_per_part``, and any segment
        whose newest event fell behind ``max_age_ms`` of the partition's
        newest. Expired rows are deliberate policy (counted separately
        from ``lost_rows``)."""
        if self.max_rows_per_part is None and self.max_age_ms is None:
            return
        segs = self._by_part.get(part, [])
        victims: list[_Segment] = []
        # phase 1 — row cap pops in WRITE order (oldest position first)
        if self.max_rows_per_part is not None:
            total = sum(s.count for s in segs)
            while segs and total > self.max_rows_per_part:
                victims.append(segs.pop(0))
                total -= victims[-1].count
        # phase 2 — age horizon from the SURVIVORS' newest event (a
        # just-popped segment must not inflate it), sweeping EVERY
        # segment: event time is client-supplied, so a backfilled segment
        # can sit behind a fresher one in write order
        if self.max_age_ms is not None and segs:
            horizon = max(s.ts_max for s in segs) - self.max_age_ms
            victims += [s for s in segs if s.ts_max < horizon]
            segs[:] = [s for s in segs if s.ts_max >= horizon]
        for victim in victims:
            self.expired_rows += victim.count
            self.segments.remove(victim)
            (self.dir / victim.path).unlink(missing_ok=True)
        if victims:
            self._reindex()

    # -------------------------------------------------------- maintenance
    def compact(self, target_rows: int | None = None) -> dict:
        """Merge runs of contiguous small segments per partition into
        files of up to ``target_rows`` (default 8x the spool segment) —
        the maintenance the reference delegates to its time-series
        store's own compaction (Influx shard compaction). Row positions
        are preserved, so by-id lookups, replay cursors, and the query
        cap are unaffected. Crash-safe: the merged file is renamed into
        place before the sources are deleted; a crash in between leaves
        covered sources that ``_load_index`` sweeps."""
        target = int(target_rows or 8 * self.segment_rows)
        merged_segments = files_removed = 0
        for part, segs in list(self._by_part.items()):
            i = 0
            while i < len(segs):
                run = [segs[i]]
                total = segs[i].count
                j = i + 1
                while (j < len(segs)
                       and segs[j].start == run[-1].start + run[-1].count
                       and total + segs[j].count <= target):
                    total += segs[j].count
                    run.append(segs[j])
                    j += 1
                if len(run) < 2:
                    i = j
                    continue
                cols: "dict[str, list] | None" = {c: [] for c in _COLUMNS}
                for s in run:
                    sc = self._segment_cols(s)
                    if sc is None:   # quarantined: leave this run alone
                        cols = None
                        break
                    for c in _COLUMNS:
                        cols[c].append(sc[c])
                if cols is None:
                    i = j
                    continue
                merged = {c: np.concatenate(cols[c]) for c in _COLUMNS}
                start = run[0].start
                ts = merged["ts_ms"]
                ts_min = int(ts.min()) if ts.size else 0
                ts_max = int(ts.max()) if ts.size else 0
                stats = _compute_stats(merged)
                members, stats = _segment_members(
                    part, start, self.topology, merged, total, ts_min,
                    ts_max, stats, self.compress)
                name = f"seg-p{part:04d}-o{start:014d}-n{total}.npz"
                tmp = self.dir / (name + ".tmp")
                with open(tmp, "wb") as f:
                    np.savez(f, **members)
                tmp.replace(self.dir / name)
                new_seg = _Segment(
                    part=part, start=start, count=total,
                    ts_min=ts_min, ts_max=ts_max, path=name, stats=stats)
                for s in run:
                    (self.dir / s.path).unlink(missing_ok=True)
                    self.segments.remove(s)
                    files_removed += 1
                self.segments.append(new_seg)
                merged_segments += 1
                segs[i:j] = [new_seg]
                i += 1
        if merged_segments:
            self.segments.sort(key=lambda s: (s.part, s.start))
            self._reindex()
            self._save_index()
        return {"merged_segments": merged_segments,
                "files_removed": files_removed,
                "files_now": len(self.segments)}

    def disk_usage(self) -> dict:
        """Bytes on disk: live segments + everything under retired-*/
        (the disk-bounding observability knob). Tolerates concurrent
        expiry/compaction unlinking files mid-walk."""
        live = 0
        segments = list(self.segments)
        for s in segments:
            try:
                live += (self.dir / s.path).stat().st_size
            except FileNotFoundError:
                pass
            except OSError:
                pass
        retired = retired_files = 0
        for d in self.dir.glob("retired-*"):
            for f in d.rglob("*"):
                try:
                    if f.is_file():
                        retired += f.stat().st_size
                        retired_files += 1
                except OSError:
                    pass
        return {"live_bytes": live, "live_segments": len(segments),
                "retired_bytes": retired, "retired_files": retired_files}

    def purge_retired(self) -> int:
        """Delete every retired-*/ directory (call AFTER their history has
        been migrated to the new topology — reshard_snapshot's archive
        migration — or is otherwise expendable). Returns bytes
        reclaimed."""
        import shutil

        freed = 0
        for d in self.dir.glob("retired-*"):
            for f in d.rglob("*"):
                if f.is_file():
                    freed += f.stat().st_size
            shutil.rmtree(d)
        return freed

    def note_lost(self, count: int) -> None:
        """Record rows that wrapped before spooling (mis-sized trigger —
        surfaced in metrics the way the feed reports ``lag_lost``)."""
        self.lost_rows += int(count)

    # ------------------------------------------------------------- query
    def get_row(self, part: int, pos: int) -> dict | None:
        """Fetch one archived row by (partition, absolute position) — the
        by-id lookup for events evicted from the ring. Returns the ring
        column layout as a dict, or None if the position was never
        spilled."""
        seg = self._segment_for(part, pos)
        if seg is None:
            return None
        cols = self._segment_cols(seg)
        if cols is None:
            return None
        i = pos - seg.start
        if not bool(cols["valid"][i]):
            return None
        return {c: cols[c][i] for c in _COLUMNS}

    def _segment_for(self, part: int, pos: int) -> "_Segment | None":
        import bisect

        segs = self._by_part.get(part)
        if not segs:
            return None
        i = bisect.bisect_right(segs, pos, key=lambda s: s.start) - 1
        if i >= 0 and segs[i].start <= pos < segs[i].start + segs[i].count:
            return segs[i]
        return None

    def next_start(self, part: int, pos: int) -> int | None:
        """First archived position strictly after ``pos`` that is on disk
        — where replay resumes after a recorded-loss gap."""
        import bisect

        segs = self._by_part.get(part)
        if not segs:
            return None
        i = bisect.bisect_right(segs, pos, key=lambda s: s.start)
        return segs[i].start if i < len(segs) else None

    def _segment_cols(self, seg: "_Segment") -> dict | None:
        return self._cols_or_drop(seg, _COLUMNS)

    def read_rows(self, part: int, start: int, count: int):
        """Contiguous archived rows [start, start+n) of a partition as a
        StoreSlice-compatible column namespace (n <= count; one segment per
        call — callers loop). Returns (cols, n); n == 0 means the range is
        not on disk (never spilled, or a recorded-loss gap — see
        :meth:`next_start`). Bisect lookup + the shared LRU decode cache,
        so chunked replay never rescans the index or re-extracts a segment
        file."""
        import types

        seg = self._segment_for(part, start)
        if seg is None:
            return None, 0
        i = start - seg.start
        n = min(count, seg.count - i)
        cols = self._segment_cols(seg)
        if cols is None:
            return None, 0
        return types.SimpleNamespace(
            **{c: cols[c][i:i + n] for c in _COLUMNS}), n

    def query(self, *, max_pos: dict[int, int] | None = None,
              device: int | None = None, etype: int | None = None,
              tenant: int | None = None, since_ms: int | None = None,
              until_ms: int | None = None, assignment: int | None = None,
              aux0: int | None = None, aux1: int | None = None,
              area: int | None = None, customer: int | None = None,
              limit: int = 100,
              device_parts: frozenset[int] | None = None,
              assignment_parts: frozenset[int] | None = None,
              ) -> tuple[int, list[dict]]:
        """Newest-first filtered scan over archived rows, with PUSHDOWN.

        The :class:`SegmentPlanner` evaluates the predicate set against
        every segment's zone maps + blooms first; only survivors are
        decoded (newest-first), the scan stops materializing candidates
        once the page is provably complete, provably-full-match segments
        contribute their stored row count without being decoded at all,
        and only the columns the query touches load from disk — the final
        page winners are the only rows whose payload columns materialize.
        Results (total AND rows, ts-tie ordering included) are
        byte-identical to :meth:`query_unpruned`, the retained full-scan
        reference — pinned by tests/test_archive_pushdown.py and the
        smoke-bench archive gate.

        ``max_pos[part]`` caps the scan at rows already EVICTED from that
        partition's ring (absolute position < max_pos) so ring + archive
        results never overlap. ``device_parts``/``assignment_parts`` scope
        a shard-LOCAL id filter to the partitions of its owning shard (mesh
        engines — the id namespaces repeat per shard). Returns
        (total_matching, top rows) where each row is a plain dict of
        scalars/arrays in ring column layout plus ``part``/``pos``.

        Implementation: a one-request :meth:`query_batch` — the batched
        entry point is the product path (one planner call per batcher
        round); this wrapper keeps the historical signature for direct
        callers (DistributedEngine._merge_archive, tests, the oracle
        parity matrix)."""
        return self.query_batch(
            [{"limit": limit, "filters": dict(
                device=device, etype=etype, tenant=tenant,
                assignment=assignment, aux0=aux0, aux1=aux1, area=area,
                customer=customer, since_ms=since_ms, until_ms=until_ms,
                device_parts=device_parts,
                assignment_parts=assignment_parts)}],
            max_pos=max_pos)[0]

    @property
    def planner(self) -> SegmentPlanner:
        """The shared planner — the analytics job manager (models/analytics)
        plans its streaming rounds through the same vectorized tables the
        query path uses, cost accounting included."""
        return self._planner

    @property
    def planner_calls(self) -> int:
        """Planning passes served (shared-table evaluations, one per
        plan/plan_batch call) — the swtpu_archive_planner_calls_total
        source; a batcher round contributes exactly 1."""
        return self._planner.calls

    def query_batch(self, requests: list, *,
                    max_pos: dict[int, int] | None = None) -> list:
        """Serve N pushdown queries against ONE planner call: each request
        is ``{"limit": n, "filters": {...}}`` in :class:`SegmentPlanner`
        filter-kwarg shape,
        all sharing one eviction-cap capture (``max_pos`` — the batcher
        round snapshots cursors once). Per-request results are
        byte-identical to a standalone :meth:`query` with the same
        arguments (pinned in tests/test_archive_pushdown.py); segment
        decodes still dedupe across requests through the LRU
        :class:`SegmentCache`."""
        plans = self._planner.plan_batch(
            [r["filters"] for r in requests], max_pos=max_pos)
        out = []
        for req, (plan_rows, considered) in zip(requests, plans):
            self.queries += 1
            self.plan_considered += considered
            self.plan_pruned += considered - len(plan_rows)
            out.append(self._scan_planned(
                plan_rows, max_pos, max(0, int(req["limit"])),
                req["filters"]))
        return out

    def _scan_planned(self, plan_rows: list, max_pos, limit: int,
                      filters: dict) -> tuple[int, list[dict]]:
        """The post-plan decode/materialize pass of one pushdown query —
        the body :meth:`query` always had, factored so query_batch can
        run it per request behind a single shared planning pass. Must
        stay byte-identical to the retained :meth:`query_unpruned`
        oracle. ``limit`` <= 0 is a count-only page: (total, []) —
        matches the oracle's limit=0 behavior (Engine clamps to >= 1,
        but the distributed path forwards the caller's limit
        verbatim)."""
        from sitewhere_tpu_torch.ops.query import host_filter_mask

        device = filters.get("device")
        etype = filters.get("etype")
        tenant = filters.get("tenant")
        assignment = filters.get("assignment")
        aux0 = filters.get("aux0")
        aux1 = filters.get("aux1")
        area = filters.get("area")
        customer = filters.get("customer")
        since_ms = filters.get("since_ms")
        until_ms = filters.get("until_ms")
        pred_cols = ["valid", "ts_ms"]
        for col, v in (("device", device), ("etype", etype),
                       ("tenant", tenant), ("assignment", assignment),
                       ("area", area), ("customer", customer)):
            if v is not None:
                pred_cols.append(col)
        if aux0 is not None or aux1 is not None:
            pred_cols.append("aux")
        total = 0
        # page candidates: (ts, scan_order, rank_in_segment, seg, row).
        # Sorting by (-ts, scan_order, rank) reproduces the reference
        # merge exactly: the full scan appends per-segment newest-first
        # pages in (part, start) order and stable-sorts on -ts, so ties
        # resolve by scan order then in-segment rank.
        kept: list[tuple[int, int, int, _Segment, int]] = []
        kth: int | None = None
        decoded: set[str] = set()
        for order_i, seg, full_match, ts_hi, cap_covers in plan_rows:
            # the page is CLOSED to this segment when it already holds
            # ``limit`` rows all strictly newer than anything the segment
            # can contain (strict: an equal-ts row could still win its
            # tie-break on scan order)
            page_closed = kth is not None and kth > ts_hi
            if page_closed and full_match:
                # zone maps prove every valid row matches and the cap
                # covers the segment: count it without touching the file
                total += seg.stats["rows"]
                self.count_shortcuts += 1
                continue
            need = ("valid", "ts_ms") if full_match else tuple(pred_cols)
            cols = self._cols_or_drop(seg, need)
            if cols is None:
                continue   # quarantined mid-query: rows unavailable
            decoded.add(seg.path)
            m = cols["valid"].astype(bool)
            if max_pos is not None and not cap_covers:
                cap = min(seg.count, max_pos.get(seg.part, 0) - seg.start)
                m[cap:] = False
            if not full_match:
                m &= host_filter_mask(
                    cols, device=device, etype=etype, tenant=tenant,
                    assignment=assignment, aux0=aux0, aux1=aux1,
                    area=area, customer=customer, since_ms=since_ms,
                    until_ms=until_ms)
            idx = np.nonzero(m)[0]
            total += int(idx.size)
            if page_closed or not idx.size:
                continue
            ts = cols["ts_ms"]
            sel = idx[np.argsort(-ts[idx], kind="stable")][:limit]
            kept.extend((int(ts[i]), order_i, j, seg, int(i))
                        for j, i in enumerate(sel))
            kept.sort(key=lambda t: (-t[0], t[1], t[2]))
            del kept[limit:]
            kth = kept[-1][0] if kept and len(kept) == limit else None
        self.plan_decoded += len(decoded)
        rows: list[dict] = []
        for ts_v, order_i, j, seg, i in kept:
            cols = self._cols_or_drop(seg, _COLUMNS)
            if cols is None:
                continue   # payload columns rotted behind good pred cols
            row = {c: cols[c][i] for c in _COLUMNS}
            row["part"] = seg.part
            row["pos"] = seg.start + i
            rows.append(row)
        return total, rows

    def query_unpruned(self, *, max_pos: dict[int, int] | None = None,
                       device: int | None = None, etype: int | None = None,
                       tenant: int | None = None, since_ms: int | None = None,
                       until_ms: int | None = None,
                       assignment: int | None = None,
                       aux0: int | None = None, aux1: int | None = None,
                       area: int | None = None, customer: int | None = None,
                       limit: int = 100,
                       device_parts: frozenset[int] | None = None,
                       assignment_parts: frozenset[int] | None = None,
                       ) -> tuple[int, list[dict]]:
        """The pre-pushdown full scan, kept VERBATIM as the parity oracle:
        decodes every eligible segment with its own ``np.load`` and
        filters row-by-row. :meth:`query` must return byte-identical
        (total, rows) — the smoke bench hard-gates it and the pushdown
        tests pin it across tie/bloom/gap edge cases."""
        total = 0
        top: list[tuple[int, dict]] = []
        for seg in self.segments:
            if max_pos is not None and seg.start >= max_pos.get(seg.part, 0):
                continue
            if since_ms is not None and seg.ts_max < since_ms:
                continue
            if until_ms is not None and seg.ts_min > until_ms:
                continue
            if device is not None and device_parts is not None \
                    and seg.part not in device_parts:
                continue
            with np.load(self.dir / seg.path) as z:
                m = np.asarray(z["valid"], bool).copy()
                cap = seg.count
                if max_pos is not None:
                    cap = min(cap, max_pos.get(seg.part, 0) - seg.start)
                    m[cap:] = False
                if device is not None:
                    m &= np.asarray(z["device"]) == device
                if etype is not None:
                    m &= np.asarray(z["etype"]) == etype
                if tenant is not None:
                    m &= np.asarray(z["tenant"]) == tenant
                if assignment is not None:
                    if assignment_parts is not None \
                            and seg.part not in assignment_parts:
                        m[:] = False
                    else:
                        m &= np.asarray(z["assignment"]) == assignment
                if aux0 is not None:
                    m &= np.asarray(z["aux"])[:, 0] == aux0
                if aux1 is not None:
                    m &= np.asarray(z["aux"])[:, 1] == aux1
                if area is not None:
                    m &= np.asarray(z["area"]) == area
                if customer is not None:
                    m &= np.asarray(z["customer"]) == customer
                ts = np.asarray(z["ts_ms"])
                if since_ms is not None:
                    m &= ts >= since_ms
                if until_ms is not None:
                    m &= ts <= until_ms
                idx = np.nonzero(m)[0]
                total += int(idx.size)
                if not idx.size:
                    continue
                # keep only this segment's newest ``limit`` matches
                order = idx[np.argsort(-ts[idx], kind="stable")][:limit]
                cols = {c: np.asarray(z[c])[order] for c in _COLUMNS}
                for j, i in enumerate(order):
                    row = {c: cols[c][j] for c in _COLUMNS}
                    row["part"] = seg.part
                    row["pos"] = seg.start + int(i)
                    top.append((int(ts[i]), row))
        top.sort(key=lambda t: -t[0])
        return total, [r for _, r in top[:limit]]
