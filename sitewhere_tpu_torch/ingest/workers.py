"""Sharded arena decode on host threads (port of ``ShardedArenaDecoder`` in
``sitewhere_tpu/ingest/workers.py``; its multiprocess ``DecodeWorkerPool``
is not ported).

One wire batch splits across N threads by payload bytes; each thread
decodes a contiguous payload range into the matching disjoint row range
of the same :class:`~sitewhere_tpu_torch.ingest.arena.StagingArena`
through ``swtpu_shard_decode_arena_pylist``. The native scans release the
GIL, so the shards run in parallel on the host's cores.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

# One process-wide thread pool behind every engine's sharded decode: the
# threads are fungible across engines (the scans release the GIL), and a
# shared pool keeps many engines in one process from piling up threads.
_shard_pool = None
_shard_pool_lock = threading.Lock()


def _shard_executor():
    global _shard_pool
    with _shard_pool_lock:
        if _shard_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _shard_pool = ThreadPoolExecutor(
                max_workers=max(1, (os.cpu_count() or 2) - 1),
                thread_name_prefix="swtpu-shard")
    return _shard_pool


class ShardedArenaDecoder:
    """Drop-in for ``NativeBatchDecoder.decode_into`` decoded by up to
    ``n_workers`` shards.

    Determinism contract: arena contents, interner id assignment included,
    are byte-identical to the single-threaded ``decode_into``. Strings not
    yet in the shared interners go to per-shard overlay tables and their
    uses become patch records; the serial merge interns the overlay tails
    in shard order, which is first-occurrence row order (shards are
    ordered contiguous row ranges, and each overlay assigns local ids in
    first-occurrence order), then applies the patches as vectorized
    scatters. Known divergence, as in the JAX package: within one row, a
    first-seen measurement name whose lane collides with an already-known
    name's lane applies after the scan instead of in key order — reachable
    only under lane aliasing, which the single path also resolves by
    aliasing. The caller holds the engine lock, which keeps the shared
    interners read-only during the scans."""

    # below this many payloads per shard the thread and merge overhead
    # beats the parallel scan: the batch decodes single-threaded
    min_shard_payloads = 64

    def __init__(self, decoder, n_workers: int):
        if not decoder.has_shard:
            raise RuntimeError("sharded decode entry points unavailable")
        if n_workers < 1:
            raise ValueError("need at least one decode worker")
        self.decoder = decoder
        self.lib = decoder.lib
        self.py_lib = decoder.py_lib
        self.n_workers = n_workers
        self.sharded_batches = 0
        self._ctxs = [self.lib.swtpu_shard_create(decoder.handle)
                      for _ in range(n_workers)]

    def decode_into(self, payloads, arena, lo: int,
                    *, binary: bool = False) -> tuple[int, int]:
        n = len(payloads)
        if lo + n > arena.rows:
            raise ValueError(f"{n} payloads exceed arena room "
                             f"{arena.rows - lo}")
        k = min(self.n_workers, n // self.min_shard_payloads)
        if k <= 1 or type(payloads) is not list:
            return self.decoder.decode_into(payloads, arena, lo, binary=binary)
        cum = np.cumsum(np.fromiter(map(len, payloads), np.int64, n))
        total = int(cum[-1])
        # contiguous payload ranges cut at ~equal byte boundaries: the scan
        # cost tracks bytes, and contiguity is what makes shard order ==
        # row order (the determinism argument)
        cuts = np.searchsorted(cum, (total * np.arange(1, k)) // k,
                               side="left") + 1
        bounds = [0]
        for b in cuts:
            b = int(min(b, n))
            if b > bounds[-1]:
                bounds.append(b)
        if bounds[-1] != n:
            bounds.append(n)
        used = len(bounds) - 1
        if used <= 1:
            return self.decoder.decode_into(payloads, arena, lo, binary=binary)
        pool = _shard_executor()
        futs = [pool.submit(self._decode_shard, w, payloads, bounds[w],
                            bounds[w + 1] - bounds[w], arena, lo + bounds[w],
                            binary)
                for w in range(1, used)]
        first = self._decode_shard(0, payloads, 0, bounds[1], arena, lo, binary)
        results = [first] + [f.result() for f in futs]
        if any(r is None for r in results):
            # a shard saw a non-bytes item: redo the whole range on the
            # single path (shards never touched the shared interners, so
            # the retry has no side effects to undo)
            return self.decoder.decode_into(payloads, arena, lo, binary=binary)
        n_ok = sum(r[0] for r in results)
        collisions = sum(r[1] for r in results)
        ok_drop, extra_coll = self._merge(used, arena, bounds, lo)
        self.sharded_batches += 1
        return n_ok - ok_drop, collisions + extra_coll

    def _decode_shard(self, w: int, payloads, start: int, cnt: int,
                      arena, row0: int, binary: bool):
        collisions = ctypes.c_int32(0)
        args = self.decoder.arena_out_args(arena, row0, row0 + cnt, collisions)
        n_ok = int(self.py_lib.swtpu_shard_decode_arena_pylist(
            self._ctxs[w], payloads, np.int32(start), np.int32(cnt),
            np.int32(self.decoder.channels), *args,
            np.int32(1 if binary else 0)))
        if n_ok < 0:
            return None
        return n_ok, int(collisions.value)

    def _merge(self, used: int, arena, bounds, lo: int) -> tuple[int, int]:
        """Interner-tail merge and patch application, serial, under the
        engine lock. Patch scatters only overwrite cells still holding the
        matching provisional id (-2 - idx): a later occurrence of the key
        may have replaced it. Returns (ok_rows_dropped,
        extra_lane_collisions)."""
        c = ctypes
        lib = self.lib
        dec = self.decoder
        handles = (dec.tokens.handle, dec.names.handle,
                   dec.alert_types.handle, dec.event_ids.handle)
        channels = dec.channels
        sbuf = c.create_string_buffer(1024)
        ok_drop = 0
        extra_coll = 0

        def ptr(a, t):
            return a.ctypes.data_as(c.POINTER(t))

        for w in range(used):
            ctx = self._ctxs[w]
            row0 = lo + bounds[w]
            maps = []
            for kind in range(4):
                cnt = int(lib.swtpu_shard_new_count(ctx, np.int32(kind)))
                m = np.empty(cnt, np.int32)
                for i in range(cnt):
                    ln = int(lib.swtpu_shard_new_string(
                        ctx, np.int32(kind), np.int32(i), sbuf, 1024))
                    m[i] = int(lib.swtpu_intern(
                        handles[kind], sbuf.raw[:ln], np.int32(ln)))
                maps.append(m)
            for kind in range(4):
                pc = int(lib.swtpu_shard_patch_count(ctx, np.int32(kind)))
                if not pc:
                    continue
                rows = np.empty(pc, np.int32)
                idxs = np.empty(pc, np.int32)
                vals = np.empty(pc, np.float32)
                lib.swtpu_shard_patch_fetch(
                    ctx, np.int32(kind), ptr(rows, c.c_int32),
                    ptr(idxs, c.c_int32), ptr(vals, c.c_float))
                rows = rows + np.int32(row0)
                if kind == 0:      # device tokens
                    fin = maps[kind][idxs]
                    hit = arena.token_id[rows] == (-2 - idxs)
                    r, f = rows[hit], fin[hit]
                    arena.token_id[r] = f
                    bad = f < 0
                    if bad.any():
                        # interner capacity exhausted during the merge: the
                        # row becomes a decode failure, like the direct
                        # path's interner-full rejection
                        rb = r[bad]
                        ok_drop += int(np.sum(arena.rtype[rb] >= 0))
                        arena.rtype[rb] = -1
                        arena.token_id[rb] = -1
                elif kind == 1:    # measurement names -> value lanes
                    # idx >= 0: overlay id (mapped through the merged tail,
                    # its collision counted here against the final id);
                    # idx < 0: a known name deferred for key-order replay,
                    # its final id bit-inverted, its collision already
                    # counted at scan time
                    direct = idxs < 0
                    fin = np.where(direct, ~idxs,
                                   maps[kind][np.where(direct, 0, idxs)])
                    good = fin >= 0
                    extra_coll += int(np.sum(fin[good & ~direct] >= channels))
                    f = fin[good]
                    # in-order scatter: a repeated (row, lane) keeps the
                    # last write, as the single-threaded key order does
                    arena.values[rows[good], f % channels] = vals[good]
                    arena.vmask[rows[good], f % channels] = 1
                else:              # alert types (aux0) / alternate ids (aux1)
                    fin = maps[kind][idxs]
                    lane = 0 if kind == 2 else 1
                    hit = arena.aux[rows, lane] == (-2 - idxs)
                    arena.aux[rows[hit], lane] = np.where(
                        fin[hit] >= 0, fin[hit], -1)
        return ok_drop, extra_coll

    def close(self) -> None:
        for ctx in self._ctxs:
            self.lib.swtpu_shard_destroy(ctx)
        self._ctxs = []
