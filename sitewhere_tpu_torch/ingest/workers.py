"""Host decode fan-out (port of ``sitewhere_tpu/ingest/workers.py``).

* :class:`ShardedArenaDecoder` — one wire batch splits across N threads by
  payload bytes; each thread decodes a contiguous payload range into the
  matching disjoint row range of the same
  :class:`~sitewhere_tpu_torch.ingest.arena.StagingArena` through
  ``swtpu_shard_decode_arena_pylist``. The native scans release the GIL,
  so the shards run in parallel on the host's cores.
* :class:`DecodeWorkerPool` — N decode processes, each running the C++
  scanner (native/src/swtpu.cpp) over wire batches in shared memory into
  a shared-memory SoA; the engine process translates dictionary ids and
  stages the columns into its (pinned) arena with one vectorised copy.

Dictionary federation: each worker owns local interners for device
tokens, measurement names, alert types and alternate ids (interner state
cannot be shared across processes). Workers report newly interned strings
once; the engine keeps per-worker translation tables, so steady-state
batches translate with numpy gathers. Measurement names also need a lane
permutation (a name's value lands in lane ``name_id % channels``, and
worker name ids diverge from the engine's); if a worker's lane mapping
ever becomes ambiguous the pool decodes that worker's batches in the
engine instead (``worker_fallback_batches``), trading speed for
exactness.

The workers are spawned processes that never import torch: this module,
``ingest/fast_decode.py`` and ``native/binding.py`` import numpy and the
standard library only, so a child neither pays a torch import nor can
create a CUDA context. The shared memory is ordinary (not page-locked):
the engine's absorb copies it into the pinned arena, and the arena's
``non_blocking`` copy moves it to the card.
"""

from __future__ import annotations

import ctypes
import multiprocessing as mp
import os
import threading
import time
from multiprocessing import shared_memory

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
        self.active_workers = n_workers   # the autotuner's fan-out knob
        self.last_workers = 1             # shards the last batch used
        self.sharded_batches = 0
        # span plumbing: the engine sets ``tracer`` once and
        # ``current_trace`` a batch (under its lock), so each shard's scan
        # records an ``ingest.shard_decode`` span on the batch's trace
        self.tracer = None
        self.current_trace: str | None = None
        self._ctxs = [self.lib.swtpu_shard_create(decoder.handle)
                      for _ in range(n_workers)]

    def set_active_workers(self, n: int) -> int:
        """Clamp and apply a new shard fan-out (the autotuner's hook)."""
        self.active_workers = max(1, min(int(n), self.n_workers))
        return self.active_workers

    def decode_into(self, payloads, arena, lo: int,
                    *, binary: bool = False) -> tuple[int, int]:
        n = len(payloads)
        if lo + n > arena.rows:
            raise ValueError(f"{n} payloads exceed arena room "
                             f"{arena.rows - lo}")
        k = min(self.active_workers, n // self.min_shard_payloads)
        if k <= 1 or type(payloads) is not list:
            self.last_workers = 1
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
            self.last_workers = 1
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
            self.last_workers = 1
            return self.decoder.decode_into(payloads, arena, lo, binary=binary)
        n_ok = sum(r[0] for r in results)
        collisions = sum(r[1] for r in results)
        ok_drop, extra_coll = self._merge(used, arena, bounds, lo)
        self.last_workers = used
        self.sharded_batches += 1
        return n_ok - ok_drop, collisions + extra_coll

    def _decode_shard(self, w: int, payloads, start: int, cnt: int,
                      arena, row0: int, binary: bool):
        collisions = ctypes.c_int32(0)
        t0 = time.perf_counter_ns()
        args = self.decoder.arena_out_args(arena, row0, row0 + cnt, collisions)
        n_ok = int(self.py_lib.swtpu_shard_decode_arena_pylist(
            self._ctxs[w], payloads, np.int32(start), np.int32(cnt),
            np.int32(self.decoder.channels), *args,
            np.int32(1 if binary else 0)))
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.record("ingest.shard_decode", t0, time.perf_counter_ns(),
                          trace_id=self.current_trace, shard=w, payloads=cnt)
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


_HDR = 8  # int64 header slots of shm_in: [n_msgs, buf_len, reserved...]


def _shm_arrays(buf, max_msgs: int, channels: int) -> dict[str, np.ndarray]:
    """Carve the output SoA views out of one shared-memory block."""
    b, c = max_msgs, channels
    off = 0

    def take(dtype, shape):
        nonlocal off
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        a = np.ndarray(shape, dtype, buffer=buf, offset=off)
        off += n
        return a

    return {
        "rtype": take(np.int32, (b,)),
        "token": take(np.int32, (b,)),
        "ts": take(np.int64, (b,)),
        "values": take(np.float32, (b, c)),
        "chmask": take(np.uint8, (b, c)),
        "aux0": take(np.int32, (b,)),
        "aux1": take(np.int32, (b,)),
        "level": take(np.int32, (b,)),
    }


def _out_bytes(max_msgs: int, channels: int) -> int:
    return max_msgs * (4 + 4 + 8 + 4 * channels + channels + 4 + 4 + 4)


def _worker_main(conn, in_name: str, out_name: str, max_msgs: int,
                 max_bytes: int, channels: int, token_capacity: int) -> None:
    """One decode worker: wire batch in shm_in -> SoA in shm_out. Replies
    ``("done", n_ok, collisions, new_tokens, new_names, new_alerts,
    new_eids)``, the ``new_*`` lists carrying the strings this batch
    interned first, in local-id order (the engine extends its translation
    tables from exactly these). Imports no torch."""
    from sitewhere_tpu_torch.ingest.fast_decode import NativeBatchDecoder
    from sitewhere_tpu_torch.native.binding import NativeInterner

    shm_in = shared_memory.SharedMemory(name=in_name)
    shm_out = shared_memory.SharedMemory(name=out_name)
    try:
        hdr = np.ndarray((_HDR,), np.int64, buffer=shm_in.buf)
        offsets = np.ndarray((max_msgs + 1,), np.int64, buffer=shm_in.buf,
                             offset=_HDR * 8)
        data_off = _HDR * 8 + (max_msgs + 1) * 8
        out = _shm_arrays(shm_out.buf, max_msgs, channels)
        tokens = NativeInterner(token_capacity)
        dec = NativeBatchDecoder(tokens, channels)
        n_tok = n_name = n_alert = n_eid = 0

        def tail(interner, since: int) -> list[str]:
            return [interner.token(i) for i in range(since, len(interner))]

        while True:
            msg = conn.recv()
            if msg is None:
                break
            n = int(hdr[0])
            payloads_buf = bytes(shm_in.buf[data_off:data_off + int(hdr[1])])
            # one scanner call over the whole batch, straight into shm
            n_ok, collisions = dec.decode_packed(
                payloads_buf, offsets, n, out["rtype"], out["token"],
                out["ts"], out["values"], out["chmask"], out["aux0"],
                out["aux1"], out["level"])
            new_tokens = tail(tokens, n_tok)
            new_names = tail(dec.names, n_name)
            new_alerts = tail(dec.alert_types, n_alert)
            new_eids = tail(dec.event_ids, n_eid)
            n_tok += len(new_tokens)
            n_name += len(new_names)
            n_alert += len(new_alerts)
            n_eid += len(new_eids)
            conn.send(("done", n_ok, collisions,
                       new_tokens, new_names, new_alerts, new_eids))
    finally:
        shm_in.close()
        shm_out.close()
        conn.close()


class _Worker:
    """One spawned decode process, its two shared-memory blocks and the
    engine-side translation state of its local dictionaries."""

    def __init__(self, max_msgs: int, max_bytes: int, channels: int,
                 token_capacity: int, ctx):
        in_bytes = _HDR * 8 + (max_msgs + 1) * 8 + max_bytes
        self.shm_in = shared_memory.SharedMemory(create=True, size=in_bytes)
        self.shm_out = shared_memory.SharedMemory(
            create=True, size=_out_bytes(max_msgs, channels))
        self.hdr = np.ndarray((_HDR,), np.int64, buffer=self.shm_in.buf)
        self.offsets = np.ndarray((max_msgs + 1,), np.int64,
                                  buffer=self.shm_in.buf, offset=_HDR * 8)
        self.data_off = _HDR * 8 + (max_msgs + 1) * 8
        self.out = _shm_arrays(self.shm_out.buf, max_msgs, channels)
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(
            target=_worker_main,
            args=(child, self.shm_in.name, self.shm_out.name, max_msgs,
                  max_bytes, channels, token_capacity),
            daemon=True)
        self.proc.start()
        child.close()
        self.tok_map = np.empty(0, np.int32)     # worker token -> engine
        self.alert_map = np.empty(0, np.int32)   # worker alert -> engine
        self.eid_map = np.empty(0, np.int32)     # worker alt-id -> engine
        self.lane_owner: dict[int, int] = {}     # worker lane -> engine lane
        self.elane_owner: dict[int, int] = {}    # engine lane -> worker lane
        self.n_names_seen = 0   # dense worker-local name ids handed out
        self.lane_conflict = False
        self.pending: tuple[list[bytes], str] | None = None

    def close(self) -> None:
        try:
            self.conn.send(None)
        except (BrokenPipeError, OSError):
            pass
        self.proc.join(timeout=5)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=5)
        self.conn.close()
        for shm in (self.shm_in, self.shm_out):
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass


class DecodeWorkerPool:
    """Round-robin pool of decode processes in front of one engine.

    ``submit()`` hands a wire batch to the next worker and returns at once
    (absorbing that worker's previous batch first if it is still out);
    ``flush()`` absorbs everything. The absorb's summaries have the shape
    of ``engine.ingest_json_batch``'s. Run it from a file-backed
    ``__main__`` (spawn re-imports it)."""

    def __init__(self, engine, n_workers: int | None = None,
                 max_msgs: int | None = None, max_bytes: int = 1 << 24):
        if engine._native_decoder is None:
            raise ValueError("DecodeWorkerPool needs a native engine "
                             "(use_native=True)")
        if engine.config.strict_channels:
            # the strict contract (reject and roll back a batch that would
            # exceed channel capacity) cannot be enforced from worker-local
            # interners: a colliding batch would be WAL-logged and staged
            # before the engine saw the collision
            raise ValueError(
                "DecodeWorkerPool does not support strict_channels engines;"
                " use the in-process ingest path")
        self.engine = engine
        self.channels = engine.config.channels
        self.n_workers = n_workers or max(1, (os.cpu_count() or 1) - 1)
        self.max_msgs = max_msgs or max(16384, engine.config.batch_capacity)
        self.max_bytes = max_bytes
        ctx = mp.get_context("spawn")   # children must not inherit torch
        self.workers: list[_Worker] = []
        try:
            for _ in range(self.n_workers):
                self.workers.append(_Worker(
                    self.max_msgs, max_bytes, self.channels,
                    engine.config.token_capacity, ctx))
        except BaseException:
            for w in self.workers:
                w.close()
            raise
        self._next = 0
        self.summaries: list[dict] = []
        self.fallback_batches = 0

    # ------------------------------------------------------------ engine side
    def _absorb(self, w: _Worker) -> dict | None:
        if w.pending is None:
            return None
        payloads, tenant = w.pending
        w.pending = None
        kind, n_ok, collisions, new_tokens, new_names, new_alerts, \
            new_eids = w.conn.recv()
        assert kind == "done"
        eng = self.engine
        # extend the translation tables from first-seen strings, under the
        # engine lock (the interners are shared with admin registration and
        # in-process ingest)
        with eng.lock:
            if new_tokens:
                w.tok_map = np.concatenate([
                    w.tok_map,
                    np.fromiter((eng.tokens.intern(t) for t in new_tokens),
                                np.int32, len(new_tokens))])
            if new_alerts:
                w.alert_map = np.concatenate([
                    w.alert_map,
                    np.fromiter((eng.alert_types.intern(t) for t in new_alerts),
                                np.int32, len(new_alerts))])
            if new_eids:
                w.eid_map = np.concatenate([
                    w.eid_map,
                    np.fromiter((eng.event_ids.intern(t) for t in new_eids),
                                np.int32, len(new_eids))])
            names = eng._native_decoder.names
            for name in new_names:
                wid = w.n_names_seen   # dense worker-local name id order
                w.n_names_seen += 1
                eid = names.intern(name)
                wlane, elane = wid % self.channels, eid % self.channels
                prev = w.lane_owner.get(wlane)
                if prev is None:
                    # the engine lane must not belong to a different worker
                    # lane already: a non-injective map would let one
                    # lane's scatter clobber the other's
                    if w.elane_owner.get(elane, wlane) != wlane:
                        w.lane_conflict = True
                    w.lane_owner[wlane] = elane
                    w.elane_owner[elane] = wlane
                elif prev != elane:
                    w.lane_conflict = True
        n = len(payloads)
        if w.lane_conflict:
            # an ambiguous lane permutation: exactness over speed, decode
            # this worker's batches in the engine from the raw payloads
            self.fallback_batches += 1
            with eng.lock:
                eng.host_counters["worker_fallback_batches"] = \
                    eng.host_counters.get("worker_fallback_batches", 0) + 1
            return eng.ingest_json_batch(payloads, tenant=tenant)
        from sitewhere_tpu_torch.engine import WAL_JSON
        from sitewhere_tpu_torch.ingest.decoders import JsonDeviceRequestDecoder
        from sitewhere_tpu_torch.ingest.fast_decode import (RT_ALERT,
                                                            RT_MEASUREMENT,
                                                            DecodedArrays)

        # shm views, not copies: the engine's staging (one vectorised copy
        # into the arena, or the copy path's buffer slices) completes
        # inside _ingest_decoded below, before this worker gets its next
        # batch
        o = w.out
        rtype = o["rtype"][:n]
        token = o["token"][:n]
        gtok = (w.tok_map[np.clip(token, 0, max(0, len(w.tok_map) - 1))]
                if len(w.tok_map) else np.full(n, -1, np.int32))
        gtok = np.where(rtype >= 0, gtok, -1).astype(np.int32)
        # scatter only the lanes that carry data (each has a name behind
        # it, hence an entry in lane_owner): an unmapped lane must never
        # overwrite a mapped engine lane
        if all(wl == el for wl, el in w.lane_owner.items()):
            values = o["values"][:n]
            chmask = o["chmask"][:n].astype(bool)
        else:
            wl = np.fromiter(w.lane_owner.keys(), np.int64, len(w.lane_owner))
            el = np.fromiter(w.lane_owner.values(), np.int64,
                             len(w.lane_owner))
            raw_v = o["values"][:n]
            raw_m = o["chmask"][:n].astype(bool)
            values = np.zeros((n, self.channels), np.float32)
            chmask = np.zeros((n, self.channels), bool)
            values[:, el] = raw_v[:, wl]
            chmask[:, el] = raw_m[:, wl]
            # the permutation comes from measurement names only; location
            # rows carry lat/lon/elevation in fixed lanes 0-2 and other
            # non-measurement rows use raw lanes: keep them as decoded
            nonmeas = rtype != RT_MEASUREMENT
            if np.any(nonmeas):
                values[nonmeas] = raw_v[nonmeas]
                chmask[nonmeas] = raw_m[nonmeas]
        aux0 = o["aux0"][:n]
        alert_rows = rtype == RT_ALERT
        if np.any(alert_rows) and len(w.alert_map):
            # in place on the shm view: the slot is dead until the
            # worker's next batch overwrites it
            aux0[alert_rows] = w.alert_map[
                np.clip(aux0[alert_rows], 0, len(w.alert_map) - 1)]
        aux1 = o["aux1"][:n]
        alt_rows = aux1 >= 0
        if np.any(alt_rows) and len(w.eid_map):
            aux1[alt_rows] = w.eid_map[
                np.clip(aux1[alt_rows], 0, len(w.eid_map) - 1)]
        res = DecodedArrays(
            n_ok=int(np.sum(rtype >= 0)), rtype=rtype, token_id=gtok,
            ts_ms64=o["ts"][:n], values=values, chmask=chmask,
            aux0=aux0, aux1=aux1, level=o["level"][:n],
            collisions=collisions)
        with eng.lock:
            eng._wal_append(WAL_JSON, payloads, tenant)
            # through the engine's staging arenas when it has them: one
            # vectorised shm -> pinned-arena copy
            return eng._ingest_decoded(res, payloads, tenant,
                                       JsonDeviceRequestDecoder())

    def submit(self, payloads: list[bytes], tenant: str = "default") -> None:
        """Queue one wire batch on the next worker (absorbing that worker's
        outstanding batch first: at most one batch in flight a worker)."""
        w = self.workers[self._next]
        self._next = (self._next + 1) % self.n_workers
        s = self._absorb(w)
        if s is not None:
            self.summaries.append(s)
        n = len(payloads)
        if n > self.max_msgs:
            raise ValueError(f"batch of {n} exceeds max_msgs {self.max_msgs}")
        lens = np.fromiter((len(p) for p in payloads), np.int64, n)
        total = int(lens.sum())
        if total > self.max_bytes:
            raise ValueError(
                f"batch of {total} payload bytes exceeds the pool's "
                f"max_bytes {self.max_bytes}; raise max_bytes or split "
                "the batch")
        w.offsets[0] = 0
        np.cumsum(lens, out=w.offsets[1:1 + n])
        buf = b"".join(payloads)
        w.shm_in.buf[w.data_off:w.data_off + len(buf)] = buf
        w.hdr[0], w.hdr[1] = n, len(buf)
        w.pending = (payloads, tenant)
        w.conn.send(("decode",))

    def flush(self) -> list[dict]:
        """Absorb every outstanding batch; returns their summaries."""
        out, self.summaries = self.summaries, []
        for w in self.workers:
            s = self._absorb(w)
            if s is not None:
                out.append(s)
        return out

    def stats(self) -> dict:
        return {
            "n_workers": self.n_workers,
            "fallback_batches": self.fallback_batches,
            "lane_conflicts": sum(1 for w in self.workers if w.lane_conflict),
        }

    def close(self) -> None:
        try:
            self.flush()
        finally:
            for w in self.workers:
                w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
