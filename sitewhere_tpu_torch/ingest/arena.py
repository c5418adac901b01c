"""Zero-copy ingest staging arenas (port of ``sitewhere_tpu/ingest/arena.py``).

A :class:`StagingArena` is one preallocated SoA buffer holding both the
decoder's scratch columns (``rtype``/``ts64``/``level``) and the final
``EventBatch`` columns. The native scanner writes straight into the final
columns (the ``swtpu_decode_arena_*`` entry points take the arena's
column slices, the two ``aux`` lanes strided), the commit pass runs a few
vectorized in-place transforms, and the dispatch copies the same buffers
to the device — no row-level Python, no staging copy, no allocation per
batch.

On a CUDA engine every final column is one page-locked torch tensor
(``pin_memory=True``), allocated once per pool; the host code works on
numpy views of those tensors, and :meth:`StagingArena.view_batch` copies
them to the card with ``non_blocking=True``. That copy is still reading
the pinned buffers after it returns, so an arena may be refilled only
after the work that read it has finished: the :class:`ArenaPool` retires
each dispatched arena with a ticket, a ``torch.cuda.Event`` recorded on
the stream that ran both the copy and the step, and recycles it once the
ticket has completed. On a CPU engine the columns are ordinary tensors
and the step has run by the time it returns: the ticket is None.

An arena also carries the flight records of the batches staged in it
(``traces``): the recycle observes the ticket complete, so it stamps
their ``device_ready`` without a sync of its own.

With ``dispatch_depth`` >= 2 and more arenas than that depth, the decode
of batch N+1 overlaps the copy and the step of batch N. An exhausted pool
waits on the oldest in-flight dispatch (backpressure, counted in
``waits``) rather than allocating.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from sitewhere_tpu_torch.core.events import EventBatch
from sitewhere_tpu_torch.core.types import AUX_LANES, NULL_ID

# the EventBatch columns an arena carries to the device, in field order
_COLUMNS = ("valid", "etype", "token_id", "tenant_id", "ts_ms",
            "received_ms", "values", "vmask", "aux", "seq")


class ArenaStallError(RuntimeError):
    """``ArenaPool.acquire`` gave up waiting on a wedged in-flight dispatch
    (``timeout_s`` exceeded): raised instead of hanging the ingest thread
    under the engine lock."""


class StagingArena:
    """One preallocated SoA staging buffer of ``rows`` event slots.

    ``rows`` is ``batch_capacity * scan_chunk``: with ``scan_chunk`` K > 1
    the arena is consumed as K lanes of ``rows // K`` by the arena scan
    step (``pipeline.make_arena_scan_step``); the ``seq`` column is tiled
    per lane. ``cursor`` is the fill position; rows past the cursor at
    dispatch are masked invalid (free padding).

    The final columns live in ``tensors`` (page-locked with ``pin``); the
    attributes of the same names are numpy views of them, which the
    decoder and the commit write. ``vmask`` is uint8 storage (the decoder
    ABI's type), handed to the step viewed as bool."""

    __slots__ = ("rows", "channels", "lanes", "cursor", "traces", "tensors",
                 "valid", "etype", "token_id", "tenant_id", "ts_ms",
                 "received_ms", "values", "vmask", "aux", "seq",
                 "rtype", "ts64", "level")

    def __init__(self, rows: int, channels: int, lanes: int = 1,
                 pin: bool = False):
        if rows % max(1, lanes):
            raise ValueError(f"arena rows {rows} not divisible by "
                             f"{lanes} scan lanes")
        self.rows = rows
        self.channels = channels
        self.lanes = max(1, lanes)
        self.cursor = 0
        self.traces: list = []   # flight records of batches staged here

        def col(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, pin_memory=pin)

        i32 = torch.int32
        self.tensors = {
            "valid": col((rows,), torch.bool, False),
            "etype": col((rows,), i32),
            "token_id": col((rows,), i32, NULL_ID),
            "tenant_id": col((rows,), i32, NULL_ID),
            "ts_ms": col((rows,), i32),
            "received_ms": col((rows,), i32),
            "values": col((rows, channels), torch.float32),
            "vmask": col((rows, channels), torch.uint8),
            "aux": col((rows, AUX_LANES), i32, NULL_ID),
            "seq": col((rows,), i32),
        }
        for name, t in self.tensors.items():
            setattr(self, name, t.numpy())
        self.seq[:] = np.tile(np.arange(rows // self.lanes, dtype=np.int32),
                              self.lanes)
        # decoder scratch columns (host-only, never transferred)
        self.rtype = np.empty(rows, np.int32)
        self.ts64 = np.empty(rows, np.int64)
        self.level = np.empty(rows, np.int32)

    @property
    def room(self) -> int:
        return self.rows - self.cursor

    @property
    def nbytes(self) -> int:
        """Host bytes this arena holds: the final columns and the decoder
        scratch, all allocated for the arena's lifetime (the memory
        ledger's per-arena unit)."""
        return sum(v.nbytes for name in self.__slots__
                   if isinstance((v := getattr(self, name)), np.ndarray))

    def view_batch(self, device: torch.device) -> EventBatch:
        """The full-capacity EventBatch of the arena's columns on
        ``device``: asynchronous copies from the pinned buffers on a CUDA
        device, the arena's own tensors on the CPU (rows past the cursor
        must already be masked invalid by the dispatcher)."""
        cols = {name: self.tensors[name].to(device, non_blocking=True)
                for name in _COLUMNS}
        cols["vmask"] = cols["vmask"].view(torch.bool)
        return EventBatch(**cols)

    def reset(self) -> None:
        """Make the arena fillable again. Stale column contents are inert
        (every row is dead until the next commit sets its ``valid``); the
        valid mask itself is cleared so a stale True can never leak
        through a partial dispatch."""
        self.cursor = 0
        self.traces = []
        self.valid[:] = False


class ShardedStagingArena:
    """Stacked ``[n_shards, rows]`` staging arena of the multi-shard
    engine (port of ``sitewhere_tpu/ingest/arena.py:ShardedStagingArena``).

    Each shard owns one lane of ``rows`` slots (C-order, so a lane is one
    contiguous slab) with its own fill ``cursors[s]``; the batch path
    scatters routed rows into the lanes, and :meth:`view_batches` copies
    lane ``s`` to shard ``s``'s device, one ``non_blocking`` copy per
    column from page-locked memory (``pin``), and hands each shard its
    EventBatch. With ``lanes`` (= scan_chunk) K > 1 each shard's lane is
    consumed as K chunks of ``rows // K``. The decode runs before the
    scatter, so only final EventBatch columns live here. The pool retires
    a dispatched arena with a ticket that completes once every shard's
    copy and step have."""

    __slots__ = ("n_shards", "rows", "channels", "lanes", "cursors",
                 "traces", "tensors", "valid", "etype", "token_id",
                 "tenant_id", "ts_ms", "received_ms", "values", "vmask",
                 "aux", "seq")

    def __init__(self, n_shards: int, rows: int, channels: int,
                 lanes: int = 1, pin: bool = False):
        if rows % max(1, lanes):
            raise ValueError(f"arena rows {rows} not divisible by "
                             f"{lanes} scan lanes")
        self.n_shards = n_shards
        self.rows = rows
        self.channels = channels
        self.lanes = max(1, lanes)
        self.cursors = np.zeros(n_shards, np.int64)
        self.traces: list = []
        s = n_shards

        def col(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, pin_memory=pin)

        i32 = torch.int32
        self.tensors = {
            "valid": col((s, rows), torch.bool, False),
            "etype": col((s, rows), i32),
            "token_id": col((s, rows), i32, NULL_ID),
            "tenant_id": col((s, rows), i32, NULL_ID),
            "ts_ms": col((s, rows), i32),
            "received_ms": col((s, rows), i32),
            "values": col((s, rows, channels), torch.float32),
            "vmask": col((s, rows, channels), torch.uint8),
            "aux": col((s, rows, AUX_LANES), i32, NULL_ID),
            "seq": col((s, rows), i32),
        }
        for name, t in self.tensors.items():
            setattr(self, name, t.numpy())
        self.seq[:] = np.tile(np.arange(rows // self.lanes, dtype=np.int32),
                              self.lanes)

    @property
    def cursor(self) -> int:
        """Rows staged over every lane (flush callers test its truth)."""
        return int(self.cursors.sum())

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors.values())

    def view_batches(self, mesh: list[torch.device]) -> list[EventBatch]:
        """One EventBatch a shard, lane ``s`` on ``mesh[s]`` (asynchronous
        copies from pinned memory to a card; the arena's own tensors on
        the CPU). Lanes past each shard's cursor must already be masked
        invalid by the dispatcher."""
        out = []
        for s, dev in enumerate(mesh):
            cols = {name: self.tensors[name][s].to(dev, non_blocking=True)
                    for name in _COLUMNS}
            cols["vmask"] = cols["vmask"].view(torch.bool)
            out.append(EventBatch(**cols))
        return out

    def reset(self) -> None:
        self.cursors[:] = 0
        self.valid[:] = False
        self.traces = []


class ArenaPool:
    """Fixed pool of staging arenas rotating through in-flight dispatches.

    Not thread-safe by itself: the engine serializes acquire and retire
    under its lock. A ticket is anything with ``query()`` (completed,
    without blocking) and ``synchronize()`` (block until completed) — the
    engine's ``torch.cuda.Event`` — or None for work that has already
    run. ``factory`` makes another arena type (the multi-shard engine
    pools :class:`ShardedStagingArena`); the pool needs only ``reset()``,
    ``nbytes`` and ``traces`` of its arenas."""

    def __init__(self, n_arenas: int, rows: int, channels: int,
                 lanes: int = 1, pin: bool = False, factory=None):
        if n_arenas < 1:
            raise ValueError("arena pool needs at least one arena")
        self.n_arenas = n_arenas
        make = factory or (lambda: StagingArena(rows, channels, lanes, pin))
        self._free: list = [make() for _ in range(n_arenas)]
        self._inflight: collections.deque = collections.deque()
        self.waits = 0   # times acquire had to block on the oldest dispatch
        self._occupancy_hwm = 0   # most arenas out of the free list at once
        # per-arena footprint, cached: it must hold even while every arena
        # is checked out
        self._arena_nbytes = self._free[0].nbytes

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)

    @property
    def nbytes(self) -> int:
        """Host bytes of the pool's staging buffers (page-locked on a CUDA
        engine): free, filling and in-flight arenas stay allocated for the
        pool's lifetime."""
        return self.n_arenas * self._arena_nbytes

    def take_occupancy_hwm(self, reset: bool = True) -> int:
        """Most arenas out of the free pool at once since the last reset
        (the scrape resets; peeks pass ``reset=False``)."""
        current = self.n_arenas - len(self._free)
        hwm = max(self._occupancy_hwm, current)
        if reset:
            self._occupancy_hwm = current
        return hwm

    def acquire(self, timeout_s: float | None = None) -> StagingArena:
        """A fillable arena; blocks on the oldest in-flight dispatch when
        every arena is tied up (ingest backpressure). With ``timeout_s``
        the wait is bounded: a dispatch that never completes raises
        :class:`ArenaStallError` instead of hanging."""
        self._reclaim_ready()
        if not self._free:
            self.waits += 1
            self._reclaim_oldest(timeout_s)
        arena = self._free.pop()
        occupied = self.n_arenas - len(self._free)
        if occupied > self._occupancy_hwm:
            self._occupancy_hwm = occupied
        return arena

    def retire(self, arena: StagingArena, ticket, traces=()) -> None:
        """Hand a dispatched arena back; it recycles once ``ticket`` has
        completed. ``traces`` are the flight records of its batches: they
        ride the arena while it is in flight, and the recycle, which
        observes the ticket, stamps their ``device_ready`` at no extra
        sync."""
        arena.traces = list(traces)
        self._inflight.append((arena, ticket))

    @staticmethod
    def _mark_ready(traces) -> None:
        # overwrite, like every stage mark: a batch spanning several
        # arenas keeps its last chunk's readiness — but never after its
        # readback, which already observed every chunk complete
        for rec in traces:
            if "readback" not in rec.stages:
                rec.mark("device_ready")

    def _reclaim_oldest(self, timeout_s: float | None = None) -> None:
        ticket = self._inflight[0][1]
        if timeout_s is not None and ticket is not None:
            # bounded wait: poll the ticket and refuse to pop an arena we
            # may never get back
            deadline = time.monotonic() + timeout_s
            while not ticket.query():
                if time.monotonic() >= deadline:
                    raise ArenaStallError(
                        f"arena recycle stalled: oldest of "
                        f"{len(self._inflight)} in-flight dispatch(es) "
                        f"not ready after {timeout_s:.3f}s")
                time.sleep(min(0.001, timeout_s / 10))
        arena, ticket = self._inflight.popleft()
        if ticket is not None:
            ticket.synchronize()
        self._mark_ready(arena.traces)
        arena.reset()
        self._free.append(arena)

    def _reclaim_ready(self) -> None:
        """Recycle arenas whose dispatches already finished (no blocking)."""
        while self._inflight:
            ticket = self._inflight[0][1]
            if ticket is not None and not ticket.query():
                return
            arena, _ = self._inflight.popleft()
            self._mark_ready(arena.traces)
            arena.reset()
            self._free.append(arena)

    def drain(self) -> None:
        """Block until every in-flight arena is reclaimed."""
        while self._inflight:
            self._reclaim_oldest()
