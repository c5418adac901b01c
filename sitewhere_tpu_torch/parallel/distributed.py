"""The mesh product engine (port of ``sitewhere_tpu/parallel/distributed.py``).

``ShardedEngine`` (parallel/sharded.py) runs the fused step over the shards
but takes pre-interned integer batches. :class:`DistributedEngine` is the
product on top, everything the single-card ``Engine`` offers over one state
a shard:

* string device tokens, interned once by the native C++ interner (or the
  Python one with ``use_native=False``) and routed to the owning shard:
  shard ``gid % n_shards`` owns interner id ``gid`` as its local token
  ``gid // n_shards``; global device and assignment ids are ``local *
  n_shards + shard``, so the host mirrors stay flat dicts;
* host staging of every shard at once (``_StackedBuffer``, page-locked on
  the card), one dispatch a flush: one copy a shard to its device and the
  single-card step on each (``ShardedEngine.step``), one fence a dispatch,
  outputs read back only in :meth:`DistributedEngine.drain`;
* the WAL, strict channels, ``process()`` and the batch skeleton of
  ``engine.IngestHostMixin`` (the same code as the single-card engine),
  the flight recorder, the span tracer and the conservation ledger;
* fair multi-tenant batch formation a shard, the archive spooler a
  (shard, arena) partition, admin CRUD, ``query_events`` with the archive
  merge, device-state reads and search, the presence sweep, ``get_event``,
  the outbound feed (:class:`DistributedFeedConsumer`), snapshot and WAL
  recovery (:func:`restore_distributed`, :func:`recover_distributed`).

The admin updaters are the single-card ones (``engine._admin_*``) applied
to the owning shard's state. Reads take the per-shard leaves they need in
one small gather and one device-to-host copy; ``state`` (the stacked copy
of every shard) is for save, restore and the tests. The snapshot is the
JAX package's: ``sharded_state.npz`` with its leaf keys and
``host_distributed.json``, whose ``config`` holds the JAX fields only (the
port-only ones ride in ``port_config``), so either package restores the
other's snapshot.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import pathlib
import threading
import time

import numpy as np
import torch

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE
from sitewhere_tpu_torch.core.events import EpochBase, EventBatch
from sitewhere_tpu_torch.core.registry import MAX_ACTIVE_ASSIGNMENTS, TokenInterner
from sitewhere_tpu_torch.core.state import RECENT_DEPTH
from sitewhere_tpu_torch.core.types import (AUX_LANES, DEFAULT_VALUE_CHANNELS,
                                            NULL_ID, DeviceAssignmentStatus,
                                            EventType, PresenceState)
from sitewhere_tpu_torch.engine import (WAL_BINARY, WAL_JSON, AssignmentInfo,
                                        ChannelMap, DeviceInfo, IngestHostMixin,
                                        _admin_add_assignment,
                                        _admin_create_device,
                                        _admin_set_assignment_status,
                                        _admin_set_device_active,
                                        _admin_set_parent,
                                        _admin_update_assignment,
                                        _admin_update_device, _FairChunk,
                                        _tenant_event_counts,
                                        format_tenant_counter_grid, tenant_cap,
                                        tenant_counts_dict)
from sitewhere_tpu_torch.ingest.decoders import (BinaryEventDecoder,
                                                 JsonDeviceRequestDecoder)
from sitewhere_tpu_torch.ops.readback import read_range, slice_to_host
from sitewhere_tpu_torch.parallel.sharded import (ShardedEngine, _Fences,
                                                  _stacked_query)
from sitewhere_tpu_torch.pipeline import PipelineConfig, StepOutput
from sitewhere_tpu_torch.utils.conservation import FlowLedger
from sitewhere_tpu_torch.utils.flight import FlightRecorder
from sitewhere_tpu_torch.utils.metrics import next_engine_label
from sitewhere_tpu_torch.utils.tracing import SpanTracer, stage

@dataclasses.dataclass
class DistributedConfig:
    """Per-shard capacities and the host engine's knobs (the
    ``EngineConfig`` analog). The global token capacity is ``n_shards *
    token_capacity_per_shard``. Every field but the last two is the JAX
    package's, with its default."""

    n_shards: int | None = None            # None: make_mesh(None, device)
    device_capacity_per_shard: int = 1 << 14
    token_capacity_per_shard: int = 1 << 15
    assignment_capacity_per_shard: int = 1 << 15
    store_capacity_per_shard: int = 1 << 16
    channels: int = DEFAULT_VALUE_CHANNELS
    batch_capacity_per_shard: int = 2048
    flush_interval_s: float = 0.05
    auto_register: bool = True
    default_device_type: str = "default"
    presence_missing_s: float = 8 * 3600.0
    use_native: bool = True                # a failed native build raises
    strict_channels: bool = False
    fair_tenancy: bool = False
    wal_dir: str | None = None
    archive_dir: str | None = None         # spill each (shard, arena)
                                           # sub-ring before overwrite
    archive_segment_rows: int = 4096
    archive_max_rows: int | None = None    # per-(shard, arena) retention
    archive_max_age_ms: int | None = None  # event-time retention horizon
    archive_cache_segments: int = 8        # LRU segment-decode cache depth
    flight_recorder: bool = True
    flight_capacity: int = 1024
    span_trace: bool = True
    span_capacity: int = 4096
    span_sample: float = 1.0
    span_seed: int = 0
    qos: bool = False                      # admission at the edges and a
                                           # weighted-fair ingest turn
    tenant_rates: dict | None = None
    qos_default_rate_eps: float = 0.0
    qos_burst_s: float = 2.0
    tenant_weights: dict | None = None
    shed_threshold: int = 0                # 0: 4 * batch * n_shards
    qos_min_retry_after_s: float = 0.05
    conservation: bool = True
    # port-only: where the shards live ("cuda" spreads them over the
    # visible GPUs, any other device holds them all), and a group-commit
    # WAL (appends buffer, a commit thread fsyncs, each dispatch waits for
    # its records to be durable); the JAX engine flushes every append
    device: str = DEFAULT_DEVICE
    wal_group_commit: bool = False


# the fields a snapshot's ``config`` leaves out: the JAX package's
# DistributedConfig has none of them
_PORT_ONLY = ("device", "wal_group_commit")


class _StackedBuffer:
    """Host staging of every shard at once: ``[S, B, ...]`` columns with a
    fill count a shard, written through numpy views. On a card the columns
    are page-locked, so :meth:`emit`'s batch reaches each shard's device in
    asynchronous copies; a fresh set is allocated after each emit (the
    pinned allocator reuses a block only once the copies that read it have
    completed)."""

    def __init__(self, n_shards: int, capacity: int, channels: int,
                 pin: bool = False):
        self.n_shards = n_shards
        self.capacity = capacity
        self.channels = channels
        self.pin = pin
        self._alloc()

    def _alloc(self) -> None:
        s, b, c = self.n_shards, self.capacity, self.channels

        def col(shape, dtype, fill):
            return torch.full(shape, fill, dtype=dtype, pin_memory=self.pin)

        i32 = torch.int32
        self._cols = {
            "valid": col((s, b), torch.bool, False),
            "etype": col((s, b), i32, 0),
            "token_id": col((s, b), i32, NULL_ID),
            "tenant_id": col((s, b), i32, NULL_ID),
            "ts_ms": col((s, b), i32, 0),
            "received_ms": col((s, b), i32, 0),
            "values": col((s, b, c), torch.float32, 0.0),
            "vmask": col((s, b, c), torch.bool, False),
            "aux": col((s, b, AUX_LANES), i32, NULL_ID),
            "seq": col((s, b), i32, 0),
        }
        for name, t in self._cols.items():
            setattr(self, name, t.numpy())
        self.counts = np.zeros(s, np.int64)

    def total(self) -> int:
        return int(self.counts.sum())

    def room(self, shard: int) -> int:
        return self.capacity - int(self.counts[shard])

    def append_row(self, shard: int, etype: int, local_token: int,
                   tenant_id: int, ts: int, recv: int,
                   values: np.ndarray | None, vmask: np.ndarray | None,
                   aux0: int, aux1: int) -> bool:
        i = int(self.counts[shard])
        if i >= self.capacity:
            return False
        self.etype[shard, i] = etype
        self.token_id[shard, i] = local_token
        self.tenant_id[shard, i] = tenant_id
        self.ts_ms[shard, i] = ts
        self.received_ms[shard, i] = recv
        if vmask is not None:
            self.values[shard, i] = values
            self.vmask[shard, i] = vmask
        self.aux[shard, i, 0] = aux0
        self.aux[shard, i, 1] = aux1
        self.counts[shard] = i + 1
        return True

    def emit(self) -> EventBatch:
        """The staged rows as one stacked ``[S, B, ...]`` EventBatch of host
        tensors (what ``ShardedEngine.step`` / ``split_batch`` take); the
        buffer starts over on fresh columns."""
        b = self.capacity
        self.valid[:] = np.arange(b)[None, :] < self.counts[:, None]
        self.seq[:] = np.arange(b, dtype=np.int32)[None, :]
        batch = EventBatch(**self._cols)
        self._alloc()
        return batch


def _host(tensors: list[torch.Tensor], device: torch.device) -> np.ndarray:
    """Per-shard tensors of one shape, stacked on ``device`` and read in one
    device-to-host copy."""
    return torch.stack([t.to(device) for t in tensors]).cpu().numpy()


class DistributedEngine(IngestHostMixin):
    """Multi-shard product engine: one object serving every shard. All
    mutations serialize through one lock (single writer, as the single-card
    engine); a dispatch runs the step on every shard. The WAL, strict
    channels, ``process()`` and the batch skeleton come from
    ``IngestHostMixin``: the single-card engine's semantics by
    construction. Runs on the card unless ``config.device`` says
    otherwise."""

    def __init__(self, config: DistributedConfig | None = None):
        self.config = c = config or DistributedConfig()
        self.sharded = ShardedEngine(
            n_shards=c.n_shards,
            device_capacity_per_shard=c.device_capacity_per_shard,
            token_capacity_per_shard=c.token_capacity_per_shard,
            assignment_capacity_per_shard=c.assignment_capacity_per_shard,
            store_capacity_per_shard=c.store_capacity_per_shard,
            channels=c.channels,
            config=PipelineConfig(auto_register=c.auto_register,
                                  default_device_type=0),
            device=c.device,
        )
        self.n_shards = self.sharded.n_shards
        self.mesh = self.sharded.mesh
        self.device = self.mesh[0]
        self.epoch = EpochBase()
        self.lock = threading.RLock()
        self.host_counters: dict[str, int] = {}
        token_capacity = c.token_capacity_per_shard * self.n_shards
        # the native data plane unless the caller asks for the Python path;
        # a failed build raises here (no quiet fallback)
        self._native_decoder = None
        if c.use_native:
            from sitewhere_tpu_torch.ingest.fast_decode import NativeBatchDecoder
            from sitewhere_tpu_torch.native.binding import NativeInterner

            self.tokens = NativeInterner(token_capacity)
            self._native_decoder = NativeBatchDecoder(self.tokens, c.channels)
            self.channel_map = ChannelMap(c.channels, self._native_decoder.names,
                                          strict=c.strict_channels)
            self.alert_types = self._native_decoder.alert_types
            # the decoder's event-id interner (alternate ids): batch-decoded
            # and per-request rows share one id space
            self.event_ids = self._native_decoder.event_ids
        else:
            self.tokens = TokenInterner(token_capacity)
            self.channel_map = ChannelMap(c.channels, strict=c.strict_channels)
            self.alert_types = TokenInterner(1 << 20)
            self.event_ids = TokenInterner(1 << 22)
        self.tenants = TokenInterner(1 << 16)
        self.tenants.intern("default")
        self.device_types = TokenInterner(1 << 16)
        self.device_types.intern(c.default_device_type)
        self.areas = TokenInterner(1 << 16)
        self.customers = TokenInterner(1 << 16)
        self.assets = TokenInterner(1 << 16)

        self._buf = _StackedBuffer(self.n_shards, c.batch_capacity_per_shard,
                                   c.channels,
                                   pin=any(d.type == "cuda" for d in self.mesh))
        self._last_flush = time.monotonic()
        # host mirrors: flat dicts over GLOBAL ids (local * n_shards + shard)
        self.devices: dict[int, DeviceInfo] = {}
        self.token_device: dict[int, int] = {}        # gid -> global did
        self.assignments: dict[int, AssignmentInfo] = {}
        self.assignment_tokens: dict[str, int] = {}
        self.device_slots: dict[int, list[int]] = {}
        self._next_device = np.zeros(self.n_shards, np.int64)   # per shard
        self._next_assignment = np.zeros(self.n_shards, np.int64)
        self.dead_letters: list[str] = []             # unregistered tokens
        self.outputs: list[dict] = []
        self._pending_outs: list[StepOutput] = []
        self._pending_fences: list = []               # one a dispatch
        self._pending_tenant_fixups: list[tuple[int, int, int]] = []
        self._dispatches = 0
        # flight recorder: the mixin's _ingest_batch binds a record a batch,
        # flush_async / drain stamp dispatch, device_ready and readback
        self.flight = FlightRecorder(capacity=c.flight_capacity,
                                     enabled=c.flight_recorder)
        self._staged_traces: list = []
        self._pending_traces: list[list] = []
        self.tracer = SpanTracer(capacity=c.span_capacity, enabled=c.span_trace,
                                 sample=c.span_sample, seed=c.span_seed)
        self.metrics_label = next_engine_label()
        # conservation ledger: rows staged and rows dispatched
        self.ledger = FlowLedger(enabled=c.conservation)
        self.conservation_auditor = None
        # fair tenancy: {tenant_id: deque[_FairChunk]} a shard
        self._fair_queues: list[dict[int, collections.deque]] = [
            {} for _ in range(self.n_shards)]
        self._fair_queued = np.zeros(self.n_shards, np.int64)
        self.wal = None
        self._wal_local = threading.local()
        self._wal_last_seq = 0
        if c.wal_dir:
            from sitewhere_tpu_torch.utils.ingestlog import IngestLog

            self.wal = IngestLog(c.wal_dir, group_commit=c.wal_group_commit)
        # retention: every (shard, arena) sub-ring spills to its own archive
        # partition before its rows can be overwritten
        self.archive = None
        self._rows_since_spool = 0
        if c.archive_dir:
            from sitewhere_tpu_torch.utils.archive import EventArchive, mesh_topology

            arenas = self.arenas
            acap = c.store_capacity_per_shard // arenas
            self.archive = EventArchive(
                c.archive_dir,
                segment_rows=max(1, min(c.archive_segment_rows, acap // 4)),
                max_rows_per_part=c.archive_max_rows,
                topology=mesh_topology(self.n_shards, arenas),
                max_age_ms=c.archive_max_age_ms,
                cache_segments=c.archive_cache_segments)
            self._spool_trigger = max(self.archive.segment_rows,
                                      acap // 2 - c.batch_capacity_per_shard)
        # overload discipline, as the single-card engine: admission at the
        # edges, a weighted-fair turn on the batch-ingest critical section;
        # WAL recovery calls the ingest methods directly and never sheds
        if c.qos:
            from sitewhere_tpu_torch.utils.qos import (AdmissionController,
                                                       WeightedFairGate)

            self.qos = AdmissionController(
                tenant_rates=c.tenant_rates,
                default_rate_eps=c.qos_default_rate_eps,
                burst_s=c.qos_burst_s,
                shed_threshold=(c.shed_threshold
                                or 4 * c.batch_capacity_per_shard * self.n_shards),
                backlog_fn=lambda: self.staged_count,
                min_retry_after_s=c.qos_min_retry_after_s)
            self._wfq_gate = WeightedFairGate(c.tenant_weights)

    # ---------------------------------------------------------------- routing
    def _route(self, gid: int) -> tuple[int, int]:
        """(shard, local_token) of a global interner id."""
        return gid % self.n_shards, gid // self.n_shards

    def _gdid(self, shard: int, local_did: int) -> int:
        return local_did * self.n_shards + shard

    def _split_gdid(self, gdid: int) -> tuple[int, int]:
        return gdid % self.n_shards, gdid // self.n_shards

    @property
    def shards(self) -> list:
        """The live per-shard states (``PipelineState`` a shard)."""
        return self.sharded.shards

    @property
    def state(self):
        """The stacked ``[n_shards, ...]`` copy of every shard's state, on
        the first shard's device (cold paths: save, restore, tests)."""
        return self.sharded.state

    @property
    def arenas(self) -> int:
        return int(self.shards[0].store.cursor.shape[-1])

    @property
    def staged_count(self) -> int:
        return self._buf.total() + int(self._fair_queued.sum())

    def _heads(self) -> np.ndarray:
        """Absolute ring write head of every (shard, arena), ``[S, A]``
        int64, in one gather and one device-to-host copy."""
        ec = _host([torch.stack([st.store.epoch, st.store.cursor])
                    for st in self.shards], self.device).astype(np.int64)
        return ec[:, 0] * self.ring_arena_capacity() + ec[:, 1]

    def _sync_mirrors(self) -> None:
        while self._buf.total() or self._fair_queued.sum():
            self.flush_async()
        if self._pending_outs:
            self.drain()

    # ---------------------------------------------------------------- ingest
    # process() comes from IngestHostMixin: it converts a request to one SoA
    # row and calls _stage_row, which routes it to its owning shard
    def _stage_row(self, et, token_id, tenant_id, ts, now, values, mask,
                   aux0, aux1) -> None:
        """Stage one converted event row into its owning shard's lane
        (``token_id`` is the GLOBAL interner id). Caller holds the lock."""
        shard, local = self._route(token_id)
        self.ledger.add("staged_rows", 1)
        has_vals = mask is not None and mask.any()
        if self.config.fair_tenancy:
            i32 = np.int32
            self._fair_enqueue(shard, tenant_id, _FairChunk(
                etype=np.array([et], i32),
                token=np.array([local], i32),
                ts=np.array([ts], i32),
                recv=np.array([now], i32),
                values=values[None].copy() if has_vals else None,
                vmask=mask[None].copy() if has_vals else None,
                aux0=np.array([aux0], i32),
                aux1=np.array([aux1], i32),
            ))
            return
        row = (shard, et, local, tenant_id, ts, now,
               values if has_vals else None, mask if has_vals else None,
               aux0, aux1)
        if not self._buf.append_row(*row):
            self.flush_async()
            self._buf.append_row(*row)
        if self._buf.room(shard) == 0:
            self.flush_async()

    def ingest_json_batch(self, payloads: list[bytes], tenant: str = "default",
                          traceparent: str | None = None) -> dict:
        """One native decode call for the batch, then vectorized routing and
        staging (no per-event Python)."""
        return self._ingest_batch(
            payloads, tenant, WAL_JSON, JsonDeviceRequestDecoder(),
            self._native_decoder.decode if self._native_decoder else None,
            binary=False, traceparent=traceparent)

    def ingest_binary_batch(self, payloads: list[bytes], tenant: str = "default",
                            traceparent: str | None = None) -> dict:
        return self._ingest_batch(
            payloads, tenant, WAL_BINARY, BinaryEventDecoder(),
            self._native_decoder.decode_binary if self._native_decoder
            else None, binary=True, traceparent=traceparent)

    def _ingest_decoded(self, res, payloads, tenant, reg_decoder) -> dict:
        """Stage a natively decoded SoA batch, grouped by owning shard with
        one stable argsort. The alternate-id lane stays unset on this path,
        as in the JAX engine."""
        with self.lock:
            now = self._staging_now()
            base_ms = int(self.epoch.base_unix_s * 1000)
            etype, ok, ts_rel, values, failed, n_reg_ok = \
                self._decode_prologue(res, payloads, tenant, reg_decoder,
                                      now, base_ms)
            idxs = np.nonzero(ok)[0]
            tenant_id = self.tenants.intern(tenant)
            gids = res.token_id[idxs]
            shards = gids % self.n_shards
            locals_ = gids // self.n_shards
            order = np.argsort(shards, kind="stable")
            sidx, sshard, slocal = idxs[order], shards[order], locals_[order]
            bounds = np.searchsorted(sshard, np.arange(self.n_shards + 1))
            staged = 0
            for s in range(self.n_shards):
                rows = sidx[bounds[s]:bounds[s + 1]]
                toks = slocal[bounds[s]:bounds[s + 1]]
                if not len(rows):
                    continue
                if self.config.fair_tenancy:
                    self._fair_enqueue(s, tenant_id, _FairChunk(
                        etype=etype[rows], token=toks.astype(np.int32),
                        ts=ts_rel[rows], recv=np.full(len(rows), now, np.int32),
                        values=values[rows], vmask=res.chmask[rows],
                        aux0=res.aux0[rows],
                        aux1=np.full(len(rows), NULL_ID, np.int32)))
                    staged += len(rows)
                    continue
                pos = 0
                while pos < len(rows):
                    b = self._buf   # a flush swaps the buffer's columns
                    room = b.room(s)
                    if room == 0:
                        self.flush_async()
                        room = b.capacity
                    chunk = rows[pos:pos + room]
                    lo = int(b.counts[s])
                    hi = lo + len(chunk)
                    b.etype[s, lo:hi] = etype[chunk]
                    b.token_id[s, lo:hi] = toks[pos:pos + room]
                    b.tenant_id[s, lo:hi] = tenant_id
                    b.ts_ms[s, lo:hi] = ts_rel[chunk]
                    b.received_ms[s, lo:hi] = now
                    b.values[s, lo:hi] = values[chunk]
                    b.vmask[s, lo:hi] = res.chmask[chunk]
                    b.aux[s, lo:hi, 0] = res.aux0[chunk]
                    b.counts[s] = hi
                    staged += len(chunk)
                    pos += len(chunk)
                if self._buf.room(s) == 0:
                    self.flush_async()
            self.channel_map.collisions += res.collisions
            self.ledger.add("staged_rows", staged)
            return {"decoded": int(np.sum(ok)) + n_reg_ok, "failed": failed,
                    "staged": staged}

    # ----------------------------------------------------------- fair tenancy
    def _fair_enqueue(self, shard: int, tenant_id: int, chunk: _FairChunk) -> None:
        q = self._fair_queues[shard].get(tenant_id)
        if q is None:
            q = self._fair_queues[shard][tenant_id] = collections.deque()
        q.append(chunk)
        self._fair_queued[shard] += chunk.remaining
        if self._fair_queued[shard] >= self.config.batch_capacity_per_shard:
            self.flush_async()

    def fair_backlog(self, tenant: str) -> int:
        with self.lock:
            tid = self.tenants.lookup(tenant)
            return sum(c.remaining for queues in self._fair_queues
                       for c in queues.get(tid, ()))

    def _form_fair_batch(self, shard: int) -> None:
        """Quota-sliced batch formation across tenants for one shard's lane
        (``Engine._form_fair_batch`` a shard). Caller holds the lock."""
        b = self._buf
        queues = self._fair_queues[shard]
        while self._fair_queued[shard] and b.room(shard):
            active = [t for t, q in queues.items() if q]
            if not active:
                break
            quota = max(1, b.room(shard) // len(active))
            for tid in active:
                q = queues[tid]
                take = quota
                while take > 0 and q and b.room(shard):
                    ch = q[0]
                    k = min(take, ch.remaining, b.room(shard))
                    lo = int(b.counts[shard])
                    hi, p = lo + k, ch.pos
                    b.etype[shard, lo:hi] = ch.etype[p:p + k]
                    b.token_id[shard, lo:hi] = ch.token[p:p + k]
                    b.tenant_id[shard, lo:hi] = tid
                    b.ts_ms[shard, lo:hi] = ch.ts[p:p + k]
                    b.received_ms[shard, lo:hi] = ch.recv[p:p + k]
                    if ch.values is not None:
                        b.values[shard, lo:hi] = ch.values[p:p + k]
                        b.vmask[shard, lo:hi] = ch.vmask[p:p + k]
                    b.aux[shard, lo:hi, 0] = ch.aux0[p:p + k]
                    b.aux[shard, lo:hi, 1] = ch.aux1[p:p + k]
                    b.counts[shard] = hi
                    ch.pos += k
                    take -= k
                    self._fair_queued[shard] -= k
                    if ch.remaining == 0:
                        q.popleft()
        for tid in [t for t, q in queues.items() if not q]:
            del queues[tid]

    # ------------------------------------------------------------------ step
    def maybe_flush(self) -> dict | None:
        with self.lock:
            expired = (time.monotonic() - self._last_flush
                       >= self.config.flush_interval_s)
            if (self._buf.total() or self._fair_queued.sum()) and expired:
                return self.flush()
            if self._pending_outs and expired:
                return self.drain()[-1]
            return None

    def flush(self) -> dict:
        try:
            with self.lock, stage("sharded_step"):
                self.flush_async()
                while self._fair_queued.sum():
                    self.flush_async()
                return self.drain()[-1]
        except Exception:
            self.flight.dump_error(logging.getLogger(__name__))
            raise

    def _fence(self):
        """The dispatch's ticket: a CUDA event on every card a shard sits
        on (None when every shard is on the CPU)."""
        devs = sorted({d for d in self.mesh if d.type == "cuda"},
                      key=lambda x: x.index or 0)
        if not devs:
            return None
        events = []
        for d in devs:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            events.append(ev)
        return events[0] if len(events) == 1 else _Fences(events)

    def flush_async(self) -> None:
        """Dispatch one step on every shard (no host sync); the outputs
        queue for :meth:`drain`. Every WAL record of the staged rows is
        durable before their copies are enqueued."""
        with self.lock:
            if self._fair_queued.sum():
                for s in range(self.n_shards):
                    if self._fair_queued[s]:
                        self._form_fair_batch(s)
            if not self._buf.total():
                return
            n_staged = int(max(self._buf.counts))   # the fullest shard's rows
            self.ledger.add("dispatched_rows", self._buf.total())
            traces, self._staged_traces = self._staged_traces, []
            self._wal_gate(traces)
            for rec in traces:
                rec.mark("dispatch")
            out = self.sharded.step(self._buf.emit())
            self._pending_outs.append(out)
            self._pending_fences.append(self._fence())
            self._pending_traces.append(traces)
            self._dispatches += 1
            self._last_flush = time.monotonic()
            if self.archive is not None:
                # each staged row persists at most one event per active
                # assignment of its shard
                self._rows_since_spool += n_staged * MAX_ACTIVE_ASSIGNMENTS
                if self._rows_since_spool >= self._spool_trigger:
                    self._spool()

    def barrier(self) -> None:
        """Dispatch every staged row and wait for the dispatches to
        complete, reading nothing back (drain reads)."""
        with self.lock:
            while self._buf.total() or self._fair_queued.sum():
                self.flush_async()
            if self._pending_fences and self._pending_fences[-1] is not None:
                self._pending_fences[-1].synchronize()

    def ring_heads(self) -> dict[int, int]:
        """Absolute ring write head per archive partition (``shard *
        arenas + arena``): the one definition the spooler and the
        conservation ledger share. Caller holds the lock."""
        heads = self._heads()
        arenas = heads.shape[1]
        return {s * arenas + a: int(heads[s, a])
                for s in range(self.n_shards) for a in range(arenas)}

    def ring_arena_capacity(self) -> int:
        """Rows one (shard, arena) sub-ring holds before wrapping."""
        return self.config.store_capacity_per_shard // self.arenas

    def _spool(self) -> None:
        """Spill whole segments of every (shard, arena) sub-ring. Caller
        holds the lock. One ``read_range`` and one copy a segment."""
        arenas = self.arenas
        acap = self.ring_arena_capacity()
        rows = self.archive.segment_rows
        heads = self.ring_heads()
        for s in range(self.n_shards):
            store = self.shards[s].store
            for a in range(arenas):
                part = s * arenas + a
                head = heads[part]
                start = self.archive.spilled(part)
                if head - start > acap:   # wrapped before we got here
                    self.archive.note_lost(head - acap - start)
                    start = head - acap
                while head - start >= rows:
                    sl = slice_to_host(read_range(store, start % acap, rows, arena=a))
                    self.archive.append_segment(part, start, sl)
                    start += rows
        self._rows_since_spool = 0

    def drain(self) -> list[dict]:
        """Absorb the queued outputs: the scalar counter lanes of the whole
        backlog in one copy; the token lists are read (their occupied
        prefix) only for shards that registered or dead-lettered."""
        with self.lock:
            if not self._pending_outs:
                return [{"found": 0, "missed": 0, "registered": 0,
                         "persisted": 0, "new_tokens": [], "dead_tokens": []}]
            outs, self._pending_outs = self._pending_outs, []
            self._pending_fences = []
            trace_lists, self._pending_traces = self._pending_traces, []
            scalars = torch.stack([
                torch.stack([o.n_found, o.n_missed, o.n_registered, o.n_persisted])
                for o in outs]).cpu().numpy()            # [n, 4, S]
            for recs in trace_lists:   # the copy observed completion
                for rec in recs:
                    if "device_ready" not in rec.stages:
                        rec.mark("device_ready")
                    rec.mark("readback")
            summaries = [self._absorb_output(o, s) for o, s in zip(outs, scalars)]
            self._mirror_new_device_tenants()
            return summaries

    def _absorb_output(self, out: StepOutput, scalars) -> dict:
        """Mirror one dispatch's outputs: each shard's device-side
        allocation order is its compacted ``new_tokens`` order, as in the
        single-card engine."""
        n_found_s, n_missed_s, n_reg_s, n_pers_s = (np.asarray(x) for x in scalars)
        new_all: list[str] = []
        dead_all: list[str] = []
        for s in range(self.n_shards):
            k = int(n_reg_s[s])
            if k:
                for local_tok in out.new_tokens[s, :k].cpu().tolist():
                    gid = local_tok * self.n_shards + s
                    did = int(self._next_device[s])
                    aid = int(self._next_assignment[s])
                    self._next_device[s] += 1
                    self._next_assignment[s] += 1
                    gdid = self._gdid(s, did)
                    self.token_device[gid] = gdid
                    token = self.tokens.token(gid)
                    self.devices[gdid] = DeviceInfo(
                        token=token, device_type=self.config.default_device_type,
                        tenant="default",   # set from the tenant column below
                        auto_registered=True)
                    self._pending_tenant_fixups.append((gdid, s, did))
                    self._record_assignment(self._gdid(s, aid), gdid, slot=0)
                    new_all.append(token)
            dk = min(int(n_missed_s[s]), out.dead_tokens.shape[1])
            if dk:
                for t in out.dead_tokens[s, :dk].cpu().tolist():
                    if t != NULL_ID:
                        dead_all.append(self.tokens.token(t * self.n_shards + s))
        self.dead_letters.extend(dead_all)
        summary = {"found": int(n_found_s.sum()), "missed": int(n_missed_s.sum()),
                   "registered": int(n_reg_s.sum()),
                   "persisted": int(n_pers_s.sum()),
                   "new_tokens": new_all, "dead_tokens": dead_all}
        self.outputs.append(summary)
        del self.outputs[:-256]
        return summary

    def _mirror_new_device_tenants(self) -> None:
        """The tenant column of every auto-registered device in one gather
        a shard and one copy."""
        if not self._pending_tenant_fixups:
            return
        fix, self._pending_tenant_fixups = self._pending_tenant_fixups, []
        parts = []
        for s in range(self.n_shards):
            dids = [d for _, sh, d in fix if sh == s]
            if dids:
                col = self.shards[s].registry.device_tenant
                parts.append(col[torch.tensor(dids, device=col.device)].to(self.device))
        tens = torch.cat(parts).cpu().tolist()
        # parts are shard-ordered: walk the fixups in the same order
        ordered = [f for s in range(self.n_shards) for f in fix if f[1] == s]
        for (gdid, _, _), ten in zip(ordered, tens):
            if ten != NULL_ID:
                info = self.devices.get(gdid)
                if info is not None:
                    info.tenant = self.tenants.token(ten)
                    aid = (self.device_slots.get(gdid) or [NULL_ID])[0]
                    if aid != NULL_ID and aid in self.assignments:
                        self.assignments[aid].tenant = info.tenant

    # ------------------------------------------------------------------ admin
    def _apply(self, shard: int, fn, *args) -> None:
        """A single-card admin updater on one shard's state."""
        self.sharded.shards[shard] = fn(self.sharded.shards[shard], *args)

    def register_device(self, token: str, device_type: str | None = None,
                        tenant: str = "default", area: str | None = None,
                        customer: str | None = None,
                        metadata: dict | None = None) -> int:
        """API-path device creation (get-or-create); returns the GLOBAL
        device id."""
        with self.lock:
            self._sync_mirrors()
            gid = self.tokens.intern(token)
            existing = self.token_device.get(gid)
            if existing is not None:
                return existing
            shard, local_tok = self._route(gid)
            did = int(self._next_device[shard])
            aid = int(self._next_assignment[shard])
            if did >= self.config.device_capacity_per_shard:
                raise RuntimeError(f"device capacity exhausted on shard {shard}")
            type_name = device_type or self.config.default_device_type
            # the admin-path registration rides the WAL as its wire envelope
            self._wal_admin_register(token, type_name, tenant, area, customer)
            self._next_device[shard] += 1
            self._next_assignment[shard] += 1
            self._apply(shard, _admin_create_device, local_tok, did, aid,
                        self.device_types.intern(type_name),
                        self.tenants.intern(tenant),
                        self.areas.intern(area) if area else NULL_ID,
                        self.customers.intern(customer) if customer else NULL_ID)
            gdid = self._gdid(shard, did)
            self.token_device[gid] = gdid
            self.devices[gdid] = DeviceInfo(
                token=token, device_type=type_name, tenant=tenant, area=area,
                customer=customer, metadata=metadata or {})
            self._record_assignment(self._gdid(shard, aid), gdid, slot=0,
                                    area=area, customer=customer)
            return gdid

    def delete_device(self, token: str) -> bool:
        with self.lock:
            self._sync_mirrors()
            gdid = self.token_device.get(self.tokens.lookup(token))
            if gdid is None:
                return False
            shard, did = self._split_gdid(gdid)
            self._apply(shard, _admin_set_device_active, did, False)
            return True

    def map_device(self, child_token: str, parent_token: str) -> DeviceInfo:
        """Gateway/composite mapping. The device's parent column is
        shard-local, so it is written only when parent and child share a
        shard; the host mirror always records the mapping."""
        with self.lock:
            self._sync_mirrors()
            cdid = self.token_device.get(self.tokens.lookup(child_token))
            if cdid is None:
                raise KeyError(f"device {child_token!r} not registered")
            pdid = self.token_device.get(self.tokens.lookup(parent_token))
            if pdid is None:
                raise KeyError(f"parent device {parent_token!r} not registered")
            if cdid == pdid:
                raise ValueError("device cannot be its own parent")
            info = self.devices[cdid]
            info.metadata = dict(info.metadata) | {"parentToken": parent_token}
            cs, cd = self._split_gdid(cdid)
            ps, pd = self._split_gdid(pdid)
            if cs == ps:
                self._apply(cs, _admin_set_parent, cd, pd)
            return info

    def _record_assignment(self, gaid: int, gdid: int, slot: int,
                           token: str | None = None, asset: str | None = None,
                           area: str | None = None, customer: str | None = None,
                           metadata: dict | None = None) -> AssignmentInfo:
        dev = self.devices[gdid]
        tok = token or f"{dev.token}:a{gaid}"
        info = AssignmentInfo(
            token=tok, id=gaid, device_token=dev.token, tenant=dev.tenant,
            asset=asset, area=area or dev.area, customer=customer or dev.customer,
            metadata=metadata or {}, created_ms=self.epoch.now_ms())
        self.assignments[gaid] = info
        self.assignment_tokens[tok] = gaid
        slots = self.device_slots.setdefault(gdid, [NULL_ID] * MAX_ACTIVE_ASSIGNMENTS)
        slots[slot] = gaid
        return info

    def create_assignment(self, device_token: str, token: str | None = None,
                          asset: str | None = None, area: str | None = None,
                          customer: str | None = None,
                          metadata: dict | None = None) -> AssignmentInfo:
        with self.lock:
            self._sync_mirrors()
            gdid = self.token_device.get(self.tokens.lookup(device_token))
            if gdid is None:
                raise KeyError(f"device {device_token!r} not registered")
            if token is not None and token in self.assignment_tokens:
                raise ValueError(f"assignment token {token!r} already exists")
            slots = self.device_slots.setdefault(
                gdid, [NULL_ID] * MAX_ACTIVE_ASSIGNMENTS)
            try:
                slot = slots.index(NULL_ID)
            except ValueError:
                raise ValueError(
                    f"device {device_token!r} already has "
                    f"{MAX_ACTIVE_ASSIGNMENTS} active assignments") from None
            shard, did = self._split_gdid(gdid)
            aid = int(self._next_assignment[shard])
            if aid >= self.config.assignment_capacity_per_shard:
                raise RuntimeError("assignment capacity exhausted")
            self._next_assignment[shard] += 1
            self._apply(shard, _admin_add_assignment, did, aid, slot,
                        self.assets.intern(asset) if asset else NULL_ID,
                        self.areas.intern(area) if area else NULL_ID,
                        self.customers.intern(customer) if customer else NULL_ID)
            return self._record_assignment(
                self._gdid(shard, aid), gdid, slot, token=token, asset=asset,
                area=area, customer=customer, metadata=metadata)

    def update_device(self, token: str, device_type: str | None = None,
                      area: str | None = None, customer: str | None = None,
                      metadata: dict | None = None) -> DeviceInfo:
        """Update a device's columns on its owning shard and its host
        metadata."""
        with self.lock:
            self._sync_mirrors()
            gdid = self.token_device.get(self.tokens.lookup(token))
            if gdid is None:
                raise KeyError(f"device {token!r} not registered")
            info = self.devices[gdid]
            shard, did = self._split_gdid(gdid)
            type_id = self.device_types.intern(
                device_type if device_type is not None else info.device_type)
            new_area = area if area is not None else info.area
            area_id = self.areas.intern(new_area) if new_area else NULL_ID
            new_customer = customer if customer is not None else info.customer
            customer_id = (self.customers.intern(new_customer)
                           if new_customer else NULL_ID)
            self._apply(shard, _admin_update_device, did, type_id, area_id,
                        customer_id)
            if device_type is not None:
                info.device_type = device_type
            if area is not None:
                info.area = area
            if customer is not None:
                info.customer = customer
            if metadata is not None:
                info.metadata = metadata
            return info

    def get_assignment(self, token: str) -> AssignmentInfo | None:
        aid = self.assignment_tokens.get(token)
        return self.assignments.get(aid) if aid is not None else None

    def list_assignments(self, device_token: str | None = None,
                         status: str | None = None, area: str | None = None,
                         asset: str | None = None,
                         customer: str | None = None) -> list[AssignmentInfo]:
        with self.lock:
            out = [a for a in self.assignments.values()
                   if (device_token is None or a.device_token == device_token)
                   and (status is None or a.status == status)
                   and (area is None or a.area == area)
                   and (asset is None or a.asset == asset)
                   and (customer is None or a.customer == customer)]
            return sorted(out, key=lambda a: a.id)

    def _set_assignment_status(self, token: str,
                               status: DeviceAssignmentStatus) -> AssignmentInfo:
        with self.lock:
            self._sync_mirrors()
            gaid = self.assignment_tokens.get(token)
            if gaid is None:
                raise KeyError(f"assignment {token!r} not found")
            shard, aid = self._split_gdid(gaid)
            active = status is not DeviceAssignmentStatus.RELEASED
            self._apply(shard, _admin_set_assignment_status, aid, int(status),
                        active)
            info = self.assignments[gaid]
            info.status = status.name
            if not active:
                info.released_ms = self.epoch.now_ms()
                gdid = self.token_device.get(self.tokens.lookup(info.device_token))
                if gdid is not None and gdid in self.device_slots:
                    self.device_slots[gdid] = [NULL_ID if a == gaid else a
                                               for a in self.device_slots[gdid]]
            return info

    def release_assignment(self, token: str) -> AssignmentInfo:
        return self._set_assignment_status(token, DeviceAssignmentStatus.RELEASED)

    def mark_assignment_missing(self, token: str) -> AssignmentInfo:
        """Flag an assignment MISSING; it stays active, so events still
        expand to it."""
        return self._set_assignment_status(token, DeviceAssignmentStatus.MISSING)

    def update_assignment(self, token: str, asset: str | None = None,
                          area: str | None = None, customer: str | None = None,
                          metadata: dict | None = None) -> AssignmentInfo:
        """Update an assignment's association columns on its owning shard
        and its host metadata."""
        with self.lock:
            self._sync_mirrors()
            gaid = self.assignment_tokens.get(token)
            if gaid is None:
                raise KeyError(f"assignment {token!r} not found")
            info = self.assignments[gaid]
            shard, aid = self._split_gdid(gaid)
            new_asset = asset if asset is not None else info.asset
            new_area = area if area is not None else info.area
            new_customer = customer if customer is not None else info.customer
            # intern before mutating: a capacity error never half-applies
            asset_id = self.assets.intern(new_asset) if new_asset else NULL_ID
            area_id = self.areas.intern(new_area) if new_area else NULL_ID
            customer_id = (self.customers.intern(new_customer)
                           if new_customer else NULL_ID)
            self._apply(shard, _admin_update_assignment, aid, asset_id, area_id,
                        customer_id)
            info.asset, info.area, info.customer = new_asset, new_area, new_customer
            if metadata is not None:
                info.metadata = metadata
            return info

    def delete_assignment(self, token: str) -> bool:
        """Detach the assignment on its shard (release semantics) and drop
        its host record; persisted events keep its id."""
        with self.lock:
            self._sync_mirrors()
            gaid = self.assignment_tokens.get(token)
            if gaid is None:
                return False
            if self.assignments[gaid].status != "RELEASED":
                self._set_assignment_status(token, DeviceAssignmentStatus.RELEASED)
            del self.assignments[gaid]
            del self.assignment_tokens[token]
            return True

    # ------------------------------------------------------------------ reads
    def get_device(self, token: str) -> DeviceInfo | None:
        if self._pending_outs:
            with self.lock:
                self._sync_mirrors()
        gdid = self.token_device.get(self.tokens.lookup(token))
        return self.devices.get(gdid) if gdid is not None else None

    def get_device_state(self, token: str) -> dict | None:
        """One device's aggregated state, read from its owning shard."""
        with self.lock:
            self._sync_mirrors()
            gdid = self.token_device.get(self.tokens.lookup(token))
            if gdid is None:
                return None
            shard, d = self._split_gdid(gdid)
            dst = self.shards[shard].device_state
            row = {f: getattr(dst, f)[d].cpu().numpy() for f in (
                "presence", "last_interaction_ms", "meas_last", "meas_last_ms",
                "recent_loc", "recent_loc_ms", "recent_loc_valid",
                "recent_alert_level", "recent_alert_type", "recent_alert_ms",
                "recent_alert_valid", "event_counts")}
            chans = {}
            for name, nid in self.channel_map.names.items():
                ch = nid % self.config.channels
                ts = int(row["meas_last_ms"][ch])
                if ts > -(2**31) + 10:
                    chans[name] = {"value": float(row["meas_last"][ch]), "ts_ms": ts}
            recent_locs = [
                {"latitude": float(row["recent_loc"][r, 0]),
                 "longitude": float(row["recent_loc"][r, 1]),
                 "elevation": float(row["recent_loc"][r, 2]),
                 "ts_ms": int(row["recent_loc_ms"][r])}
                for r in range(RECENT_DEPTH) if bool(row["recent_loc_valid"][r])]
            recent_alerts = [
                {"level": int(row["recent_alert_level"][r]),
                 "type": self.alert_types.token(int(row["recent_alert_type"][r])),
                 "ts_ms": int(row["recent_alert_ms"][r])}
                for r in range(RECENT_DEPTH) if bool(row["recent_alert_valid"][r])]
            return {
                "device": self.devices[gdid].token,
                "shard": shard,
                "presence": PresenceState(int(row["presence"])).name,
                "last_interaction_ms": int(row["last_interaction_ms"]),
                "measurements": chans,
                "recent_locations": recent_locs,
                "recent_alerts": recent_alerts,
                "event_counts": {EventType(e).name: int(row["event_counts"][e])
                                 for e in range(6)},
            }

    def query_events(self, device_token: str | None = None,
                     etype: EventType | None = None, tenant: str | None = None,
                     since_ms: int | None = None, until_ms: int | None = None,
                     limit: int = 100, assignment_id: int | None = None,
                     aux0: int | None = None, area: str | None = None,
                     customer: str | None = None,
                     alternate_id: str | None = None) -> dict:
        """Global newest-first query: every shard scans its own ring (top
        ``limit`` on its device), the host merges the pages with one stable
        argsort (shard-major on timestamp ties). ``assignment_id`` is a
        GLOBAL id; its local row filters on the owning shard."""
        with self.lock:
            self._sync_mirrors()
            empty = {"total": 0, "events": []}
            dev_filter = NULL_ID
            shard_filter = None
            if device_token is not None:
                gdid = self.token_device.get(self.tokens.lookup(device_token))
                if gdid is None:
                    return empty
                shard_filter, dev_filter = self._split_gdid(gdid)
            ten = NULL_ID
            if tenant is not None:
                ten = self.tenants.lookup(tenant)
                if ten == NULL_ID:   # an unknown tenant matches nothing
                    return empty
            area_id = customer_id = aux1 = None
            if area is not None:
                area_id = self.areas.lookup(area)
                if area_id == NULL_ID:
                    return empty
            if customer is not None:
                customer_id = self.customers.lookup(customer)
                if customer_id == NULL_ID:
                    return empty
            if alternate_id is not None:
                aux1 = self.event_ids.lookup(alternate_id)
                if aux1 == NULL_ID:
                    return empty
            a_local = None
            if assignment_id is not None:
                # the owning shard's local row; the scan keeps to that shard
                a_shard, a_local = self._split_gdid(assignment_id)
                if shard_filter is not None and shard_filter != a_shard:
                    return empty
                shard_filter = a_shard
            res = _stacked_query(
                [st.store for st in self.shards],
                int(etype) if etype is not None else NULL_ID, ten,
                since_ms if since_ms is not None else -(2**31),
                until_ms if until_ms is not None else 2**31 - 1,
                limit=limit, device=dev_filter, device_shard=shard_filter,
                assignment=a_local,
                assignment_shard=shard_filter if a_local is not None else None,
                aux0=aux0, aux1=aux1, area=area_id, customer=customer_id)
            ts = res.ts_ms
            valid = np.arange(ts.shape[1])[None, :] < res.n[:, None]
            s_idx, i_idx = np.nonzero(valid)
            order = np.argsort(-ts[s_idx, i_idx], kind="stable")[:limit]
            lane_names = self._lane_names()
            events = [
                self._format_event(
                    int(res.etype[s, i]), int(s), int(res.device[s, i]),
                    int(res.assignment[s, i]), int(res.ts_ms[s, i]),
                    int(res.received_ms[s, i]), res.values[s, i],
                    res.vmask[s, i], res.aux[s, i], lane_names)
                for s, i in zip(s_idx[order], i_idx[order])]
            total = int(np.sum(res.total))
            if self.archive is not None and self.archive.segments:
                arenas = self.arenas
                parts_of = (frozenset(shard_filter * arenas + a for a in range(arenas))
                            if shard_filter is not None else None)
                total, events = self._merge_archive(
                    total, events, limit, lane_names,
                    device=dev_filter if dev_filter != NULL_ID else None,
                    device_parts=parts_of,
                    etype=int(etype) if etype is not None else None,
                    tenant=ten if ten != NULL_ID else None,
                    since_ms=since_ms, until_ms=until_ms, assignment=a_local,
                    assignment_parts=parts_of if a_local is not None else None,
                    aux0=aux0, aux1=aux1, area=area_id, customer=customer_id)
            return {"total": total, "events": events}

    def _merge_archive(self, total: int, events: list[dict], limit: int,
                       lane_names: dict[int, str], **filters) -> tuple[int, list[dict]]:
        """Fold archived (evicted from the ring) history into a page, each
        (shard, arena) partition capped below its ring's oldest row, so no
        row counts twice. Caller holds the lock."""
        heads = self._heads()
        arenas = heads.shape[1]
        acap = self.ring_arena_capacity()
        max_pos = {s * arenas + a: int(heads[s, a]) - acap
                   for s in range(self.n_shards) for a in range(arenas)}
        if all(v <= 0 for v in max_pos.values()):
            return total, events
        a_total, rows = self.archive.query(max_pos=max_pos, limit=limit, **filters)
        if not a_total:
            return total, events
        a_events = [
            self._format_event(
                int(r["etype"]), int(r["part"]) // arenas, int(r["device"]),
                int(r["assignment"]), int(r["ts_ms"]), int(r["received_ms"]),
                r["values"], r["vmask"], r["aux"], lane_names)
            for r in rows]
        merged = sorted(events + a_events, key=lambda e: -e["eventDateMs"])[:limit]
        return total + a_total, merged

    def _lane_names(self) -> dict[int, str]:
        lane_names: dict[int, str] = {}
        for name, nid in self.channel_map.names.items():
            lane_names.setdefault(nid % self.config.channels, name)
        return lane_names

    def _format_event(self, et_i: int, shard: int, device: int, assignment: int,
                      ts: int, received: int, values, vmask, aux,
                      lane_names: dict[int, str]) -> dict:
        """One persisted store row (shard-local ids) as the REST event dict:
        the formatter of the ring query, the archive merge and the by-id
        lookup."""
        et = EventType(et_i)
        gdid = self._gdid(shard, device)
        info = self.devices.get(gdid)
        ev = {"type": et.name, "deviceToken": info.token if info else None,
              "shard": shard, "assignmentId": self._gdid(shard, assignment),
              "eventDateMs": ts, "receivedDateMs": received}
        if et is EventType.MEASUREMENT:
            ev["measurements"] = {lane_names.get(int(c), f"ch{c}"): float(values[c])
                                  for c in np.nonzero(vmask)[0]}
        elif et is EventType.LOCATION:
            if vmask[0]:
                ev["latitude"], ev["longitude"], ev["elevation"] = (
                    float(values[0]), float(values[1]), float(values[2]))
            else:
                ev["latitude"] = ev["longitude"] = ev["elevation"] = None
        elif et is EventType.ALERT:
            ev["level"] = int(values[0])
            atype = int(aux[0])
            ev["alertType"] = (self.alert_types.token(atype)
                               if 0 <= atype < len(self.alert_types) else None)
        elif et is EventType.COMMAND_INVOCATION:
            ev["invocationId"] = int(aux[0])
        elif et is EventType.COMMAND_RESPONSE:
            oid = int(aux[0])
            ev["originatingEventId"] = (self.event_ids.token(oid)
                                        if 0 <= oid < len(self.event_ids) else None)
        elif et is EventType.STATE_CHANGE:
            sid = int(aux[0])
            if 0 <= sid < len(self.event_ids):
                attr, _, change = self.event_ids.token(sid).partition(":")
                ev["attribute"], ev["stateChange"] = attr, change
        return ev

    def search_device_states(self, last_interaction_before_ms: int | None = None,
                             presence: str | None = None,
                             limit: int = 100) -> list[dict]:
        """Device-state search over every shard's columns (one copy)."""
        with self.lock:
            self._sync_mirrors()
            cols = _host([torch.stack([st.device_state.last_interaction_ms,
                                       st.device_state.presence.to(torch.int32)])
                          for st in self.shards], self.device)
            last, pres = cols[:, 0], cols[:, 1]
            mask = np.arange(last.shape[1])[None, :] < self._next_device[:, None]
            if last_interaction_before_ms is not None:
                mask &= last < last_interaction_before_ms
            if presence is not None:
                mask &= pres == int(PresenceState[presence.upper()])
            out = []
            for s, d in zip(*np.nonzero(mask)):
                if len(out) >= limit:
                    break
                info = self.devices.get(self._gdid(int(s), int(d)))
                if info is None:
                    continue
                out.append({"device": info.token, "deviceType": info.device_type,
                            "tenant": info.tenant, "shard": int(s),
                            "presence": PresenceState(int(pres[s, d])).name,
                            "lastInteractionMs": int(last[s, d])})
            return out

    def presence_sweep(self) -> list[str]:
        """Mark stale devices MISSING on every shard; returns their tokens."""
        with self.lock:
            self._sync_mirrors()
            pairs = self.sharded.presence_sweep(
                self.epoch.now_ms(), int(self.config.presence_missing_s * 1000))
            out = []
            for s, d in pairs:
                info = self.devices.get(self._gdid(s, d))
                if info is not None:
                    out.append(info.token)
            return out

    presence_sweep_local = presence_sweep

    def get_event(self, event_id: int, tenant: str | None = None) -> dict | None:
        """One persisted event by its mesh-global id (``pos * n_parts +
        shard * arenas + arena``, the id :class:`DistributedFeedConsumer`
        hands out). None when the id was never written or its slot was
        overwritten and no archive holds it; ``tenant`` scopes the lookup
        (another tenant's row reads as absent)."""
        with self.lock:
            self._sync_mirrors()
            ten = None
            if tenant is not None:
                ten = self.tenants.lookup(tenant)
                if ten == NULL_ID:
                    return None
            if event_id < 0:
                return None
            arenas = self.arenas
            pos, s, a = split_event_id(event_id, self.n_shards, arenas)
            acap = self.ring_arena_capacity()
            store = self.shards[s].store
            ep, cu = torch.stack([store.epoch[a], store.cursor[a]]).cpu().tolist()
            head = ep * acap + cu
            if pos >= head:
                return None
            if pos < head - acap:
                # evicted from the ring: the archive answers, so the by-id
                # surface agrees with query_events
                if self.archive is None:
                    return None
                r = self.archive.get_row(s * arenas + a, pos)
                if r is None or (ten is not None and int(r["tenant"]) != ten):
                    return None
                ev = self._format_event(
                    int(r["etype"]), s, int(r["device"]), int(r["assignment"]),
                    int(r["ts_ms"]), int(r["received_ms"]), r["values"], r["vmask"],
                    r["aux"], self._lane_names())
                ev["eventId"] = event_id
                return ev
            sl = slice_to_host(read_range(store, pos % acap, 1, arena=a))
            if not bool(sl.valid[0]):
                return None
            if ten is not None and int(sl.tenant[0]) != ten:
                return None
            ev = self._format_event(
                int(sl.etype[0]), s, int(sl.device[0]), int(sl.assignment[0]),
                int(sl.ts_ms[0]), int(sl.received_ms[0]), sl.values[0],
                sl.vmask[0], sl.aux[0], self._lane_names())
            ev["eventId"] = event_id
            return ev

    def make_feed_consumer(self, group_id: str, max_batch: int = 1024,
                           start_from_latest: bool = False):
        """An outbound consumer over the per-shard rings."""
        return DistributedFeedConsumer(self, group_id, max_batch=max_batch,
                                       start_from_latest=start_from_latest)

    def metrics(self) -> dict:
        m = self.sharded.global_metrics()
        m["channel_collisions"] = self.channel_map.collisions
        m["staged"] = self.staged_count
        m["n_shards"] = self.n_shards
        m["devices"] = int(self._next_device.sum())
        if self.archive is not None:
            m["archived_rows"] = self.archive.total_rows()
            m["archive_lost_rows"] = self.archive.lost_rows
        return dict(self.host_counters) | m   # core keys win

    def tenant_metrics(self) -> dict[str, dict[str, int]]:
        """Per-tenant event counts over every shard: the single-card
        segment-sum a shard, summed (tenant ids are engine-global, so the
        sum of the per-shard ``[T, E]`` grids is exact)."""
        with self.lock:
            self._sync_mirrors()
            n_tenants = len(self.tenants)
            t_cap = tenant_cap(n_tenants)
            counts = _host([_tenant_event_counts(st, t_cap) for st in self.shards],
                           self.device).sum(axis=0)
        return tenant_counts_dict(counts, self.tenants, n_tenants)

    def shard_metrics(self) -> list[dict]:
        """Per-shard scalar counters (one copy) and mirrored device
        counts."""
        fields = [f.name for f in dataclasses.fields(self.shards[0].metrics)
                  if getattr(self.shards[0].metrics, f.name).dim() == 0]
        vals = _host([torch.stack([getattr(st.metrics, f).to(torch.int64)
                                   for f in fields]) for st in self.shards],
                     self.device)
        return [{name: int(vals[s, i]) for i, name in enumerate(fields)}
                | {"devices": int(self._next_device[s])}
                for s in range(self.n_shards)]

    def tenant_pipeline_counters(self) -> dict[str, dict[str, int]]:
        """The device-side per-tenant counter grid summed over the shards
        (tenant ids are engine-global). Read on the scrape path only."""
        with self.lock:
            grid = _host([st.metrics.tenant_counters for st in self.shards],
                         self.device).sum(axis=0)
            return format_tenant_counter_grid(grid, self.tenants)

    # ------------------------------------------------------------- durability
    def total_cursor(self) -> int:
        """Sum of the absolute store cursors of every shard: monotone under
        appends, the WAL watermark of the whole mesh."""
        return int(self._heads().sum())

    def save(self, directory) -> dict:
        """Snapshot every shard's state, the host mirrors and the interners
        (the JAX package's format); with the WAL, exact crash recovery
        (:func:`recover_distributed`)."""
        directory = pathlib.Path(directory)
        with self.lock:
            self._sync_mirrors()
            manifest = self.sharded.save(directory)
            cursor = self.total_cursor()
            cfg = dataclasses.asdict(self.config)
            host = {
                "format": 1,
                "config": {k: v for k, v in cfg.items() if k not in _PORT_ONLY},
                "port_config": {k: cfg[k] for k in _PORT_ONLY if k != "device"},
                "n_shards": self.n_shards,
                "epoch_base_unix_s": self.epoch.base_unix_s,
                "store_cursor": cursor,
                "next_device": [int(x) for x in self._next_device],
                "next_assignment": [int(x) for x in self._next_assignment],
                "tokens": [self.tokens.token(i) for i in range(len(self.tokens))],
                "tenants": [self.tenants.token(i) for i in range(len(self.tenants))],
                "device_types": [self.device_types.token(i)
                                 for i in range(len(self.device_types))],
                "channel_names": [self.channel_map.names.token(i)
                                  for i in range(len(self.channel_map.names))],
                "alert_types": [self.alert_types.token(i)
                                for i in range(len(self.alert_types))],
                "areas": [self.areas.token(i) for i in range(len(self.areas))],
                "customers": [self.customers.token(i)
                              for i in range(len(self.customers))],
                "assets": [self.assets.token(i) for i in range(len(self.assets))],
                "event_ids": [self.event_ids.token(i)
                              for i in range(len(self.event_ids))],
                "token_device": {str(k): v for k, v in self.token_device.items()},
                "devices": {str(d): dataclasses.asdict(i)
                            for d, i in self.devices.items()},
                "assignments": {str(a): dataclasses.asdict(i)
                                for a, i in self.assignments.items()},
                "device_slots": {str(k): v for k, v in self.device_slots.items()},
                "dead_letters": self.dead_letters[-4096:],
            }
            (directory / "host_distributed.json").write_text(json.dumps(host))
            if self.wal is not None:
                self.wal.append_watermark(cursor)
                self.wal.sync()
            manifest["store_cursor"] = cursor
            return manifest


def encode_event_id(pos: int, shard: int, arena: int, n_shards: int,
                    arenas: int) -> int:
    """Mesh-global event id ``pos * (n_shards * arenas) + shard * arenas +
    arena``: the one place the id layout lives (:func:`split_event_id`
    inverts it)."""
    return pos * (n_shards * arenas) + shard * arenas + arena


def split_event_id(event_id: int, n_shards: int,
                   arenas: int) -> tuple[int, int, int]:
    """Inverse of :func:`encode_event_id`: (pos, shard, arena)."""
    parts = n_shards * arenas
    part = event_id % parts
    return event_id // parts, part // arenas, part % arenas


class DistributedFeedConsumer:
    """Outbound consumer group over the mesh engine's per-shard rings: one
    committed offset a (shard, arena) sub-ring, event ids from
    :func:`encode_event_id`, so commits are exact and ids unique across the
    mesh. A consumer that falls behind replays evicted rows from the
    archive; without one, the overwritten rows count in ``lag_lost``."""

    def __init__(self, engine: DistributedEngine, group_id: str,
                 max_batch: int = 1024, start_from_latest: bool = False):
        self.engine = engine
        self.group_id = group_id
        self.max_batch = max_batch
        self.n_shards = engine.n_shards
        self.arenas = engine.arenas
        self.offsets = np.zeros((self.n_shards, self.arenas), np.int64)
        if start_from_latest:
            self.offsets[:] = engine._heads()
        self.lag_lost = 0

    def _events_from_slice(self, sl, base: int, count: int, s: int, a: int,
                           lane_names: dict[int, str]) -> list:
        """Enrich one contiguous host column slice (a ring read or an
        archived segment: both carry the ring's columns)."""
        from sitewhere_tpu_torch.outbound.feed import OutboundEvent

        eng = self.engine
        out = []
        for i in range(count):
            if not bool(sl.valid[i]):
                continue
            gdid = eng._gdid(s, int(sl.device[i]))
            info = eng.devices.get(gdid)
            et = EventType(int(sl.etype[i]))
            meas = {}
            lat = lon = None
            if et is EventType.MEASUREMENT:
                for ch in np.nonzero(np.asarray(sl.vmask[i]))[0]:
                    meas[lane_names.get(int(ch), f"ch{ch}")] = float(sl.values[i, ch])
            elif et is EventType.LOCATION and bool(sl.vmask[i, 0]):
                lat = float(sl.values[i, 0])
                lon = float(sl.values[i, 1])
            out.append(OutboundEvent(
                latitude=lat, longitude=lon,
                event_id=encode_event_id(base + i, s, a, self.n_shards, self.arenas),
                etype=et,
                device_token=info.token if info else f"#{gdid}",
                device_id=gdid,
                assignment_id=eng._gdid(s, int(sl.assignment[i])),
                tenant=(eng.tenants.token(int(sl.tenant[i]))
                        if int(sl.tenant[i]) != NULL_ID else "default"),
                area_id=int(sl.area[i]), customer_id=int(sl.customer[i]),
                asset_id=int(sl.asset[i]), ts_ms=int(sl.ts_ms[i]),
                received_ms=int(sl.received_ms[i]), measurements=meas,
                values=[float(v) for v in sl.values[i]],
                aux0=int(sl.aux[i, 0]), aux1=int(sl.aux[i, 1])))
        return out

    def poll(self) -> list:
        # the whole poll holds the engine lock: a concurrent flush replaces
        # the shards' states, and a wrapped ring would serve new rows under
        # old positions
        with self.engine.lock:
            if self.engine._pending_outs:
                self.engine.drain()
            return self._poll_locked()

    def _poll_locked(self) -> list:
        """The poll body; the caller holds the engine lock (it guards the
        shards' stores and the archive index)."""
        eng = self.engine
        acap = eng.ring_arena_capacity()
        heads = eng._heads()
        out: list = []
        archive = eng.archive
        lane_names = eng._lane_names()
        for s in range(self.n_shards):
            for a in range(self.arenas):
                head = int(heads[s, a])
                if head <= self.offsets[s, a]:
                    continue
                # a lagging consumer replays evicted rows from its archive
                # partition; replay does not advance the committed offset
                # (redelivery until commit), only an unrecoverable gap does,
                # and counts as lag_lost
                oldest = max(0, head - acap)
                budget = self.max_batch
                part = s * self.arenas + a
                if archive is None and self.offsets[s, a] < oldest:
                    self.lag_lost += oldest - int(self.offsets[s, a])
                    self.offsets[s, a] = oldest
                pos = int(self.offsets[s, a])
                while archive is not None and pos < oldest and budget > 0:
                    sl, n = archive.read_rows(part, pos, min(oldest - pos, budget))
                    if n == 0:
                        # skip a gap only when nothing replayed but
                        # uncommitted precedes it (else a crash before the
                        # commit would drop those events)
                        if pos != int(self.offsets[s, a]):
                            break
                        nxt = archive.next_start(part, pos)
                        nxt = oldest if nxt is None else min(nxt, oldest)
                        # registered gaps never held data: not a loss
                        self.lag_lost += max(0, nxt - pos - archive.gap_rows(part, pos, nxt))
                        self.offsets[s, a] = nxt
                        pos = nxt
                        continue
                    out.extend(self._events_from_slice(sl, pos, n, s, a, lane_names))
                    pos += n
                    budget -= n
                if pos < oldest:
                    continue   # the batch filled mid-replay: next poll resumes
                count = min(head - pos, budget)
                if count <= 0:
                    continue
                sl = slice_to_host(read_range(eng.shards[s].store, pos % acap, count,
                                              arena=a))
                out.extend(self._events_from_slice(sl, pos, count, s, a, lane_names))
        return out

    def commit(self, events: list) -> None:
        for ev in events:
            pos, s, a = split_event_id(ev.event_id, self.n_shards, self.arenas)
            self.offsets[s, a] = max(self.offsets[s, a], pos + 1)


def restore_distributed(directory, device: str | torch.device = DEFAULT_DEVICE,
                        epoch_cls: type[EpochBase] = EpochBase) -> DistributedEngine:
    """A DistributedEngine from a snapshot directory of either package
    (the same shard count: ``parallel/reshard.reshard_snapshot`` changes
    it first), its shards on ``device``."""
    directory = pathlib.Path(directory)
    host = json.loads((directory / "host_distributed.json").read_text())
    config = DistributedConfig(**host["config"], **host.get("port_config", {}))
    config.n_shards = host["n_shards"]
    config.device = str(device)
    eng = DistributedEngine(config)
    eng.sharded.restore(directory)
    eng.epoch = epoch_cls(host["epoch_base_unix_s"])
    eng._next_device = np.asarray(host["next_device"], np.int64)
    eng._next_assignment = np.asarray(host["next_assignment"], np.int64)
    for key, interner in (("tokens", eng.tokens), ("tenants", eng.tenants),
                          ("device_types", eng.device_types),
                          ("channel_names", eng.channel_map.names),
                          ("alert_types", eng.alert_types), ("areas", eng.areas),
                          ("customers", eng.customers), ("assets", eng.assets),
                          ("event_ids", eng.event_ids)):
        for tok in host[key]:
            interner.intern(tok)
    eng.token_device = {int(k): v for k, v in host["token_device"].items()}
    eng.devices = {int(k): DeviceInfo(**v) for k, v in host["devices"].items()}
    eng.assignments = {int(k): AssignmentInfo(**v)
                       for k, v in host["assignments"].items()}
    eng.assignment_tokens = {i.token: a for a, i in eng.assignments.items()}
    eng.device_slots = {int(k): list(v) for k, v in host["device_slots"].items()}
    eng.dead_letters = list(host["dead_letters"])
    # the conservation ledger rebases over the restored counters before
    # any WAL replay
    eng.ledger.rebase(eng)
    return eng


def recover_distributed(snapshot_dir, wal_dir=None, adopt_wal: bool = False,
                        device: str | torch.device = DEFAULT_DEVICE,
                        epoch_cls: type[EpochBase] = EpochBase) -> DistributedEngine:
    """Crash recovery of the mesh engine: restore the snapshot, then replay
    the WAL past its watermark through the wire format that accepted each
    record (``utils/checkpoint.replay_wal_into``, as ``recover_engine``).

    ``adopt_wal=True``: when the snapshot carries no WAL (a resharded one
    sets ``wal_dir`` to None), the engine adopts ``wal_dir`` as its live
    log after the replay. By default a log named here stays read-only (a
    preserved recovery copy stays byte-identical)."""
    from sitewhere_tpu_torch.utils.checkpoint import replay_wal_into

    snapshot_dir = pathlib.Path(snapshot_dir)
    eng = restore_distributed(snapshot_dir, device, epoch_cls)
    host = json.loads((snapshot_dir / "host_distributed.json").read_text())
    if wal_dir is None and eng.config.wal_dir is None:
        return eng
    if adopt_wal and eng.wal is None and wal_dir is not None:
        # the tail replays first, then new ingest journals into the same
        # log (the replay detaches the live WAL while it feeds records)
        from sitewhere_tpu_torch.utils.ingestlog import IngestLog

        eng.config.wal_dir = str(wal_dir)
        eng.wal = IngestLog(wal_dir, group_commit=eng.config.wal_group_commit)
    replay_wal_into(eng, host["store_cursor"], wal_dir)
    return eng
