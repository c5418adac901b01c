"""The multi-shard engines (port of ``sitewhere_tpu/parallel/sharded.py``).

Every shard owns a slice of the token space and of the device-row space,
so after routing each shard runs the single-card fused step
(``pipeline.pipeline_step``) on its own slice. JAX keeps one stacked
``[n_shards, ...]`` state sharded over a device mesh and runs the step
once per chip in one ``shard_map`` program. The port keeps one
``PipelineState`` a shard, each on its shard's device of the mesh
(``parallel/mesh.make_mesh``: every shard on ``cuda:0`` on one card, shard
``s`` on ``cuda:s`` with several), and a dispatch loops the single-card
step over the shards; each engine's ``state`` property is the stacked
view (``stack_states``) that save, restore and the parity tests read.
Folding the shard axis into the ops, so that all shards share one set of
launches, is later speed work.

* :class:`ShardedEngine` — the stripped-down engine over stacked state:
  host-routed per-shard batches, or (``exchange=True``) unrouted batches
  moved to their owners by ``parallel/exchange.exchange_events``; global
  queries, presence sweep, state readback, save and restore. Given a
  ``process_group`` that spans several processes, each process holds
  its own shards of one global numbering
  (``parallel/multihost.local_shard_ids``), ``n_shards`` counts them all
  and ``global_metrics`` sums over the group; the cross-process exchange,
  queries and snapshots are refused with the limit named. Without one
  (the default), the shards are this process's alone, whatever default
  group the process has joined.
* :class:`SpmdEngine` — the real engine (``engine.Engine``) with its
  device plane over the shards: one host surface (WAL, QoS, tracing and
  flight records, the conservation ledger, admin, rules and rollups,
  zones), token-slot routing (``parallel/placement``), a stacked
  ``[n_shards, rows]`` staging arena (``ingest/arena.ShardedStagingArena``)
  or the per-row router (``arena=False``), ``scan_chunk`` > 1 and
  ``ingest_arenas`` depth, query rounds over every shard
  (:class:`SpmdQueryBatcher`), and the shard flow and heat documents.

Host contract: device and assignment ids are shard-qualified (``gid =
shard * capacity + local``) on every host surface; token ids stay global
in one interner, and each shard's store rows carry local ids.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, resolve_device
from sitewhere_tpu_torch.core.events import EventBatch, HostEventBuffer
from sitewhere_tpu_torch.core.registry import MAX_ACTIVE_ASSIGNMENTS
from sitewhere_tpu_torch.core.state import RECENT_DEPTH
from sitewhere_tpu_torch.core.types import (NULL_ID, NUM_EVENT_TYPES,
                                            DeviceAssignmentStatus, EventType,
                                            PresenceState)
from sitewhere_tpu_torch.engine import (DeviceInfo, Engine, EngineConfig,
                                        QueryBatcher, _admin_add_assignment,
                                        _admin_create_device,
                                        _admin_set_assignment_status,
                                        _admin_set_device_active,
                                        _admin_set_parent,
                                        _admin_update_assignment,
                                        _admin_update_device,
                                        _fetch_query_result, _merge_summaries,
                                        _tenant_event_counts,
                                        format_tenant_counter_grid,
                                        merged_rules_state, tenant_cap,
                                        tenant_counts_dict)
from sitewhere_tpu_torch.ops.query import (QueryParams, merge_shard_pages,
                                           query_store, query_store_batch)
from sitewhere_tpu_torch.parallel.exchange import exchange_events
from sitewhere_tpu_torch.parallel.mesh import make_mesh
from sitewhere_tpu_torch.parallel.multihost import all_sum, group_span
from sitewhere_tpu_torch.parallel.placement import (DEFAULT_SLOTS_PER_RANK,
                                                    slot_for_token)
from sitewhere_tpu_torch.pipeline import (PipelineConfig, PipelineState,
                                          StepOutput, make_arena_scan_step,
                                          make_presence_sweep, pipeline_step)
from sitewhere_tpu_torch.utils.shardobs import ShardHeatTracker


# --------------------------------------------------------------- state trees

def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of one or more state dataclasses of
    one structure (None subtrees stay None; static fields, such as a rule
    block's ``layout``, are taken from ``tree``)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return tree


def stack_states(states: list, device: torch.device | None = None):
    """Per-shard states (or batches) stacked on a leading ``[n_shards]``
    axis, on ``device`` (default: the first shard's)."""
    dev = device or next(iter(_leaves(states[0]))).device
    return tree_map(lambda *xs: torch.stack([x.to(dev) for x in xs]), *states)


def unstack_state(stacked, mesh: list[torch.device]) -> list:
    """A stacked state split into one state a shard, shard ``s`` on
    ``mesh[s]``."""
    return [tree_map(lambda x, _s=s, _d=d: x[_s].to(_d).clone(), stacked)
            for s, d in enumerate(mesh)]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def create_stacked_state(mesh: list[torch.device], device_capacity_per_shard: int,
                         token_capacity_per_shard: int,
                         assignment_capacity_per_shard: int,
                         store_capacity_per_shard: int,
                         channels: int = 8) -> list[PipelineState]:
    """One fresh engine state a shard, each on its shard's device."""
    return [PipelineState.create(device_capacity_per_shard, token_capacity_per_shard,
                                 assignment_capacity_per_shard,
                                 store_capacity_per_shard, channels, device=d)
            for d in mesh]


def split_batch(batch, mesh: list[torch.device]) -> list[EventBatch]:
    """A stacked ``[n_shards, B, ...]`` batch (numpy or tensor columns)
    as one EventBatch a shard on its device; a list passes through, each
    batch moved to its shard's device. Page-locked host tensor columns
    move with asynchronous copies."""
    if isinstance(batch, (list, tuple)):
        return [tree_map(lambda x, _d=d: x.to(_d), b) for b, d in zip(batch, mesh)]

    def col(x, s, dev):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x[s])).to(dev)
        # page-locked host columns copy asynchronously (their owner does not
        # write them again)
        return x[s].to(dev, non_blocking=dev.type == "cuda" and x.is_pinned())

    return [EventBatch(**{f.name: col(getattr(batch, f.name), s, d)
                          for f in dataclasses.fields(EventBatch)})
            for s, d in enumerate(mesh)]


def _stack_outs(outs: list[StepOutput], device: torch.device) -> StepOutput:
    return StepOutput(*(torch.stack([x.to(device) for x in field])
                        for field in zip(*outs)))


def _sweep_shards(states, now_ms: int, missing_ms: int):
    """The presence sweep on every shard: (new states, newly-missing masks
    as host bool arrays)."""
    sweep = make_presence_sweep()
    new_states, masks = [], []
    for st in states:
        i32 = dict(dtype=torch.int32, device=st.next_device.device)
        st, newly = sweep(st, torch.tensor(now_ms, **i32),
                          torch.tensor(missing_ms, **i32))
        new_states.append(st)
        masks.append(newly)
    return new_states, [m.cpu().numpy() for m in masks]


class _Fences:
    """The ticket of one dispatch over several devices: a CUDA event on
    each, complete when all are."""

    def __init__(self, events):
        self.events = events

    def query(self) -> bool:
        return all(e.query() for e in self.events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


# ------------------------------------------------------------ ShardedEngine

class ShardedEngine:
    """Host handle of the stripped-down sharded engine: the mesh, one state
    a shard, the routed or exchanging step. Entry points run on the card
    unless ``device`` says otherwise. ``mesh`` and ``shards`` are this
    process's; ``n_shards`` is the job's (``n_local`` a process, the
    first of them ``shard_offset``): ``n_local`` unless the caller passes
    the ``process_group`` the job's shards span."""

    def __init__(self, n_shards: int | None = None,
                 device_capacity_per_shard: int = 4096,
                 token_capacity_per_shard: int = 8192,
                 assignment_capacity_per_shard: int = 8192,
                 store_capacity_per_shard: int = 1 << 16,
                 channels: int = 8, config: PipelineConfig | None = None,
                 exchange: bool = False, bucket_capacity: int | None = None,
                 device: str | torch.device = DEFAULT_DEVICE,
                 process_group=None):
        self.mesh = make_mesh(n_shards, device)
        self.group = process_group
        rank, world = group_span(process_group)
        self.n_local = len(self.mesh)
        self.n_shards = self.n_local * world
        self.shard_offset = rank * self.n_local
        self.tokens_per_shard = token_capacity_per_shard
        self.config = config or PipelineConfig()
        self.exchange = exchange
        self.bucket = bucket_capacity or 0
        self.channels = channels
        self.shards = create_stacked_state(
            self.mesh, device_capacity_per_shard, token_capacity_per_shard,
            assignment_capacity_per_shard, store_capacity_per_shard, channels)

    @property
    def state(self) -> PipelineState:
        """The stacked ``[n_shards, ...]`` view of the shards' states (a
        copy, on the first shard's device)."""
        return stack_states(self.shards, self.mesh[0])

    @state.setter
    def state(self, stacked: PipelineState) -> None:
        self.shards = unstack_state(stacked, self.mesh)

    def shard_of_token(self, global_token: int) -> tuple[int, int]:
        """(shard, local_token) of a global token id: the host-side
        partitioner."""
        return global_token // self.tokens_per_shard, global_token % self.tokens_per_shard

    def step(self, stacked_batch) -> StepOutput:
        """One sharded step over a stacked ``[n_shards, B, ...]`` batch (or
        a list of per-shard batches); returns the per-shard outputs
        stacked. With ``exchange`` every row first moves to the shard
        that owns its token, and bucket overflow counts as missed."""
        if self.exchange and not self.bucket:
            raise ValueError("exchange=True requires bucket_capacity")
        if self.exchange:
            self._single_process("the exchange across processes")
        batches = split_batch(stacked_batch, self.mesh)
        overflow = [None] * self.n_local
        if self.exchange:
            res = exchange_events(batches, self.n_shards, self.tokens_per_shard,
                                  self.bucket)
            batches = [r.batch for r in res]
            overflow = [r.n_overflow for r in res]
        outs = []
        for s in range(self.n_local):
            st, out = pipeline_step(self.shards[s], batches[s], self.config)
            if overflow[s] is not None:
                out = out._replace(n_missed=out.n_missed + overflow[s])
                st = dataclasses.replace(st, metrics=dataclasses.replace(
                    st.metrics, missed=st.metrics.missed + overflow[s]))
            self.shards[s] = st
            outs.append(out)
        return _stack_outs(outs, self.mesh[0])

    def _single_process(self, what: str) -> None:
        if self.n_shards != self.n_local:
            raise ValueError(f"ShardedEngine: {what} is not supported when the "
                             f"shards span {self.n_shards // self.n_local} processes")

    def global_metrics(self) -> dict:
        """The scalar counters summed over the shards, over every process
        of the group (the per-tenant grid is not folded)."""
        fields = [f.name for f in dataclasses.fields(self.shards[0].metrics)
                  if getattr(self.shards[0].metrics, f.name).dim() == 0]
        vals = np.sum([torch.stack([getattr(st.metrics, f) for f in fields]).cpu().numpy()
                       for st in self.shards], axis=0)
        if self.n_shards != self.n_local:
            vals = all_sum(vals, self.group)
        return {f: int(v) for f, v in zip(fields, vals)}

    # ----------------------------------------------------------- queries
    def query_events(self, etype: EventType | None = None,
                     tenant_id: int | None = None, since_ms: int | None = None,
                     until_ms: int | None = None, limit: int = 100) -> dict:
        """Global newest-first event query: every shard scans its own ring
        (:func:`_stacked_query`), then the per-shard pages merge on the
        host, newest first, shard-major on ties."""
        self._single_process("query_events")
        imin, imax = -(2**31), 2**31 - 1
        res = _stacked_query(
            [st.store for st in self.shards],
            int(etype) if etype is not None else NULL_ID,
            tenant_id if tenant_id is not None else NULL_ID,
            since_ms if since_ms is not None else imin,
            until_ms if until_ms is not None else imax, limit=limit)
        total = int(np.sum(res.total))
        valid = np.arange(res.ts_ms.shape[1])[None, :] < res.n[:, None]
        s_idx, i_idx = np.nonzero(valid)
        order = np.argsort(-res.ts_ms[s_idx, i_idx], kind="stable")[:limit]
        events = [{"shard": int(s), "type": EventType(int(res.etype[s, i])).name,
                   "device": int(res.device[s, i]),
                   "assignmentId": int(res.assignment[s, i]),
                   "tenant": int(res.tenant[s, i]),
                   "eventDateMs": int(res.ts_ms[s, i])}
                  for s, i in zip(s_idx[order], i_idx[order])]
        return {"total": total, "events": events}

    def presence_sweep(self, now_ms: int, missing_ms: int) -> list[tuple[int, int]]:
        """Mark stale devices MISSING on this process's shards; returns the
        (global shard, local_device_id) pairs newly missing."""
        self.shards, masks = _sweep_shards(self.shards, now_ms, missing_ms)
        return [(self.shard_offset + s, int(d))
                for s, m in enumerate(masks) for d in np.nonzero(m)[0]]

    def device_state_summary(self, shard: int, device_id: int) -> dict:
        """One device's aggregated state, read from its owning shard (one
        of this process's)."""
        if not 0 <= shard - self.shard_offset < self.n_local:
            raise ValueError(f"shard {shard} is not one of this process's "
                             f"{self.shard_offset}..{self.shard_offset + self.n_local - 1}")
        ds = self.shards[shard - self.shard_offset].device_state
        presence, last = torch.stack([ds.presence[device_id].to(torch.int64),
                                      ds.last_interaction_ms[device_id].to(torch.int64)
                                      ]).cpu().tolist()
        counts = ds.event_counts[device_id].cpu().numpy()
        return {"shard": shard, "device": device_id,
                "presence": PresenceState(presence).name,
                "lastInteractionMs": last,
                "eventCounts": {EventType(e).name: int(counts[e])
                                for e in range(NUM_EVENT_TYPES)}}

    # -------------------------------------------------------- durability
    def save(self, directory) -> dict:
        """Snapshot every shard's state (stacked) to a directory."""
        from sitewhere_tpu_torch.utils.checkpoint import _leaves as state_leaves

        self._single_process("save")
        directory = pathlib.Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        arrays = {k: v.cpu().numpy() for k, v in state_leaves(self.state)}
        np.savez_compressed(directory / "sharded_state.npz", **arrays)
        manifest = {"format": 1, "n_shards": self.n_shards,
                    "tokens_per_shard": self.tokens_per_shard,
                    "channels": self.channels, "metrics": self.global_metrics()}
        (directory / "sharded_manifest.json").write_text(json.dumps(manifest))
        return manifest

    def restore(self, directory) -> None:
        """Load a snapshot written by :meth:`save` (the shard count, token
        slice and channels must match)."""
        from sitewhere_tpu_torch.utils.checkpoint import _leaves as state_leaves

        self._single_process("restore")
        directory = pathlib.Path(directory)
        manifest = json.loads((directory / "sharded_manifest.json").read_text())
        for key, have in (("n_shards", self.n_shards),
                          ("tokens_per_shard", self.tokens_per_shard),
                          ("channels", self.channels)):
            if manifest[key] != have:
                raise ValueError(f"snapshot {key}={manifest[key]} != engine {key}={have}")
        data = np.load(directory / "sharded_state.npz")
        cur = self.state
        loaded = {}
        for key, t in state_leaves(cur):
            if key.startswith(".metrics.") and key not in data.files:
                loaded[key] = t          # a counter the snapshot predates
                continue
            arr = data[key]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"snapshot leaf {key} shape {arr.shape} != engine "
                                 f"{tuple(t.shape)} (capacity mismatch)")
            loaded[key] = torch.from_numpy(arr).to(t.device)
        paths = iter(k for k, _ in state_leaves(cur))
        self.state = tree_map(lambda _t: loaded[next(paths)], cur)


class _HostPage:
    """Per-shard query pages fetched to the host and stacked: the fields
    of ``QueryResult`` with a leading shard axis (numpy)."""

    def __init__(self, results):
        host = [_fetch_query_result(r) for r in results]
        for name in host[0]._fields:
            setattr(self, name, np.stack([getattr(h, name) for h in host]))


def _stacked_query(stores, etype, tenant, t0, t1, *, limit, device=None,
                   device_shard=None, assignment=None, assignment_shard=None,
                   aux0=None, aux1=None, area=None, customer=None) -> _HostPage:
    """The ring query on every shard, pages fetched and stacked on a
    leading shard axis. ``device``/``device_shard`` (and the assignment
    pair) restrict the scan to one row on its owning shard; the other
    filters pass to ``query_store`` on every shard."""
    results = []
    for sidx, st in enumerate(stores):
        dev = NULL_ID if device is None else device
        if device_shard is not None and sidx != device_shard:
            dev = -2     # matched by no store row
        asn = assignment
        if assignment is not None and assignment_shard is not None \
                and sidx != assignment_shard:
            asn = -2
        results.append(query_store(st, dev, etype, tenant, t0, t1, limit=limit,
                                   assignment=asn, aux0=aux0, aux1=aux1, area=area,
                                   customer=customer))
    return _HostPage(results)


# --------------------------------------------------------------- SpmdEngine

class SpmdQueryBatcher(QueryBatcher):
    """The query round over every shard: each group's ``query_store_batch``
    runs on every shard's store (on its own device), then the per-shard
    pages merge on the host into the single-card page
    (``ops.query.merge_shard_pages``). Device and assignment predicates
    arrive in the global id space (``shard * capacity + local``) and are
    localized to the owning shard; the other shards match nothing."""

    def _snapshot(self):
        return [st.store for st in self.engine.shards]

    def _launch(self, stores, cols: torch.Tensor, limit: int):
        eng = self.engine
        dcap, acap = eng._device_cap, eng._assignment_cap
        out = []
        for sidx, store in enumerate(stores):
            c = cols.clone()
            for row, cap in ((0, dcap), (5, acap)):   # device, assignment
                col = c[row]
                loc = torch.where(torch.div(col, cap, rounding_mode="floor") == sidx,
                                  col - sidx * cap, -2)
                c[row] = torch.where(col == NULL_ID, NULL_ID, loc)
            out.append(query_store_batch(store, QueryParams(*c.to(eng.mesh[sidx])),
                                         limit=limit))
        return out

    def _unpack_round(self, entries: list[dict], results, cursors) -> None:
        eng = self.engine
        host = _HostPage(results)              # every field [S, Q, ...]
        off = np.arange(eng.n_shards, dtype=np.int64).reshape(-1, 1, 1)
        dev, asn = host.device, host.assignment
        host.device = np.where(dev >= 0, dev + off * eng._device_cap, dev).astype(dev.dtype)
        host.assignment = np.where(asn >= 0, asn + off * eng._assignment_cap,
                                   asn).astype(asn.dtype)
        from sitewhere_tpu_torch.ops.query import QueryResult

        for q, entry in enumerate(entries):
            pages = QueryResult(*(getattr(host, f)[:, q] for f in QueryResult._fields))
            entry["result"] = merge_shard_pages(pages, entry["limit"])
            entry["cursors"] = cursors
            entry["q"] = len(entries)
            entry["event"].set()


class SpmdEngine(Engine):
    """The real engine with its device plane over ``n_shards`` shards.

    One engine object, one host surface (``ingest_json_batch``,
    ``query_events``, ``register_device``, ``metrics``, rules — the
    ``Engine`` API), one state a shard:

    - the slot space of ``parallel/placement`` is the sharding axis:
      ``shard_for_token(token, n)`` routes a token where the cluster's
      genesis ``owner_rank`` map would place it;
    - batch ingest decodes the wire batch once (the native scanner, else
      the Python decoder into the same SoA columns), routes every row to
      its shard vectorized, and scatters the rows into the lanes of a
      stacked ``[n_shards, rows]`` staging arena, one copy per shard to
      its device at dispatch. The per-row router (:meth:`_stage_row`)
      carries the admin and registration rows, and every row with
      ``arena=False``. A dispatch runs the single-card step on each
      shard's lane (WAL durable before the copy, ``dispatch_depth``
      pipelining and the arena recycle kept); ``scan_chunk`` K > 1 runs
      K steps a shard on its K lanes, and ``ingest_arenas`` depth > 1
      overlaps the decode of batch N+1 with the device work of batch N;
    - queries run each shard's ring scan and merge on the host
      (:class:`SpmdQueryBatcher`), equal to the single-card page
      whenever timestamp ties do not span shards;
    - rules are installed on every shard; a harvest folds the per-shard
      rings (``ops.rules.merge_shard_harvests``).

    Device and assignment ids are shard-qualified (``gid = shard *
    capacity + local_id``) on every host surface; store rows carry local
    ids.

    Refused, as in the JAX package: the archive tier, the analytics
    window, ``fair_tenancy``, ``tenant_arenas`` != 1, ``autotune``,
    parents on another shard; ``search_device_states``, ``get_event``,
    the outbound feed and ``ingest_event_batch`` are not shard-aware."""

    def __init__(self, config: EngineConfig | None = None,
                 n_shards: int | None = None, arena: bool = True,
                 device: str | torch.device = DEFAULT_DEVICE):
        cfg0 = config or EngineConfig()
        for bad, why in (
                (cfg0.archive_dir, "archive tier"),
                (cfg0.analytics_devices, "analytics window"),
                (cfg0.tenant_arenas != 1, "tenant_arenas != 1"),
                (cfg0.fair_tenancy, "fair_tenancy"),
                (cfg0.autotune, "autotune")):
            if bad:
                raise ValueError(f"SpmdEngine does not support {why} (v1)")
        mesh = make_mesh(n_shards, device)
        n = len(mesh)
        # arena=False keeps the per-row router on the batch path: the
        # byte-identity oracle
        self._spmd_arena = bool(arena) and cfg0.ingest_arenas >= 0
        self.mesh = mesh
        self.n_shards = n
        self._device_cap = cfg0.device_capacity
        self._token_cap = cfg0.token_capacity
        self._assignment_cap = cfg0.assignment_capacity
        self._store_cap = cfg0.store_capacity
        # the interner spans every shard's tokens; the base constructor
        # builds the shards (_create_state) and the stacked arena pool
        # (_create_arenas)
        super().__init__(dataclasses.replace(
            cfg0, use_native=cfg0.use_native and self._spmd_arena,
            token_capacity=cfg0.token_capacity * n), device=mesh[0])
        c = self.config
        # host router: one staging lane a shard; token routes cache as
        # (shard, local_token_id), mirrored in arrays for the batch path
        self._shard_bufs = [HostEventBuffer(c.batch_capacity, c.channels)
                            for _ in range(n)]
        self._shard_tokens: list[list[int]] = [[] for _ in range(n)]
        self._tid_route: dict[int, tuple[int, int]] = {}
        self._route_shard = np.full(c.token_capacity, -1, np.int32)
        self._route_ltid = np.full(c.token_capacity, -1, np.int32)
        self._next_local_device = [0] * n
        self._next_local_assignment = [0] * n
        # shard observability: per-shard flow counters at the sites the
        # conservation ledger counts (same ``ledger.enabled`` gate), and
        # the slot bincount, dispatch skew and staged high-watermark that
        # ``shard_heat.enabled`` toggles
        self._shard_rows_routed = np.zeros(n, np.int64)
        self._shard_rows_dispatched = np.zeros(n, np.int64)
        self._shard_staged_hwm = np.zeros(n, np.int64)
        self._route_slot = np.full(c.token_capacity, -1, np.int32)
        self._slot_rows = np.zeros(n * DEFAULT_SLOTS_PER_RANK, np.int64)
        self.shard_heat = ShardHeatTracker(n, n * DEFAULT_SLOTS_PER_RANK)
        old = self._query_batcher
        self._query_batcher = SpmdQueryBatcher(self, max_batch=c.query_coalesce)
        self._query_batcher._wfq = old._wfq

    # ------------------------------------------------------------ state
    def _create_state(self) -> None:
        self.shards = create_stacked_state(
            self.mesh, self._device_cap, self._token_cap, self._assignment_cap,
            self._store_cap, self.config.channels)

    def _create_arenas(self) -> None:
        # the stacked arena pool; no decode sharder (as in JAX)
        if self._spmd_arena:
            self._build_arena_machinery(max(1, self.config.scan_chunk))

    @property
    def state(self) -> PipelineState:
        """The stacked ``[n_shards, ...]`` view of the shards' states (a
        copy, on the first shard's device): what the JAX engine's
        ``state`` is."""
        return stack_states(self.shards, self.mesh[0])

    @state.setter
    def state(self, stacked: PipelineState) -> None:
        self.shards = unstack_state(stacked, self.mesh)

    def _fence(self):
        """The dispatch's ticket: a CUDA event on every card a shard sits
        on (None when every shard is on the CPU)."""
        devs = {d for d in self.mesh if d.type == "cuda"}
        if not devs:
            return None
        events = []
        for d in sorted(devs, key=lambda x: x.index or 0):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            events.append(ev)
        return events[0] if len(events) == 1 else _Fences(events)

    # ---------------------------------------------------------- routing
    def _build_arena_machinery(self, k: int) -> None:
        from sitewhere_tpu_torch.ingest.arena import ArenaPool, ShardedStagingArena

        c = self.config
        rows = c.batch_capacity * k
        pin = any(d.type == "cuda" for d in self.mesh)
        self._arena_pool = ArenaPool(
            c.ingest_arenas or max(1, c.dispatch_depth) + 2, rows, c.channels,
            lanes=k, factory=lambda: ShardedStagingArena(
                self.n_shards, rows, c.channels, lanes=k, pin=pin))
        self._arena_step = None
        if k > 1:
            self._arena_step = make_arena_scan_step(
                self.pipeline_config, c.batch_capacity, c.channels, k)

    def _route_token(self, token_id: int) -> tuple[int, int]:
        """(shard, local_token_id) of a global interned token: the slot
        space decides the shard, local ids allocate densely a shard in
        first-seen order (as a single-card engine fed that shard's
        substream would)."""
        route = self._tid_route.get(token_id)
        if route is None:
            slot = slot_for_token(self.tokens.token(token_id), self.n_shards)
            shard = slot % self.n_shards
            locs = self._shard_tokens[shard]
            ltid = len(locs)
            if ltid >= self._token_cap:
                raise RuntimeError("token capacity exhausted")
            locs.append(token_id)
            route = (shard, ltid)
            self._tid_route[token_id] = route
            if token_id < len(self._route_shard):
                self._route_shard[token_id] = shard
                self._route_ltid[token_id] = ltid
                self._route_slot[token_id] = slot
        return route

    def _route_rows(self, tids: np.ndarray):
        """Vectorized (shard, local_tid) of a batch of global token ids;
        unseen tokens route in first-occurrence order, as the per-row
        router would allocate them."""
        sh = self._route_shard[tids]
        if (sh < 0).any():
            miss = tids[sh < 0]
            _, first = np.unique(miss, return_index=True)
            for t in miss[np.sort(first)]:
                self._route_token(int(t))
            sh = self._route_shard[tids]
        return sh, self._route_ltid[tids]

    # ----------------------------------------------------------- ingest
    def _stage_row(self, et, token_id, tenant_id, ts, now, values, mask,
                   aux0, aux1) -> None:
        self.host_counters["staged_copy_rows"] = \
            self.host_counters.get("staged_copy_rows", 0) + 1
        self.ledger.add("staged_rows", 1)
        shard, ltid = self._route_token(token_id)
        if self.ledger.enabled:
            self._shard_rows_routed[shard] += 1
        if self.shard_heat.enabled and token_id < len(self._route_slot):
            self._slot_rows[self._route_slot[token_id]] += 1
        buf = self._shard_bufs[shard]
        i = len(buf)
        if not buf.append(et, ltid, tenant_id, ts, now, (), aux0, aux1):
            self.flush_async()
            i = len(buf)
            buf.append(et, ltid, tenant_id, ts, now, (), aux0, aux1)
        if mask is not None and mask.any():
            buf.values[i, :] = values
            buf.vmask[i, :] = mask
        if buf.full:
            self.flush_async()

    def _ingest_batch_inner(self, payloads, tenant, tag, dec, native_fn,
                            binary, rec, gate_ctx) -> dict:
        """The batch skeleton with the stacked-arena scatter in place of
        the single arena: the batch decodes once (the native scanner, else
        :meth:`_decode_batch_py`) and scatters into the shard lanes. The
        lock and WAL order is the base skeleton's; ``arena=False`` takes
        the base path, whose rows reach :meth:`_stage_row`."""
        if self._arena_pool is None:
            return super()._ingest_batch_inner(payloads, tenant, tag, dec,
                                               native_fn, binary, rec, gate_ctx)
        if native_fn is None:
            with gate_ctx, self.lock:
                try:
                    res = self._decode_batch_py(payloads, dec)
                    if res is None:
                        # stream or multi-request envelopes: the whole batch
                        # takes the per-request path
                        predecoded = self._strict_predecode(payloads, dec)
                        self._wal_append(tag, payloads, tenant)
                        summary = self._ingest_python_fallback(payloads, tenant,
                                                               dec, predecoded)
                        rec.mark("decode")
                        rec.mark("commit")
                        return summary
                    rec.mark("decode")
                    self._wal_append(tag, payloads, tenant)
                    return self._ingest_decoded_spmd(res, payloads, tenant, dec,
                                                     rec)
                finally:
                    self._clear_now_pin()
        if self.config.strict_channels:
            with gate_ctx, self.lock:
                try:
                    names_before = len(self.channel_map.names)
                    res = native_fn(payloads)
                    rec.mark("decode")
                    self._check_strict_native(res, names_before)
                    self._wal_append(tag, payloads, tenant)
                    return self._ingest_decoded_spmd(res, payloads, tenant, dec,
                                                     rec)
                finally:
                    self._clear_now_pin()
        # lenient path: native decode outside the lock (and the turn)
        res = native_fn(payloads)
        rec.mark("decode")
        with gate_ctx, self.lock:
            try:
                self._wal_append(tag, payloads, tenant)
                return self._ingest_decoded_spmd(res, payloads, tenant, dec, rec)
            finally:
                self._clear_now_pin()

    def _decode_batch_py(self, payloads, dec):
        """The Python decode into the native decoder's SoA layout
        (``DecodedArrays``), so the arena scatter runs the same with or
        without the C++ scanner. Interning follows payload order (token,
        the row's string fields, the alternate id: :meth:`process`'s
        order), so every interner id matches the per-request path. None
        when a payload is not a single mappable request (the caller takes
        the per-request path for the whole batch). Caller holds the
        lock."""
        from sitewhere_tpu_torch.ingest.fast_decode import (
            RT_ACK, RT_ALERT, RT_LOCATION, RT_MAP, RT_MEASUREMENT, RT_REGISTER,
            RT_STATE_CHANGE, RTYPE_TO_ETYPE, DecodedArrays)
        from sitewhere_tpu_torch.ingest.requests import RequestType

        rt_of = {
            RequestType.REGISTER_DEVICE: RT_REGISTER,
            RequestType.DEVICE_MEASUREMENT: RT_MEASUREMENT,
            RequestType.DEVICE_LOCATION: RT_LOCATION,
            RequestType.DEVICE_ALERT: RT_ALERT,
            RequestType.DEVICE_STATE_CHANGE: RT_STATE_CHANGE,
            RequestType.ACKNOWLEDGE: RT_ACK,
            RequestType.MAP_DEVICE: RT_MAP,
        }
        n = len(payloads)
        reqs: list = []
        names: list[str] = []
        for p in payloads:
            try:
                decoded = dec.decode(p, {})
            except Exception:
                reqs.append(None)   # a failed row (rtype -1)
                continue
            if len(decoded) != 1 or decoded[0].type not in rt_of:
                return None
            reqs.append(decoded[0])
            if decoded[0].measurements:
                names.extend(decoded[0].measurements)
        if self.channel_map.strict:
            # refuse before interning and the WAL: a refused batch leaks nothing
            self.channel_map.validate(names)
        c = self.config.channels
        rtype = np.full(n, -1, np.int32)
        token_id = np.full(n, -1, np.int32)
        ts64 = np.full(n, -1, np.int64)
        values = np.zeros((n, c), np.float32)
        chmask = np.zeros((n, c), np.bool_)
        aux0 = np.full(n, NULL_ID, np.int32)
        aux1 = np.full(n, NULL_ID, np.int32)
        level = np.zeros(n, np.int32)
        for i, req in enumerate(reqs):
            if req is None:
                continue
            try:
                rt = rt_of[req.type]
                token_id[i] = self.tokens.intern(req.device_token)
                if req.event_ts_ms is not None:
                    ts64[i] = req.event_ts_ms
                et = RTYPE_TO_ETYPE[rt]
                if et == int(EventType.MEASUREMENT) and req.measurements:
                    for name, val in req.measurements.items():
                        ch = self.channel_map.channel_of(name)
                        values[i, ch] = val
                        chmask[i, ch] = True
                elif et == int(EventType.LOCATION):
                    if req.latitude is not None and req.longitude is not None:
                        values[i, 0] = req.latitude
                        values[i, 1] = req.longitude
                        values[i, 2] = req.elevation or 0.0
                        chmask[i, :3] = True
                elif et == int(EventType.ALERT):
                    level[i] = int(req.alert_level)
                    chmask[i, 0] = True
                    aux0[i] = self.alert_types.intern(req.alert_type or "alert")
                elif et == int(EventType.COMMAND_RESPONSE) and req.originating_event_id:
                    aux0[i] = self.event_ids.intern(req.originating_event_id)
                elif (et == int(EventType.STATE_CHANGE)
                      and (req.attribute or req.state_type)):
                    aux0[i] = self.event_ids.intern(
                        f"{req.attribute or ''}:{req.state_type or ''}")
                if rt not in (RT_REGISTER, RT_MAP) and req.alternate_id is not None:
                    aux1[i] = self.event_ids.intern(req.alternate_id)
                rtype[i] = rt
            except Exception:
                rtype[i] = -1   # a row-level failure, as the native decoder
        return DecodedArrays(
            n_ok=int(np.sum(rtype >= 0)), rtype=rtype, token_id=token_id,
            ts_ms64=ts64, values=values, chmask=chmask, aux0=aux0, aux1=aux1,
            level=level, collisions=0)

    def _ingest_decoded(self, res, payloads, tenant, reg_decoder) -> dict:
        # the decode-worker pool's seam: externally decoded SoA batches
        # take the same stacked-arena scatter
        if self._arena_pool is None:
            return super()._ingest_decoded(res, payloads, tenant, reg_decoder)
        return self._ingest_decoded_spmd(res, payloads, tenant, reg_decoder,
                                         self.flight.current())

    def _ingest_decoded_spmd(self, res, payloads, tenant, reg_decoder, rec) -> dict:
        """Scatter a decoded SoA batch into the shard lanes of the fill
        arena: routing is two indexed loads over the batch, the scatter
        one fancy-indexed store a column. Registration, mapping and
        acknowledge envelopes re-route through the per-request path; their
        tokens route first, in payload order, so local ids allocate as the
        per-row router would."""
        from sitewhere_tpu_torch.ingest.fast_decode import RT_MAP

        rec.add("path", "arena")
        with self.lock:
            now = self._staging_now()
            base_ms = int(self.epoch.base_unix_s * 1000)
            tids = res.token_id
            # route every token the row router would, in payload order:
            # event and ack rows (staged) and register rows (routed by
            # register_device); mapping rows never allocate a route
            routable = (tids >= 0) & (res.rtype != RT_MAP)
            sh = np.full(len(tids), -1, np.int32)
            ltid = np.full(len(tids), -1, np.int32)
            if routable.any():
                sh[routable], ltid[routable] = self._route_rows(tids[routable])
            rec.mark("route")
            etype, ok, ts_rel, values, failed, n_reg_ok = self._decode_prologue(
                res, payloads, tenant, reg_decoder, now, base_ms)
            idxs = np.nonzero(ok)[0]
            tenant_id = self.tenants.intern(tenant)
            staged = 0
            rem = idxs
            while rem.size:
                arena = self._arena_fill
                if arena is None:
                    arena = self._arena_fill = self._acquire_arena(tenant, int(rem.size))
                rs = sh[rem]
                # running offsets within each shard's run of this chunk
                cum = np.empty(rem.size, np.int64)
                for s in np.unique(rs):
                    m = rs == s
                    cum[m] = np.arange(int(m.sum()))
                dst = arena.cursors[rs] + cum
                fit = dst < arena.rows
                rows_f, rs_f, dst_f = rem[fit], rs[fit], dst[fit]
                arena.etype[rs_f, dst_f] = etype[rows_f]
                arena.token_id[rs_f, dst_f] = ltid[rows_f]
                arena.tenant_id[rs_f, dst_f] = tenant_id
                arena.ts_ms[rs_f, dst_f] = ts_rel[rows_f]
                arena.received_ms[rs_f, dst_f] = now
                arena.values[rs_f, dst_f] = values[rows_f]
                arena.vmask[rs_f, dst_f] = res.chmask[rows_f]
                arena.aux[rs_f, dst_f, 0] = res.aux0[rows_f]
                arena.aux[rs_f, dst_f, 1] = res.aux1[rows_f]
                arena.valid[rs_f, dst_f] = True
                binc = np.bincount(rs_f, minlength=self.n_shards)
                arena.cursors += binc
                if self.ledger.enabled:
                    self._shard_rows_routed += binc
                if self.shard_heat.enabled and rows_f.size:
                    self._slot_rows += np.bincount(self._route_slot[tids[rows_f]],
                                                   minlength=self._slot_rows.size)
                staged += int(rows_f.size)
                rec.mark("arena_fill")
                if rec.trace_id is not None and (not arena.traces
                                                 or arena.traces[-1] is not rec):
                    arena.traces.append(rec)
                if rows_f.size < rem.size:
                    # a shard lane filled: dispatch, and scatter the rest
                    # into a fresh arena
                    self._dispatch_arena()
                    rem = rem[~fit]
                else:
                    rem = rem[:0]
            rec.mark("commit")
            arena = self._arena_fill
            if arena is not None and int(arena.cursors.min()) >= arena.rows:
                self._dispatch_arena()   # every lane exactly full
            self.channel_map.collisions += res.collisions
            self.host_counters["arena_rows"] = \
                self.host_counters.get("arena_rows", 0) + staged
            self.ledger.add("staged_rows", staged)
        return {"decoded": staged + n_reg_ok, "failed": failed, "staged": staged}

    def _run_shards(self, step, batches: list[EventBatch]) -> list[StepOutput]:
        """One dispatch: ``step`` on every shard's state and batch, in shard
        order. Caller holds the lock."""
        outs = []
        for s, batch in enumerate(batches):
            self.shards[s], out = step(self.shards[s], batch)
            outs.append(out)
        return outs

    def _dispatch_arena(self) -> None:
        """Dispatch the fill arena: lanes past each shard's cursor masked
        invalid, the WAL gate, one copy a shard to its device, the step on
        every shard (K steps a shard with ``scan_chunk`` K > 1). Caller
        holds the lock."""
        arena = self._arena_fill
        if arena is None or not arena.cursors.any():
            return
        if self.shard_heat.enabled:
            self._shard_staged_hwm = np.maximum(self._shard_staged_hwm,
                                                self._shard_staged_now())
        arena.valid &= np.arange(arena.rows)[None, :] < arena.cursors[:, None]
        per_shard = arena.valid.sum(axis=1)
        self.ledger.add("dispatched_rows", int(per_shard.sum()))
        if self.ledger.enabled:
            self._shard_rows_dispatched += per_shard
        skew = (self.shard_heat.note_dispatch(per_shard)
                if self.shard_heat.enabled else None)
        traces, arena.traces = arena.traces, []
        self._wal_gate(traces)
        for rec in traces:
            rec.mark("dispatch")
            if skew is not None:
                rec.add("shard_rows", "/".join(str(int(x)) for x in per_shard))
                rec.add("skew", round(skew, 3))
        outs = self._run_shards(self._arena_step or self._step,
                                arena.view_batches(self.mesh))
        fence = self._fence()
        self._enqueue_out(outs, fence, traces)
        self._arena_pool.retire(arena, fence, traces)
        self._arena_fill = None
        self._arena_dispatches += 1
        self._last_flush = time.monotonic()
        self._note_dispatch()

    def flush_async(self) -> None:
        """One dispatch of the per-row router's lanes: every shard's buffer
        (an empty one rides as all-invalid rows) through the step on its
        shard. A partly filled arena dispatches first (never
        mid-commit)."""
        with self.lock:
            staged = self.staged_count
            if staged > self._backlog_hwm:
                self._backlog_hwm = staged
            if (self._arena_fill is not None and self._arena_fill.cursor
                    and not self._arena_committing):
                self._dispatch_arena()
            lens = np.array([len(b) for b in self._shard_bufs], np.int64)
            n_staged = int(lens.sum())
            if not n_staged:
                return
            if self.ledger.enabled:
                self._shard_rows_dispatched += lens
            if self.shard_heat.enabled:
                self._shard_staged_hwm = np.maximum(self._shard_staged_hwm, lens)
                self.shard_heat.note_dispatch(lens)
            traces, self._staged_traces = self._staged_traces, []
            self._wal_gate(traces)   # before the copies of the batches
            for rec in traces:
                rec.mark("dispatch")
            self.ledger.add("dispatched_rows", n_staged)
            batches = [b.emit(d) for b, d in zip(self._shard_bufs, self.mesh)]
            outs = self._run_shards(self._step, batches)
            self._enqueue_out(outs, self._fence(), traces)
            self._note_dispatch()
            self._last_flush = time.monotonic()

    def ingest_event_batch(self, batch: EventBatch) -> None:
        raise NotImplementedError(
            "SpmdEngine: ingest_event_batch takes one card's batch; ingest "
            "through the wire batch paths")

    @property
    def staged_count(self) -> int:
        return (sum(len(b) for b in self._shard_bufs) + len(self._buf)
                + self._fair_queued
                + (self._arena_fill.cursor if self._arena_fill is not None else 0))

    def _arena_backlogged(self) -> bool:
        return bool(self._arena_fill is not None and self._arena_fill.cursor
                    and not self._arena_committing)

    def _sync_mirrors(self) -> None:
        while any(len(b) for b in self._shard_bufs) or self._arena_backlogged():
            self.flush_async()
        if self._pending_outs:
            self.drain()

    def maybe_flush(self) -> dict | None:
        with self.lock:
            expired = (time.monotonic() - self._last_flush
                       >= self.config.flush_interval_s)
            if (any(len(b) for b in self._shard_bufs)
                    or self._arena_backlogged()) and expired:
                return self.flush()
            if self._pending_outs and expired:
                return _merge_summaries(self.drain())
            return None

    def barrier(self) -> None:
        with self.lock:
            while any(len(b) for b in self._shard_bufs) or self._arena_backlogged():
                self.flush_async()
            if self._pending_fences and self._pending_fences[-1] is not None:
                self._pending_fences[-1].synchronize()

    def drain(self) -> list[dict]:
        """Absorb every queued dispatch: the scalar counters of every shard
        and lane in one copy, then each shard's outputs in shard order
        (lane by lane for a scan dispatch)."""
        with self.lock:
            if not self._pending_outs:
                return [{"found": 0, "missed": 0, "registered": 0,
                         "persisted": 0, "new_tokens": [], "dead_tokens": []}]
            outs, self._pending_outs = self._pending_outs, []
            self._pending_fences = []
            trace_lists, self._pending_traces = self._pending_traces, []
            units = []   # (shard, StepOutput of one step)
            for dispatch in outs:
                for shard, out in enumerate(dispatch):
                    if out.n_found.dim() == 0:
                        units.append((shard, out))
                    else:
                        units.extend((shard, StepOutput(*(x[k] for x in out)))
                                     for k in range(out.n_found.shape[0]))
            dev0 = self.mesh[0]
            scalars = torch.stack([
                torch.stack([o.n_found, o.n_missed, o.n_registered,
                             o.n_persisted]).to(dev0) for _, o in units]).cpu().tolist()
            for recs in trace_lists:
                for rec in recs:
                    st = rec.stages
                    if st.get("device_ready", -1) < st.get("dispatch", 0):
                        rec.mark("device_ready")
                    rec.mark("readback")
            return [self._absorb_shard(shard, out, *s)
                    for (shard, out), s in zip(units, scalars)]

    def _absorb_shard(self, shard: int, out: StepOutput, n_found: int,
                      n_missed: int, n_registered: int, n_persisted: int) -> dict:
        """The single-card absorb for one shard's step: local token, device
        and assignment ids translate through the shard's route tables into
        the global spaces of the host mirrors."""
        toks = self._shard_tokens[shard]
        new_tokens = []
        if n_registered:
            new_tokens = [toks[t] for t in out.new_tokens[:n_registered].cpu().tolist()]
        new_ldids, new_ids = [], []   # (global tid, global did, global aid)
        for gtid in new_tokens:
            ldid = self._next_local_device[shard]
            laid = self._next_local_assignment[shard]
            self._next_local_device[shard] = ldid + 1
            self._next_local_assignment[shard] = laid + 1
            gdid = shard * self._device_cap + ldid
            gaid = shard * self._assignment_cap + laid
            self.token_device[gtid] = gdid
            new_ldids.append(ldid)
            new_ids.append((gtid, gdid, gaid))
        if new_ldids:
            reg = self.shards[shard].registry
            idx = torch.tensor(new_ldids, device=reg.device_tenant.device)
            tenants = reg.device_tenant[idx].cpu().tolist()
            for (gtid, gdid, gaid), ten in zip(new_ids, tenants):
                tenant = self.tenants.token(ten) if ten != NULL_ID else "default"
                self.devices[gdid] = DeviceInfo(
                    token=self.tokens.token(gtid),
                    device_type=self.config.default_device_type,
                    tenant=tenant, auto_registered=True)
                self._record_assignment(gaid, gdid, slot=0)
        dead = []
        if n_missed:
            dead = [toks[t] if t < len(toks) else t
                    for t in out.dead_tokens[:n_missed].cpu().tolist()]
        self.dead_letters.extend(dead)
        summary = {"found": n_found, "missed": n_missed, "registered": n_registered,
                   "persisted": n_persisted, "new_tokens": new_tokens,
                   "dead_tokens": dead}
        self.outputs.append(summary)
        del self.outputs[:-256]
        return summary

    # ------------------------------------------------------------ admin
    def _apply(self, shard: int, fn, *args) -> None:
        """A single-card admin update on one shard's state."""
        self.shards[shard] = fn(self.shards[shard], *args)

    def register_device(self, token: str, device_type: str | None = None,
                        tenant: str = "default", area: str | None = None,
                        customer: str | None = None,
                        metadata: dict | None = None) -> int:
        with self.lock:
            self._sync_mirrors()
            token_id = self.tokens.intern(token)
            existing = self.token_device.get(token_id)
            if existing is not None:
                return existing
            shard, ltid = self._route_token(token_id)
            ldid = self._next_local_device[shard]
            laid = self._next_local_assignment[shard]
            if ldid >= self._device_cap:
                raise RuntimeError("device capacity exhausted")
            if laid >= self._assignment_cap:
                raise RuntimeError("assignment capacity exhausted")
            type_name = device_type or self.config.default_device_type
            self._wal_admin_register(token, type_name, tenant, area, customer)
            self._next_local_device[shard] = ldid + 1
            self._next_local_assignment[shard] = laid + 1
            self._apply(shard, _admin_create_device, ltid, ldid, laid,
                        self.device_types.intern(type_name),
                        self.tenants.intern(tenant),
                        self.areas.intern(area) if area else NULL_ID,
                        self.customers.intern(customer) if customer else NULL_ID)
            gdid = shard * self._device_cap + ldid
            gaid = shard * self._assignment_cap + laid
            self.token_device[token_id] = gdid
            self.devices[gdid] = DeviceInfo(
                token=token, device_type=type_name, tenant=tenant, area=area,
                customer=customer, metadata=metadata or {})
            self._record_assignment(gaid, gdid, slot=0, area=area, customer=customer)
            return gdid

    def delete_device(self, token: str) -> bool:
        with self.lock:
            did = self.token_device.get(self.tokens.lookup(token))
            if did is None:
                return False
            shard, ldid = divmod(did, self._device_cap)
            self._apply(shard, _admin_set_device_active, ldid, False)
            return True

    def map_device(self, child_token: str, parent_token: str) -> DeviceInfo:
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
            cshard, cldid = divmod(cdid, self._device_cap)
            pshard, pldid = divmod(pdid, self._device_cap)
            if cshard != pshard:
                raise ValueError("SPMD engine: parent and child must share a shard "
                                 "(token placement decides the shard)")
            info = self.devices[cdid]
            info.metadata = dict(info.metadata) | {"parentToken": parent_token}
            self._apply(cshard, _admin_set_parent, cldid, pldid)
            return info

    def update_device(self, token: str, device_type: str | None = None,
                      area: str | None = None, customer: str | None = None,
                      metadata: dict | None = None) -> DeviceInfo:
        with self.lock:
            self._sync_mirrors()
            did = self.token_device.get(self.tokens.lookup(token))
            if did is None:
                raise KeyError(f"device {token!r} not registered")
            shard, ldid = divmod(did, self._device_cap)
            info = self.devices[did]
            type_id = self.device_types.intern(
                device_type if device_type is not None else info.device_type)
            new_area = area if area is not None else info.area
            area_id = self.areas.intern(new_area) if new_area else NULL_ID
            new_customer = customer if customer is not None else info.customer
            customer_id = self.customers.intern(new_customer) if new_customer else NULL_ID
            parent_update = None   # (new metadata, local parent id or None)
            if metadata is not None:
                old_parent = info.metadata.get("parentToken")
                metadata = dict(metadata)
                if "parentToken" not in metadata and old_parent is not None:
                    metadata["parentToken"] = old_parent
                new_parent = metadata.get("parentToken")
                if new_parent != old_parent:
                    if new_parent is None:
                        metadata.pop("parentToken", None)
                        parent_update = (metadata, NULL_ID)
                    else:
                        pdid = self.token_device.get(self.tokens.lookup(new_parent))
                        if pdid is None:
                            raise KeyError(f"parent device {new_parent!r} not registered")
                        if pdid == did:
                            raise ValueError("device cannot be its own parent")
                        pshard, pldid = divmod(pdid, self._device_cap)
                        if pshard != shard:
                            raise ValueError("SPMD engine: parent and child must "
                                             "share a shard")
                        parent_update = (metadata, pldid)
                else:
                    if new_parent is None:
                        metadata.pop("parentToken", None)
                    parent_update = (metadata, None)
            if device_type is not None:
                info.device_type = device_type
            if area is not None:
                info.area = area
            if customer is not None:
                info.customer = customer
            if parent_update is not None:
                info.metadata, pldid = parent_update
                if pldid is not None:
                    self._apply(shard, _admin_set_parent, ldid, pldid)
            self._apply(shard, _admin_update_device, ldid, type_id, area_id, customer_id)
            return info

    def create_assignment(self, device_token: str, token: str | None = None,
                          asset: str | None = None, area: str | None = None,
                          customer: str | None = None, metadata: dict | None = None):
        with self.lock:
            self._sync_mirrors()
            did = self.token_device.get(self.tokens.lookup(device_token))
            if did is None:
                raise KeyError(f"device {device_token!r} not registered")
            if token is not None and token in self.assignment_tokens:
                raise ValueError(f"assignment token {token!r} already exists")
            shard, ldid = divmod(did, self._device_cap)
            slots = self.device_slots.setdefault(did, [NULL_ID] * MAX_ACTIVE_ASSIGNMENTS)
            try:
                slot = slots.index(NULL_ID)
            except ValueError:
                raise ValueError(
                    f"device {device_token!r} already has "
                    f"{MAX_ACTIVE_ASSIGNMENTS} active assignments") from None
            laid = self._next_local_assignment[shard]
            if laid >= self._assignment_cap:
                raise RuntimeError("assignment capacity exhausted")
            self._next_local_assignment[shard] = laid + 1
            self._apply(shard, _admin_add_assignment, ldid, laid, slot,
                        self.assets.intern(asset) if asset else NULL_ID,
                        self.areas.intern(area) if area else NULL_ID,
                        self.customers.intern(customer) if customer else NULL_ID)
            gaid = shard * self._assignment_cap + laid
            info = self._record_assignment(gaid, did, slot, token=token, asset=asset,
                                           area=area, customer=customer,
                                           metadata=metadata)
            self._assignment_trigger(device_token, "assignment.created", info.tenant)
            return info

    def update_assignment(self, token: str, asset: str | None = None,
                          area: str | None = None, customer: str | None = None,
                          metadata: dict | None = None):
        with self.lock:
            self._sync_mirrors()
            aid = self.assignment_tokens.get(token)
            if aid is None:
                raise KeyError(f"assignment {token!r} not found")
            shard, laid = divmod(aid, self._assignment_cap)
            info = self.assignments[aid]
            new_asset = asset if asset is not None else info.asset
            new_area = area if area is not None else info.area
            new_customer = customer if customer is not None else info.customer
            self._apply(shard, _admin_update_assignment, laid,
                        self.assets.intern(new_asset) if new_asset else NULL_ID,
                        self.areas.intern(new_area) if new_area else NULL_ID,
                        self.customers.intern(new_customer) if new_customer else NULL_ID)
            info.asset, info.area, info.customer = new_asset, new_area, new_customer
            if metadata is not None:
                info.metadata = metadata
            return info

    def _set_assignment_status(self, token: str, status: DeviceAssignmentStatus):
        with self.lock:
            self._sync_mirrors()
            aid = self.assignment_tokens.get(token)
            if aid is None:
                raise KeyError(f"assignment {token!r} not found")
            shard, laid = divmod(aid, self._assignment_cap)
            active = status is not DeviceAssignmentStatus.RELEASED
            self._apply(shard, _admin_set_assignment_status, laid, int(status), active)
            info = self.assignments[aid]
            info.status = status.name
            if not active:
                info.released_ms = self.epoch.now_ms()
                did = self.token_device.get(self.tokens.lookup(info.device_token))
                if did is not None and did in self.device_slots:
                    self.device_slots[did] = [NULL_ID if s == aid else s
                                              for s in self.device_slots[did]]
            self._assignment_trigger(info.device_token,
                                     f"assignment.{status.name.lower()}", info.tenant)
            return info

    # ---------------------------------------------------------- queries
    def get_device_state(self, token: str) -> dict | None:
        with self.lock:
            self._sync_mirrors()
            did = self.token_device.get(self.tokens.lookup(token))
            if did is None:
                return None
            s, d = divmod(did, self._device_cap)
            dst = self.shards[s].device_state
            ds = {f.name: getattr(dst, f.name)[d].cpu().numpy()
                  for f in dataclasses.fields(dst)}
            chans = {}
            for name, nid in self.channel_map.names.items():
                ch = nid % self.config.channels
                ts = int(ds["meas_last_ms"][ch])
                if ts > -(2**31) + 10:
                    chans[name] = {"value": float(ds["meas_last"][ch]), "ts_ms": ts}
            recent_locs = [
                {"latitude": float(ds["recent_loc"][r, 0]),
                 "longitude": float(ds["recent_loc"][r, 1]),
                 "elevation": float(ds["recent_loc"][r, 2]),
                 "ts_ms": int(ds["recent_loc_ms"][r])}
                for r in range(RECENT_DEPTH) if bool(ds["recent_loc_valid"][r])]
            recent_alerts = [
                {"level": int(ds["recent_alert_level"][r]),
                 "type": self.alert_types.token(int(ds["recent_alert_type"][r])),
                 "ts_ms": int(ds["recent_alert_ms"][r])}
                for r in range(RECENT_DEPTH) if bool(ds["recent_alert_valid"][r])]
            return {
                "device": self.devices[did].token,
                "presence": PresenceState(int(ds["presence"])).name,
                "last_interaction_ms": int(ds["last_interaction_ms"]),
                "measurements": chans,
                "recent_locations": recent_locs,
                "recent_alerts": recent_alerts,
                "event_counts": {EventType(e).name: int(ds["event_counts"][e])
                                 for e in range(NUM_EVENT_TYPES)},
            }

    def search_device_states(self, *a, **kw):
        raise NotImplementedError(
            "SpmdEngine: search_device_states is not shard-aware yet (v1)")

    def get_event(self, *a, **kw):
        raise NotImplementedError(
            "SpmdEngine: get_event ring positions are per-shard (v1)")

    def make_feed_consumer(self, *a, **kw):
        raise NotImplementedError(
            "SpmdEngine: outbound feeds are not shard-aware yet (v1)")

    # ------------------------------------------------ sweep and counters
    def presence_sweep(self) -> list[str]:
        with self.lock:
            self._sync_mirrors()
            self.shards, masks = _sweep_shards(
                self.shards, self.epoch.now_ms(),
                int(self.config.presence_missing_s * 1000))
            toks = []
            for s, m in enumerate(masks):
                for ld in np.nonzero(m)[0]:
                    info = self.devices.get(s * self._device_cap + int(ld))
                    if info is not None:
                        toks.append(info.token)
            return toks

    presence_sweep_local = presence_sweep

    def tenant_metrics(self) -> dict[str, dict[str, int]]:
        with self.lock:
            self._sync_mirrors()
            n_tenants = len(self.tenants)
            t_cap = tenant_cap(n_tenants)
            counts = sum(_tenant_event_counts(st, t_cap).cpu().numpy()
                         for st in self.shards)
        return tenant_counts_dict(counts, self.tenants, n_tenants)

    def _counter_grids(self) -> np.ndarray:
        """The shards' tenant counter grids, [S, T, lanes], in one copy."""
        return torch.stack([st.metrics.tenant_counters.to(self.mesh[0])
                            for st in self.shards]).cpu().numpy()

    def tenant_pipeline_counters(self) -> dict[str, dict[str, int]]:
        with self.lock:
            return format_tenant_counter_grid(self._counter_grids().sum(axis=0),
                                              self.tenants)

    def rule_counters(self) -> dict:
        with self.lock:
            rs = self.shards[0].rules
            out: dict = {}
            if rs is not None and rs.rules is not None:
                f, m, l, o = np.sum([torch.stack(
                    [st.rules.rules.fires, st.rules.rules.missed, st.rules.rules.late,
                     st.rules.rules.oob]).cpu().numpy() for st in self.shards], axis=0)
                out.update(ruleFires=int(f), ruleMissedFires=int(m),
                           ruleLateEvents=int(l), ruleOobGroups=int(o),
                           rulesActive=rs.rules.n_rules)
            if rs is not None and rs.rollups is not None:
                out.update(rollupLateEvents=sum(int(st.rules.rollups.late)
                                                for st in self.shards),
                           rollupsActive=rs.rollups.n_rollups)
            return out

    def _metric_counters(self):
        per = []
        for st in self.shards:
            m = st.metrics
            rb = st.rules.rules if st.rules is not None else None
            cols = [m.processed, m.found, m.missed, m.registered, m.persisted,
                    m.reg_overflow] + ([rb.fires] if rb is not None else [])
            per.append(torch.stack(cols).to(self.mesh[0]))
        vals = torch.stack(per).sum(0).cpu().tolist()
        rb = self.shards[0].rules.rules if self.shards[0].rules is not None else None
        return vals[:6], ((vals[6], rb.n_rules) if rb is not None else None)

    def metrics(self) -> dict:
        # the shard heat and skew series stay out of this dict (its keys
        # are pinned equal to the single-card engine's): shard_flow and
        # spmd_heat carry them
        out = super().metrics()
        out["staged"] = sum(len(b) for b in self._shard_bufs)
        return out

    # ------------------------------------------------- shard observability
    def _shard_staged_now(self) -> np.ndarray:
        """Rows staged a shard lane now (router buffers and the fill
        arena's cursors). Caller holds the lock."""
        lens = np.array([len(b) for b in self._shard_bufs], np.int64)
        fill = self._arena_fill
        if fill is not None:
            lens = lens + np.asarray(fill.cursors, np.int64)
        return lens

    def take_shard_staged_hwm(self, reset: bool = True) -> list[int]:
        """The worst staged backlog of each shard lane since the last take
        (the scrape resets it; peeks pass ``reset=False``)."""
        with self.lock:
            now = self._shard_staged_now()
            hwm = np.maximum(self._shard_staged_hwm, now)
            if reset:
                self._shard_staged_hwm = now
            return [int(x) for x in hwm]

    def shard_flow(self) -> dict:
        """The per-shard flow breakdown: the tenant counter grids read
        unfolded, and the router's routed / dispatched / backlog counts.
        The conservation ledger embeds it as its "spmd" stage."""
        from sitewhere_tpu_torch.pipeline import TENANT_COUNTER_LANES

        with self.lock:
            grid = self._counter_grids()                     # [S, T, L]
            proc = torch.stack([st.metrics.processed.to(self.mesh[0])
                                for st in self.shards]).cpu().numpy()
            routed = self._shard_rows_routed.copy()
            dispatched = self._shard_rows_dispatched.copy()
            backlog = np.array([len(b) for b in self._shard_bufs], np.int64)
            fill = self._arena_fill
            if fill is not None:
                for s, cnt in enumerate(fill.cursors):
                    backlog[s] += int(np.sum(fill.valid[s, :int(cnt)]))
            counting = self.ledger.enabled
        lanes = grid.sum(axis=1)                             # [S, L]
        per = []
        for s in range(self.n_shards):
            row = {"shard": s, "processed": int(proc[s]),
                   "routed_rows": int(routed[s]),
                   "dispatched_rows": int(dispatched[s]),
                   "backlog_rows": int(backlog[s])}
            row.update({lane: int(lanes[s, i])
                        for i, lane in enumerate(TENANT_COUNTER_LANES)})
            per.append(row)
        doc = {"shards": self.n_shards, "counting": counting, "perShard": per}
        # attached persistent-connection edges are the feeder stage of this
        # flow: one read of the shard document shows socket -> arena ->
        # shard (kept out of metrics(): dispatch-shape equality pin)
        if getattr(self, "wire_edges", None):
            from sitewhere_tpu_torch.ingest.wire_edge import aggregate_wire_snapshot

            wire = aggregate_wire_snapshot(self)
            if wire is not None:
                doc["wire"] = wire
        return doc

    def harvest_shard_heat(self, now_s: float | None = None):
        """Update the heat tracker from the counter-grid deltas (one copy
        of the grids the step keeps); ``now_s`` injects a clock."""
        t = time.monotonic() if now_s is None else float(now_s)
        with self.lock:
            self.shard_heat.harvest(self._counter_grids(), self._slot_rows, t)
        return self.shard_heat

    def spmd_heat(self) -> dict:
        """The heat and skew document (``utils.shardobs.spmd_heat_payload``)."""
        from sitewhere_tpu_torch.utils.shardobs import spmd_heat_payload

        return spmd_heat_payload(self)

    # ---------------------------------------------------- zones and rules
    def set_geofence_zones(self, polygons, max_vertices: int = 16) -> None:
        from sitewhere_tpu_torch.ops.geofence import pack_zones
        from sitewhere_tpu_torch.pipeline import ZoneTable

        with self.lock:
            if not polygons:
                self.shards = [dataclasses.replace(st, zones=None) for st in self.shards]
                return
            verts, valid = pack_zones(polygons, max_vertices)
            self.shards = [dataclasses.replace(st, zones=ZoneTable(
                torch.from_numpy(verts).to(d), torch.from_numpy(valid).to(d)))
                for st, d in zip(self.shards, self.mesh)]

    def set_rules(self, rules_state, *, preserve_state: bool = False) -> None:
        """Install the rule tables on every shard: each evaluates the whole
        rule set on its own substream (a device's group lives whole on its
        shard, so device-scoped fire totals equal the single card's)."""
        with self.lock:
            self.shards = [dataclasses.replace(st, rules=merged_rules_state(
                st.rules, tree_map(lambda x, _d=d: x.to(_d).clone(), rules_state),
                preserve_state)) for st, d in zip(self.shards, self.mesh)]

    def _rollup_tables(self, p: int):
        """Rollup ``p``'s per-shard ``[G, B]`` tables folded into the
        single-card read layout: device-scope groups move to the
        shard-qualified device-id space; area and tenant groups (global
        ids, per-shard partial aggregates) merge per bucket — counts and
        sums add, min and max fold, windows align on the newest id."""
        from sitewhere_tpu_torch.ops.rules import SCOPE_DEVICE

        ros = [st.rules.rollups for st in self.shards]
        scope = int(ros[0].scope[p])
        wid, cnt, vsum, vmin, vmax = (
            np.stack([getattr(ro, f)[p].cpu().numpy() for ro in ros])
            for f in ("wid", "cnt", "vsum", "vmin", "vmax"))      # each [S, G, B]
        s_n, g_n, b_n = cnt.shape
        if scope == SCOPE_DEVICE:
            g_out = max(s_n * self._device_cap, g_n)
            span = min(g_n, self._device_cap)
            out = tuple(np.zeros((g_out, b_n), a.dtype) for a in (wid, cnt, vsum, vmin, vmax))
            for s in range(s_n):
                lo = s * self._device_cap
                for dst, src in zip(out, (wid, cnt, vsum, vmin, vmax)):
                    dst[lo:lo + span] = src[s, :span]
            return out
        live = cnt > 0
        top = np.where(live, wid, np.iinfo(wid.dtype).min).max(axis=0)
        on = live & (wid == top[None])
        mcnt = np.where(on, cnt, 0).sum(axis=0)
        return (np.where(mcnt > 0, top, 0).astype(wid.dtype),
                mcnt.astype(cnt.dtype),
                np.where(on, vsum, 0.0).sum(axis=0).astype(vsum.dtype),
                np.where(on, vmin, np.inf).min(axis=0).astype(vmin.dtype),
                np.where(on, vmax, -np.inf).max(axis=0).astype(vmax.dtype))

    def poll_rule_fires(self):
        """Harvest every shard's pending ring, then fold them on the host
        (``ops.rules.merge_shard_harvests``): device-scope rings move to
        the shard-qualified device-id space, area and tenant rings merge
        per global group. Returns the single-card ``(pend_key, pend_val,
        pend_w, pend_h)``, or None without rules."""
        from sitewhere_tpu_torch.ops.rules import harvest_fires, merge_shard_harvests

        with self.lock:
            rs = self.shards[0].rules
            if rs is None or rs.rules is None:
                return None
            layout = rs.rules.layout
            self._sync_mirrors()
            per = []
            for s, st in enumerate(self.shards):
                new_rules, *fires = harvest_fires(st.rules)
                self.shards[s] = dataclasses.replace(st, rules=new_rules)
                per.append([x.cpu().numpy() for x in fires])
        return merge_shard_harvests(*(np.stack(x) for x in zip(*per)),
                                    layout=layout, device_cap=self._device_cap)
