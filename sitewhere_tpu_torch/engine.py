"""The host engine (port of ``sitewhere_tpu/engine.py``).

Owns the interners (device tokens, tenants, measurement channels, alert
types), the staging arenas and buffer, the device-resident pipeline state
and the host mirror of registry metadata. Ported so far:

- wire ingest: ``ingest_json_batch`` / ``ingest_binary_batch`` through the
  native decoder (``native/src/swtpu.cpp``, built on first use) straight
  into pooled staging arenas (page-locked on a CUDA engine) that dispatch
  with one asynchronous copy, optionally decoded by several threads
  (``ingest_workers``), with strict channel mode; the copy-staging path
  (``ingest_arenas=-1``); the Python decode path only when asked for
  (``use_native=False``); per-request ``process()``, registration and
  mapping envelopes included; ``ingest_event_batch`` for batches built on
  the device in bulk;
- dispatch: ``flush_async`` / ``flush`` / ``maybe_flush`` / ``barrier``
  with ``scan_chunk`` (K batches a dispatch) and ``dispatch_depth``
  (outstanding steps before the host waits), ``drain`` with the host
  mirrors of auto-registration;
- durability: the write-ahead log (``wal_dir``, group commit), appended
  before staging and fsync'd before the dispatch that copies its rows to
  the device; snapshots and recovery live in ``utils/checkpoint.py``, the
  conservation ledger in ``utils/conservation.py``;
- admin and state: ``register_device``, ``map_device``, the registry
  admin API (``update_device``, ``delete_device``, ``create_assignment``,
  ``get_assignment``, ``list_assignments``, ``update_assignment``,
  ``delete_assignment``, ``release_assignment``,
  ``mark_assignment_missing``; ``assignment_triggers`` emits their
  STATE_CHANGE events), ``auto_register``, ``tenant_arenas``,
  ``get_device_state``, ``search_device_states``, ``presence_sweep``,
  ``set_geofence_zones``;
- reads: ``query_events`` through the shared-scan :class:`QueryBatcher`
  (``query_coalesce`` queries a round), two-tier with the archive,
  ``get_event`` (ring, then archive), ``make_feed_consumer``
  (outbound/feed.py), ``tenant_metrics``, ``tenant_pipeline_counters``,
  ``metrics()``;
- the archive tier (``archive_dir``, utils/archive.py): ring segments
  spill to disk before the ring overwrites them, and the archive->device
  anomaly jobs of models/analytics.py score archived history;
- the streaming-rules tier: ``set_rules``, ``poll_rule_fires``,
  ``rule_counters`` (rules/manager.py drives them);
- the host plane: one flight-recorder lifecycle record a batch (every
  ingest summary carries its ``trace_id``; ``get_trace``,
  ``recent_traces``, ``get_trace_timeline``, ``slo_harvest``), the span
  tracer (query rounds, shard decode, archive jobs), fair tenancy
  (``fair_tenancy``: quota-sliced batch formation across tenants), QoS
  (``qos``: token-bucket admission at the edges, a weighted-fair turn on
  the ingest critical section and the query rounds, arena stalls shed as
  typed ``ShedError``), the stage-time autotuner (``autotune``,
  ``set_ingest_tuning``) and the multiprocess decode pool
  (ingest/workers.DecodeWorkerPool).

Not ported yet: the replica feed, the rollup archive and the multi-chip
engines.

``device_ready`` is stamped only where the host has already observed a
dispatch complete — the dispatch-depth wait on its fence, the arena
recycle on its ticket, and ``drain`` (which also stamps ``readback``):
a CUDA launch returns at once, and no sync is added to stamp a mark.

Auto-registration happens on the device (ops/registration.py); the host
mirrors it from the step's ``new_tokens`` (allocation order == list order).
Admin registration allocates from the host counter and writes the device
row with :func:`_admin_create_device`, bumping the same counters.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, resolve_device
from sitewhere_tpu_torch.core.events import (EpochBase, EventBatch,
                                             HostEventBuffer, pack_batches)
from sitewhere_tpu_torch.core.registry import MAX_ACTIVE_ASSIGNMENTS, TokenInterner
from sitewhere_tpu_torch.core.state import RECENT_DEPTH
from sitewhere_tpu_torch.core.types import (AUX_LANES, DEFAULT_VALUE_CHANNELS,
                                            NULL_ID, DeviceAssignmentStatus,
                                            EventType, PresenceState)
from sitewhere_tpu_torch.ingest.decoders import (BinaryEventDecoder,
                                                 JsonDeviceRequestDecoder,
                                                 encode_binary_request)
from sitewhere_tpu_torch.ingest.fast_decode import (RT_ACK, RT_MAP, RT_REGISTER,
                                                    RTYPE_TO_ETYPE)
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.ops.geofence import pack_zones
from sitewhere_tpu_torch.ops.query import QueryParams, bucket_limit, query_store_batch
from sitewhere_tpu_torch.ops.readback import arena_cursor, read_range, slice_to_host
from sitewhere_tpu_torch.ops.rules import harvest_fires
from sitewhere_tpu_torch.pipeline import (TENANT_COUNTER_BUCKETS,
                                          TENANT_COUNTER_LANES, PipelineConfig,
                                          PipelineState, StepOutput, ZoneTable,
                                          make_arena_scan_step,
                                          make_packed_scan_step,
                                          make_presence_sweep, pipeline_step)
from sitewhere_tpu_torch.utils.conservation import FlowLedger
from sitewhere_tpu_torch.utils.flight import FlightRecorder
from sitewhere_tpu_torch.utils.metrics import next_engine_label, query_metrics
from sitewhere_tpu_torch.utils.tracing import (SpanTracer, current_traceparent,
                                               stage)

# WAL record format tags (first byte of every logged payload): recovery
# replays each record through the decoder that originally accepted it
WAL_JSON = b"\x01"
WAL_BINARY = b"\x02"


class ChannelCapacityError(ValueError):
    """Raised in strict channel mode when distinct measurement names exceed
    the configured channel count."""


class ChannelMap:
    """Measurement-name -> channel-index interner (per engine). Beyond
    ``channels`` distinct names, strict engines raise
    :class:`ChannelCapacityError`; lenient engines reuse lanes modulo and
    count each collision."""

    def __init__(self, channels: int, names=None, strict: bool = False):
        self.channels = channels
        self.names = names if names is not None else TokenInterner(1 << 20)
        self.collisions = 0
        self.strict = strict

    def channel_of(self, name: str) -> int:
        nid = self.names.intern(name)
        if nid >= self.channels:
            self.collisions += 1
            if self.strict:
                raise ChannelCapacityError(
                    f"measurement name {name!r} exceeds channel capacity "
                    f"{self.channels}; raise EngineConfig.channels or drop "
                    "strict_channels")
        return nid % self.channels

    def validate(self, names) -> None:
        """Strict-mode capacity check without interning: a rejected request
        must not consume lanes, so names intern only once the request is
        accepted (``channel_of`` on the staging pass)."""
        if not self.strict:
            return
        unseen: set[str] = set()
        for name in names:
            nid = self.names.lookup(name)
            if nid < 0:
                unseen.add(name)
            elif nid >= self.channels:
                self.collisions += 1
                raise ChannelCapacityError(
                    f"measurement name {name!r} exceeds channel capacity "
                    f"{self.channels}; raise EngineConfig.channels or drop "
                    "strict_channels")
        if len(self.names) + len(unseen) > self.channels:
            self.collisions += 1
            raise ChannelCapacityError(
                f"{len(unseen)} new measurement name(s) would exceed channel "
                f"capacity {self.channels}; raise EngineConfig.channels or "
                "drop strict_channels")


def _empty_summary() -> dict:
    return {"found": 0, "missed": 0, "registered": 0, "persisted": 0,
            "new_tokens": [], "dead_tokens": []}


def _merge_summaries(summaries: list[dict]) -> dict:
    """Fold per-step drain summaries into one (counts sum, token lists
    concatenate) — the summary a flush() caller sees."""
    out = _empty_summary()
    for s in summaries:
        for k in ("found", "missed", "registered", "persisted"):
            out[k] += s[k]
        out["new_tokens"].extend(s["new_tokens"])
        out["dead_tokens"].extend(s["dead_tokens"])
    return out


def _empty_host_batch(capacity: int, channels: int) -> EventBatch:
    """All-invalid numpy-backed EventBatch (tail padding of a scan chunk)."""
    return EventBatch(
        valid=np.zeros(capacity, np.bool_),
        etype=np.zeros(capacity, np.int32),
        token_id=np.full(capacity, NULL_ID, np.int32),
        tenant_id=np.full(capacity, NULL_ID, np.int32),
        ts_ms=np.zeros(capacity, np.int32),
        received_ms=np.zeros(capacity, np.int32),
        values=np.zeros((capacity, channels), np.float32),
        vmask=np.zeros((capacity, channels), np.bool_),
        aux=np.full((capacity, AUX_LANES), NULL_ID, np.int32),
        seq=np.arange(capacity, dtype=np.int32),
    )


@dataclasses.dataclass
class EngineConfig:
    """The ported subset of ``sitewhere_tpu.engine.EngineConfig`` (same
    names and defaults)."""

    device_capacity: int = 1 << 17
    token_capacity: int = 1 << 18
    assignment_capacity: int = 1 << 18
    store_capacity: int = 1 << 18
    channels: int = DEFAULT_VALUE_CHANNELS
    batch_capacity: int = 8192
    flush_interval_s: float = 0.05     # max added latency before maybe_flush
                                       # forces a flush
    auto_register: bool = True         # unknown tokens register on the
                                       # device; False dead-letters them
    default_device_type: str = "default"
    assignment_triggers: bool = False  # emit STATE_CHANGE events on
                                       # assignment create / status change
    presence_missing_s: float = 8 * 3600.0  # presence sweep's missing interval
    use_native: bool = True            # C++ decode and interning; a failed
                                       # build raises. False = the Python
                                       # decode path
    strict_channels: bool = False      # raise (instead of aliasing lanes)
                                       # past the channel capacity
    wal_dir: str | None = None         # write-ahead log directory; None
                                       # disables the log
    wal_group_commit: bool = True      # appends buffer, a commit thread
                                       # fsyncs once per quiescent window,
                                       # and dispatch waits for durability
    wal_group_window_s: float = 0.002  # the commit thread's quiescent window
    ingest_workers: int = 0            # threads decoding one wire batch
                                       # into disjoint arena rows (byte-
                                       # identical to one thread); 0 = one
                                       # per core, 1 = single-threaded
    scan_chunk: int = 1                # >1: K batches a dispatch (one copy,
                                       # K steps); adds up to K-1 batches
                                       # of latency
    dispatch_depth: int = 1            # outstanding dispatches before the
                                       # host waits for the oldest
    analytics_devices: int = 0         # device-resident telemetry windows for [0, M)
    analytics_window: int = 128        # W timesteps per window
    tenant_arenas: int = 1             # >1: the event ring splits into
                                       # per-tenant-hash arenas (a tenant's
                                       # burst evicts only its own rows)
    query_coalesce: int = 16           # most concurrent event queries one
                                       # query_store_batch serves
    archive_dir: str | None = None     # retention tier: ring segments
                                       # spill here before the ring
                                       # overwrites them; query_events,
                                       # get_event and the feed read both
    archive_segment_rows: int = 4096   # rows a spilled segment (clamped
                                       # to arena_capacity // 4)
    archive_max_rows: int | None = None  # rows kept a partition (None =
                                         # all history)
    archive_max_age_ms: int | None = None  # event-time retention horizon
    archive_cache_segments: int = 8    # decoded-segment LRU depth
    archive_compress: bool = False     # per-column codecs on spilled
                                       # segments (same answers)
    ingest_arenas: int = 0             # staging arenas of the native batch
                                       # path: 0 = dispatch_depth + 2,
                                       # -1 = the copy-staging path
    arena_stall_timeout_s: float | None = None  # bound the wait for a free
                                       # arena: ArenaStallError instead of
                                       # hanging on a wedged dispatch
    rule_groups: int = 1024            # group slots (device/area/tenant ids)
                                       # each rule and rollup tracks; ids
                                       # beyond count as out-of-band
    rollup_buckets: int = 32           # tumbling-window ring depth per
                                       # (rollup, group)
    rule_pending: int = 4              # pending-fire ring depth per
                                       # (rule, group)
    conservation: bool = True          # count the conservation ledger's
                                       # staged and dispatched rows
    fair_tenancy: bool = False         # quota-sliced batch formation
                                       # across tenants (the copy path)
    autotune: bool = False             # stage-time autotuner: steer
                                       # dispatch_depth / decode fan-out
                                       # (and optionally scan_chunk)
                                       # toward the measured bottleneck
    autotune_interval: int = 64        # dispatches between evaluations
    autotune_scan_chunk: bool = False  # let the tuner change scan_chunk
                                       # (rebuilds the pinned arenas)
    flight_recorder: bool = True       # one lifecycle record a batch
                                       # (utils/flight.py)
    flight_capacity: int = 1024        # lifecycle records retained
    span_trace: bool = True            # live spans (utils/tracing.py)
    span_capacity: int = 4096          # completed spans retained
    span_sample: float = 1.0           # head-based keep fraction, seeded
                                       # per trace id; the slowest decile
                                       # per span name is kept regardless
    span_seed: int = 0                 # sampling hash seed
    devicewatch: bool = True           # the JAX device plane's switch, kept
                                       # so configs round-trip: the memory
                                       # ledger (utils/devicewatch.py)
                                       # needs none, and eager torch has
                                       # no compile watchdog to switch
    qos: bool = False                  # per-tenant token-bucket admission
                                       # at the edges + weighted-fair
                                       # ingest and query scheduling
    tenant_rates: dict | None = None   # tenant -> admitted events/s
    qos_default_rate_eps: float = 0.0  # rate of unlisted tenants (0 = no
                                       # per-tenant cap)
    qos_burst_s: float = 2.0           # token-bucket depth, in seconds of
                                       # the tenant's rate
    tenant_weights: dict | None = None  # weighted-fair weights (1.0 each
                                        # by default)
    shed_threshold: int = 0            # staged-row backlog at which every
                                       # tenant sheds "saturated" (0 = 4 *
                                       # batch_capacity * scan_chunk)
    qos_min_retry_after_s: float = 0.05  # Retry-After floor of a shed
    slo_p99_target_ms: float | None = None  # the autotuner steers toward
                                       # this per-tenant ingest-e2e p99


@dataclasses.dataclass
class DeviceInfo:
    """Host-side device metadata (strings); hot columns live on device."""

    token: str
    device_type: str
    tenant: str
    area: str | None = None
    customer: str | None = None
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    auto_registered: bool = False


@dataclasses.dataclass
class AssignmentInfo:
    """Host-side assignment metadata; the hot columns live on device."""

    token: str
    id: int
    device_token: str
    tenant: str
    status: str = "ACTIVE"
    asset: str | None = None
    area: str | None = None
    customer: str | None = None
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    created_ms: int = 0
    released_ms: int | None = None


def _set_at(x: torch.Tensor, index, value) -> torch.Tensor:
    out = x.clone()
    out[index] = value
    return out


def _admin_create_device(state: PipelineState, token_id: int, device_id: int,
                         assignment_id: int, type_id: int, tenant_id: int,
                         area_id: int, customer_id: int) -> PipelineState:
    """Write one device + ACTIVE assignment row (API-path creation)."""
    reg = state.registry
    reg = dataclasses.replace(
        reg,
        token_to_device=_set_at(reg.token_to_device, token_id, device_id),
        device_active=_set_at(reg.device_active, device_id, True),
        device_type=_set_at(reg.device_type, device_id, type_id),
        device_tenant=_set_at(reg.device_tenant, device_id, tenant_id),
        device_area=_set_at(reg.device_area, device_id, area_id),
        device_customer=_set_at(reg.device_customer, device_id, customer_id),
        device_assignments=_set_at(reg.device_assignments, (device_id, 0),
                                   assignment_id),
        assignment_active=_set_at(reg.assignment_active, assignment_id, True),
        assignment_status=_set_at(reg.assignment_status, assignment_id,
                                  int(DeviceAssignmentStatus.ACTIVE)),
        assignment_device=_set_at(reg.assignment_device, assignment_id,
                                  device_id),
        assignment_area=_set_at(reg.assignment_area, assignment_id, area_id),
        assignment_customer=_set_at(reg.assignment_customer, assignment_id,
                                    customer_id),
    )
    return dataclasses.replace(
        state,
        registry=reg,
        next_device=torch.clamp(state.next_device, min=device_id + 1),
        next_assignment=torch.clamp(state.next_assignment,
                                    min=assignment_id + 1),
    )


def _admin_set_parent(state: PipelineState, device_id: int,
                      parent_id: int) -> PipelineState:
    """Write one device's gateway/composite parent (MapDevice)."""
    reg = state.registry
    return dataclasses.replace(state, registry=dataclasses.replace(
        reg, device_parent=_set_at(reg.device_parent, device_id, parent_id)))


def _admin_set_device_active(state: PipelineState, device_id: int,
                             active: bool) -> PipelineState:
    """Write one device's active flag (delete_device)."""
    reg = state.registry
    return dataclasses.replace(state, registry=dataclasses.replace(
        reg, device_active=_set_at(reg.device_active, device_id, active)))


def _admin_update_device(state: PipelineState, device_id: int, type_id: int,
                         area_id: int, customer_id: int) -> PipelineState:
    """Write one device's type, area and customer columns."""
    reg = state.registry
    return dataclasses.replace(state, registry=dataclasses.replace(
        reg,
        device_type=_set_at(reg.device_type, device_id, type_id),
        device_area=_set_at(reg.device_area, device_id, area_id),
        device_customer=_set_at(reg.device_customer, device_id, customer_id)))


def _admin_add_assignment(state: PipelineState, device_id: int,
                          assignment_id: int, slot: int, asset_id: int,
                          area_id: int, customer_id: int) -> PipelineState:
    """Attach one more ACTIVE assignment to a device slot (the slots feed
    the per-assignment expansion of every event of the device)."""
    reg = state.registry
    reg = dataclasses.replace(
        reg,
        device_assignments=_set_at(reg.device_assignments,
                                   (device_id, slot), assignment_id),
        assignment_active=_set_at(reg.assignment_active, assignment_id, True),
        assignment_status=_set_at(reg.assignment_status, assignment_id,
                                  int(DeviceAssignmentStatus.ACTIVE)),
        assignment_device=_set_at(reg.assignment_device, assignment_id,
                                  device_id),
        assignment_asset=_set_at(reg.assignment_asset, assignment_id,
                                 asset_id),
        assignment_area=_set_at(reg.assignment_area, assignment_id, area_id),
        assignment_customer=_set_at(reg.assignment_customer, assignment_id,
                                    customer_id),
    )
    return dataclasses.replace(
        state, registry=reg,
        next_assignment=torch.clamp(state.next_assignment,
                                    min=assignment_id + 1))


def _admin_update_assignment(state: PipelineState, assignment_id: int,
                             asset_id: int, area_id: int,
                             customer_id: int) -> PipelineState:
    """Write one assignment's asset, area and customer columns."""
    reg = state.registry
    return dataclasses.replace(state, registry=dataclasses.replace(
        reg,
        assignment_asset=_set_at(reg.assignment_asset, assignment_id,
                                 asset_id),
        assignment_area=_set_at(reg.assignment_area, assignment_id, area_id),
        assignment_customer=_set_at(reg.assignment_customer, assignment_id,
                                    customer_id)))


def _admin_set_assignment_status(state: PipelineState, assignment_id: int,
                                 status: int, active: bool) -> PipelineState:
    """Write one assignment's status; a release (``active=False``) also
    detaches it from its device's slot row, so events stop expanding to
    it. The device row is found on the device (no host read): a
    ``NULL_ID`` device indexes the last row, as the JAX update does."""
    reg = state.registry
    did = reg.assignment_device[assignment_id].long()
    row = reg.device_assignments[did]
    new_row = row if active else torch.where(row == assignment_id, NULL_ID, row)
    reg = dataclasses.replace(
        reg,
        assignment_status=_set_at(reg.assignment_status, assignment_id, status),
        assignment_active=_set_at(reg.assignment_active, assignment_id, active),
        device_assignments=_set_at(reg.device_assignments, did, new_row),
    )
    return dataclasses.replace(state, registry=reg)


# rule/rollup parameter columns: a swap that keeps shapes and layout
# replaces exactly these and preserves the carried state
_RULE_PARAM_FIELDS = ("active", "etype", "tenant", "ch_a", "val_a",
                      "ch_b", "val_b", "window_ms")
_ROLLUP_PARAM_FIELDS = ("channel", "scope", "etype", "window_ms")


def merged_rules_state(old, new, preserve_state: bool):
    """The rules subtree that replaces ``old`` with ``new``: ``new`` as it
    is, or with ``preserve_state`` (same-shaped tables) ``old``'s carried
    accumulators under ``new``'s parameter columns."""
    if not (preserve_state and old is not None and new is not None):
        return new
    merged_rules = old.rules
    if old.rules is not None and new.rules is not None:
        merged_rules = dataclasses.replace(old.rules, **{
            f: getattr(new.rules, f) for f in _RULE_PARAM_FIELDS})
    merged_rollups = old.rollups
    if old.rollups is not None and new.rollups is not None:
        merged_rollups = dataclasses.replace(old.rollups, **{
            f: getattr(new.rollups, f) for f in _ROLLUP_PARAM_FIELDS})
    return dataclasses.replace(new, rules=merged_rules, rollups=merged_rollups)


def tenant_cap(n_tenants: int) -> int:
    """Static power-of-two tenant bucket for the per-tenant segment-sum."""
    return max(64, 1 << max(0, n_tenants - 1).bit_length())


def format_tenant_counter_grid(grid, tenants) -> dict[str, dict[str, int]]:
    """[T_BUCKETS, C] device counter grid -> {tenant: {lane: n}} (quiet
    buckets omitted; buckets past the named-tenant range label as
    ``bucketN``)."""
    names = {tid % TENANT_COUNTER_BUCKETS: tenants.token(tid)
             for tid in range(min(len(tenants), TENANT_COUNTER_BUCKETS))}
    return {
        names.get(b, f"bucket{b}"): {
            lane: int(grid[b, i])
            for i, lane in enumerate(TENANT_COUNTER_LANES)}
        for b in range(grid.shape[0]) if grid[b].any()
    }


def tenant_counts_dict(counts, tenants, n_tenants: int) -> dict:
    """[t_cap, E] count grid -> {tenant: {EventType: n}} (quiet tenants
    skipped)."""
    out: dict[str, dict[str, int]] = {}
    for tid in range(min(n_tenants, counts.shape[0])):
        if not counts[tid].any():
            continue
        out[tenants.token(tid)] = {
            EventType(e).name: int(counts[tid, e])
            for e in range(counts.shape[1])
        }
    return out


def _tenant_event_counts(state: PipelineState, t_cap: int) -> torch.Tensor:
    """Segment-sum of the per-device event counters by tenant: [t_cap, E]
    int32. The JAX engine reduces with a one-hot einsum; cuBLAS has no
    int32 GEMM, so the port adds each device row into its tenant's row
    (inactive devices and tenants past ``t_cap`` into a spare row)."""
    reg = state.registry
    counts = state.device_state.event_counts              # [N, E]
    tenant = torch.where(reg.device_active, reg.device_tenant, -1)
    row = torch.where((tenant >= 0) & (tenant < t_cap), tenant, t_cap)
    out = counts.new_zeros((t_cap + 1, counts.shape[1]))
    out.index_add_(0, row.long(), counts)
    return out[:t_cap]


class _FairChunk:
    """A run of staged rows of one tenant awaiting fair batch formation.
    ``pos`` advances as formation slices rows out; the arrays are never
    copied after enqueue."""

    __slots__ = ("etype", "token", "ts", "recv", "values", "vmask",
                 "aux0", "aux1", "pos")

    def __init__(self, etype, token, ts, recv, values, vmask, aux0, aux1):
        self.etype = etype
        self.token = token
        self.ts = ts
        self.recv = recv
        self.values = values
        self.vmask = vmask
        self.aux0 = aux0
        self.aux1 = aux1
        self.pos = 0

    @property
    def remaining(self) -> int:
        return len(self.etype) - self.pos


def _fetch_query_result(res):
    """A launched query's page as numpy arrays (waits for the device). A
    module-level seam so tests can pin that the wait and the readback
    happen without the engine lock held."""
    return type(res)(*(col.cpu().numpy() for col in res))


class QueryBatcher:
    """Shared-scan micro-batcher for ``Engine.query_events``.

    Concurrent queries coalesce: the first submitter becomes the leader
    and drains the queue in rounds; queries arriving while a round
    executes form the next round. Each round groups entries by their
    power-of-two ``limit`` bucket and runs one ``query_store_batch`` per
    group — Q queries share a single pass over the ring. With an archive,
    the round also serves every archive request it holds in one planner
    pass (``EventArchive.query_batch``), capped at the rows the round's
    ring snapshot no longer holds, so the two tiers neither overlap nor
    leave a gap.

    Lock discipline: the leader takes the engine lock only to snapshot
    ``state.store`` (and its cursors) and enqueue the query's device work;
    the device wait, the readback and all host-side formatting happen
    outside it. The snapshot stays valid outside the lock because the
    port's step is functional — every step builds new state tensors and
    never writes into the old ones, so the snapshot's tensors are never
    overwritten. The cursors are cloned all the same, so that a step that
    writes in place could not move the archive cap under the ring scan.
    The archive pass holds the lock (the spooler mutates the archive
    under it), once a round.

    With QoS on (``attach_wfq``), an overflowing round's slots follow the
    tenants' weights instead of arrival order. Each round opens the
    ``query.round.snapshot``, ``.archive`` and ``.fetch`` spans, a
    follower's wait a ``query.coalesce_wait`` span."""

    def __init__(self, engine, max_batch: int = 16):
        self.engine = engine
        self.max_batch = max(1, int(max_batch))
        self._mu = threading.Lock()
        self._queue: list[dict] = []
        self._running = False
        self._wfq = None         # weighted-fair round membership (QoS)
        self.programs = 0        # query_store_batch calls launched
        self.coalesced = 0       # queries served through them
        self.max_coalesced = 0   # largest micro-batch observed
        self._metrics = query_metrics()

    def attach_wfq(self, weights: dict | None) -> None:
        """Weighted-fair round membership: when more queries are queued
        than one round holds, slots go in per-tenant virtual-time order
        instead of first come."""
        from sitewhere_tpu_torch.utils.qos import WFQPicker

        self._wfq = WFQPicker(weights)

    def observe_latency(self, seconds: float) -> None:
        self._metrics["latency"].observe(seconds)
        self._metrics["queries"].inc()

    def run(self, params: tuple, limit: int, archive: dict | None = None,
            tenant: str | None = None, trace_id: str | None = None):
        """Submit one predicate set (``QueryParams`` field order, plain
        ints) at a bucketed ``limit``. ``archive`` (``{"limit":
        exact_page, "filters": {...}}``) asks the round to scan the
        archive for this query too. Returns ``(row, cursors, q,
        archive_result)``: the query's ``QueryResult`` row as numpy
        arrays, the snapshot's cursor capture (``(epoch, cursor,
        arena_capacity)`` or None), the size of the micro-batch it rode
        in, and the ``(total, rows)`` archive page (None when there is no
        archive, it is empty or the ring still holds everything)."""
        entry = {"params": params, "limit": int(limit),
                 "event": threading.Event(), "result": None,
                 "cursors": None, "q": 0, "error": None,
                 "archive": archive, "archive_result": None,
                 "tenant": tenant or "default", "trace": trace_id}
        if self.engine.lock._is_owned():
            # a caller already inside the engine lock must not park as a
            # follower: the leader would block on the lock it holds
            self._execute([entry])
        else:
            with self._mu:
                self._queue.append(entry)
                lead = not self._running
                if lead:
                    self._running = True
            if lead:
                self._drain()
            else:
                wait_sp = self.engine.tracer.begin(
                    "query.coalesce_wait", trace_id=trace_id)
                entry["event"].wait()
                wait_sp.end(q=entry["q"])
            if entry["error"] is not None:
                raise entry["error"]
        return (entry["result"], entry["cursors"], entry["q"],
                entry["archive_result"])

    def _drain(self) -> None:
        """Leader loop: execute rounds until the queue is empty. The empty
        check and the ``_running`` handoff are atomic, so no entry can
        strand."""
        while True:
            with self._mu:
                if self._wfq is not None and len(self._queue) > self.max_batch:
                    # an overflowing round under QoS: membership follows
                    # the tenants' weights (FIFO within a tenant)
                    batch, self._queue = self._wfq.pick(self._queue,
                                                        self.max_batch)
                else:
                    batch = self._queue[: self.max_batch]
                    del self._queue[: len(batch)]
                if not batch:
                    self._running = False
                    return
            try:
                self._execute(batch)
            except Exception as e:   # fail every entry of the round loudly
                for entry in batch:
                    if not entry["event"].is_set():
                        entry["error"] = e
                        entry["event"].set()

    def _execute(self, batch: list[dict]) -> None:
        eng = self.engine
        groups: dict[int, list[dict]] = {}
        for entry in batch:
            groups.setdefault(entry["limit"], []).append(entry)
        # round-level spans attribute to the first traced entry (the round
        # is one shared unit of work); context managers, so a failed round
        # leaves no open span on the leader thread
        round_trace = next((e.get("trace") for e in batch if e.get("trace")),
                           None)
        launched = []
        with eng.tracer.begin("query.round.snapshot",
                              trace_id=round_trace, q=len(batch)) as snap_sp:
            with eng.lock:
                store = self._snapshot()
                cursors = None
                if eng.archive is not None:
                    cursors = (store.epoch.clone(), store.cursor.clone(),
                               store.arena_capacity)
                for limit, entries in groups.items():
                    cols = torch.tensor([e["params"] for e in entries],
                                        dtype=torch.int32).T
                    launched.append((entries, self._launch(store, cols, limit)))
                    qn = len(entries)
                    self.programs += 1
                    self.coalesced += qn
                    self.max_coalesced = max(self.max_coalesced, qn)
                    self._metrics["batch"].observe(float(qn))
                    self._metrics["programs"].inc()
            snap_sp.annotate(programs=len(launched))
        # one archive pass for every archive request of the round, capped
        # at absolute positions below head - capacity of the snapshot
        archive_entries = [e for e in batch if e["archive"] is not None]
        if archive_entries and cursors is not None:
            ep, cu, acap = cursors
            ep, cu = ep.cpu().numpy(), cu.cpu().numpy()
            max_pos = {a: int(ep[a]) * acap + int(cu[a]) - acap
                       for a in range(len(cu))}
            with eng.lock:
                if eng.archive.segments and any(v > 0 for v in max_pos.values()):
                    with eng.tracer.begin(
                            "query.round.archive", trace_id=round_trace,
                            queries=len(archive_entries)) as arch_sp:
                        decoded0 = eng.archive.plan_decoded
                        results = eng.archive.query_batch(
                            [e["archive"] for e in archive_entries],
                            max_pos=max_pos)
                        for e, res in zip(archive_entries, results):
                            e["archive_result"] = res
                        arch_sp.annotate(segments_decoded=eng.archive.plan_decoded
                                         - decoded0)
        with eng.tracer.begin("query.round.fetch", trace_id=round_trace):
            for entries, res in launched:
                self._unpack_round(entries, res, cursors)

    # the round's three device seams (the multi-shard engine's batcher
    # spans every shard through them): the store snapshot, the launch of
    # one limit group's query_store_batch from its host parameter columns
    # ([N_QUERY_PARAMS, Q] int32), and the readback of its pages
    def _snapshot(self):
        return self.engine.state.store

    def _launch(self, store, cols: torch.Tensor, limit: int):
        return query_store_batch(store, QueryParams(*cols.to(self.engine.device)),
                                 limit=limit)

    def _unpack_round(self, entries: list[dict], res, cursors) -> None:
        host = _fetch_query_result(res)
        for q, entry in enumerate(entries):
            entry["result"] = type(host)(*(col[q] for col in host))
            entry["cursors"] = cursors
            entry["q"] = len(entries)
            entry["event"].set()


class Engine:
    """Single-device engine instance."""

    def __init__(self, config: EngineConfig | None = None,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.config = config or EngineConfig()
        c = self.config
        self.device = resolve_device(device)
        self.epoch = EpochBase()
        self.lock = threading.RLock()
        self.host_counters: dict[str, int] = {}
        # the native data plane (C++ decode + interning) unless the caller
        # asks for the Python path; a failed build raises here
        self._native_decoder = None
        if c.use_native:
            from sitewhere_tpu_torch.ingest.fast_decode import NativeBatchDecoder
            from sitewhere_tpu_torch.native.binding import NativeInterner

            self.tokens = NativeInterner(c.token_capacity)
            self._native_decoder = NativeBatchDecoder(self.tokens, c.channels)
            self.channel_map = ChannelMap(c.channels, self._native_decoder.names,
                                          strict=c.strict_channels)
            self.alert_types = self._native_decoder.alert_types
            # alternate/correlation ids (the aux1 lane): the engine adopts
            # the decoder's interner so the batch path and process() hand
            # out the same ids
            self.event_ids = self._native_decoder.event_ids
        else:
            self.tokens = TokenInterner(c.token_capacity)
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
        self.pipeline_config = PipelineConfig(auto_register=c.auto_register)
        self._create_state()
        self._scan_step = make_packed_scan_step(
            self.pipeline_config, c.batch_capacity, c.channels)
        self._buf = HostEventBuffer(c.batch_capacity, c.channels)
        self._staged_batches: list[EventBatch] = []   # emitted host batches
                                                      # awaiting a scan chunk
        # zero-copy arena ingest (native batch decode only): the scanner
        # writes straight into pooled staging columns that one copy moves
        # to the device; with scan_chunk K > 1 an arena holds K batches
        # and one dispatch runs K steps on its lanes
        self._arena_pool = None
        self._arena_fill = None
        self._arena_step = None
        self._arena_committing = False
        self._arena_dispatches = 0
        self._sharder = None
        self._create_arenas()
        self._last_flush = time.monotonic()
        # host mirrors
        self.devices: dict[int, DeviceInfo] = {}           # device_id -> info
        self.token_device: dict[int, int] = {}             # token_id -> device_id
        self.assignments: dict[int, AssignmentInfo] = {}   # assignment_id -> info
        self.assignment_tokens: dict[str, int] = {}        # token -> assignment_id
        self.device_slots: dict[int, list[int]] = {}       # device_id -> slot row
        self._next_device = 0
        self._next_assignment = 0
        self.dead_letters: list[int] = []                  # unregistered token ids
        self.outputs: list[dict] = []                      # recent step summaries
        self._pending_outs: list[StepOutput] = []          # un-absorbed outputs
        self._pending_fences: list = []                    # their fences
        self._fair_queues: dict[int, collections.deque] = {}  # tenant -> rows
        self._fair_queued = 0
        self._backlog_hwm = 0   # staged-row high-watermark (reset on scrape)
        # flight recorder: one lifecycle record a batch; _staged_traces
        # holds records whose rows wait in the copy-staging buffer,
        # _pending_traces parallels _pending_outs for drain's stamps
        self.flight = FlightRecorder(capacity=c.flight_capacity,
                                     enabled=c.flight_recorder)
        self._staged_traces: list = []
        self._pending_traces: list[list] = []
        # live spans for what flight records do not time (shard decode,
        # query rounds, archive jobs)
        self.tracer = SpanTracer(capacity=c.span_capacity,
                                 enabled=c.span_trace,
                                 sample=c.span_sample, seed=c.span_seed)
        if self._sharder is not None:
            self._sharder.tracer = self.tracer
        # process-unique label scoping this engine's series on the
        # process-global registry (the SLO harvest writes under it)
        self.metrics_label = next_engine_label()
        self._query_batcher = QueryBatcher(self, max_batch=c.query_coalesce)
        # conservation ledger: rows staged and rows dispatched; the
        # auditor (utils/conservation.ConservationAuditor) attaches here
        self.ledger = FlowLedger(enabled=c.conservation)
        self.conservation_auditor = None
        # persistent-connection wire edges register here (none is ported)
        self.wire_edges: list = []
        # durability: accepted payloads append to the WAL before staging,
        # tagged by wire format so recovery replays each through the
        # decoder that accepted it (utils/checkpoint.recover_engine)
        self.wal = None
        self._wal_local = threading.local()   # re-entrancy guard per thread
        self._wal_last_seq = 0   # newest append ticket; dispatch gates on it
        if c.wal_dir:
            from sitewhere_tpu_torch.utils.ingestlog import IngestLog

            self.wal = IngestLog(c.wal_dir, group_commit=c.wal_group_commit,
                                 group_window_s=c.wal_group_window_s)
        # the retention tier: rows spill to disk before the ring can
        # overwrite them
        self.archive = None
        self._rows_since_spool = 0
        # the spooler's host cost: spools, segments written, host syncs
        # (one for the ring heads, one copy a segment) and seconds
        self.spool_stats = {"spools": 0, "segments": 0, "syncs": 0,
                            "seconds": 0.0}
        if c.archive_dir:
            from sitewhere_tpu_torch.utils.archive import (EventArchive,
                                                           single_topology)

            acap = c.store_capacity // c.tenant_arenas
            self.archive = EventArchive(
                c.archive_dir,
                segment_rows=max(1, min(c.archive_segment_rows, acap // 4)),
                max_rows_per_part=c.archive_max_rows,
                topology=single_topology(c.tenant_arenas),
                max_age_ms=c.archive_max_age_ms,
                cache_segments=c.archive_cache_segments,
                compress=c.archive_compress)
            # spool whenever any arena could be halfway to overwrite: with
            # every staged row landing in one arena, backlog + one batch
            # stays below the arena's capacity
            self._spool_trigger = max(self.archive.segment_rows,
                                      acap // 2 - c.batch_capacity)
            # one scan-chunk dispatch advances a head by up to
            # K * batch * MAX_ACTIVE rows before the next spool check; past
            # the arena's headroom no trigger can spill without loss (a
            # loss is still counted)
            worst = (max(1, c.scan_chunk) * c.batch_capacity
                     * MAX_ACTIVE_ASSIGNMENTS)
            if worst > acap - self.archive.segment_rows:
                logging.getLogger(__name__).warning(
                    "archive: one dispatch can write %d rows but arena "
                    "capacity is %d: the ring may wrap before spooling; "
                    "raise store_capacity or lower scan_chunk/batch_capacity",
                    worst, acap)
        # stage-time autotuner (opt-in): one knob an evaluation toward the
        # flight recorder's measured bottleneck
        self._autotuner = None
        if c.autotune:
            from sitewhere_tpu_torch.utils.autotune import StageTimeAutotuner

            self._autotuner = StageTimeAutotuner(
                self, interval=c.autotune_interval,
                adapt_scan_chunk=c.autotune_scan_chunk)
        # overload discipline: token-bucket admission (consulted by the
        # edges, never by the engine's own ingest, so WAL replay can never
        # shed a durable event) and weighted-fair scheduling of the ingest
        # critical section and the query rounds
        self.qos = None
        self._wfq_gate = None
        self._stall_sheds = 0     # arena-stall sheds (not a metrics() key)
        if c.qos:
            from sitewhere_tpu_torch.utils.qos import (AdmissionController,
                                                       WeightedFairGate)

            self.qos = AdmissionController(
                tenant_rates=c.tenant_rates,
                default_rate_eps=c.qos_default_rate_eps,
                burst_s=c.qos_burst_s,
                shed_threshold=(c.shed_threshold
                                or 4 * c.batch_capacity * max(1, c.scan_chunk)),
                backlog_fn=lambda: self.staged_count,
                min_retry_after_s=c.qos_min_retry_after_s)
            self._wfq_gate = WeightedFairGate(c.tenant_weights)
            self._query_batcher.attach_wfq(c.tenant_weights)

    def _create_state(self) -> None:
        """The initial device state: one ``PipelineState`` on
        ``self.device`` (the multi-shard engine builds its shards here)."""
        c = self.config
        self.state = PipelineState.create(
            c.device_capacity, c.token_capacity, c.assignment_capacity,
            c.store_capacity, c.channels,
            analytics_devices=c.analytics_devices,
            analytics_window=c.analytics_window,
            store_arenas=c.tenant_arenas,
            device=self.device,
        )

    def _create_arenas(self) -> None:
        """The staging-arena pool (native batch decode only) and the
        decode sharder: one wire batch decoded by several threads into
        disjoint arena rows, byte-identical to one thread."""
        c = self.config
        if self._native_decoder is not None and c.ingest_arenas >= 0:
            self._build_arena_machinery(max(1, c.scan_chunk))
        if self._arena_pool is not None:
            n_workers = c.ingest_workers or (os.cpu_count() or 1)
            if n_workers > 1:
                from sitewhere_tpu_torch.ingest.workers import ShardedArenaDecoder

                self._sharder = ShardedArenaDecoder(self._native_decoder,
                                                    n_workers)

    def _build_arena_machinery(self, k: int) -> None:
        """(Re)build the staging-arena pool (page-locked on a CUDA engine)
        and, for k > 1, the K-lane arena scan step: one constructor for
        ``__init__`` and a ``scan_chunk`` retune."""
        from sitewhere_tpu_torch.ingest.arena import ArenaPool

        c = self.config
        self._arena_pool = ArenaPool(
            c.ingest_arenas or max(1, c.dispatch_depth) + 2,
            c.batch_capacity * k, c.channels, lanes=k,
            pin=self.device.type == "cuda")
        self._arena_step = None
        if k > 1:
            self._arena_step = make_arena_scan_step(
                self.pipeline_config, c.batch_capacity, c.channels, k)

    def set_ingest_tuning(self, *, scan_chunk: int | None = None,
                          dispatch_depth: int | None = None,
                          ingest_workers: int | None = None,
                          shed_threshold: int | None = None) -> dict:
        """Apply ingest knobs at run time — the one choke point of the
        autotuner and of operators, because each knob invalidates other
        machinery:

          dispatch_depth   takes effect at the next dispatch
          ingest_workers   clamps the sharded-decode fan-out
          shed_threshold   moves the QoS saturation valve (no-op without
                           QoS)
          scan_chunk       dispatches what is staged, waits out every
                           in-flight dispatch (no arena of the old shape
                           may still feed a copy), then rebuilds the
                           pinned arena pool and the arena scan step

        Returns the applied values."""
        with self.lock:
            c = self.config
            if dispatch_depth is not None:
                c.dispatch_depth = max(1, int(dispatch_depth))
            if ingest_workers is not None and self._sharder is not None:
                self._sharder.set_active_workers(ingest_workers)
            if shed_threshold is not None and self.qos is not None:
                c.shed_threshold = max(1, int(shed_threshold))
                self.qos.shed_threshold = c.shed_threshold
            if scan_chunk is not None:
                k = max(1, int(scan_chunk))
                if k != max(1, c.scan_chunk) and self._arena_pool is not None:
                    self._dispatch_arena()
                    self._dispatch_staged(all_batches=True)
                    self._arena_pool.drain()
                    self._build_arena_machinery(k)
                    c.scan_chunk = k
            applied = {"scan_chunk": c.scan_chunk,
                       "dispatch_depth": c.dispatch_depth,
                       "ingest_workers": (self._sharder.active_workers
                                          if self._sharder else 1)}
            if self.qos is not None:
                applied["shed_threshold"] = self.qos.shed_threshold
            return applied

    def take_backlog_hwm(self, reset: bool = True) -> int:
        """Most staged rows waiting at once since the last reset (the
        scrape resets; peeks pass ``reset=False``)."""
        hwm = max(self._backlog_hwm, self.staged_count)
        if reset:
            self._backlog_hwm = self.staged_count
        return hwm

    # --------------------------------------------------------- flight recorder
    def get_trace(self, trace_id: str) -> dict:
        """The lifecycle records of one trace id."""
        return {"traceId": trace_id,
                "records": self.flight.records_of(trace_id)}

    def recent_traces(self, limit: int = 50) -> list[dict]:
        return self.flight.recent(limit)

    def get_trace_timeline(self, trace_id: str) -> dict:
        """One trace as a Chrome-trace-event document (loads in Perfetto):
        the flight record's lifecycle intervals merged with the tracer's
        live spans."""
        from sitewhere_tpu_torch.utils.tracing import (finish_timeline,
                                                       timeline_events)

        return finish_timeline(trace_id, timeline_events(self, trace_id))

    def slo_harvest(self) -> list:
        """Completed ingest lifecycles not yet exported to the SLO plane,
        each handed out once (the scrape's per-tenant
        ``swtpu_ingest_e2e_seconds`` is built from them, so the ingest
        path pays no sync for SLO latency)."""
        return self.flight.harvest_completed("ingest",
                                             terminal="device_ready")

    def _step(self, state: PipelineState, batch: EventBatch):
        return pipeline_step(state, batch, self.pipeline_config)

    def _fence(self):
        """A CUDA event recorded after the work enqueued so far on the
        engine's stream (the copy and the step of the latest dispatch), or
        None on the CPU, where that work has already run."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @property
    def staged_count(self) -> int:
        return (len(self._buf) + self._fair_queued
                + (self._arena_fill.cursor if self._arena_fill is not None
                   else 0)
                + sum(int(np.sum(b.valid)) for b in self._staged_batches))

    def _sync_mirrors(self) -> None:
        """Make host mirrors current: dispatch staged rows and absorb the
        pending outputs (lock held). The fill arena is not dispatched
        mid-commit: a registration envelope's admin path re-enters here
        while the arena's valid mask is still being built, and its
        committed rows dispatch when the commit finishes."""
        while (len(self._buf) or self._fair_queued
               or (self._arena_fill is not None and self._arena_fill.cursor
                   and not self._arena_committing)):
            self.flush_async()
        if self._staged_batches:
            self._dispatch_staged(all_batches=True)
        if self._pending_outs:
            self.drain()

    # ------------------------------------------------------------------ WAL
    def _wal_append(self, tag: bytes, payloads: list[bytes],
                    tenant: str) -> None:
        """Log accepted payloads, under the engine lock (a snapshot's
        watermark can never cover a record whose events were not staged).
        No-op while replaying, or while an outer ingest path on this
        thread already logged the raw batch. With group commit the append
        buffers and returns a ticket; :meth:`_wal_gate` holds the dispatch
        until it is durable. Without it, the group is written and flushed
        inline."""
        if self.wal is None or getattr(self._wal_local, "depth", 0):
            return
        rec = self.flight.current()
        t0 = time.perf_counter()
        self._wal_last_seq = self.wal.append_many(
            payloads, tag + tenant.encode() + b"\x00")
        if not self.wal.group_commit:
            self.wal.flush()
        rec.mark("wal_append")
        rec.add("wal_flush_ms", round((time.perf_counter() - t0) * 1000, 3))

    def _wal_gate(self, traces=()) -> None:
        """Block until every WAL record appended so far is durable — called
        under the engine lock before a dispatch enqueues its host-to-device
        copy; stamps ``wal_durable`` on the dispatch's records. No-op
        without a WAL or without group commit (whose appends flushed
        inline, and which promises no durability at dispatch)."""
        if self.wal is None or not self.wal.group_commit:
            return
        t0 = time.perf_counter()
        self.wal.wait_durable(self._wal_last_seq)
        dt = time.perf_counter() - t0
        for rec in traces:
            rec.mark("wal_durable")
            rec.add("wal_gate_ms", round(dt * 1000, 3))

    @contextlib.contextmanager
    def _wal_suppress(self):
        """Suppress WAL logging for nested process() calls on this thread
        (their raw batch is already logged)."""
        self._wal_local.depth = getattr(self._wal_local, "depth", 0) + 1
        try:
            yield
        finally:
            self._wal_local.depth -= 1

    def _wal_admin_register(self, token: str, device_type: str, tenant: str,
                            area: str | None, customer: str | None) -> None:
        """Log an admin-path registration as its wire-form REGISTER
        envelope, in the critical section of the mutation, so that WAL
        replay recreates it. The wire path already logged its envelope and
        re-enters under ``_wal_suppress``: no-op there."""
        if self.wal is None or getattr(self._wal_local, "depth", 0):
            return
        extras = {"deviceTypeToken": device_type}
        if area:
            extras["areaToken"] = area
        if customer:
            extras["customerToken"] = customer
        req = DecodedRequest(type=RequestType.REGISTER_DEVICE,
                             device_token=token, tenant=tenant, extras=extras)
        self._wal_append(WAL_BINARY, [encode_binary_request(req)], tenant)

    # ------------------------------------------------------------------ ingest
    def process(self, req) -> None:
        """Stage one decoded request (the per-request path); flushes when
        the staging batch fills. Registration and mapping envelopes take
        the admin path; event requests convert to one staged SoA row."""
        with self.lock:
            if self.channel_map.strict and req.measurements:
                # strict mode rejects before the WAL append (a refused
                # event is never durable) and without interning (refused
                # names leak no lanes)
                self.channel_map.validate(req.measurements)
            if self.wal is not None:
                # log the request in the binary wire form when it has one;
                # other types are snapshot-only
                try:
                    self._wal_append(WAL_BINARY, [encode_binary_request(req)],
                                     req.tenant)
                except KeyError:
                    pass
            if req.type is RequestType.REGISTER_DEVICE:
                # the envelope above is this registration's WAL record
                with self._wal_suppress():
                    self.register_device(
                        req.device_token,
                        device_type=req.extras.get(
                            "deviceTypeToken", self.config.default_device_type),
                        tenant=req.tenant,
                        area=req.extras.get("areaToken"),
                        customer=req.extras.get("customerToken"),
                    )
                return
            if req.type is RequestType.MAP_DEVICE:
                parent = (req.extras.get("parentToken")
                          or req.extras.get("parentHardwareId"))
                if parent:
                    self.map_device(req.device_token, parent)
                return
            et = req.event_type
            if et is None:
                return
            now = self.epoch.now_ms()
            # wire timestamps are absolute unix ms; device lanes carry int32
            # ms relative to the engine epoch base
            if req.event_ts_ms is not None:
                base_ms = int(self.epoch.base_unix_s * 1000)
                ts = int(np.clip(req.event_ts_ms - base_ms,
                                 -(2**31) + 1, 2**31 - 1))
            else:
                ts = now
            token_id = self.tokens.intern(req.device_token)
            tenant_id = self.tenants.intern(req.tenant)
            channels = self.config.channels
            values = np.zeros(channels, np.float32)
            mask = np.zeros(channels, np.bool_)
            aux0 = NULL_ID
            if et is EventType.MEASUREMENT and req.measurements:
                for name, val in req.measurements.items():
                    ch = self.channel_map.channel_of(name)
                    values[ch] = val
                    mask[ch] = True
            elif et is EventType.LOCATION:
                # lanes only when coordinates were provided: no (0, 0) rows
                if req.latitude is not None and req.longitude is not None:
                    values[0], values[1] = req.latitude, req.longitude
                    values[2] = req.elevation or 0.0
                    mask[:3] = True
            elif et is EventType.ALERT:
                values[0] = float(int(req.alert_level))
                mask[0] = True
                aux0 = self.alert_types.intern(req.alert_type or "alert")
            elif et is EventType.COMMAND_RESPONSE and req.originating_event_id:
                aux0 = self.event_ids.intern(req.originating_event_id)
            elif et is EventType.STATE_CHANGE and (req.attribute or req.state_type):
                aux0 = self.event_ids.intern(
                    f"{req.attribute or ''}:{req.state_type or ''}")
            aux1 = (self.event_ids.intern(req.alternate_id)
                    if req.alternate_id is not None else NULL_ID)
            self._stage_row(int(et), token_id, tenant_id, ts, now,
                            values, mask, aux0, aux1)

    def _stage_row(self, et, token_id, tenant_id, ts, now, values, mask,
                   aux0, aux1) -> None:
        """Stage one converted event row; flushes when the batch fills.
        Caller holds the lock."""
        self.host_counters["staged_copy_rows"] = \
            self.host_counters.get("staged_copy_rows", 0) + 1
        self.ledger.add("staged_rows", 1)
        if self.config.fair_tenancy:
            i32 = np.int32
            has_vals = mask is not None and (mask.any() or values.any())
            self._fair_enqueue(tenant_id, _FairChunk(
                etype=np.array([et], i32),
                token=np.array([token_id], i32),
                ts=np.array([ts], i32),
                recv=np.array([now], i32),
                values=values[None].copy() if has_vals else None,
                vmask=mask[None].copy() if has_vals else None,
                aux0=np.array([aux0], i32),
                aux1=np.array([aux1], i32),
            ))
            return
        i = len(self._buf)
        if not self._buf.append(et, token_id, tenant_id, ts, now, (), aux0, aux1):
            self.flush_async()
            i = len(self._buf)
            self._buf.append(et, token_id, tenant_id, ts, now, (), aux0, aux1)
        if mask is not None and mask.any():
            self._buf.values[i, :] = values
            self._buf.vmask[i, :] = mask
        if self._buf.full:
            self.flush_async()

    def _fair_enqueue(self, tenant_id: int, chunk: _FairChunk) -> None:
        """Queue a chunk of staged rows under its tenant (a whole decode
        batch is one chunk). Caller holds the lock."""
        q = self._fair_queues.get(tenant_id)
        if q is None:
            q = self._fair_queues[tenant_id] = collections.deque()
        q.append(chunk)
        self._fair_queued += chunk.remaining
        if self._fair_queued >= self.config.batch_capacity:
            self.flush_async()

    def fair_backlog(self, tenant: str) -> int:
        """Rows queued but not yet batched for one tenant (fair mode)."""
        with self.lock:
            tid = self.tenants.lookup(tenant)
            return sum(c.remaining for c in self._fair_queues.get(tid, ()))

    def _form_fair_batch(self) -> None:
        """Quota-sliced batch formation across tenants: each pass gives
        every tenant with backlog an equal share of the staging buffer's
        remaining room, copied as vectorized slices — one tenant's burst
        cannot starve the others' latency. Caller holds the lock."""
        b = self._buf
        while self._fair_queued and not b.full:
            active = [t for t, q in self._fair_queues.items() if q]
            if not active:
                break
            quota = max(1, (b.capacity - len(b)) // len(active))
            for tid in active:
                q = self._fair_queues[tid]
                take = quota
                while take > 0 and q and not b.full:
                    ch = q[0]
                    k = min(take, ch.remaining, b.capacity - len(b))
                    lo, hi, p = b._n, b._n + k, ch.pos
                    b.etype[lo:hi] = ch.etype[p:p + k]
                    b.token_id[lo:hi] = ch.token[p:p + k]
                    b.tenant_id[lo:hi] = tid
                    b.ts_ms[lo:hi] = ch.ts[p:p + k]
                    b.received_ms[lo:hi] = ch.recv[p:p + k]
                    if ch.values is not None:
                        b.values[lo:hi] = ch.values[p:p + k]
                        b.vmask[lo:hi] = ch.vmask[p:p + k]
                    b.aux[lo:hi, 0] = ch.aux0[p:p + k]
                    b.aux[lo:hi, 1] = ch.aux1[p:p + k]
                    b._n = hi
                    ch.pos += k
                    take -= k
                    self._fair_queued -= k
                    if ch.remaining == 0:
                        q.popleft()
        for tid in [t for t, q in self._fair_queues.items() if not q]:
            del self._fair_queues[tid]

    def ingest_json_batch(self, payloads: list[bytes],
                          tenant: str = "default",
                          traceparent: str | None = None) -> dict:
        """Decode a batch of JSON device-request payloads in one native call
        and stage them vectorized (no per-event Python); with
        ``use_native=False``, decode each payload in Python and stage it
        through :meth:`process`. Returns ``{"decoded", "failed"}`` (and
        ``"staged"`` on the native path) and the batch's ``trace_id``.
        Registration and mapping envelopes take the per-request path."""
        return self._ingest_batch(
            payloads, tenant, WAL_JSON, JsonDeviceRequestDecoder(),
            self._native_decoder.decode if self._native_decoder else None,
            binary=False, traceparent=traceparent)

    def ingest_binary_batch(self, payloads: list[bytes],
                            tenant: str = "default",
                            traceparent: str | None = None) -> dict:
        """:meth:`ingest_json_batch` for the flat-binary wire format
        (``ingest/decoders.encode_binary_request``)."""
        return self._ingest_batch(
            payloads, tenant, WAL_BINARY, BinaryEventDecoder(),
            self._native_decoder.decode_binary if self._native_decoder
            else None, binary=True, traceparent=traceparent)

    def _ingest_batch(self, payloads: list[bytes], tenant: str, tag: bytes,
                      dec, native_fn, binary: bool,
                      traceparent: str | None = None) -> dict:
        """The batch skeleton: strict validation -> WAL -> stage, in one
        flight-recorder lifecycle record (``traceparent``, explicit or
        bound, joins a trace instead of opening one). With QoS the
        batch's weighted-fair turn orders which tenant enters the ingest
        critical section next; callers already inside the engine lock
        skip the turn (parking them would deadlock). ``native_fn`` is the
        native SoA decoder call (None = Python)."""
        rec = self.flight.begin(
            "ingest", tenant=tenant, n_payloads=len(payloads),
            traceparent=traceparent or current_traceparent())
        gate = self._wfq_gate
        gate_ctx = (gate.turn(tenant, len(payloads))
                    if gate is not None and not self.lock._is_owned()
                    else contextlib.nullcontext())
        with self.flight.bind(rec):
            summary = self._ingest_batch_inner(payloads, tenant, tag, dec,
                                               native_fn, binary, rec,
                                               gate_ctx)
        if rec.trace_id is not None:
            rec.add_counts(summary)
            if rec.meta.get("path") != "arena" and summary.get("staged"):
                with self.lock:
                    if self.staged_count:
                        # rows wait in the shared buffer: the next flush
                        # stamps this record's dispatch
                        self._staged_traces.append(rec)
                    else:
                        # a mid-ingest buffer-fill flush already dispatched
                        # every row: join the newest in-flight dispatch so
                        # drain stamps the tail stages
                        rec.mark("dispatch")
                        if self._pending_traces:
                            self._pending_traces[-1].append(rec)
                        else:
                            rec.mark("device_ready")
            summary["trace_id"] = rec.trace_id
        return summary

    def _ingest_batch_inner(self, payloads, tenant, tag, dec, native_fn,
                            binary, rec, gate_ctx) -> dict:
        # gate_ctx is the batch's single-use weighted-fair turn; each
        # branch enters it just before its own critical section, never
        # around work designed to run outside the lock
        if native_fn is None:
            with gate_ctx, self.lock:
                predecoded = self._strict_predecode(payloads, dec)
                self._wal_append(tag, payloads, tenant)
                summary = self._ingest_python_fallback(payloads, tenant, dec,
                                                       predecoded)
                rec.mark("decode")
                rec.mark("commit")
                return summary
        if self.config.strict_channels:
            # strict decodes under the lock, so a rejected batch can roll
            # back the names it interned without clobbering a concurrent
            # batch's
            with gate_ctx, self.lock:
                names_before = len(self.channel_map.names)
                res = native_fn(payloads)
                rec.mark("decode")
                self._check_strict_native(res, names_before)
                self._wal_append(tag, payloads, tenant)
                summary = self._ingest_decoded(res, payloads, tenant, dec)
                rec.mark("commit")
                return summary
        if self._arena_pool is not None and not self.config.fair_tenancy:
            with gate_ctx:
                return self._ingest_batch_arena(payloads, tenant, tag, dec,
                                                binary)
        # copy path: decode outside the lock (and outside the turn), log
        # and stage atomically
        res = native_fn(payloads)
        rec.mark("decode")
        with gate_ctx, self.lock:
            self._wal_append(tag, payloads, tenant)
            summary = self._ingest_decoded(res, payloads, tenant, dec)
            rec.mark("commit")
            return summary

    def _strict_predecode(self, payloads, dec):
        """Strict pre-pass of the Python path: decode once and check the
        channel capacity without interning, so a rejected batch leaks no
        lanes. Returns the per-payload request lists (None = failed) for
        :meth:`_ingest_python_fallback`; None when strict mode is off.
        Caller holds the lock."""
        if not self.channel_map.strict:
            return None
        decoded: list[list | None] = []
        names: list[str] = []
        for p in payloads:
            try:
                reqs = dec.decode(p, {})
            except Exception:
                decoded.append(None)   # counted failed on the ingest pass
                continue
            decoded.append(reqs)
            for req in reqs:
                names.extend(req.measurements or ())
        self.channel_map.validate(names)
        return decoded

    def _check_strict_native(self, res, names_before: int) -> None:
        """Strict native path: on any lane collision the whole batch is
        rejected before the WAL and staging, and the names it interned
        roll back. Caller holds the lock."""
        if not self.config.strict_channels or not res.collisions:
            return
        self.channel_map.names.truncate(names_before)
        self.channel_map.collisions += res.collisions
        raise ChannelCapacityError(
            f"{res.collisions} measurement lane collision(s) in batch: "
            f"distinct names exceed channel capacity "
            f"{self.config.channels}; raise channels or drop strict_channels")

    def _ingest_python_fallback(self, payloads, tenant, dec,
                                predecoded=None) -> dict:
        """Per-request staging; reuses the strict pre-pass's decode when
        there is one. A payload that fails to decode or to stage counts as
        failed."""
        failed = 0
        with self._wal_suppress():   # the raw batch is already logged
            if predecoded is not None:
                for reqs in predecoded:
                    if reqs is None:
                        failed += 1
                        continue
                    for req in reqs:
                        req.tenant = tenant
                        self.process(req)
            else:
                for p in payloads:
                    try:
                        for req in dec.decode(p, {}):
                            req.tenant = tenant
                            self.process(req)
                    except Exception:
                        failed += 1
        return {"decoded": len(payloads) - failed, "failed": failed}

    def _reroute_envelopes(self, rtype: np.ndarray, payloads, tenant,
                           reg_decoder) -> tuple[np.ndarray, int, int]:
        """Registration, mapping and acknowledge envelopes carry strings the
        fast columns do not extract: decode each again and stage it
        through :meth:`process`. Returns (their row mask, envelopes
        staged, envelopes failed). Caller holds the lock."""
        regs = (rtype == RT_REGISTER) | (rtype == RT_MAP) | (rtype == RT_ACK)
        n_ok = failed = 0
        if regs.any():
            with self._wal_suppress():   # the raw batch is already logged
                for i in np.nonzero(regs)[0]:
                    try:
                        for req in reg_decoder.decode(payloads[int(i)], {}):
                            req.tenant = tenant
                            self.process(req)
                        n_ok += 1
                    except Exception:
                        failed += 1
        return regs, n_ok, failed

    def _decode_prologue(self, res, payloads, tenant, reg_decoder,
                         now: int, base_ms: int):
        """Post-processing of a native SoA decode on the copy path: map
        request types to event types, re-route the envelopes, relativize
        timestamps and fold alert levels into values lane 0. Returns
        (etype, ok, ts_rel, values, failed, n_reg_ok). Caller holds the
        lock."""
        etype = RTYPE_TO_ETYPE[np.clip(res.rtype, -1, 7)]
        ok = (res.rtype >= 0) & (etype >= 0)
        regs, n_reg_ok, reg_failed = self._reroute_envelopes(
            res.rtype, payloads, tenant, reg_decoder)
        ok &= ~regs   # slow-path rows must not also stage on the fast path
        failed = int(np.sum(res.rtype < 0)) + reg_failed
        # relative int32 timestamps (absent -> now)
        ts_rel = np.where(
            res.ts_ms64 >= 0,
            np.clip(res.ts_ms64 - base_ms, -(2**31) + 1, 2**31 - 1),
            now,
        ).astype(np.int32)
        values = res.values
        alert_rows = ok & (etype == int(EventType.ALERT))
        if np.any(alert_rows):
            values = values.copy()
            values[alert_rows, 0] = res.level[alert_rows]
        return etype, ok, ts_rel, values, failed, n_reg_ok

    # ------------------------------------------------------------ arena ingest
    def _acquire_arena(self, tenant: str, n_remaining: int):
        """Pool acquire bounded by ``arena_stall_timeout_s``: a wedged
        in-flight dispatch raises a typed shed
        (``utils/qos.ShedError``, reason "stall", counted in
        ``swtpu_qos_shed_total`` with QoS on) instead of hanging the
        ingest thread under the engine lock. Chunks of the batch staged
        before the stall are already WAL-durable and dispatch normally."""
        from sitewhere_tpu_torch.ingest.arena import ArenaStallError

        try:
            return self._arena_pool.acquire(
                timeout_s=self.config.arena_stall_timeout_s)
        except ArenaStallError as e:
            self._stall_sheds += 1
            if self.qos is not None:
                self.qos.note_shed(tenant, n_remaining, "stall")
            from sitewhere_tpu_torch.utils.qos import ShedError

            raise ShedError(
                f"ingest shed: {e}", tenant=tenant,
                retry_after_s=max(1.0, self.config.arena_stall_timeout_s
                                  or 1.0),
                reason="stall") from e

    def _ingest_batch_arena(self, payloads, tenant, tag, reg_decoder,
                            binary: bool) -> dict:
        """Zero-copy batch ingest: the native scanner decodes straight into
        the fill arena at its cursor, the commit runs a few vectorized
        in-place transforms, and full arenas dispatch without a staging
        copy. Each chunk is WAL-appended before any of its rows can
        dispatch. Decode runs under the lock (the arena is shared state)."""
        summary = {"decoded": 0, "failed": 0, "staged": 0}
        n = len(payloads)
        rec = self.flight.current()
        rec.add("path", "arena")
        with self.lock:
            now = self.epoch.now_ms()
            base_ms = int(self.epoch.base_unix_s * 1000)
            pos = 0
            while pos < n:
                arena = self._arena_fill
                if arena is None:
                    arena = self._arena_fill = self._acquire_arena(tenant,
                                                                   n - pos)
                take = min(n - pos, arena.room)
                chunk = payloads if take == n else payloads[pos:pos + take]
                lo = arena.cursor
                dec = self._sharder or self._native_decoder
                if dec is self._sharder:
                    # the shards' decode spans join this batch's trace (the
                    # engine lock serializes arena decode)
                    dec.current_trace = rec.trace_id
                _, collisions = dec.decode_into(chunk, arena, lo, binary=binary)
                rec.mark("decode")
                rec.mark("arena_fill")
                if self._sharder is not None:
                    rec.add("ingest_workers", self._sharder.last_workers)
                self._wal_append(tag, chunk, tenant)
                self._arena_commit(arena, lo, take, chunk, tenant,
                                   reg_decoder, now, base_ms, summary)
                rec.mark("commit")
                if rec.trace_id is not None:
                    arena.traces.append(rec)
                self.channel_map.collisions += collisions
                arena.cursor = lo + take
                if arena.room == 0:
                    self._dispatch_arena()
                pos += take
        return summary

    def _ingest_decoded_arena(self, res, payloads, tenant,
                              reg_decoder) -> dict:
        """Stage an already decoded SoA batch (the strict path's) through
        the arena: one vectorized copy of the decode columns into the fill
        arena, then the shared commit. The caller has WAL-logged the raw
        batch."""
        summary = {"decoded": 0, "failed": 0, "staged": 0}
        n = len(res.rtype)
        rec = self.flight.current()
        rec.add("path", "arena")
        with self.lock:
            now = self.epoch.now_ms()
            base_ms = int(self.epoch.base_unix_s * 1000)
            pos = 0
            while pos < n:
                arena = self._arena_fill
                if arena is None:
                    arena = self._arena_fill = self._acquire_arena(tenant,
                                                                   n - pos)
                take = min(n - pos, arena.room)
                lo, hi = arena.cursor, arena.cursor + take
                sl = slice(pos, pos + take)
                arena.rtype[lo:hi] = res.rtype[sl]
                arena.token_id[lo:hi] = res.token_id[sl]
                arena.ts64[lo:hi] = res.ts_ms64[sl]
                arena.values[lo:hi] = res.values[sl]
                arena.vmask[lo:hi] = res.chmask[sl]
                arena.aux[lo:hi, 0] = res.aux0[sl]
                arena.aux[lo:hi, 1] = res.aux1[sl]
                arena.level[lo:hi] = res.level[sl]
                rec.mark("arena_fill")
                self._arena_commit(arena, lo, take, payloads[pos:pos + take],
                                   tenant, reg_decoder, now, base_ms, summary)
                rec.mark("commit")
                if rec.trace_id is not None:
                    arena.traces.append(rec)
                arena.cursor = hi
                if arena.room == 0:
                    self._dispatch_arena()
                pos += take
            self.channel_map.collisions += res.collisions
        return summary

    def _arena_commit(self, arena, lo, n, payloads, tenant, reg_decoder,
                      now, base_ms, summary) -> None:
        """Make arena rows [lo, lo+n) live: map request types to event
        types, relativize timestamps, fold alert levels, fill the
        batch-constant columns — vectorized, in place. Envelopes re-route
        through the per-request path. Caller holds the lock."""
        hi = lo + n
        rt = arena.rtype[lo:hi]
        etype = arena.etype[lo:hi]
        np.take(RTYPE_TO_ETYPE, np.clip(rt, -1, 7), out=etype)
        ok = (rt >= 0) & (etype >= 0)
        # a re-routed envelope may stage per-request rows into the copy
        # buffer, whose fill-triggered flush must not dispatch this arena
        # mid-commit (its valid mask is not set yet)
        self._arena_committing = True
        try:
            regs, n_reg_ok, reg_failed = self._reroute_envelopes(
                rt, payloads, tenant, reg_decoder)
        finally:
            self._arena_committing = False
        ok &= ~regs
        ts64 = arena.ts64[lo:hi]
        # relative int32 timestamps (absent -> now); the clip bounds the
        # int64 -> int32 cast of the assignment
        rel = np.clip(ts64 - base_ms, -(2**31) + 1, 2**31 - 1)
        arena.ts_ms[lo:hi] = np.where(ts64 >= 0, rel, now)
        arena.received_ms[lo:hi] = now
        arena.tenant_id[lo:hi] = self.tenants.intern(tenant)
        # aux0 (alert type) and aux1 (alternate id) were written by the
        # decoder; alert rows carry their level in values[:, 0]
        alert_rows = ok & (etype == int(EventType.ALERT))
        if alert_rows.any():
            arena.values[lo:hi][alert_rows, 0] = arena.level[lo:hi][alert_rows]
        arena.valid[lo:hi] = ok
        staged = int(np.sum(ok))
        summary["decoded"] += staged + n_reg_ok
        summary["failed"] += int(np.sum(rt < 0)) + reg_failed
        summary["staged"] += staged
        self.host_counters["arena_rows"] = \
            self.host_counters.get("arena_rows", 0) + staged
        self.ledger.add("staged_rows", staged)

    def _dispatch_arena(self) -> None:
        """Dispatch the fill arena (full or partial: rows past the cursor
        are masked invalid) and retire it to the pool, which recycles it
        once the copy and the step that read it have completed. Caller
        holds the lock."""
        arena = self._arena_fill
        if arena is None or arena.cursor == 0:
            return
        arena.valid[arena.cursor:] = False
        self.ledger.add("dispatched_rows", int(np.sum(arena.valid)))
        traces, arena.traces = arena.traces, []
        # every WAL record of the arena's rows is durable before the copy
        # to the device is enqueued
        self._wal_gate(traces)
        for rec in traces:
            rec.mark("dispatch")
        step = self._arena_step or self._step
        self.state, out = step(self.state, arena.view_batch(self.device))
        # one fence after the copy and the step, on the stream that ran
        # both: the arena's ticket and the dispatch-depth wait; whichever
        # wait observes it first stamps device_ready
        fence = self._fence()
        self._enqueue_out(out, fence, traces)
        self._arena_pool.retire(arena, fence, traces)
        self._archive_account(arena.cursor * MAX_ACTIVE_ASSIGNMENTS)
        self._arena_fill = None
        self._arena_dispatches += 1
        self._last_flush = time.monotonic()
        self._note_dispatch()

    def _note_dispatch(self) -> None:
        """The autotuner's per-dispatch hook (under the engine lock; a
        knob it applies re-enters the same lock)."""
        if self._autotuner is not None:
            self._autotuner.note_dispatch()

    def _ingest_decoded(self, res, payloads, tenant, reg_decoder) -> dict:
        """Stage a natively decoded SoA batch: through the arena when the
        engine has one, else copied into the staging buffer (the copy
        path); envelopes re-decode on the per-request path."""
        if self._arena_pool is not None and not self.config.fair_tenancy:
            return self._ingest_decoded_arena(res, payloads, tenant,
                                              reg_decoder)
        with self.lock:
            now = self.epoch.now_ms()
            base_ms = int(self.epoch.base_unix_s * 1000)
            etype, ok, ts_rel, values, failed, n_reg_ok = \
                self._decode_prologue(res, payloads, tenant, reg_decoder,
                                      now, base_ms)
            idxs = np.nonzero(ok)[0]
            tenant_id = self.tenants.intern(tenant)
            if self.config.fair_tenancy:
                # the whole call shares one tenant: its decode batch
                # enqueues as one chunk (array slices, no per-row Python);
                # ``values`` goes in whole, alert rows carry their level
                # there with the mask unset
                if len(idxs):
                    self._fair_enqueue(tenant_id, _FairChunk(
                        etype=etype[idxs], token=res.token_id[idxs],
                        ts=ts_rel[idxs],
                        recv=np.full(len(idxs), now, np.int32),
                        values=values[idxs], vmask=res.chmask[idxs],
                        aux0=res.aux0[idxs], aux1=res.aux1[idxs]))
                self.channel_map.collisions += res.collisions
                self.ledger.add("staged_rows", len(idxs))
                return {"decoded": int(np.sum(ok)) + n_reg_ok,
                        "failed": failed, "staged": int(len(idxs))}
            staged = 0
            pos = 0
            # an all-rows-decoded batch (the steady state) stages with
            # plain slices instead of a gather per column
            contiguous = len(idxs) == len(ok)
            while pos < len(idxs):
                room = self.config.batch_capacity - len(self._buf)
                if room == 0:
                    self.flush_async()
                    room = self.config.batch_capacity
                chunk = (slice(pos, min(pos + room, len(idxs)))
                         if contiguous else idxs[pos: pos + room])
                n_chunk = (chunk.stop - chunk.start if contiguous
                           else len(chunk))
                b = self._buf
                lo = b._n
                hi = lo + n_chunk
                b.etype[lo:hi] = etype[chunk]
                b.token_id[lo:hi] = res.token_id[chunk]
                b.tenant_id[lo:hi] = tenant_id
                b.ts_ms[lo:hi] = ts_rel[chunk]
                b.received_ms[lo:hi] = now
                b.values[lo:hi] = values[chunk]
                b.vmask[lo:hi] = res.chmask[chunk]
                b.aux[lo:hi, 0] = res.aux0[chunk]
                b.aux[lo:hi, 1] = res.aux1[chunk]
                b._n = hi
                staged += n_chunk
                pos += room
            if self._buf.full:
                self.flush_async()
            self.channel_map.collisions += res.collisions
            self.host_counters["staged_copy_rows"] = \
                self.host_counters.get("staged_copy_rows", 0) + staged
            self.ledger.add("staged_rows", staged)
            return {"decoded": int(np.sum(ok)) + n_reg_ok, "failed": failed,
                    "staged": staged}

    def ingest_event_batch(self, batch: EventBatch) -> None:
        """Dispatch one batch already built in bulk (columns on this
        engine's device, token/tenant ids from this engine's interners) as
        one pipeline step; its output queues for :meth:`drain` like a
        staged batch's. Its rows bypass the WAL; the conservation ledger
        counts them staged and dispatched at once, as a device-side sum
        read only by the audit (no host sync here)."""
        if batch.capacity != self.config.batch_capacity:
            raise ValueError(f"batch capacity {batch.capacity} != engine "
                             f"batch_capacity {self.config.batch_capacity}")
        with self.lock:
            # staged rows keep their order
            while (len(self._buf) or self._fair_queued
                   or (self._arena_fill is not None
                       and self._arena_fill.cursor)):
                self.flush_async()
            self._dispatch_staged(all_batches=True)
            self.ledger.add_device("bulk_rows", batch.valid)
            self.state, out = self._step(self.state, batch)
            self._enqueue_out(out, self._fence())
            self._archive_account(batch.capacity * MAX_ACTIVE_ASSIGNMENTS)
            self._note_dispatch()

    # ---------------------------------------------------------------- dispatch
    def maybe_flush(self) -> dict | None:
        """Flush if the latency budget expired (call from a timer loop);
        drains the pending outputs on the same interval."""
        with self.lock:
            expired = (time.monotonic() - self._last_flush
                       >= self.config.flush_interval_s)
            if (len(self._buf) or self._fair_queued or self._staged_batches
                    or (self._arena_fill is not None
                        and self._arena_fill.cursor)) and expired:
                return self.flush()
            if self._pending_outs and expired:
                return _merge_summaries(self.drain())
            return None

    def flush(self) -> dict:
        """Run the staged work through the pipeline and sync host mirrors;
        returns the aggregate summary of everything drained. On an error
        the flight recorder logs the recent batch lifecycles before the
        error propagates."""
        try:
            with self.lock, stage("pipeline_step"):
                self.flush_async()
                while self._fair_queued:   # fair mode: a batch a dispatch
                    self.flush_async()
                self._dispatch_staged(all_batches=True)
                return _merge_summaries(self.drain())
        except Exception:
            self.flight.dump_error(logging.getLogger(__name__))
            raise

    def flush_async(self) -> None:
        """Dispatch the staged work without reading anything back: the
        step outputs queue for :meth:`drain`. A partly filled arena
        dispatches too (never mid-commit). With ``scan_chunk`` K > 1,
        emitted copy-path batches accumulate and dispatch K at a time."""
        with self.lock:
            # the staged-backlog high-watermark, sampled where it peaks
            staged = self.staged_count
            if staged > self._backlog_hwm:
                self._backlog_hwm = staged
            # fair queues form a batch whenever rows are queued (even with
            # the flag toggled off since: queued rows never strand)
            if self._fair_queued:
                self._form_fair_batch()
            if (self._arena_fill is not None and self._arena_fill.cursor
                    and not self._arena_committing):
                self._dispatch_arena()
            if not len(self._buf):
                return
            n_staged = len(self._buf)
            if self.config.scan_chunk > 1:
                self._staged_batches.append(self._buf.emit_host())
                self._dispatch_staged(all_batches=False)
            else:
                traces, self._staged_traces = self._staged_traces, []
                self._wal_gate(traces)   # before the copy of the batch
                for rec in traces:
                    rec.mark("dispatch")
                self.ledger.add("dispatched_rows", n_staged)
                batch = self._buf.emit(self.device)
                self.state, out = self._step(self.state, batch)
                self._enqueue_out(out, self._fence(), traces)
                # each staged row persists up to one event per active
                # assignment: count the upper bound, so rows always spill
                # before the ring wraps over them
                self._archive_account(n_staged * MAX_ACTIVE_ASSIGNMENTS)
                self._note_dispatch()
            self._last_flush = time.monotonic()

    def _dispatch_staged(self, all_batches: bool) -> None:
        """Dispatch accumulated copy-path batches as K-chunks: one packed
        transfer and K steps per chunk. With ``all_batches`` a partial
        tail chunk is padded with empty batches (valid=False rows, zero
        counts) to K."""
        k = self.config.scan_chunk
        while self._staged_batches:
            if len(self._staged_batches) < k and not all_batches:
                return
            chunk, self._staged_batches = (self._staged_batches[:k],
                                           self._staged_batches[k:])
            while len(chunk) < k:
                chunk.append(_empty_host_batch(self.config.batch_capacity,
                                               self.config.channels))
            # the records of every batch in the chunk: the chunk is the
            # dispatch unit
            traces, self._staged_traces = self._staged_traces, []
            self._wal_gate(traces)
            for rec in traces:
                rec.mark("dispatch")
            self.ledger.add("dispatched_rows",
                            sum(int(np.sum(b.valid)) for b in chunk))
            packed = torch.from_numpy(pack_batches(chunk)).to(self.device)
            self.state, outs = self._scan_step(self.state, packed)
            self._enqueue_out(outs, self._fence(), traces)
            # counted where the ring head advances, not at staging
            self._archive_account(
                k * self.config.batch_capacity * MAX_ACTIVE_ASSIGNMENTS)
            self._note_dispatch()

    def _enqueue_out(self, out: StepOutput, fence, traces=()) -> None:
        """Queue a step output for drain, bounding outstanding dispatches
        to ``dispatch_depth``: once that many are queued, wait on the
        fence of the dispatch ``dispatch_depth`` back (at depth 1, the one
        just dispatched). The wait observed that dispatch complete, so it
        stamps ``device_ready`` on its records (on the CPU the step has
        run already)."""
        self._pending_outs.append(out)
        self._pending_fences.append(fence)
        self._pending_traces.append(list(traces))
        d = max(1, self.config.dispatch_depth)
        if len(self._pending_fences) >= d:
            if self._pending_fences[-d] is not None:
                self._pending_fences[-d].synchronize()
            for rec in self._pending_traces[-d]:
                rec.mark("device_ready")

    def barrier(self) -> None:
        """Dispatch all staged work and wait for it to complete, with no
        device-to-host readback (drain, which reads, is left to reporting
        boundaries)."""
        with self.lock:
            while (len(self._buf) or self._fair_queued
                   or (self._arena_fill is not None
                       and self._arena_fill.cursor)):
                self.flush_async()
            self._dispatch_staged(all_batches=True)
            if self._pending_fences and self._pending_fences[-1] is not None:
                self._pending_fences[-1].synchronize()

    def _archive_account(self, max_new_rows: int) -> None:
        """Track the upper bound of ring rows a dispatch wrote; spool when
        any arena could be approaching overwrite. Caller holds the lock.
        No-op without an archive."""
        if self.archive is None:
            return
        self._rows_since_spool += max_new_rows
        if self._rows_since_spool >= self._spool_trigger:
            self._spool()

    def ring_heads(self) -> dict[int, int]:
        """Absolute ring write head per archive partition (= arena), read
        in one device-to-host copy: the one definition the spooler and the
        conservation ledger share. Caller holds the lock."""
        store = self.state.store
        ep, cu = torch.stack([store.epoch, store.cursor]).cpu().tolist()
        acap = store.arena_capacity
        return {a: ep[a] * acap + cu[a] for a in range(store.arenas)}

    def ring_arena_capacity(self) -> int:
        """Rows one archive partition's ring holds before wrapping."""
        return int(self.state.store.arena_capacity)

    def _spool(self) -> None:
        """Spill whole segments of not-yet-archived ring rows to disk.
        Caller holds the lock. Each segment is one ``read_range`` of
        ``segment_rows`` rows and one device-to-host copy; a partial tail
        stays in the ring (queryable there), so the archive holds whole
        segments only. The reads wait for the dispatched steps (stream
        order), so they are host syncs: ``spool_stats`` counts them."""
        t0 = time.perf_counter()
        store = self.state.store
        acap = self.ring_arena_capacity()
        rows = self.archive.segment_rows
        st = self.spool_stats
        heads = self.ring_heads()
        st["syncs"] += 1
        for a, head in heads.items():
            start = self.archive.spilled(a)
            if head - start > acap:   # wrapped before we got here
                self.archive.note_lost(head - acap - start)
                start = head - acap
            while head - start >= rows:
                sl = slice_to_host(read_range(store, start % acap, rows, arena=a))
                self.archive.append_segment(a, start, sl)
                start += rows
                st["segments"] += 1
                st["syncs"] += 1
        self._rows_since_spool = 0
        st["spools"] += 1
        st["seconds"] += time.perf_counter() - t0

    def drain(self) -> list[dict]:
        """Absorb every queued step output into the host mirrors. Only the
        scalar counters are fetched for the whole backlog (one transfer);
        token lists are sliced to their occupied prefix. A scan chunk's
        stacked output absorbs lane by lane."""
        with self.lock:
            if not self._pending_outs:
                return [_empty_summary()]
            outs, self._pending_outs = self._pending_outs, []
            self._pending_fences = []
            trace_lists, self._pending_traces = self._pending_traces, []
            lanes = []
            for out in outs:
                if out.n_found.dim() == 0:
                    lanes.append(out)
                else:
                    lanes.extend(StepOutput(*(x[i] for x in out))
                                 for i in range(out.n_found.shape[0]))
            scalars = torch.stack([
                torch.stack([o.n_found, o.n_missed, o.n_registered,
                             o.n_persisted]) for o in lanes]).cpu().tolist()
            # the copy above observed every drained dispatch: stamp
            # readback, and device_ready where no wait observed the
            # record's last dispatch first (a batch of several chunks may
            # hold an earlier chunk's mark)
            for recs in trace_lists:
                for rec in recs:
                    st = rec.stages
                    if st.get("device_ready", -1) < st.get("dispatch", 0):
                        rec.mark("device_ready")
                    rec.mark("readback")
            return [self._absorb_output(out, *s) for out, s in zip(lanes, scalars)]

    def _absorb_output(self, out: StepOutput, n_found: int, n_missed: int,
                       n_registered: int, n_persisted: int) -> dict:
        new_tokens = []
        if n_registered:
            new_tokens = out.new_tokens[:n_registered].cpu().tolist()
        # mirror device-side auto-registration: allocation order == list order
        new_dids = []
        new_aids = []
        for tid in new_tokens:
            did = self._next_device
            aid = self._next_assignment
            self._next_device += 1
            self._next_assignment += 1
            self.token_device[tid] = did
            new_dids.append(did)
            new_aids.append(aid)
        if new_dids:
            idx = torch.tensor(new_dids, device=self.device)
            tenants = self.state.registry.device_tenant[idx].cpu().tolist()
            for tid, did, aid, ten in zip(new_tokens, new_dids, new_aids, tenants):
                tenant = self.tenants.token(ten) if ten != NULL_ID else "default"
                self.devices[did] = DeviceInfo(
                    token=self.tokens.token(tid),
                    device_type=self.config.default_device_type,
                    tenant=tenant,
                    auto_registered=True,
                )
                self._record_assignment(aid, did, slot=0)
        dead = []
        if n_missed:
            dead = out.dead_tokens[:n_missed].cpu().tolist()
        self.dead_letters.extend(dead)
        summary = {
            "found": n_found,
            "missed": n_missed,
            "registered": n_registered,
            "persisted": n_persisted,
            "new_tokens": new_tokens,
            "dead_tokens": dead,
        }
        self.outputs.append(summary)
        del self.outputs[:-256]
        return summary

    # ------------------------------------------------------------------ admin
    def register_device(
        self,
        token: str,
        device_type: str | None = None,
        tenant: str = "default",
        area: str | None = None,
        customer: str | None = None,
        metadata: dict | None = None,
    ) -> int:
        """API-path device creation (get-or-create) with explicit metadata."""
        with self.lock:
            # staged events may still reference tokens about to be registered
            self._sync_mirrors()
            token_id = self.tokens.intern(token)
            existing = self.token_device.get(token_id)
            if existing is not None:
                return existing
            did = self._next_device
            aid = self._next_assignment
            if did >= self.config.device_capacity:
                raise RuntimeError("device capacity exhausted")
            type_name = device_type or self.config.default_device_type
            # the registration rides the WAL as its wire-form envelope
            self._wal_admin_register(token, type_name, tenant, area, customer)
            self._next_device += 1
            self._next_assignment += 1
            self.state = _admin_create_device(
                self.state, token_id, did, aid,
                self.device_types.intern(type_name),
                self.tenants.intern(tenant),
                self.areas.intern(area) if area else NULL_ID,
                self.customers.intern(customer) if customer else NULL_ID,
            )
            self.token_device[token_id] = did
            self.devices[did] = DeviceInfo(
                token=token, device_type=type_name, tenant=tenant,
                area=area, customer=customer, metadata=metadata or {},
            )
            self._record_assignment(aid, did, slot=0, area=area, customer=customer)
            return did

    def delete_device(self, token: str) -> bool:
        """Deactivate a device's row (its events stop matching); the host
        metadata stays. False when the token has no device."""
        with self.lock:
            did = self.token_device.get(self.tokens.lookup(token))
            if did is None:
                return False
            self.state = _admin_set_device_active(self.state, did, False)
            return True

    def map_device(self, child_token: str, parent_token: str) -> DeviceInfo:
        """Map a device under a gateway/composite parent (the MapDevice
        request): the parent lands in the device row's ``device_parent``
        and in the child's metadata."""
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
            self.state = _admin_set_parent(self.state, cdid, pdid)
            return info

    def update_device(self, token: str, device_type: str | None = None,
                      area: str | None = None, customer: str | None = None,
                      metadata: dict | None = None) -> DeviceInfo:
        """Update a device's columns and host metadata. A ``parentToken``
        key in ``metadata`` remaps (a token) or unmaps (None) the device's
        parent in the device row too; an absent key keeps the mapping."""
        with self.lock:
            self._sync_mirrors()
            did = self.token_device.get(self.tokens.lookup(token))
            if did is None:
                raise KeyError(f"device {token!r} not registered")
            info = self.devices[did]
            # validate (and intern) everything before mutating either
            # view, so a failed update never half-applies
            type_id = self.device_types.intern(
                device_type if device_type is not None else info.device_type)
            new_area = area if area is not None else info.area
            area_id = self.areas.intern(new_area) if new_area else NULL_ID
            new_customer = customer if customer is not None else info.customer
            customer_id = (self.customers.intern(new_customer)
                           if new_customer else NULL_ID)
            parent_update = None   # (new metadata, parent id, NULL_ID or None)
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
                        pdid = self.token_device.get(
                            self.tokens.lookup(new_parent))
                        if pdid is None:
                            raise KeyError(
                                f"parent device {new_parent!r} not registered")
                        if pdid == did:
                            raise ValueError("device cannot be its own parent")
                        parent_update = (metadata, pdid)
                else:
                    if new_parent is None:
                        metadata.pop("parentToken", None)
                    parent_update = (metadata, None)   # no column change
            if device_type is not None:
                info.device_type = device_type
            if area is not None:
                info.area = area
            if customer is not None:
                info.customer = customer
            if parent_update is not None:
                info.metadata, pdid = parent_update
                if pdid is not None:
                    self.state = _admin_set_parent(self.state, did, pdid)
            self.state = _admin_update_device(self.state, did, type_id,
                                              area_id, customer_id)
            return info

    def _record_assignment(self, aid: int, did: int, slot: int,
                           token: str | None = None, asset: str | None = None,
                           area: str | None = None, customer: str | None = None,
                           metadata: dict | None = None) -> AssignmentInfo:
        """Record host metadata for an assignment already written on the
        device. Caller holds the engine lock."""
        dev = self.devices[did]
        tok = token or f"{dev.token}:a{aid}"
        info = AssignmentInfo(
            token=tok, id=aid, device_token=dev.token, tenant=dev.tenant,
            asset=asset, area=area or dev.area, customer=customer or dev.customer,
            metadata=metadata or {}, created_ms=self.epoch.now_ms(),
        )
        self.assignments[aid] = info
        self.assignment_tokens[tok] = aid
        slots = self.device_slots.setdefault(did, [NULL_ID] * MAX_ACTIVE_ASSIGNMENTS)
        slots[slot] = aid
        return info

    def create_assignment(self, device_token: str, token: str | None = None,
                          asset: str | None = None, area: str | None = None,
                          customer: str | None = None,
                          metadata: dict | None = None) -> AssignmentInfo:
        """Attach one more ACTIVE assignment to a registered device, in
        its first free slot."""
        with self.lock:
            self._sync_mirrors()
            did = self.token_device.get(self.tokens.lookup(device_token))
            if did is None:
                raise KeyError(f"device {device_token!r} not registered")
            if token is not None and token in self.assignment_tokens:
                raise ValueError(f"assignment token {token!r} already exists")
            slots = self.device_slots.setdefault(
                did, [NULL_ID] * MAX_ACTIVE_ASSIGNMENTS)
            try:
                slot = slots.index(NULL_ID)
            except ValueError:
                raise ValueError(
                    f"device {device_token!r} already has "
                    f"{MAX_ACTIVE_ASSIGNMENTS} active assignments") from None
            aid = self._next_assignment
            if aid >= self.config.assignment_capacity:
                raise RuntimeError("assignment capacity exhausted")
            self._next_assignment += 1
            self.state = _admin_add_assignment(
                self.state, did, aid, slot,
                self.assets.intern(asset) if asset else NULL_ID,
                self.areas.intern(area) if area else NULL_ID,
                self.customers.intern(customer) if customer else NULL_ID)
            info = self._record_assignment(
                aid, did, slot, token=token, asset=asset, area=area,
                customer=customer, metadata=metadata)
            self._assignment_trigger(device_token, "assignment.created",
                                     info.tenant)
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

    def update_assignment(self, token: str, asset: str | None = None,
                          area: str | None = None,
                          customer: str | None = None,
                          metadata: dict | None = None) -> AssignmentInfo:
        """Update an assignment's asset, area and customer columns and its
        host metadata."""
        with self.lock:
            self._sync_mirrors()
            aid = self.assignment_tokens.get(token)
            if aid is None:
                raise KeyError(f"assignment {token!r} not found")
            info = self.assignments[aid]
            new_asset = asset if asset is not None else info.asset
            new_area = area if area is not None else info.area
            new_customer = customer if customer is not None else info.customer
            # intern before mutating, so a capacity error never half-applies
            asset_id = self.assets.intern(new_asset) if new_asset else NULL_ID
            area_id = self.areas.intern(new_area) if new_area else NULL_ID
            customer_id = (self.customers.intern(new_customer)
                           if new_customer else NULL_ID)
            self.state = _admin_update_assignment(self.state, aid, asset_id,
                                                  area_id, customer_id)
            info.asset, info.area, info.customer = new_asset, new_area, new_customer
            if metadata is not None:
                info.metadata = metadata
            return info

    def delete_assignment(self, token: str) -> bool:
        """Release an assignment on the device and drop its host record.
        Persisted events that carry its id stay in the ring and the
        archive: a delete does not rewrite history."""
        with self.lock:
            self._sync_mirrors()
            aid = self.assignment_tokens.get(token)
            if aid is None:
                return False
            if self.assignments[aid].status != "RELEASED":
                self._set_assignment_status(token, DeviceAssignmentStatus.RELEASED)
            del self.assignments[aid]
            del self.assignment_tokens[token]
            return True

    def _set_assignment_status(self, token: str,
                               status: DeviceAssignmentStatus) -> AssignmentInfo:
        with self.lock:
            self._sync_mirrors()
            aid = self.assignment_tokens.get(token)
            if aid is None:
                raise KeyError(f"assignment {token!r} not found")
            active = status is not DeviceAssignmentStatus.RELEASED
            self.state = _admin_set_assignment_status(self.state, aid,
                                                      int(status), active)
            info = self.assignments[aid]
            info.status = status.name
            if not active:
                info.released_ms = self.epoch.now_ms()
                did = self.token_device.get(self.tokens.lookup(info.device_token))
                if did is not None and did in self.device_slots:
                    self.device_slots[did] = [
                        NULL_ID if sl == aid else sl
                        for sl in self.device_slots[did]]
            self._assignment_trigger(
                info.device_token, f"assignment.{status.name.lower()}",
                info.tenant)
            return info

    def _assignment_trigger(self, device_token: str, change: str,
                            tenant: str) -> None:
        """Stage a STATE_CHANGE event (attribute ``assignment``) on an
        assignment's creation or status change, when
        ``assignment_triggers`` asks for it. Caller holds the lock."""
        if not self.config.assignment_triggers:
            return
        self.process(DecodedRequest(
            type=RequestType.DEVICE_STATE_CHANGE, device_token=device_token,
            tenant=tenant, attribute="assignment", state_type=change))

    def release_assignment(self, token: str) -> AssignmentInfo:
        """End an assignment: RELEASED, detached from its device's slot."""
        return self._set_assignment_status(token, DeviceAssignmentStatus.RELEASED)

    def mark_assignment_missing(self, token: str) -> AssignmentInfo:
        """Flag an assignment MISSING; it stays active, so events still
        expand to it."""
        return self._set_assignment_status(token, DeviceAssignmentStatus.MISSING)

    def get_device(self, token: str) -> DeviceInfo | None:
        with self.lock:
            self._sync_mirrors()
            did = self.token_device.get(self.tokens.lookup(token))
            return self.devices.get(did) if did is not None else None

    def get_device_state(self, token: str) -> dict | None:
        """Read back one device's aggregated state (device-state API)."""
        with self.lock:
            self._sync_mirrors()
            tid = self.tokens.lookup(token)
            did = self.token_device.get(tid)
            if did is None:
                return None
            # one device row of every field the answer needs, to the host
            ds = {f.name: getattr(self.state.device_state, f.name)[did].cpu().numpy()
                  for f in dataclasses.fields(self.state.device_state)}
            chans = {}
            for name, nid in self.channel_map.names.items():
                ch = nid % self.config.channels
                ts = int(ds["meas_last_ms"][ch])
                if ts > -(2**31) + 10:
                    chans[name] = {"value": float(ds["meas_last"][ch]),
                                   "ts_ms": ts}
            recent_locs = [
                {
                    "latitude": float(ds["recent_loc"][r, 0]),
                    "longitude": float(ds["recent_loc"][r, 1]),
                    "elevation": float(ds["recent_loc"][r, 2]),
                    "ts_ms": int(ds["recent_loc_ms"][r]),
                }
                for r in range(RECENT_DEPTH)
                if bool(ds["recent_loc_valid"][r])
            ]
            recent_alerts = [
                {
                    "level": int(ds["recent_alert_level"][r]),
                    "type": self.alert_types.token(int(ds["recent_alert_type"][r])),
                    "ts_ms": int(ds["recent_alert_ms"][r]),
                }
                for r in range(RECENT_DEPTH)
                if bool(ds["recent_alert_valid"][r])
            ]
            return {
                "device": self.devices[did].token,
                "presence": PresenceState(int(ds["presence"])).name,
                "last_interaction_ms": int(ds["last_interaction_ms"]),
                "measurements": chans,
                "recent_locations": recent_locs,
                "recent_alerts": recent_alerts,
                "event_counts": {
                    EventType(e).name: int(ds["event_counts"][e]) for e in range(6)
                },
            }

    def search_device_states(
        self,
        last_interaction_before_ms: int | None = None,
        presence: str | None = None,
        device_tokens: list[str] | None = None,
        area: str | None = None,
        device_type: str | None = None,
        limit: int = 100,
    ) -> list[dict]:
        """Filtered device-state search (lastInteractionDateBefore /
        presence / tokens / area / device type); the filters run over the
        device-resident state columns, read back once."""
        with self.lock:
            self._sync_mirrors()
            n = self._next_device
            if n == 0:
                return []
            ds = self.state.device_state
            last = ds.last_interaction_ms[:n].cpu().numpy()
            pres = ds.presence[:n].cpu().numpy()
            mask = np.ones(n, np.bool_)
            if last_interaction_before_ms is not None:
                mask &= last < last_interaction_before_ms
            if presence is not None:
                mask &= pres == int(PresenceState[presence.upper()])
            if device_tokens is not None:
                wanted = {self.token_device.get(self.tokens.lookup(t))
                          for t in device_tokens}
                sel = np.zeros(n, np.bool_)
                for d in wanted:
                    if d is not None and d < n:
                        sel[d] = True
                mask &= sel
            reg = self.state.registry
            if area is not None:
                aid = self.areas.lookup(area)
                if aid == NULL_ID:   # unknown area matches nothing
                    mask[:] = False
                else:
                    mask &= reg.device_area[:n].cpu().numpy() == aid
            if device_type is not None:
                ty = self.device_types.lookup(device_type)
                if ty == NULL_ID:
                    mask[:] = False
                else:
                    mask &= reg.device_type[:n].cpu().numpy() == ty
            out = []
            for d in np.nonzero(mask)[0][:limit]:
                info = self.devices.get(int(d))
                if info is None:
                    continue
                out.append({
                    "device": info.token,
                    "deviceType": info.device_type,
                    "tenant": info.tenant,
                    "presence": PresenceState(int(pres[d])).name,
                    "lastInteractionMs": int(last[d]),
                })
            return out

    # ------------------------------------------------------------------ reads
    def query_events(
        self,
        device_token: str | None = None,
        etype: EventType | None = None,
        tenant: str | None = None,
        since_ms: int | None = None,
        until_ms: int | None = None,
        limit: int = 100,
        assignment_id: int | None = None,
        aux0: int | None = None,
        area: str | None = None,
        customer: str | None = None,
        alternate_id: str | None = None,
    ) -> dict:
        """Filtered, newest-first event query over the device ring store,
        and over the archive when the engine has one (the ring's evicted
        rows, merged newest-first). Every ring filter applies on the
        device, so the limit applies after filtering. Only the mirror sync
        and the string -> id resolution run under the engine lock; the
        scan (coalesced with concurrent queries into one
        ``query_store_batch``, their archive requests into one planner
        pass) and the row formatting run outside it. ``limit`` buckets to
        the next power of two; the result slices back to the exact
        page."""
        t_q0 = time.perf_counter()
        limit = max(1, int(limit))
        rec = self.flight.begin("query", tenant=tenant or "all")
        miss = False   # an unknown string filter matches nothing — an
                       # unknown tenant must never widen to all tenants
        with self.lock:
            self._sync_mirrors()
            dev = NULL_ID
            if device_token is not None:
                tid = self.tokens.lookup(device_token)
                dev = self.token_device.get(tid, NULL_ID)
                miss |= dev == NULL_ID
            ten = NULL_ID
            if not miss and tenant is not None:
                ten = self.tenants.lookup(tenant)
                miss |= ten == NULL_ID
            area_id = customer_id = aux1 = NULL_ID
            if not miss and area is not None:
                area_id = self.areas.lookup(area)
                miss |= area_id == NULL_ID
            if not miss and customer is not None:
                customer_id = self.customers.lookup(customer)
                miss |= customer_id == NULL_ID
            if not miss and alternate_id is not None:
                aux1 = self.event_ids.lookup(alternate_id)
                miss |= aux1 == NULL_ID
            lane_names = None if miss else self._lane_names()
        rec.mark("lookup")
        if miss:
            # still a served query: counted, so miss-heavy polling shows
            self._query_batcher.observe_latency(time.perf_counter() - t_q0)
            return {"total": 0, "events": []}
        imin, imax = -(2**31), 2**31 - 1
        params = (  # QueryParams field order
            dev,
            int(etype) if etype is not None else NULL_ID,
            ten,
            int(since_ms) if since_ms is not None else imin,
            int(until_ms) if until_ms is not None else imax,
            int(assignment_id) if assignment_id is not None else NULL_ID,
            int(aux0) if aux0 is not None else NULL_ID,
            aux1, area_id, customer_id,
        )
        archive_req = None
        if self.archive is not None:
            # the archive's pushdown request: the same resolved ids as the
            # device predicates, and the caller's exact page size
            archive_req = {"limit": limit, "filters": dict(
                device=dev if device_token is not None else None,
                etype=int(etype) if etype is not None else None,
                tenant=ten if tenant is not None else None,
                since_ms=since_ms, until_ms=until_ms,
                assignment=assignment_id, aux0=aux0,
                aux1=aux1 if alternate_id is not None else None,
                area=area_id if area is not None else None,
                customer=customer_id if customer is not None else None)}
        row, _, coalesced, archive_res = self._query_batcher.run(
            params, bucket_limit(limit), archive=archive_req,
            tenant=tenant, trace_id=rec.trace_id)
        rec.mark("device")
        rec.add("coalesced", coalesced)
        total = int(row.total)
        events = [
            self._format_event(
                int(row.etype[i]), int(row.device[i]),
                int(row.assignment[i]), int(row.ts_ms[i]),
                int(row.received_ms[i]), row.values[i], row.vmask[i],
                row.aux[i], lane_names)
            for i in range(min(total, limit))
        ]
        rec.mark("format")
        if archive_res is not None:
            total, events = self._merge_archive(total, events, limit,
                                                archive_res)
            rec.mark("archive")
        self._query_batcher.observe_latency(time.perf_counter() - t_q0)
        return {"total": total, "events": events}

    def _merge_archive(self, total: int, events: list[dict], limit: int,
                       archive_res: tuple[int, list[dict]]
                       ) -> tuple[int, list[dict]]:
        """Fold the round's archive page into a ring page: format its rows
        and interleave newest-first (a stable sort: ring rows first on a
        timestamp tie)."""
        a_total, rows = archive_res
        if not a_total:
            return total, events
        lane_names = self._lane_names()
        a_events = [
            self._format_event(
                int(r["etype"]), int(r["device"]), int(r["assignment"]),
                int(r["ts_ms"]), int(r["received_ms"]), r["values"],
                r["vmask"], r["aux"], lane_names)
            for r in rows]
        merged = sorted(events + a_events,
                        key=lambda e: -e["eventDateMs"])[:limit]
        return total + a_total, merged

    def _lane_names(self) -> dict[int, str]:
        lane_names: dict[int, str] = {}
        for name, nid in self.channel_map.names.items():
            lane_names.setdefault(nid % self.config.channels, name)
        return lane_names

    def _format_event(self, et_i: int, device_id: int, assignment: int,
                      ts: int, received: int, values, vmask, aux,
                      lane_names: dict[int, str]) -> dict:
        """One persisted store row -> the REST event dict."""
        et = EventType(et_i)
        info = self.devices.get(device_id)
        ev = {
            "type": et.name,
            "deviceToken": info.token if info else None,
            "assignmentId": assignment,
            "eventDateMs": ts,
            "receivedDateMs": received,
        }
        if et is EventType.MEASUREMENT:
            ev["measurements"] = {
                lane_names.get(int(c), f"ch{c}"): float(values[c])
                for c in np.nonzero(vmask)[0]
            }
        elif et is EventType.LOCATION:
            if vmask[0]:
                ev["latitude"], ev["longitude"], ev["elevation"] = (
                    float(values[0]), float(values[1]), float(values[2]))
            else:  # decoded without coordinates — never null island
                ev["latitude"] = ev["longitude"] = ev["elevation"] = None
        elif et is EventType.ALERT:
            ev["level"] = int(values[0])
            atype = int(aux[0])
            ev["alertType"] = (
                self.alert_types.token(atype)
                if 0 <= atype < len(self.alert_types) else None)
        elif et is EventType.COMMAND_INVOCATION:
            ev["invocationId"] = int(aux[0])
        elif et is EventType.COMMAND_RESPONSE:
            oid = int(aux[0])
            ev["originatingEventId"] = (
                self.event_ids.token(oid)
                if 0 <= oid < len(self.event_ids) else None)
        elif et is EventType.STATE_CHANGE:
            sid = int(aux[0])
            if 0 <= sid < len(self.event_ids):
                attr, _, change = self.event_ids.token(sid).partition(":")
                ev["attribute"], ev["stateChange"] = attr, change
        return ev

    def get_event(self, event_id: int,
                  tenant: str | None = None) -> dict | None:
        """Fetch one persisted event by its id (``position * arenas +
        arena``, the absolute store position with one arena). An id the
        ring has evicted resolves from the archive. Returns None when the
        id was never written or is in neither tier. ``tenant`` scopes the
        lookup: another tenant's row reads as absent."""
        with self.lock:
            self._sync_mirrors()
            ten = None
            if tenant is not None:
                ten = self.tenants.lookup(tenant)
                if ten == NULL_ID:
                    return None
            store = self.state.store
            if event_id < 0:
                return None
            arena = event_id % store.arenas
            pos = event_id // store.arenas
            head = arena_cursor(store, arena)
            if pos >= head:
                return None
            if pos < head - store.arena_capacity:
                # evicted from the ring: the archive answers, so the by-id
                # surface agrees with query_events
                if self.archive is None:
                    return None
                r = self.archive.get_row(arena, pos)
                if r is None or (ten is not None and int(r["tenant"]) != ten):
                    return None
                ev = self._format_event(
                    int(r["etype"]), int(r["device"]), int(r["assignment"]),
                    int(r["ts_ms"]), int(r["received_ms"]), r["values"],
                    r["vmask"], r["aux"], self._lane_names())
                ev["eventId"] = event_id
                return ev
            sl = slice_to_host(read_range(store, pos % store.arena_capacity, 1,
                                          arena=arena))
            if not bool(sl.valid[0]):
                return None
            if ten is not None and int(sl.tenant[0]) != ten:
                return None
            ev = self._format_event(
                int(sl.etype[0]), int(sl.device[0]), int(sl.assignment[0]),
                int(sl.ts_ms[0]), int(sl.received_ms[0]), sl.values[0],
                sl.vmask[0], sl.aux[0], self._lane_names())
            ev["eventId"] = event_id
            return ev

    def make_feed_consumer(self, group_id: str, max_batch: int = 1024,
                           start_from_latest: bool = False):
        """An outbound consumer over this engine's event store
        (outbound/feed.py): one committed offset per arena, archive replay
        of evicted rows, at-least-once."""
        from sitewhere_tpu_torch.outbound.feed import FeedConsumer

        return FeedConsumer(self, group_id, max_batch=max_batch,
                            start_from_latest=start_from_latest)

    def presence_sweep(self) -> list[str]:
        """Mark stale devices MISSING; returns their tokens (each device's
        transition is reported once)."""
        with self.lock:
            self._sync_mirrors()   # async-registered devices must be mirrored
            i32 = dict(dtype=torch.int32, device=self.device)
            now = torch.tensor(self.epoch.now_ms(), **i32)
            missing_ms = torch.tensor(
                int(self.config.presence_missing_s * 1000), **i32)
            self.state, newly = make_presence_sweep()(self.state, now,
                                                      missing_ms)
            idxs = np.nonzero(newly.cpu().numpy())[0]
            return [self.devices[int(i)].token for i in idxs
                    if int(i) in self.devices]

    def tenant_metrics(self) -> dict[str, dict[str, int]]:
        """Per-tenant event counts — one on-device segment-sum of the
        per-device counters over the tenant column."""
        with self.lock:
            self._sync_mirrors()
            n_tenants = len(self.tenants)
            counts = _tenant_event_counts(
                self.state, tenant_cap(n_tenants)).cpu().numpy()
        return tenant_counts_dict(counts, self.tenants, n_tenants)

    def tenant_pipeline_counters(self) -> dict[str, dict[str, int]]:
        """The device-side per-tenant counter grid (accepted /
        dedup_dropped / geofence_hit / invalid), accumulated inside the
        step and read back here only. Tenants bucket by ``id % 64``; quiet
        buckets are omitted."""
        with self.lock:
            grid = self.state.metrics.tenant_counters.cpu().numpy()
            return format_tenant_counter_grid(grid, self.tenants)

    def set_geofence_zones(self, polygons, max_vertices: int = 16) -> None:
        """Install geofence polygons into the pipeline state so the step
        counts zone containment per tenant (the ``geofence_hit`` counter
        lane). Pass an empty list to remove the zones (the lane freezes
        at its cumulative value)."""
        with self.lock:
            if not polygons:
                self.state = dataclasses.replace(self.state, zones=None)
                return
            verts, valid = pack_zones(polygons, max_vertices)
            self.state = dataclasses.replace(self.state, zones=ZoneTable(
                torch.from_numpy(verts).to(self.device),
                torch.from_numpy(valid).to(self.device)))

    # ------------------------------------------------------- streaming rules
    def set_rules(self, rules_state, *, preserve_state: bool = False) -> None:
        """Install, replace or remove (``None``) the streaming-rules
        subtree. ``preserve_state=True`` (same-shaped rule tables, e.g. a
        threshold tweak) swaps only the parameter columns and keeps the
        carried accumulators."""
        with self.lock:
            self.state = dataclasses.replace(self.state, rules=merged_rules_state(
                self.state.rules, rules_state, preserve_state))

    def poll_rule_fires(self):
        """Harvest pending rule fires: advance the harvest cursors and read
        the rings back once. Returns numpy ``(pend_key[R, G, K],
        pend_val[R, G, K], pend_w[R, G], pend_h[R, G])`` — each group's
        ``min(w - h, K)`` newest entries, oldest first at
        ``(w - n .. w - 1) % K`` — or None when no rules are installed."""
        with self.lock:
            rs = self.state.rules
            if rs is None or rs.rules is None:
                return None
            self._sync_mirrors()
            new_rules, *fires = harvest_fires(self.state.rules)
            self.state = dataclasses.replace(self.state, rules=new_rules)
            return tuple(x.cpu().numpy() for x in fires)

    def rule_counters(self) -> dict:
        """Device-side CEP counters (status surface; not part of
        ``metrics()``: ``missed``/``late`` depend on harvest cadence and
        batch partitioning)."""
        with self.lock:
            rs = self.state.rules
            out: dict = {}
            if rs is not None and rs.rules is not None:
                rb = rs.rules
                f, m, l, o = torch.stack(
                    [rb.fires, rb.missed, rb.late, rb.oob]).cpu().tolist()
                out.update(ruleFires=f, ruleMissedFires=m, ruleLateEvents=l,
                           ruleOobGroups=o, rulesActive=rb.n_rules)
            if rs is not None and rs.rollups is not None:
                out.update(rollupLateEvents=int(rs.rollups.late),
                           rollupsActive=rs.rollups.n_rollups)
            return out

    def _rollup_tables(self, p: int):
        """One rollup's materialized tables as host arrays
        ``(wid, cnt, vsum, vmin, vmax)``, each ``[G, NB]``."""
        ro = self.state.rules.rollups
        return tuple(a[p].cpu().numpy()
                     for a in (ro.wid, ro.cnt, ro.vsum, ro.vmin, ro.vmax))

    def _metric_counters(self) -> tuple[list[int], tuple[int, int] | None]:
        """The device counters ``metrics()`` reports, read in one copy:
        (processed, found, missed, registered, persisted, reg_overflow),
        and (rule fires, rules active) when rules are installed."""
        m = self.state.metrics
        rb = self.state.rules.rules if self.state.rules is not None else None
        cols = [m.processed, m.found, m.missed, m.registered, m.persisted,
                m.reg_overflow] + ([rb.fires] if rb is not None else [])
        vals = torch.stack(cols).cpu().tolist()
        return vals[:6], ((vals[6], rb.n_rules) if rb is not None else None)

    def metrics(self) -> dict:
        counters, rules = self._metric_counters()
        return {
            # host_counters first: a counter can never shadow a core key
            **self.host_counters,
            **dict(zip(("processed", "found", "missed", "registered",
                        "persisted", "reg_overflow"), counters)),
            "channel_collisions": self.channel_map.collisions,
            "staged": len(self._buf),
            **({"arena_pool_waits": self._arena_pool.waits,
                "arena_pool_size": self._arena_pool.n_arenas}
               if self._arena_pool is not None else {}),
            **({"ingest_workers": self._sharder.active_workers,
                "sharded_batches": self._sharder.sharded_batches}
               if self._sharder is not None else {}),
            **({"wal_fsyncs": self.wal.fsyncs,
                "wal_commit_groups": self.wal.commit_groups}
               if self.wal is not None and self.wal.group_commit else {}),
            **({"archived_rows": self.archive.total_rows(),
                "archive_lost_rows": self.archive.lost_rows}
               if self.archive is not None else {}),
            # CEP tier: only the partition-invariant counters (fires is a
            # pure function of the event stream; missed/late live in
            # rule_counters())
            **({"rule_fires": rules[0], "rules_active": rules[1]}
               if rules is not None else {}),
        }
