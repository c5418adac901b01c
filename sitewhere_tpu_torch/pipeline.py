"""The fused event pipeline step on torch tensors (port of
``sitewhere_tpu/pipeline.py``).

One call processes one decoded-event batch end to end:

    lookup (gather)                 ~ per-message device lookup
    auto-register (batched scatter) ~ device-registration round trip
    assignment expansion            ~ one event per active assignment
    ring-store append               ~ per-event time-series writes
    telemetry-window update         ~ analytics windows (optional)
    streaming rules + rollups       ~ the CEP tier (optional)
    windowed state merge            ~ device-state aggregation
    per-tenant counters             ~ with the geofence test (optional)

The step is functional: it builds new state tensors and never writes into
its input. A reader that holds an older state (the engine's query
snapshot) therefore keeps a consistent view while later steps run.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, resolve_device
from sitewhere_tpu_torch.core.events import EventBatch, unpack_batch
from sitewhere_tpu_torch.core.registry import RegistryTables
from sitewhere_tpu_torch.core.state import DeviceStateStore
from sitewhere_tpu_torch.core.store import EventStore
from sitewhere_tpu_torch.core.types import NULL_ID, EventType
from sitewhere_tpu_torch.models.windows import TelemetryWindows, append_measurements
from sitewhere_tpu_torch.ops.geofence import points_in_zones
from sitewhere_tpu_torch.ops.lookup import expand_assignments, lookup_devices
from sitewhere_tpu_torch.ops.persist import append_events
from sitewhere_tpu_torch.ops.registration import register_misses
from sitewhere_tpu_torch.ops.rules import RulesState, rules_update
from sitewhere_tpu_torch.ops.segment import compact_valid_front
from sitewhere_tpu_torch.ops.window import merge_batch_state, presence_sweep

# per-tenant device-side counter grid: tenants bucket by ``id %
# TENANT_COUNTER_BUCKETS`` (floor mod: a NULL_ID tenant lands in bucket 63)
TENANT_COUNTER_BUCKETS = 64
TENANT_COUNTER_LANES = ("accepted", "dedup_dropped", "geofence_hit",
                        "invalid")


@dataclasses.dataclass(frozen=True)
class ZoneTable:
    """Device-resident geofence polygons (ops/geofence.pack_zones layout)
    for the in-step geofence-hit counter."""

    verts: torch.Tensor    # float32[Z, V, 2] (lat, lon), padded per pack_zones
    valid: torch.Tensor    # bool[Z]


@dataclasses.dataclass(frozen=True)
class PipelineMetrics:
    """Device-side counters (int32 scalars + the per-tenant grid)."""

    processed: torch.Tensor     # int32[] valid events seen
    found: torch.Tensor         # int32[] events matched to a registered device
    missed: torch.Tensor        # int32[] unregistered-device events
    registered: torch.Tensor    # int32[] devices auto-registered
    persisted: torch.Tensor     # int32[] event rows appended to the store
    reg_overflow: torch.Tensor  # int32[] batches that hit registry capacity
    # int32[TENANT_COUNTER_BUCKETS, len(TENANT_COUNTER_LANES)]
    tenant_counters: torch.Tensor

    @staticmethod
    def zeros(device: str | torch.device = DEFAULT_DEVICE) -> "PipelineMetrics":
        dev = resolve_device(device)
        return PipelineMetrics(
            *(torch.zeros((), dtype=torch.int32, device=dev) for _ in range(6)),
            tenant_counters=torch.zeros(
                (TENANT_COUNTER_BUCKETS, len(TENANT_COUNTER_LANES)),
                dtype=torch.int32, device=dev))


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """All device-resident engine state."""

    registry: RegistryTables
    device_state: DeviceStateStore
    store: EventStore
    next_device: torch.Tensor      # int32[] device-row allocation counter
    next_assignment: torch.Tensor  # int32[]
    metrics: PipelineMetrics
    # optional device-resident telemetry windows feeding the analytics
    # service; None disables the update stage
    windows: TelemetryWindows | None = None
    # optional geofence polygons for the in-step geofence-hit counter
    # (Engine.set_geofence_zones); None keeps the lane at zero
    zones: ZoneTable | None = None
    # optional streaming-rules tier (ops/rules.py), installed by
    # Engine.set_rules; None skips it
    rules: RulesState | None = None

    @staticmethod
    def create(
        device_capacity: int,
        token_capacity: int,
        assignment_capacity: int,
        store_capacity: int,
        channels: int = 8,
        bootstrap: RegistryTables | None = None,
        next_device: int = 0,
        next_assignment: int = 0,
        analytics_devices: int = 0,
        analytics_window: int = 128,
        store_arenas: int = 1,
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> "PipelineState":
        dev = resolve_device(device)
        return PipelineState(
            registry=bootstrap
            if bootstrap is not None
            else RegistryTables.zeros(device_capacity, token_capacity,
                                      assignment_capacity, device=dev),
            device_state=DeviceStateStore.zeros(device_capacity, channels,
                                                device=dev),
            store=EventStore.zeros(store_capacity, channels, store_arenas,
                                   device=dev),
            next_device=torch.tensor(next_device, dtype=torch.int32, device=dev),
            next_assignment=torch.tensor(next_assignment, dtype=torch.int32,
                                         device=dev),
            metrics=PipelineMetrics.zeros(dev),
            windows=(
                TelemetryWindows.zeros(analytics_devices, analytics_window,
                                       channels, device=dev)
                if analytics_devices > 0
                else None
            ),
        )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline configuration."""

    auto_register: bool = True
    default_device_type: int = 0
    default_area: int = NULL_ID
    default_customer: int = NULL_ID


def _tenant_counter_delta(batch: EventBatch, accepted: torch.Tensor,
                          invalid: torch.Tensor,
                          zones: ZoneTable | None) -> torch.Tensor:
    """[T_BUCKETS, 4] per-tenant lifecycle deltas for this batch:

      accepted       rows matched to a registered device
      dedup_dropped  in-batch alternate-id duplicates (same token + same
                     aux1 correlation id more than once), found with a
                     two-pass stable argsort = lexsort by (token, aux1)
      geofence_hit   location rows inside any configured zone polygon
      invalid        rows still unmatched after auto-registration

    The JAX step reduces with an int32 one-hot einsum; cuBLAS has no int32
    GEMM, so the port adds each row into bucket * 4 + lane instead."""
    b = batch.capacity
    dev = batch.valid.device
    aux1 = batch.aux[:, 1]
    has_alt = batch.valid & (aux1 != NULL_ID)
    # rows without an alternate id get unique sentinel keys so they can
    # never pair
    alt_key = torch.where(
        has_alt, aux1, -2 - torch.arange(b, dtype=torch.int32, device=dev))
    order1 = torch.sort(alt_key, stable=True).indices
    order = order1[torch.sort(batch.token_id[order1], stable=True).indices]
    st = batch.token_id[order]
    sa = alt_key[order]
    dup_sorted = torch.cat([
        torch.zeros(1, dtype=torch.bool, device=dev),
        (st[1:] == st[:-1]) & (sa[1:] == sa[:-1])])
    dedup = torch.zeros(b, dtype=torch.bool, device=dev)
    dedup[order] = dup_sorted          # order is a permutation: no collisions
    dedup = dedup & has_alt
    if zones is not None:
        is_loc = (batch.valid & (batch.etype == int(EventType.LOCATION))
                  & batch.vmask[:, 0])
        inz = points_in_zones(batch.values[:, :2], zones.verts, zones.valid)
        geo = is_loc & inz.any(1)
    else:
        geo = torch.zeros(b, dtype=torch.bool, device=dev)

    n_lanes = len(TENANT_COUNTER_LANES)
    n_cells = TENANT_COUNTER_BUCKETS * n_lanes
    bucket = batch.tenant_id % TENANT_COUNTER_BUCKETS    # floor mod, as jnp
    lane = torch.arange(n_lanes, dtype=torch.int32, device=dev)
    cell = torch.where(batch.valid[:, None], bucket[:, None] * n_lanes + lane,
                       n_cells)                            # [B, 4]
    lanes = torch.stack([accepted, dedup, geo, invalid], -1).to(torch.int32)
    grid = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev)
    grid.index_add_(0, cell.reshape(-1).long(), lanes.reshape(-1))
    return grid[:n_cells].reshape(TENANT_COUNTER_BUCKETS, n_lanes)


class StepOutput(NamedTuple):
    """Host-visible per-step results. Token lists are compacted, NULL_ID
    padded."""

    n_found: torch.Tensor        # int32[]
    n_missed: torch.Tensor       # int32[]
    n_registered: torch.Tensor   # int32[]
    n_persisted: torch.Tensor    # int32[]
    new_tokens: torch.Tensor     # int32[B] tokens auto-registered this step
    dead_tokens: torch.Tensor    # int32[B] unregistered tokens (dead letters)
    store_cursor: torch.Tensor   # int32[A] ring cursor after append
    store_epoch: torch.Tensor    # int32[A]


def pipeline_step(
    state: PipelineState, batch: EventBatch, config: PipelineConfig
) -> tuple[PipelineState, StepOutput]:
    """Process one decoded-event batch end to end."""
    reg = state.registry
    b = batch.capacity
    dev = batch.valid.device

    # 1. device lookup
    res = lookup_devices(reg, batch.token_id, batch.tenant_id, batch.valid)

    # 2. auto-registration of the miss set
    if config.auto_register:
        regres = register_misses(
            reg, state.next_device, state.next_assignment,
            batch.token_id, batch.tenant_id, res.miss,
            config.default_device_type, config.default_area,
            config.default_customer)
        reg = regres.registry
        next_device = regres.next_device
        next_assignment = regres.next_assignment
        n_registered = regres.n_registered
        new_tokens = regres.new_tokens
        reg_overflow = regres.overflow.to(torch.int32)
        # re-lookup so this batch's events flow through for just-registered
        # devices
        res = lookup_devices(reg, batch.token_id, batch.tenant_id, batch.valid)
    else:
        next_device = state.next_device
        next_assignment = state.next_assignment
        n_registered = torch.zeros((), dtype=torch.int32, device=dev)
        new_tokens = torch.full((b,), NULL_ID, dtype=torch.int32, device=dev)
        reg_overflow = torch.zeros((), dtype=torch.int32, device=dev)

    # remaining misses -> dead-letter list
    n_miss, perm = compact_valid_front(res.miss)
    front = torch.arange(b, dtype=torch.int32, device=dev) < n_miss
    dead_tokens = torch.where(front, batch.token_id[perm.long()], NULL_ID)

    # 3. per-assignment expansion
    exp = expand_assignments(reg, res)

    # 4. persistence append
    src = exp.source_row.long()
    persist = append_events(
        state.store,
        valid=exp.valid,
        etype=batch.etype[src],
        device=exp.device,
        assignment=exp.assignment,
        tenant=batch.tenant_id[src],
        area=exp.area,
        customer=exp.customer,
        asset=exp.asset,
        ts_ms=batch.ts_ms[src],
        received_ms=batch.received_ms[src],
        values=batch.values[src],
        vmask=batch.vmask[src],
        aux=batch.aux[src],
    )

    # 5. telemetry-window update for the analytics service
    windows = state.windows
    if windows is not None:
        windows = append_measurements(
            windows, res.device, res.found, batch.etype, batch.ts_ms,
            batch.seq, batch.values)

    # 5.5 streaming-rules tier: standing rules + continuous rollups on the
    #     post-lookup view; fires land in device-resident pending rings
    #     harvested at reporting cadence (Engine.poll_rule_fires)
    rules = state.rules
    if rules is not None:
        rules = rules_update(rules, batch, res.device, res.found, reg)

    # 6. windowed device-state merge
    new_device_state = merge_batch_state(
        state.device_state,
        dev=res.device,
        found=res.found,
        etype=batch.etype,
        ts_ms=batch.ts_ms,
        seq=batch.seq,
        values=batch.values,
        vmask=batch.vmask,
        aux=batch.aux,
    )

    n_found = res.found.sum(dtype=torch.int32)
    m = state.metrics
    metrics = PipelineMetrics(
        processed=m.processed + batch.count(),
        found=m.found + n_found,
        missed=m.missed + n_miss,
        registered=m.registered + n_registered,
        persisted=m.persisted + persist.appended,
        reg_overflow=m.reg_overflow + reg_overflow,
        tenant_counters=m.tenant_counters + _tenant_counter_delta(
            batch, accepted=res.found, invalid=res.miss, zones=state.zones),
    )

    new_state = PipelineState(
        registry=reg,
        device_state=new_device_state,
        store=persist.store,
        next_device=next_device,
        next_assignment=next_assignment,
        metrics=metrics,
        windows=windows,
        zones=state.zones,
        rules=rules,
    )
    out = StepOutput(
        n_found=n_found,
        n_missed=n_miss,
        n_registered=n_registered,
        n_persisted=persist.appended,
        new_tokens=new_tokens,
        dead_tokens=dead_tokens,
        store_cursor=persist.store.cursor,
        store_epoch=persist.store.epoch,
    )
    return new_state, out


def _stack_outputs(outs: list[StepOutput]) -> StepOutput:
    """K step outputs as one, each field stacked on a leading [K] axis (the
    shape ``lax.scan`` gives the JAX scan steps' outputs)."""
    return StepOutput(*(torch.stack(field) for field in zip(*outs)))


def make_packed_scan_step(config: PipelineConfig, capacity: int,
                          channels: int):
    """``step(state, packed) -> (state, outputs)`` over K batches that
    arrive as ONE uint8 [K, row_bytes] device buffer
    (``core/events.pack_batches``): K ``pipeline_step`` calls, the loop
    standing in for the JAX ``lax.scan``; outputs stacked [K, ...]."""

    def multi(state: PipelineState, packed: torch.Tensor):
        outs = []
        for row in packed:
            state, out = pipeline_step(
                state, unpack_batch(row, capacity, channels), config)
            outs.append(out)
        return state, _stack_outputs(outs)

    return multi


def make_arena_scan_step(config: PipelineConfig, capacity: int,
                         channels: int, k: int):
    """``step(state, batch) -> (state, outputs)`` consuming ONE staging
    arena of ``k * capacity`` rows, transferred once, as K
    ``pipeline_step`` calls on its [K, capacity] lanes (views, no copy);
    outputs stacked [K, ...]. The dispatch program of the zero-copy arena
    path at ``scan_chunk`` > 1."""

    def multi(state: PipelineState, batch: EventBatch):
        outs = []
        for i in range(k):
            lane = slice(i * capacity, (i + 1) * capacity)
            state, out = pipeline_step(state, EventBatch(**{
                f.name: getattr(batch, f.name)[lane]
                for f in dataclasses.fields(batch)}), config)
            outs.append(out)
        return state, _stack_outputs(outs)

    return multi


def _sweep(state: PipelineState, now_ms: torch.Tensor,
           missing_ms: torch.Tensor) -> tuple[PipelineState, torch.Tensor]:
    ds, newly_missing = presence_sweep(
        state.device_state, state.registry.device_active, now_ms, missing_ms)
    return dataclasses.replace(state, device_state=ds), newly_missing


def make_presence_sweep():
    """The presence sweep over a whole state: ``sweep(state, now_ms,
    missing_ms) -> (state, newly_missing)`` with int32 0-d ``now_ms`` and
    ``missing_ms`` (eager torch has nothing to compile, so every call
    returns the same function)."""
    return _sweep
