"""The host engine, minimal surface (port of part of ``sitewhere_tpu/engine.py``).

Owns the interners (device tokens, tenants, measurement channels, alert
types), the staging buffer, the device-resident pipeline state and the host
mirror of registry metadata. Ported so far:

- ingest: per-request ``process()`` (without the write-ahead log),
  ``ingest_json_batch`` through the Python decoder (the JAX engine's
  Python path), ``ingest_event_batch`` for batches built on the host in
  bulk, ``flush()`` as one pipeline step per staged batch and ``drain``
  with the host mirrors of auto-registration;
- admin and state: ``register_device``, ``get_device_state``,
  ``search_device_states``, ``presence_sweep``, ``set_geofence_zones``;
- reads: ``query_events`` through the shared-scan :class:`QueryBatcher`,
  ``get_event`` (ring only), ``tenant_metrics``,
  ``tenant_pipeline_counters``, ``metrics()``;
- the streaming-rules tier: ``set_rules``, ``poll_rule_fires``,
  ``rule_counters`` (rules/manager.py drives them).

The native decoder, the WAL, the archive tier and the multi-chip engines
are not ported yet.

Auto-registration happens on the device (ops/registration.py); the host
mirrors it from the step's ``new_tokens`` (allocation order == list order).
Admin registration allocates from the host counter and writes the device
row with :func:`_admin_create_device`, bumping the same counters.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, resolve_device
from sitewhere_tpu_torch.core.events import EpochBase, EventBatch, HostEventBuffer
from sitewhere_tpu_torch.core.registry import MAX_ACTIVE_ASSIGNMENTS, TokenInterner
from sitewhere_tpu_torch.core.state import RECENT_DEPTH
from sitewhere_tpu_torch.core.types import (DEFAULT_VALUE_CHANNELS, NULL_ID,
                                            DeviceAssignmentStatus, EventType,
                                            PresenceState)
from sitewhere_tpu_torch.ingest.decoders import JsonDeviceRequestDecoder
from sitewhere_tpu_torch.ingest.requests import EventDecodeException, RequestType
from sitewhere_tpu_torch.ops.geofence import pack_zones
from sitewhere_tpu_torch.ops.query import QueryParams, bucket_limit, query_store_batch
from sitewhere_tpu_torch.ops.readback import arena_cursor, read_range
from sitewhere_tpu_torch.ops.rules import harvest_fires
from sitewhere_tpu_torch.pipeline import (TENANT_COUNTER_BUCKETS,
                                          TENANT_COUNTER_LANES, PipelineConfig,
                                          PipelineState, StepOutput, ZoneTable,
                                          make_presence_sweep, pipeline_step)


class ChannelMap:
    """Measurement-name -> channel-index interner (per engine). Beyond
    ``channels`` distinct names, lanes are reused modulo and each collision
    is counted (the JAX engine's lenient mode; its strict mode is not
    ported)."""

    def __init__(self, channels: int):
        self.channels = channels
        self.names = TokenInterner(1 << 20)
        self.collisions = 0

    def channel_of(self, name: str) -> int:
        nid = self.names.intern(name)
        if nid >= self.channels:
            self.collisions += 1
        return nid % self.channels


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
    default_device_type: str = "default"
    analytics_devices: int = 0         # device-resident telemetry windows for [0, M)
    analytics_window: int = 128        # W timesteps per window
    presence_missing_s: float = 8 * 3600.0  # presence sweep's missing interval
    rule_groups: int = 1024            # group slots (device/area/tenant ids)
                                       # each rule and rollup tracks; ids
                                       # beyond count as out-of-band
    rollup_buckets: int = 32           # tumbling-window ring depth per
                                       # (rollup, group)
    rule_pending: int = 4              # pending-fire ring depth per
                                       # (rule, group)


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


# rule/rollup parameter columns: a swap that keeps shapes and layout
# replaces exactly these and preserves the carried state
_RULE_PARAM_FIELDS = ("active", "etype", "tenant", "ch_a", "val_a",
                      "ch_b", "val_b", "window_ms")
_ROLLUP_PARAM_FIELDS = ("channel", "scope", "etype", "window_ms")


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
    group — Q queries share a single pass over the ring.

    Lock discipline: the leader takes the engine lock only to snapshot
    ``state.store`` and enqueue the query's device work; the device wait,
    the readback and all host-side formatting happen outside it. The
    snapshot stays valid outside the lock because the port's step is
    functional — every step builds new state tensors and never writes
    into the old ones, so the snapshot's tensors are never overwritten.
    (An in-place step would have to copy the store here.)"""

    def __init__(self, engine, max_batch: int = 16):
        self.engine = engine
        self.max_batch = max(1, int(max_batch))
        self._mu = threading.Lock()
        self._queue: list[dict] = []
        self._running = False
        self.programs = 0        # query_store_batch calls launched
        self.coalesced = 0       # queries served through them
        self.max_coalesced = 0   # largest micro-batch observed

    def run(self, params: tuple, limit: int):
        """Submit one predicate set (``QueryParams`` field order, plain
        ints) at a bucketed ``limit``. Returns ``(row, q)``: the query's
        ``QueryResult`` row as numpy arrays and the size of the
        micro-batch it rode in."""
        entry = {"params": params, "limit": int(limit),
                 "event": threading.Event(), "result": None, "q": 0,
                 "error": None}
        if self.engine.lock._is_owned():
            # a caller already inside the engine lock must not park as a
            # follower: the leader would block on the lock it holds
            self._execute([entry])
            return entry["result"], entry["q"]
        with self._mu:
            self._queue.append(entry)
            lead = not self._running
            if lead:
                self._running = True
        if lead:
            self._drain()
        else:
            entry["event"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        return entry["result"], entry["q"]

    def _drain(self) -> None:
        """Leader loop: execute rounds until the queue is empty. The empty
        check and the ``_running`` handoff are atomic, so no entry can
        strand."""
        while True:
            with self._mu:
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
        launched = []
        with eng.lock:
            store = eng.state.store
            for limit, entries in groups.items():
                cols = torch.tensor([e["params"] for e in entries],
                                    dtype=torch.int32).T.to(eng.device)
                launched.append((entries, query_store_batch(
                    store, QueryParams(*cols), limit=limit)))
                qn = len(entries)
                self.programs += 1
                self.coalesced += qn
                self.max_coalesced = max(self.max_coalesced, qn)
        for entries, res in launched:
            host = _fetch_query_result(res)
            for q, entry in enumerate(entries):
                entry["result"] = type(host)(*(col[q] for col in host))
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
        self.tokens = TokenInterner(c.token_capacity)
        self.channel_map = ChannelMap(c.channels)
        self.alert_types = TokenInterner(1 << 20)
        self.tenants = TokenInterner(1 << 16)
        self.tenants.intern("default")
        self.device_types = TokenInterner(1 << 16)
        self.device_types.intern(c.default_device_type)
        self.areas = TokenInterner(1 << 16)
        self.customers = TokenInterner(1 << 16)
        self.event_ids = TokenInterner(1 << 22)
        self.pipeline_config = PipelineConfig()
        self.state = PipelineState.create(
            c.device_capacity, c.token_capacity, c.assignment_capacity,
            c.store_capacity, c.channels,
            analytics_devices=c.analytics_devices,
            analytics_window=c.analytics_window,
            device=self.device,
        )
        self._buf = HostEventBuffer(c.batch_capacity, c.channels)
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
        self._query_batcher = QueryBatcher(self)

    def _sync_mirrors(self) -> None:
        """Run any staged batch and absorb pending outputs (lock held)."""
        while len(self._buf):
            self.flush_async()
        if self._pending_outs:
            self.drain()

    # ------------------------------------------------------------------ ingest
    def process(self, req) -> None:
        """Stage one decoded request; flushes when the staging batch fills.
        Registration envelopes take the admin path; event requests convert
        to one staged SoA row."""
        with self.lock:
            if req.type is RequestType.REGISTER_DEVICE:
                self.register_device(
                    req.device_token,
                    device_type=req.extras.get("deviceTypeToken",
                                               self.config.default_device_type),
                    tenant=req.tenant,
                    area=req.extras.get("areaToken"),
                    customer=req.extras.get("customerToken"),
                )
                return
            if req.type is RequestType.MAP_DEVICE:
                raise NotImplementedError("device mapping is not ported yet")
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

    def ingest_json_batch(self, payloads: list[bytes],
                          tenant: str = "default") -> dict:
        """Decode a batch of JSON device-request payloads and stage each
        request through :meth:`process` — the JAX engine's Python decode
        path. Returns ``{"decoded", "failed"}``; a payload that does not
        decode counts as failed and is skipped."""
        dec = JsonDeviceRequestDecoder()
        failed = 0
        with self.lock:
            for p in payloads:
                try:
                    reqs = dec.decode(p, {})
                except EventDecodeException:
                    failed += 1
                    continue
                for req in reqs:
                    req.tenant = tenant
                    self.process(req)
        return {"decoded": len(payloads) - failed, "failed": failed}

    def ingest_event_batch(self, batch: EventBatch) -> None:
        """Dispatch one batch already built in bulk (columns on this
        engine's device, token/tenant ids from this engine's interners) as
        one pipeline step; its output queues for :meth:`drain` like a
        staged batch's. The counterpart of the JAX engine's zero-copy
        arena dispatch."""
        if batch.capacity != self.config.batch_capacity:
            raise ValueError(f"batch capacity {batch.capacity} != engine "
                             f"batch_capacity {self.config.batch_capacity}")
        with self.lock:
            while len(self._buf):      # staged rows keep their order
                self.flush_async()
            self.state, out = pipeline_step(self.state, batch,
                                            self.pipeline_config)
            self._pending_outs.append(out)

    def flush(self) -> dict:
        """Run the staged work through the pipeline and sync host mirrors;
        returns the aggregate summary of everything drained."""
        with self.lock:
            self.flush_async()
            return _merge_summaries(self.drain())

    def flush_async(self) -> None:
        """Dispatch a step on the staged batch without reading anything
        back: the step output queues for :meth:`drain`. No-op on an empty
        buffer."""
        with self.lock:
            if not len(self._buf):
                return
            batch = self._buf.emit(self.device)
            self.state, out = pipeline_step(self.state, batch,
                                            self.pipeline_config)
            self._pending_outs.append(out)

    def drain(self) -> list[dict]:
        """Absorb every queued step output into the host mirrors. Only the
        scalar counters are fetched for the whole backlog (one transfer);
        token lists are sliced to their occupied prefix."""
        with self.lock:
            if not self._pending_outs:
                return [_empty_summary()]
            outs, self._pending_outs = self._pending_outs, []
            scalars = torch.stack([
                torch.stack([o.n_found, o.n_missed, o.n_registered,
                             o.n_persisted]) for o in outs]).cpu().tolist()
            return [self._absorb_output(out, *s) for out, s in zip(outs, scalars)]

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
        """Filtered, newest-first event query over the device ring store.
        Every filter applies on the device, so the limit applies after
        filtering. Only the mirror sync and the string -> id resolution run
        under the engine lock; the scan (coalesced with concurrent queries
        into one ``query_store_batch``) and the row formatting run outside
        it. ``limit`` buckets to the next power of two; the result slices
        back to the exact page."""
        limit = max(1, int(limit))
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
        if miss:
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
        row, _ = self._query_batcher.run(params, bucket_limit(limit))
        total = int(row.total)
        events = [
            self._format_event(
                int(row.etype[i]), int(row.device[i]),
                int(row.assignment[i]), int(row.ts_ms[i]),
                int(row.received_ms[i]), row.values[i], row.vmask[i],
                row.aux[i], lane_names)
            for i in range(min(total, limit))
        ]
        return {"total": total, "events": events}

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
        """Fetch one persisted event by its absolute store position (the
        stable event id). Returns None when the id was never written or
        its ring slot has been overwritten (the archive tier is not
        ported). ``tenant`` scopes the lookup: another tenant's row reads
        as absent."""
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
            if pos >= head or pos < head - store.arena_capacity:
                return None
            sl = read_range(store, pos % store.arena_capacity, 1, arena=arena)
            sl = type(sl)(*(col.cpu().numpy() for col in sl))
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
            old = self.state.rules
            if preserve_state and old is not None and rules_state is not None:
                merged_rules = old.rules
                if old.rules is not None and rules_state.rules is not None:
                    merged_rules = dataclasses.replace(old.rules, **{
                        f: getattr(rules_state.rules, f)
                        for f in _RULE_PARAM_FIELDS})
                merged_rollups = old.rollups
                if old.rollups is not None and rules_state.rollups is not None:
                    merged_rollups = dataclasses.replace(old.rollups, **{
                        f: getattr(rules_state.rollups, f)
                        for f in _ROLLUP_PARAM_FIELDS})
                rules_state = dataclasses.replace(
                    rules_state, rules=merged_rules, rollups=merged_rollups)
            self.state = dataclasses.replace(self.state, rules=rules_state)

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

    def metrics(self) -> dict:
        m = self.state.metrics
        counters = torch.stack([m.processed, m.found, m.missed, m.registered,
                                m.persisted, m.reg_overflow]).cpu().tolist()
        rb = self.state.rules.rules if self.state.rules is not None else None
        return {
            # host_counters first: a counter can never shadow a core key
            **self.host_counters,
            **dict(zip(("processed", "found", "missed", "registered",
                        "persisted", "reg_overflow"), counters)),
            "channel_collisions": self.channel_map.collisions,
            "staged": len(self._buf),
            # CEP tier: only the partition-invariant counters (fires is a
            # pure function of the event stream; missed/late live in
            # rule_counters())
            **({"rule_fires": int(rb.fires), "rules_active": rb.n_rules}
               if rb is not None else {}),
        }
