"""The host engine, minimal surface (port of part of ``sitewhere_tpu/engine.py``).

Owns the interners (device tokens, tenants, measurement channels, alert
types), the staging buffer, the device-resident pipeline state and the host
mirror of registry metadata. Ported so far: per-request ``process()``
(without the write-ahead log), ``flush()`` as one pipeline step per staged
batch, ``drain`` with the host mirrors of auto-registration,
``register_device``, ``get_device_state`` and ``metrics()``; plus
``ingest_event_batch`` for batches built on the host in bulk. Batch wire
decoding, the WAL, queries, CEP rules, geofences, presence sweeps and the
multi-chip engines are not ported yet.

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
from sitewhere_tpu_torch.ingest.requests import RequestType
from sitewhere_tpu_torch.pipeline import (PipelineConfig, PipelineState,
                                          StepOutput, pipeline_step)


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

    def metrics(self) -> dict:
        m = self.state.metrics
        counters = torch.stack([m.processed, m.found, m.missed, m.registered,
                                m.persisted, m.reg_overflow]).cpu().tolist()
        return {
            # host_counters first: a counter can never shadow a core key
            **self.host_counters,
            **dict(zip(("processed", "found", "missed", "registered",
                        "persisted", "reg_overflow"), counters)),
            "channel_collisions": self.channel_map.collisions,
            "staged": len(self._buf),
        }
