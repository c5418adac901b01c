"""Outbound event feed: a consumer group's cursor over the persisted event
store (port of ``sitewhere_tpu/outbound/feed.py``).

Each :class:`FeedConsumer` owns a committed offset into the engine's event
store; ``poll()`` returns newly persisted events, enriched with the host
mirrors' names, as host records. Offsets commit after the handler's batch
succeeds: at-least-once delivery, a poll without a commit delivers again.
A consumer that falls behind the ring replays the evicted rows from the
archive tier. Ring reads are the port's ``read_range``, one device-to-host
copy a read.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from sitewhere_tpu_torch.core.types import NULL_ID, EventType
from sitewhere_tpu_torch.ops.readback import arena_cursor, read_range, slice_to_host


@dataclasses.dataclass
class OutboundEvent:
    """Host-side enriched event record."""

    event_id: int          # position * arenas + arena (unique, ordered)
    etype: EventType
    device_token: str
    device_id: int
    assignment_id: int
    tenant: str
    area_id: int
    asset_id: int
    ts_ms: int
    received_ms: int
    measurements: dict[str, float]
    values: list[float]
    aux0: int
    aux1: int
    customer_id: int = NULL_ID
    # set only for LOCATION events that carried coordinates (vmask lane 0);
    # a location event without coordinates leaves them None
    latitude: float | None = None
    longitude: float | None = None

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "eventId": self.event_id,
            "type": self.etype.name,
            "deviceToken": self.device_token,
            "assignmentId": self.assignment_id,
            "tenant": self.tenant,
            "areaId": self.area_id,
            "assetId": self.asset_id,
            "eventDateMs": self.ts_ms,
            "receivedDateMs": self.received_ms,
            "measurements": self.measurements,
            "values": self.values,
        }


class FeedConsumer:
    """One consumer group over the engine's event store.

    With tenant arenas each arena is an independent sub-ring with its own
    write order, so the consumer keeps one committed offset per arena (the
    arena is the partition). Event ids encode (arena, position) as
    ``position * arenas + arena``; with one arena they are plain
    positions."""

    def __init__(self, engine, group_id: str, max_batch: int = 1024,
                 start_from_latest: bool = False):
        self.engine = engine
        self.group_id = group_id
        self.max_batch = max_batch
        store = engine.state.store
        self.arenas = store.arenas
        self.offsets = [arena_cursor(store, a) if start_from_latest else 0
                        for a in range(self.arenas)]
        self.lag_lost = 0  # events overwritten before they were consumed

    @property
    def offset(self) -> int:
        """Total committed events across arenas (monotone)."""
        return sum(self.offsets)

    def poll(self) -> list[OutboundEvent]:
        """Fetch the persisted events past the committed offsets (does not
        commit: call ``commit(events)`` after processing them). The whole
        poll holds the engine lock: the ring and the archive index must
        not move between the head read and the range reads."""
        with self.engine.lock:
            if self.engine._pending_outs:
                self.engine.drain()
            return self._poll_locked()

    def _poll_locked(self) -> list[OutboundEvent]:
        store = self.engine.state.store
        acap = store.arena_capacity
        archive = getattr(self.engine, "archive", None)
        lane_names = self._lane_names()
        out: list[OutboundEvent] = []
        for a in range(self.arenas):
            head = arena_cursor(store, a)
            if head <= self.offsets[a]:
                continue
            # the oldest position the ring retains is head - capacity; a
            # lagging consumer replays older rows from the archive, and like
            # the ring read the replay does not advance the committed
            # offset. Only gaps that no tier holds advance it (lag_lost).
            oldest = max(0, head - acap)
            budget = self.max_batch
            if archive is None and self.offsets[a] < oldest:
                self.lag_lost += oldest - self.offsets[a]
                self.offsets[a] = oldest
            pos = self.offsets[a]
            while archive is not None and pos < oldest and budget > 0:
                sl, n = archive.read_rows(a, pos, min(oldest - pos, budget))
                if n == 0:
                    # a recorded loss or an expired range: skip to the next
                    # archived segment (or the ring), and only when nothing
                    # replayed but uncommitted precedes the gap
                    if pos != self.offsets[a]:
                        break   # deliver the events before the gap first
                    nxt = archive.next_start(a, pos)
                    nxt = oldest if nxt is None else min(nxt, oldest)
                    self.lag_lost += nxt - pos
                    self.offsets[a] = nxt
                    pos = nxt
                    continue
                out.extend(self._enrich(sl, pos, n, a, lane_names))
                pos += n
                budget -= n
            if pos < oldest:
                continue   # batch full mid-replay; resumes next poll
            count = min(head - pos, budget)
            if count <= 0:
                continue
            sl = slice_to_host(read_range(store, pos % acap, count, arena=a))
            out.extend(self._enrich(sl, pos, count, a, lane_names))
        return out

    def commit(self, events: list[OutboundEvent]) -> None:
        for ev in events:
            a = ev.event_id % self.arenas
            pos = ev.event_id // self.arenas
            self.offsets[a] = max(self.offsets[a], pos + 1)

    def _lane_names(self) -> dict[int, str]:
        """channel -> its first interned name."""
        eng = self.engine
        lane_names: dict[int, str] = {}
        for name, nid in eng.channel_map.names.items():
            lane_names.setdefault(nid % eng.config.channels, name)
        return lane_names

    def _enrich(self, sl, base: int, count: int, arena: int,
                lane_names: dict[int, str]) -> list[OutboundEvent]:
        """Host rows ``[0, count)`` of a slice (numpy columns, from the ring
        or the archive) as enriched records; invalid rows are skipped. The
        columns turn into Python lists once a slice, and a measurement's
        channel names once a distinct ``vmask`` row."""
        eng = self.engine
        cols = {f: np.asarray(getattr(sl, f))[:count] for f in (
            "etype", "device", "assignment", "tenant", "area", "customer",
            "asset", "ts_ms", "received_ms", "aux")}
        vmask = np.asarray(sl.vmask)[:count]
        valid = np.asarray(sl.valid)[:count]
        values = np.asarray(sl.values)[:count].tolist()
        rows = {f: v.tolist() for f, v in cols.items()}
        aux = rows["aux"]
        names_of: dict[bytes, tuple] = {}
        out = []
        for i in np.nonzero(valid)[0].tolist():
            device, tenant = rows["device"][i], rows["tenant"][i]
            info = eng.devices.get(device)
            et = EventType(rows["etype"][i])
            row = values[i]
            meas = {}
            lat = lon = None
            if et is EventType.MEASUREMENT:
                key = vmask[i].tobytes()
                lanes = names_of.get(key)
                if lanes is None:
                    chans = np.nonzero(vmask[i])[0].tolist()
                    lanes = names_of[key] = (
                        chans, [lane_names.get(ch, f"ch{ch}") for ch in chans])
                meas = dict(zip(lanes[1], [row[ch] for ch in lanes[0]]))
            elif et is EventType.LOCATION and vmask[i, 0]:
                lat, lon = row[0], row[1]
            out.append(OutboundEvent(
                event_id=(base + i) * self.arenas + arena,
                etype=et,
                device_token=info.token if info else f"#{device}",
                device_id=device,
                assignment_id=rows["assignment"][i],
                tenant=(eng.tenants.token(tenant) if tenant != NULL_ID
                        else "default"),
                area_id=rows["area"][i],
                customer_id=rows["customer"][i],
                asset_id=rows["asset"][i],
                ts_ms=rows["ts_ms"][i],
                received_ms=rows["received_ms"][i],
                measurements=meas,
                values=row,
                aux0=aux[i][0],
                aux1=aux[i][1],
                latitude=lat,
                longitude=lon))
        return out
