"""Zone monitor: geofence evaluation over the location-event feed (port of
``sitewhere_tpu/outbound/zones.py``).

A feed consumer batches the newly persisted LOCATION events, tests every
point against every zone in one ray-casting pass on the engine's device
(``ops/geofence.py``), diffs each device's zone membership against its
previous set, and injects zone.entered / zone.exited alerts back into the
pipeline: downstream consumers (device state, connectors, command
delivery) see them like any device alert.

The packed zone arrays live on ``engine.device``. A pump moves its points
there in one host-to-device copy and brings the ``[N, Z]`` answer back in
one device-to-host copy, counted in ``stats["syncs"]`` as
``Engine.spool_stats`` counts the spooler's. The JAX package pads the point
batch to a power of two so that its jitted function is not retraced; eager
torch traces nothing, so the batch goes at its own size (the answers are
the same row for row).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from sitewhere_tpu_torch.core.types import AlertLevel, EventType
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.ops.geofence import pack_zones, points_in_zones
from sitewhere_tpu_torch.utils.lifecycle import LifecycleComponent

logger = logging.getLogger(__name__)


class ZoneMonitor(LifecycleComponent):
    """Watches location events and raises zone entry/exit alerts."""

    def __init__(self, engine, device_management,
                 alert_level: AlertLevel = AlertLevel.WARNING,
                 max_vertices: int = 16):
        super().__init__("zone-monitor")
        self.engine = engine
        self.dm = device_management
        self.alert_level = alert_level
        self.max_vertices = max_vertices
        self.device = engine.device
        self.consumer = engine.make_feed_consumer("zone-monitor",
                                                  start_from_latest=True)
        # device_id -> frozenset of zone tokens currently containing it
        self.membership: dict[int, frozenset[str]] = {}
        self._zone_tokens: list[str] = []
        self._verts: torch.Tensor | None = None
        self._valid: torch.Tensor | None = None
        self._zone_version = -1
        # pumps, points and zones evaluated, device-to-host copies
        self.stats = {"pumps": 0, "points": 0, "point_zones": 0, "syncs": 0}

    def _refresh_zones(self) -> None:
        """Rebuild the packed zone arrays when the zone store changed
        (token set, identity, OR bounds: delete+recreate and in-place
        bounds edits must both invalidate the cache)."""
        zones = self.dm.zones.all()
        version = tuple(sorted(
            (z.meta.token, z.meta.id, tuple(map(tuple, z.bounds)))
            for z in zones))
        if version == self._zone_version:
            return
        self._zone_version = version
        usable = []
        tokens = []
        for z in zones:
            if len(z.bounds) > self.max_vertices:
                # create_zone validates too: one bad zone must never poison
                # the shared outbound pump
                logger.warning("zone %s has %d vertices > capacity %d; skipping",
                               z.meta.token, len(z.bounds), self.max_vertices)
                continue
            usable.append(list(z.bounds))
            tokens.append(z.meta.token)
        self._zone_tokens = tokens
        verts, valid = pack_zones(usable, self.max_vertices)
        self._verts = torch.from_numpy(verts).to(self.device)
        self._valid = torch.from_numpy(valid).to(self.device)

    def _inside(self, locs: list) -> np.ndarray:
        """``[N, Z]`` membership of the points on the engine's device: one
        copy there, one copy back."""
        pts = np.array([[e.latitude, e.longitude] for e in locs], np.float32)
        inside = points_in_zones(torch.from_numpy(pts).to(self.device),
                                 self._verts, self._valid).cpu().numpy()
        self.stats["syncs"] += 1
        self.stats["points"] += len(locs)
        self.stats["point_zones"] += len(locs) * len(self._zone_tokens)
        return inside

    async def pump(self) -> int:
        """Evaluate newly persisted location events; returns alerts raised."""
        self._refresh_zones()
        self.stats["pumps"] += 1
        events = self.consumer.poll()
        locs = [e for e in events
                if e.etype is EventType.LOCATION and e.latitude is not None]
        raised = 0
        if locs:
            if self._zone_tokens:
                inside = self._inside(locs)
            else:
                inside = np.zeros((len(locs), 0), bool)
            # latest location per device wins within the batch
            latest: dict[int, int] = {}
            for i, e in enumerate(locs):
                latest[e.device_id] = i
            for did, i in latest.items():
                now_in = frozenset(
                    tok for z, tok in enumerate(self._zone_tokens)
                    if inside[i, z])
                before = self.membership.get(did, frozenset())
                if now_in == before:
                    continue
                self.membership[did] = now_in
                token = locs[i].device_token
                for ztok in sorted(now_in - before):
                    self._alert(token, "zone.entered", ztok)
                    raised += 1
                for ztok in sorted(before - now_in):
                    self._alert(token, "zone.exited", ztok)
                    raised += 1
        if events:
            self.consumer.commit(events)
        if raised:
            self.engine.flush_async()
        return raised

    def _alert(self, device_token: str, kind: str, zone_token: str) -> None:
        self.engine.process(DecodedRequest(
            type=RequestType.DEVICE_ALERT,
            device_token=device_token,
            alert_type=f"{kind}:{zone_token}",
            alert_level=self.alert_level,
            alert_message=f"{kind} {zone_token}",
        ))
