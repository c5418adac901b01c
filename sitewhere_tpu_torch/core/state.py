"""Per-device aggregated state tensors (port of
``sitewhere_tpu/core/state.py``).

The whole device-state table is a set of device-resident tensors indexed by
dense device id; the window merge is a batched sort/segment pass
(ops/window.py).
"""

from __future__ import annotations

import dataclasses

import torch

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, INT32_MIN, resolve_device
from sitewhere_tpu_torch.core.types import (DEFAULT_VALUE_CHANNELS,
                                            NUM_EVENT_TYPES, PresenceState)

# Recent-event ring depth per event class.
RECENT_DEPTH = 3

# Location payload lanes: lat, lon, elevation.
LOC_LANES = 3


@dataclasses.dataclass(frozen=True)
class DeviceStateStore:
    """Aggregated device state. N = device capacity, R = RECENT_DEPTH,
    C = measurement channels. "Recent" rings are most-recent-first
    (slot 0 = newest)."""

    last_interaction_ms: torch.Tensor   # int32[N]  (INT32_MIN = never)
    presence: torch.Tensor              # int32[N]  PresenceState
    meas_last: torch.Tensor             # float32[N, C]
    meas_last_ms: torch.Tensor          # int32[N, C]
    recent_meas: torch.Tensor           # float32[N, R, C]
    recent_meas_mask: torch.Tensor      # bool[N, R, C]
    recent_meas_ms: torch.Tensor        # int32[N, R]
    recent_meas_valid: torch.Tensor     # bool[N, R]
    recent_loc: torch.Tensor            # float32[N, R, LOC_LANES]
    recent_loc_ms: torch.Tensor         # int32[N, R]
    recent_loc_valid: torch.Tensor      # bool[N, R]
    recent_alert_level: torch.Tensor    # int32[N, R]
    recent_alert_type: torch.Tensor     # int32[N, R]
    recent_alert_ms: torch.Tensor       # int32[N, R]
    recent_alert_valid: torch.Tensor    # bool[N, R]
    event_counts: torch.Tensor          # int32[N, NUM_EVENT_TYPES]

    @property
    def device_capacity(self) -> int:
        return self.last_interaction_ms.shape[0]

    @staticmethod
    def zeros(device_capacity: int, channels: int = DEFAULT_VALUE_CHANNELS,
              device: str | torch.device = DEFAULT_DEVICE) -> "DeviceStateStore":
        n, r, c = device_capacity, RECENT_DEPTH, channels
        dev = resolve_device(device)
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        b = dict(dtype=torch.bool, device=dev)
        return DeviceStateStore(
            last_interaction_ms=torch.full((n,), INT32_MIN, **i32),
            presence=torch.full((n,), int(PresenceState.UNKNOWN), **i32),
            meas_last=torch.zeros((n, c), **f32),
            meas_last_ms=torch.full((n, c), INT32_MIN, **i32),
            recent_meas=torch.zeros((n, r, c), **f32),
            recent_meas_mask=torch.zeros((n, r, c), **b),
            recent_meas_ms=torch.full((n, r), INT32_MIN, **i32),
            recent_meas_valid=torch.zeros((n, r), **b),
            recent_loc=torch.zeros((n, r, LOC_LANES), **f32),
            recent_loc_ms=torch.full((n, r), INT32_MIN, **i32),
            recent_loc_valid=torch.zeros((n, r), **b),
            recent_alert_level=torch.zeros((n, r), **i32),
            recent_alert_type=torch.zeros((n, r), **i32),
            recent_alert_ms=torch.full((n, r), INT32_MIN, **i32),
            recent_alert_valid=torch.zeros((n, r), **b),
            event_counts=torch.zeros((n, NUM_EVENT_TYPES), **i32),
        )
