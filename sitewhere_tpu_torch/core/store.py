"""Event persistence: device-resident ring-buffer time-series store (port of
``sitewhere_tpu/core/store.py``).

Persistence is a batched append into a fixed-capacity ring with a tenant
lane and a per-arena write cursor + epoch, so the host can compute durable
watermarks.
"""

from __future__ import annotations

import dataclasses

import torch

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, resolve_device
from sitewhere_tpu_torch.core.types import (AUX_LANES, DEFAULT_VALUE_CHANNELS,
                                            NULL_ID)


@dataclasses.dataclass(frozen=True)
class EventStore:
    """Ring buffer of persisted events. S = capacity (power of two), C = value
    channels, A = tenant arenas.

    With ``arenas == 1`` the whole store is one ring. With ``arenas > 1`` the
    rows partition into A equal sub-rings and every event appends into arena
    ``tenant_id % A`` — one tenant's burst can only evict its own arena's
    rows. Row i of arena a's logical event k is a*(S/A) + k % (S/A)."""

    cursor: torch.Tensor       # int32[A] per-arena writes (wraps with epoch)
    epoch: torch.Tensor        # int32[A] increments on cursor wrap
    etype: torch.Tensor        # int32[S]
    device: torch.Tensor       # int32[S]
    assignment: torch.Tensor   # int32[S]
    tenant: torch.Tensor       # int32[S]
    area: torch.Tensor         # int32[S]
    customer: torch.Tensor     # int32[S]
    asset: torch.Tensor        # int32[S]
    ts_ms: torch.Tensor        # int32[S]
    received_ms: torch.Tensor  # int32[S]
    values: torch.Tensor       # float32[S, C]
    vmask: torch.Tensor        # bool[S, C]
    aux: torch.Tensor          # int32[S, AUX_LANES]
    valid: torch.Tensor        # bool[S]

    @property
    def capacity(self) -> int:
        return self.etype.shape[0]

    @property
    def arenas(self) -> int:
        return self.cursor.shape[0]

    @property
    def arena_capacity(self) -> int:
        return self.capacity // self.arenas

    @staticmethod
    def zeros(capacity: int, channels: int = DEFAULT_VALUE_CHANNELS,
              arenas: int = 1,
              device: str | torch.device = DEFAULT_DEVICE) -> "EventStore":
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        if arenas < 1 or capacity % arenas:
            raise ValueError("arenas must divide capacity")
        s, c = capacity, channels
        dev = resolve_device(device)
        i32 = dict(dtype=torch.int32, device=dev)
        return EventStore(
            cursor=torch.zeros(arenas, **i32),
            epoch=torch.zeros(arenas, **i32),
            etype=torch.zeros(s, **i32),
            device=torch.full((s,), NULL_ID, **i32),
            assignment=torch.full((s,), NULL_ID, **i32),
            tenant=torch.full((s,), NULL_ID, **i32),
            area=torch.full((s,), NULL_ID, **i32),
            customer=torch.full((s,), NULL_ID, **i32),
            asset=torch.full((s,), NULL_ID, **i32),
            ts_ms=torch.zeros(s, **i32),
            received_ms=torch.zeros(s, **i32),
            values=torch.zeros((s, c), dtype=torch.float32, device=dev),
            vmask=torch.zeros((s, c), dtype=torch.bool, device=dev),
            aux=torch.full((s, AUX_LANES), NULL_ID, **i32),
            valid=torch.zeros(s, dtype=torch.bool, device=dev),
        )
