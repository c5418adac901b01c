"""Device registry: integer-indexed tables + host-side token interner
(port of ``sitewhere_tpu/core/registry.py``).

The registry is a set of device-resident int32 tables, so the per-message
device lookup is a batched gather (ops/lookup.py); the string token -> id
mapping is a host interner. Capacities are static.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator

import torch

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, resolve_device
from sitewhere_tpu_torch.core.types import NULL_ID, DeviceAssignmentStatus

# Max simultaneously-active assignments tracked per device on-device (a
# small static cap keeps the per-assignment expansion fixed-shape).
MAX_ACTIVE_ASSIGNMENTS = 4


@dataclasses.dataclass(frozen=True)
class RegistryTables:
    """Device-resident registry state. N = device capacity, T = token capacity,
    A = MAX_ACTIVE_ASSIGNMENTS, G = assignment capacity."""

    token_to_device: torch.Tensor      # int32[T] (NULL_ID = unregistered)
    device_active: torch.Tensor        # bool[N]
    device_type: torch.Tensor          # int32[N]
    device_tenant: torch.Tensor        # int32[N]
    device_area: torch.Tensor          # int32[N]
    device_customer: torch.Tensor      # int32[N]
    device_parent: torch.Tensor        # int32[N]
    device_assignments: torch.Tensor   # int32[N, A] (NULL_ID = empty)
    assignment_active: torch.Tensor    # bool[G]
    assignment_status: torch.Tensor    # int32[G] DeviceAssignmentStatus
    assignment_device: torch.Tensor    # int32[G]
    assignment_asset: torch.Tensor     # int32[G]
    assignment_area: torch.Tensor      # int32[G]
    assignment_customer: torch.Tensor  # int32[G]

    @property
    def device_capacity(self) -> int:
        return self.device_active.shape[0]

    @property
    def token_capacity(self) -> int:
        return self.token_to_device.shape[0]

    @property
    def assignment_capacity(self) -> int:
        return self.assignment_active.shape[0]

    @staticmethod
    def zeros(device_capacity: int, token_capacity: int,
              assignment_capacity: int,
              device: str | torch.device = DEFAULT_DEVICE) -> "RegistryTables":
        n, t, g = device_capacity, token_capacity, assignment_capacity
        a = MAX_ACTIVE_ASSIGNMENTS
        dev = resolve_device(device)
        i32 = dict(dtype=torch.int32, device=dev)
        return RegistryTables(
            token_to_device=torch.full((t,), NULL_ID, **i32),
            device_active=torch.zeros(n, dtype=torch.bool, device=dev),
            device_type=torch.full((n,), NULL_ID, **i32),
            device_tenant=torch.full((n,), NULL_ID, **i32),
            device_area=torch.full((n,), NULL_ID, **i32),
            device_customer=torch.full((n,), NULL_ID, **i32),
            device_parent=torch.full((n,), NULL_ID, **i32),
            device_assignments=torch.full((n, a), NULL_ID, **i32),
            assignment_active=torch.zeros(g, dtype=torch.bool, device=dev),
            assignment_status=torch.full(
                (g,), int(DeviceAssignmentStatus.RELEASED), **i32),
            assignment_device=torch.full((g,), NULL_ID, **i32),
            assignment_asset=torch.full((g,), NULL_ID, **i32),
            assignment_area=torch.full((g,), NULL_ID, **i32),
            assignment_customer=torch.full((g,), NULL_ID, **i32),
        )


class TokenInterner:
    """Thread-safe host-side string -> dense int id map."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._by_token: dict[str, int] = {}
        self._tokens: list[str] = []

    def __len__(self) -> int:
        return len(self._tokens)

    def intern(self, token: str) -> int:
        tid = self._by_token.get(token)
        if tid is not None:
            return tid
        with self._lock:
            tid = self._by_token.get(token)
            if tid is None:
                tid = len(self._tokens)
                if tid >= self.capacity:
                    raise RuntimeError(f"token capacity {self.capacity} exhausted")
                self._tokens.append(token)
                self._by_token[token] = tid
            return tid

    def lookup(self, token: str) -> int:
        return self._by_token.get(token, NULL_ID)

    def token(self, tid: int) -> str:
        return self._tokens[tid]

    def items(self) -> Iterator[tuple[str, int]]:
        return iter(self._by_token.items())
