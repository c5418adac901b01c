"""Batched device auto-registration (port of
``sitewhere_tpu/ops/registration.py``).

Unknown tokens of the miss set are deduplicated in-batch (first occurrence
wins, via scatter-min), allocated dense device + assignment rows from the
device-resident counters, and written into the registry tables in one
shot. The host mirrors the allocation from the returned new-token list.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sitewhere_tpu_torch.compat import INT32_MAX, gather_fill, scatter_drop, scatter_reduce_drop
from sitewhere_tpu_torch.core.registry import RegistryTables
from sitewhere_tpu_torch.core.types import NULL_ID, DeviceAssignmentStatus
from sitewhere_tpu_torch.ops.segment import compact_valid_front


class RegistrationResult(NamedTuple):
    registry: RegistryTables
    next_device: torch.Tensor       # int32[]
    next_assignment: torch.Tensor   # int32[]
    n_registered: torch.Tensor      # int32[] new devices this batch
    new_tokens: torch.Tensor        # int32[B] compacted, NULL_ID padded
    overflow: torch.Tensor          # bool[] capacity exhausted


def register_misses(
    reg: RegistryTables,
    next_device: torch.Tensor,
    next_assignment: torch.Tensor,
    token_id: torch.Tensor,    # int32[B]
    tenant_id: torch.Tensor,   # int32[B]
    miss: torch.Tensor,        # bool[B]
    default_type: int,
    default_area: int,
    default_customer: int,
) -> RegistrationResult:
    """Register every distinct missed token: device row + ACTIVE assignment."""
    b = token_id.shape[0]
    t = reg.token_capacity
    n = reg.device_capacity
    g = reg.assignment_capacity
    dev = token_id.device

    safe_tok = token_id.clamp(0, t - 1).long()
    known = reg.token_to_device[safe_tok] != NULL_ID
    want = miss & ~known & (token_id >= 0) & (token_id < t)

    # dedup within batch: first occurrence of each token wins (scatter-min
    # on the same INT32_MAX fill as the JAX op)
    seq = torch.arange(b, dtype=torch.int32, device=dev)
    tok_w = torch.where(want, token_id, t)
    first = scatter_reduce_drop(
        torch.full((t,), INT32_MAX, dtype=torch.int32, device=dev),
        tok_w, seq, "amin")
    winner = want & (seq == gather_fill(first, safe_tok, INT32_MAX))

    # dense rank among winners -> allocated ids
    rank = winner.cumsum(0, dtype=torch.int32) - 1
    n_new = winner.sum(dtype=torch.int32)
    new_dev = next_device + rank
    new_asn = next_assignment + rank
    fits = winner & (new_dev < n) & (new_asn < g)
    n_fit = fits.sum(dtype=torch.int32)
    overflow = n_new > n_fit

    dev_w = torch.where(fits, new_dev, n)
    asn_w = torch.where(fits, new_asn, g)
    tok_ww = torch.where(fits, token_id, t)
    # slot 0 of each new device's assignment row
    slots = scatter_drop(reg.device_assignments[:, 0], dev_w, new_asn)

    registry = dataclasses.replace(
        reg,
        token_to_device=scatter_drop(reg.token_to_device, tok_ww, new_dev),
        device_active=scatter_drop(reg.device_active, dev_w, True),
        device_type=scatter_drop(reg.device_type, dev_w, default_type),
        device_tenant=scatter_drop(reg.device_tenant, dev_w, tenant_id),
        device_area=scatter_drop(reg.device_area, dev_w, default_area),
        device_customer=scatter_drop(reg.device_customer, dev_w,
                                     default_customer),
        device_assignments=torch.cat(
            [slots[:, None], reg.device_assignments[:, 1:]], 1),
        assignment_active=scatter_drop(reg.assignment_active, asn_w, True),
        assignment_status=scatter_drop(reg.assignment_status, asn_w,
                                       int(DeviceAssignmentStatus.ACTIVE)),
        assignment_device=scatter_drop(reg.assignment_device, asn_w, new_dev),
        assignment_area=scatter_drop(reg.assignment_area, asn_w, default_area),
        assignment_customer=scatter_drop(reg.assignment_customer, asn_w,
                                         default_customer),
    )

    _, perm = compact_valid_front(fits)
    front = torch.arange(b, dtype=torch.int32, device=dev) < n_fit
    new_tokens = torch.where(front, token_id[perm.long()], NULL_ID)

    return RegistrationResult(
        registry=registry,
        next_device=next_device + n_fit,
        next_assignment=next_assignment + n_fit,
        n_registered=n_fit,
        new_tokens=new_tokens,
        overflow=overflow,
    )
