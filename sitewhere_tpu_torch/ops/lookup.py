"""Batched device lookup + assignment expansion (port of
``sitewhere_tpu/ops/lookup.py``): two gathers over device-resident registry
tables replace the per-message device lookup; the not-found branch becomes
the returned ``miss`` mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sitewhere_tpu_torch.core.registry import MAX_ACTIVE_ASSIGNMENTS, RegistryTables
from sitewhere_tpu_torch.core.types import NULL_ID


class LookupResult(NamedTuple):
    device: torch.Tensor       # int32[B] dense device id (NULL_ID on miss)
    found: torch.Tensor        # bool[B]  valid event and device registered+active
    miss: torch.Tensor         # bool[B]  valid event but unregistered/inactive
    tenant_ok: torch.Tensor    # bool[B]  event tenant matches device tenant
    assignments: torch.Tensor  # int32[B, A] active assignment ids (NULL_ID pads)
    n_assignments: torch.Tensor  # int32[B]


def _clip_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    return idx.clamp(0, size - 1).long()


def lookup_devices(
    reg: RegistryTables,
    token_id: torch.Tensor,
    tenant_id: torch.Tensor,
    valid: torch.Tensor,
) -> LookupResult:
    """Vectorized device/assignment lookup for one event batch."""
    # out-of-range token ids must miss, not alias into clipped slots
    in_range = (token_id >= 0) & (token_id < reg.token_capacity)
    safe_tok = _clip_index(token_id, reg.token_capacity)
    device = torch.where(valid & in_range, reg.token_to_device[safe_tok], NULL_ID)
    has_row = device != NULL_ID
    safe_dev = _clip_index(device, reg.device_capacity)
    active = has_row & reg.device_active[safe_dev]
    dev_tenant = torch.where(has_row, reg.device_tenant[safe_dev], NULL_ID)
    tenant_ok = has_row & ((tenant_id == NULL_ID) | (dev_tenant == tenant_id))
    found = valid & has_row & active & tenant_ok
    miss = valid & ~found
    assignments = torch.where(found[:, None], reg.device_assignments[safe_dev],
                              NULL_ID)
    # only ACTIVE assignment slots expand into events
    safe_asn = _clip_index(assignments, reg.assignment_capacity)
    asn_live = (assignments != NULL_ID) & reg.assignment_active[safe_asn]
    assignments = torch.where(asn_live, assignments, NULL_ID)
    n_assignments = asn_live.sum(1, dtype=torch.int32)
    return LookupResult(
        device=torch.where(found, device, NULL_ID),
        found=found,
        miss=miss,
        tenant_ok=tenant_ok,
        assignments=assignments,
        n_assignments=n_assignments,
    )


class ExpandedEvents(NamedTuple):
    """Per-assignment expansion of an event batch, flattened to B*A rows."""

    valid: torch.Tensor       # bool[B*A]
    device: torch.Tensor      # int32[B*A]
    assignment: torch.Tensor  # int32[B*A]
    area: torch.Tensor        # int32[B*A]
    customer: torch.Tensor    # int32[B*A]
    asset: torch.Tensor       # int32[B*A]
    source_row: torch.Tensor  # int32[B*A] row in the original batch


def expand_assignments(reg: RegistryTables, res: LookupResult) -> ExpandedEvents:
    b, a = res.assignments.shape
    asn = res.assignments.reshape(-1)
    live = asn != NULL_ID
    safe = _clip_index(asn, reg.assignment_capacity)
    device = res.device.repeat_interleave(a)
    source_row = torch.arange(b, dtype=torch.int32,
                              device=asn.device).repeat_interleave(a)
    return ExpandedEvents(
        valid=live,
        device=torch.where(live, device, NULL_ID),
        assignment=torch.where(live, asn, NULL_ID),
        area=torch.where(live, reg.assignment_area[safe], NULL_ID),
        customer=torch.where(live, reg.assignment_customer[safe], NULL_ID),
        asset=torch.where(live, reg.assignment_asset[safe], NULL_ID),
        source_row=source_row,
    )


__all__ = [
    "LookupResult",
    "ExpandedEvents",
    "lookup_devices",
    "expand_assignments",
    "MAX_ACTIVE_ASSIGNMENTS",
]
