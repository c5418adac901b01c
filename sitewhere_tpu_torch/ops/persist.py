"""Batched event persistence into the device ring store (port of
``sitewhere_tpu/ops/persist.py``): one compaction sort + one masked scatter
per batch. Invalid rows are steered out of bounds and dropped, so they
cost no ring capacity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sitewhere_tpu_torch.compat import scatter_drop
from sitewhere_tpu_torch.core.store import EventStore
from sitewhere_tpu_torch.ops.segment import lex_argsort, segment_ranks


class PersistResult(NamedTuple):
    store: EventStore
    appended: torch.Tensor  # int32[] events written this batch


def append_events(
    store: EventStore,
    valid: torch.Tensor,       # bool[E]
    etype: torch.Tensor,       # int32[E]
    device: torch.Tensor,      # int32[E]
    assignment: torch.Tensor,  # int32[E]
    tenant: torch.Tensor,      # int32[E]
    area: torch.Tensor,        # int32[E]
    customer: torch.Tensor,    # int32[E]
    asset: torch.Tensor,       # int32[E]
    ts_ms: torch.Tensor,       # int32[E]
    received_ms: torch.Tensor, # int32[E]
    values: torch.Tensor,      # float32[E, C]
    vmask: torch.Tensor,       # bool[E, C]
    aux: torch.Tensor,         # int32[E, AUX]
) -> PersistResult:
    """Append up to E events at each arena's ring cursor. Rows route to
    arena ``tenant % A``; an arena that runs out of room wraps (oldest
    rows overwritten)."""
    s = store.capacity
    a_n = store.arenas
    acap = store.arena_capacity
    e = valid.shape[0]
    # With e <= acap the positions within one arena are distinct, so the
    # single scatter below is well-defined; a larger batch could alias
    # slots inside one scatter, so that configuration is refused up front.
    if e > acap:
        raise ValueError(
            f"expanded batch ({e} rows) exceeds per-arena event-store "
            f"capacity ({acap}); allocate store_capacity >= "
            "batch_capacity * MAX_ACTIVE_ASSIGNMENTS * arenas"
        )

    # route each valid row to its tenant's arena, group rows by arena
    # (stable: batch order preserved within an arena), rank within group
    pad = torch.where(valid, 0, a_n).to(torch.int32)   # a_n = padding sentinel
    arena = torch.where(valid & (tenant >= 0), tenant % a_n, pad)
    sorted_keys, perm = lex_argsort([arena])
    s_arena = sorted_keys[0]
    rank, _ = segment_ranks(s_arena)
    p = perm.long()
    arena_safe = s_arena.clamp(0, a_n - 1)
    cur = store.cursor[arena_safe.long()]
    pos = torch.where(s_arena < a_n,
                      arena_safe * acap + (cur + rank) % acap,
                      s)   # s = out of bounds -> dropped
    # per-arena appended counts (sentinel rows land in the spare bucket)
    counts = torch.zeros(a_n + 1, dtype=torch.int32, device=valid.device)
    counts.index_add_(0, s_arena.long(), torch.ones_like(s_arena))
    counts = counts[:a_n]
    n = valid.sum(dtype=torch.int32)
    total = store.cursor + counts

    new = EventStore(
        cursor=total % acap,
        epoch=store.epoch + total // acap,
        etype=scatter_drop(store.etype, pos, etype[p]),
        device=scatter_drop(store.device, pos, device[p]),
        assignment=scatter_drop(store.assignment, pos, assignment[p]),
        tenant=scatter_drop(store.tenant, pos, tenant[p]),
        area=scatter_drop(store.area, pos, area[p]),
        customer=scatter_drop(store.customer, pos, customer[p]),
        asset=scatter_drop(store.asset, pos, asset[p]),
        ts_ms=scatter_drop(store.ts_ms, pos, ts_ms[p]),
        received_ms=scatter_drop(store.received_ms, pos, received_ms[p]),
        values=scatter_drop(store.values, pos, values[p]),
        vmask=scatter_drop(store.vmask, pos, vmask[p]),
        aux=scatter_drop(store.aux, pos, aux[p]),
        valid=scatter_drop(store.valid, pos, True),
    )
    return PersistResult(store=new, appended=n)
