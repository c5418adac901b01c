"""Sort/segment primitives used by the batched pipeline ops (port of
``sitewhere_tpu/ops/segment.py``).

Lexicographic sorts are successive *stable* sorts from the least
significant key (``torch.sort`` defaults to unstable, so ``stable=True``
is spelled out everywhere); run-length ranks come from cumulative max/min
scans (``torch.cummax``, and ``torch.cummin`` over the flipped tensor for
the reverse scan). Everything is static-shape and stays int32.
"""

from __future__ import annotations

import torch

from sitewhere_tpu_torch.compat import (INT32_MAX, INT32_MIN, gather_fill,
                                        scatter_drop, scatter_reduce_drop)


def lex_argsort(keys: list[torch.Tensor]) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Stable lexicographic argsort of equal-length 1-D keys (ascending,
    keys[0] primary). Returns (sorted_keys, permutation int32); apply
    ``perm`` to gather arbitrary payload rows."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return [key[perm] for key in keys], perm.to(torch.int32)


def segment_ranks(sorted_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Given segment ids already sorted ascending, return
    ``(rank_from_start, rank_from_end)`` within each run of equal ids
    (int32). rank_from_end == 0 marks the last element of each run."""
    n = sorted_ids.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=sorted_ids.device)
    differs = sorted_ids[1:] != sorted_ids[:-1]
    edge = torch.ones(1, dtype=torch.bool, device=sorted_ids.device)
    is_start = torch.cat([edge, differs])
    start_idx = torch.cummax(torch.where(is_start, idx, INT32_MIN), 0).values
    is_end = torch.cat([differs, edge])
    end_idx = torch.cummin(
        torch.where(is_end, idx, INT32_MAX).flip(0), 0).values.flip(0)
    return idx - start_idx, end_idx - idx


def scatter_argmax_mask(seg: torch.Tensor, key1: torch.Tensor,
                        key2: torch.Tensor, valid: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Bool mask selecting, for every segment id, the single element with
    the lexicographically largest ``(key1, key2)`` among ``valid`` rows.
    ``key2`` must be unique per row within a segment. Two scatter-max
    passes and two gathers; no sort."""
    seg_c = torch.where(valid, seg, num_segments)   # invalid rows -> dropped
    k1 = torch.where(valid, key1, INT32_MIN)
    max1 = scatter_reduce_drop(
        torch.full((num_segments,), INT32_MIN, dtype=key1.dtype,
                   device=key1.device), seg_c, k1, "amax")
    on_max1 = valid & (key1 == gather_fill(max1, seg_c, INT32_MIN))
    k2 = torch.where(on_max1, key2, INT32_MIN)
    max2 = scatter_reduce_drop(
        torch.full((num_segments,), INT32_MIN, dtype=key2.dtype,
                   device=key2.device), seg_c, k2, "amax")
    return on_max1 & (key2 == gather_fill(max2, seg_c, INT32_MIN))


def stable_partition_topk(perm: torch.Tensor, match_sorted: torch.Tensor,
                          total: torch.Tensor, limit: int) -> torch.Tensor:
    """First ``limit`` entries of the stable partition of ``perm`` by
    ``match_sorted``: matching entries keep their ``perm`` order and come
    first, non-matching entries (in ``perm`` order) fill the rest. Equals
    ``lex_argsort([~match, order_key])[:limit]`` when ``perm`` is the
    ordering sort, at O(N) per query. ``total`` must equal
    ``match_sorted.sum(-1)``.

    ``match_sorted`` may carry leading query dims (``[Q, N]`` with
    ``total`` of shape ``[Q]``: one shared ``perm``, Q partitions in one
    pass). ``dest`` is a permutation per query, so the scatter has no
    duplicate indices; destinations past ``limit`` drop."""
    m = match_sorted
    lead = tuple(m.shape[:-1])
    n = m.shape[-1]
    match_rank = torch.cumsum(m, -1, dtype=torch.int32) - 1
    non_rank = torch.cumsum(~m, -1, dtype=torch.int32) - 1
    dest = torch.where(m, match_rank, total.unsqueeze(-1) + non_rank)
    q = m.numel() // max(n, 1)
    row = torch.arange(q, dtype=torch.int32, device=m.device).view(lead + (1,))
    lin = torch.where(dest < limit, row * limit + dest, -1)
    out = scatter_drop(torch.zeros(q * limit, dtype=perm.dtype, device=m.device),
                       lin.reshape(-1), perm.expand(m.shape).reshape(-1))
    return out.view(lead + (limit,))


def compact_valid_front(valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable permutation moving ``valid`` rows to the front.
    Returns (n_valid int32[], perm int32[B])."""
    _, perm = lex_argsort([(~valid).to(torch.int32)])
    return valid.sum(dtype=torch.int32), perm
