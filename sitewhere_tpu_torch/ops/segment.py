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

from sitewhere_tpu_torch.compat import INT32_MAX, INT32_MIN


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


def compact_valid_front(valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable permutation moving ``valid`` rows to the front.
    Returns (n_valid int32[], perm int32[B])."""
    _, perm = lex_argsort([(~valid).to(torch.int32)])
    return valid.sum(dtype=torch.int32), perm
