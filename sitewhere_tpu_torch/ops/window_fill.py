"""Archive rows -> telemetry windows for the historical analytics jobs
(port of ``sitewhere_tpu/ops/window_fill.py``).

Rebuilds per-device windows [M, W, C] from a flat batch of archived
measurement rows, on the engine's device: the rows sort by (device slot,
ts, seq), rank within each device's run, and only the newest W rows of a
device are kept and scattered into the snapshot layout the scoring stack
reads (newest row at index W-1, zeros before the first row of an
underfilled window) — the layout ``models/windows.snapshot_windows`` gives
for a live ring, so ``models/service._score_windows`` scores either.

Keeping the newest W rows a device (``rank >= count - W``) makes the
scatter deterministic on CUDA: every kept row owns a unique (device, slot)
destination; dropped rows go to the spare row that is cut off
(``compat.flat_index`` / ``scatter_drop``), and the counts add int32 ones
with ``index_add_``. Static shapes, no per-device loop.
"""

from __future__ import annotations

import torch

from sitewhere_tpu_torch.compat import flat_index, gather_fill, scatter_drop
from sitewhere_tpu_torch.ops.segment import lex_argsort, segment_ranks


def fill_windows(dev_slot: torch.Tensor, ts: torch.Tensor, seq: torch.Tensor,
                 values: torch.Tensor, vmask: torch.Tensor, *, m: int,
                 w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``dev_slot`` int32[N] (the row's slot in the batch, -1 = drop),
    ``ts`` int32[N] (window order), ``seq`` int32[N] (tie-break),
    ``values`` float32[N, C], ``vmask`` bool[N, C] -> (float32[m, w, C]
    windows, int32[m] matching rows a slot; a count may exceed ``w``, the
    older rows spill off)."""
    c = values.shape[1]
    dev = values.device
    vals = torch.where(vmask, values, 0.0)
    take = (dev_slot >= 0) & (dev_slot < m)
    dev_key = torch.where(take, dev_slot, m).to(torch.int32)
    sorted_keys, perm = lex_argsort([dev_key, ts, seq])
    s_dev = sorted_keys[0]
    s_vals = vals[perm.long()]
    rank, _ = segment_ranks(s_dev)
    live = s_dev < m
    bucket = torch.where(live, s_dev, m).long()
    counts = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, bucket, live.to(torch.int32))
    counts = counts[:m]
    cnt_row = gather_fill(counts, torch.where(live, s_dev, m), 0)
    slot = rank + w - cnt_row          # right-aligned: newest lands at w-1
    keep = live & (slot >= 0)          # only the newest w rows a device
    d_w = torch.where(keep, s_dev, m)
    lin = flat_index((d_w, slot), (m, w))
    data = scatter_drop(torch.zeros((m * w, c), dtype=torch.float32, device=dev),
                        lin, s_vals)
    return data.view(m, w, c), counts
