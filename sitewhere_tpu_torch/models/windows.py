"""Device-resident per-device telemetry windows feeding the analytics models
(port of ``sitewhere_tpu/models/windows.py``).

Per-device sliding windows of measurement vectors stay resident on the
device as a [M, W, C] ring, so the anomaly models (models/anomaly.py)
consume them without host traffic. M = analytics device capacity (a dense
prefix of the device-id space), W = window length, C = sensor channels.
"""

from __future__ import annotations

import dataclasses

import torch

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, gather_fill, resolve_device, scatter_drop
from sitewhere_tpu_torch.core.types import EventType
from sitewhere_tpu_torch.ops.segment import lex_argsort, segment_ranks


@dataclasses.dataclass(frozen=True)
class TelemetryWindows:
    """Sliding measurement windows. Ring position ``cursor[d]`` is the next
    write slot for device d; ``filled[d]`` counts total writes."""

    data: torch.Tensor     # float32[M, W, C]
    cursor: torch.Tensor   # int32[M]
    filled: torch.Tensor   # int32[M] total writes (not wrapped)

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def window(self) -> int:
        return self.data.shape[1]

    @staticmethod
    def zeros(m: int, w: int, c: int,
              device: str | torch.device = DEFAULT_DEVICE) -> "TelemetryWindows":
        dev = resolve_device(device)
        return TelemetryWindows(
            data=torch.zeros((m, w, c), dtype=torch.float32, device=dev),
            cursor=torch.zeros(m, dtype=torch.int32, device=dev),
            filled=torch.zeros(m, dtype=torch.int32, device=dev),
        )


def append_measurements(
    wins: TelemetryWindows,
    dev: torch.Tensor,      # int32[B] dense device ids
    found: torch.Tensor,    # bool[B]
    etype: torch.Tensor,    # int32[B]
    ts_ms: torch.Tensor,    # int32[B]
    seq: torch.Tensor,      # int32[B]
    values: torch.Tensor,   # float32[B, C]
) -> TelemetryWindows:
    """Append this batch's measurement vectors into each device's ring, in
    (ts, seq) order — a segmented scatter with in-batch rank offsets.

    A device with more than W measurement rows in ONE batch writes several
    rows into the same ring slot; the JAX op leaves that winner to XLA, so
    such batches have no defined result on either side (callers keep a
    device's rows per batch <= W)."""
    m, w, c = wins.data.shape
    take = found & (etype == int(EventType.MEASUREMENT)) & (dev >= 0) & (dev < m)
    dev_key = torch.where(take, dev, m)
    sorted_keys, perm = lex_argsort([dev_key, ts_ms, seq])
    s_dev = sorted_keys[0]
    s_vals = values[perm.long()]
    rank, _ = segment_ranks(s_dev)
    live = s_dev < m
    d_w = torch.where(live, s_dev, m)  # out-of-bounds rows dropped
    base = gather_fill(wins.cursor, d_w, 0)
    slot = (base + rank) % w
    flat = torch.where(live, d_w * w + slot, m * w)
    data = scatter_drop(wins.data.reshape(m * w, c), flat, s_vals).reshape(m, w, c)
    counts = torch.zeros(m + 1, dtype=torch.int32, device=dev.device)
    counts.index_add_(0, d_w.long(), live.to(torch.int32))
    counts = counts[:m]
    return TelemetryWindows(
        data=data,
        cursor=(wins.cursor + counts) % w,
        filled=wins.filled + counts,
    )


def snapshot_windows(wins: TelemetryWindows) -> torch.Tensor:
    """Time-ordered windows [M, W, C] (oldest first), unrolling each ring at
    its cursor — the model-facing view."""
    m, w, c = wins.data.shape
    t = torch.arange(w, device=wins.cursor.device)
    idx = (wins.cursor.long()[:, None] + t[None, :]) % w   # oldest..newest
    return torch.gather(wins.data, 1, idx[:, :, None].expand(m, w, c))
