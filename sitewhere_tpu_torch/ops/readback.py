"""Host readback of event-store ranges (port of
``sitewhere_tpu/ops/readback.py``).

Consumers read ranges of the device ring store by absolute cursor — the
offset-committed contract of a Kafka consumer group without the broker.
``read_range`` gathers [start, start+count) of one arena (wrapping).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sitewhere_tpu_torch.core.store import EventStore


class StoreSlice(NamedTuple):
    etype: torch.Tensor
    device: torch.Tensor
    assignment: torch.Tensor
    tenant: torch.Tensor
    area: torch.Tensor
    customer: torch.Tensor
    asset: torch.Tensor
    ts_ms: torch.Tensor
    received_ms: torch.Tensor
    values: torch.Tensor
    vmask: torch.Tensor
    aux: torch.Tensor
    valid: torch.Tensor


def read_range(store: EventStore, start: int | torch.Tensor, count: int,
               arena: int = 0) -> StoreSlice:
    """Gather ``count`` rows of one arena beginning at its arena-local
    position ``start % (S/A)`` (arena 0 of a 1-arena store = the whole
    ring)."""
    s = store.arena_capacity
    pos = torch.arange(count, dtype=torch.int32, device=store.valid.device)
    idx = (arena * s + (start + pos) % s).long()
    return StoreSlice(*(getattr(store, f)[idx] for f in StoreSlice._fields))


def slice_to_host(sl: StoreSlice) -> StoreSlice:
    """The slice's columns as numpy arrays. From the card they move in one
    device-to-host copy: the columns packed as bytes into one buffer, the
    widest element type first, so every column starts aligned."""
    cols = [c.contiguous() for c in sl]
    if cols[0].device.type == "cpu":
        return StoreSlice(*(c.numpy() for c in cols))
    order = sorted(range(len(cols)), key=lambda i: -cols[i].element_size())
    flat = torch.cat([cols[i].view(torch.uint8).reshape(-1) for i in order]).cpu()
    out: list = [None] * len(cols)
    off = 0
    for i in order:
        c = cols[i]
        nb = c.numel() * c.element_size()
        out[i] = flat[off:off + nb].view(c.dtype).reshape(c.shape).numpy()
        off += nb
    return StoreSlice(*out)


def absolute_cursor(store: EventStore) -> int:
    """Total events ever written, summed over arenas — monotone under
    appends, the durable-watermark scalar."""
    epochs = store.epoch.cpu().long()
    cursors = store.cursor.cpu().long()
    return int((epochs * store.arena_capacity + cursors).sum())


def arena_cursor(store: EventStore, arena: int) -> int:
    """One arena's absolute write count (epoch*arena_capacity + cursor)."""
    return (int(store.epoch[arena]) * store.arena_capacity
            + int(store.cursor[arena]))
