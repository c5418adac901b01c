"""Host-side batch router: the token-keyed partitioner (port of
``sitewhere_tpu/parallel/router.py``).

Each decoded event is staged into the buffer of the shard that owns its
token slice (``shard = global_token // tokens_per_shard``, the local id
the remainder), and :meth:`ShardRouter.emit` produces the stacked
``[n_shards, B_local]`` host batch the sharded step consumes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sitewhere_tpu_torch.core.events import EventBatch, HostEventBuffer


def stack_host_batches(batches: list[EventBatch]) -> EventBatch:
    """Host (numpy) batches of one capacity stacked on a leading shard
    axis."""
    return EventBatch(**{f.name: np.stack([getattr(b, f.name) for b in batches])
                         for f in dataclasses.fields(EventBatch)})


class ShardRouter:
    """Per-shard staging buffers and stacked emission."""

    def __init__(self, n_shards: int, tokens_per_shard: int, batch_capacity: int,
                 channels: int = 8):
        self.n_shards = n_shards
        self.tokens_per_shard = tokens_per_shard
        self.buffers = [HostEventBuffer(batch_capacity, channels) for _ in range(n_shards)]

    def append(self, etype: int, global_token: int, tenant_id: int, ts_ms: int,
               received_ms: int, values=(), aux0: int = -1, aux1: int = -1) -> bool:
        shard = global_token // self.tokens_per_shard
        if not 0 <= shard < self.n_shards:
            return False  # host-side dead letter: token outside the global space
        local = global_token % self.tokens_per_shard
        return self.buffers[shard].append(
            etype, local, tenant_id, ts_ms, received_ms, values, aux0, aux1)

    @property
    def any_full(self) -> bool:
        return any(b.full for b in self.buffers)

    def total_staged(self) -> int:
        return sum(len(b) for b in self.buffers)

    def emit(self) -> EventBatch:
        """Stack the per-shard batches into host [n_shards, B_local, ...]
        columns and reset the buffers."""
        return stack_host_batches([b.emit_host() for b in self.buffers])
