"""Event routing across shards: bucket by owner, then all-to-all (port of
``sitewhere_tpu/parallel/exchange.py``).

When the ingest hosts cannot pre-route, each shard buckets its raw batch
by owning shard (token slice) into fixed-capacity buckets, and one
all-to-all delivers every bucket to its owner. JAX runs that as
``lax.all_to_all`` inside ``shard_map``; here the shards are one
process's list of per-shard batches, so the all-to-all is the transpose
of the ``[n_src, n_dst, bucket]`` buckets: destination ``d`` receives
bucket ``d`` of every source, in source order, copied to ``d``'s device
where the shards sit on different devices.

Buckets hold ``bucket`` rows per destination (static shapes); rows past
a full bucket are counted in ``n_overflow`` and dropped to the host
dead-letter path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sitewhere_tpu_torch.compat import scatter_drop
from sitewhere_tpu_torch.core.events import EventBatch
from sitewhere_tpu_torch.core.types import NULL_ID
from sitewhere_tpu_torch.ops.segment import lex_argsort, segment_ranks


class ExchangeResult(NamedTuple):
    batch: EventBatch           # locally owned events after the exchange
    n_overflow: torch.Tensor    # int32[] events dropped for bucket overflow


def _bucket_events(batch: EventBatch, n_shards: int, tokens_per_shard: int,
                   bucket: int) -> tuple[EventBatch, torch.Tensor]:
    """One source shard's events in [n_shards * bucket] rows grouped by
    owner, each group in ``seq`` order; the overflow count."""
    dev = batch.valid.device
    target = torch.where(batch.valid,
                         torch.div(batch.token_id, tokens_per_shard, rounding_mode="floor"),
                         n_shards)
    target = torch.clamp(target, 0, n_shards).to(torch.int32)  # garbage -> padding
    _, perm = lex_argsort([target, batch.seq])
    perm = perm.long()
    s_target = target[perm]
    rank, _ = segment_ranks(s_target)
    live = s_target < n_shards
    fits = live & (rank < bucket)
    n_overflow = (live & (rank >= bucket)).sum(dtype=torch.int32)
    slot = torch.where(fits, s_target * bucket + rank, n_shards * bucket)

    def scatter(lane, fill):
        shape = (n_shards * bucket,) + tuple(lane.shape[1:])
        return scatter_drop(torch.full(shape, fill, dtype=lane.dtype, device=dev),
                            slot, lane[perm])

    out = EventBatch(
        valid=scatter(batch.valid, False),
        etype=scatter(batch.etype, 0),
        token_id=scatter(batch.token_id, NULL_ID),
        tenant_id=scatter(batch.tenant_id, NULL_ID),
        ts_ms=scatter(batch.ts_ms, 0),
        received_ms=scatter(batch.received_ms, 0),
        values=scatter(batch.values, 0.0),
        vmask=scatter(batch.vmask, False),
        aux=scatter(batch.aux, NULL_ID),
        seq=torch.arange(n_shards * bucket, dtype=torch.int32, device=dev),
    )
    return out, n_overflow


def exchange_events(batches: list[EventBatch], n_shards: int, tokens_per_shard: int,
                    bucket: int) -> list[ExchangeResult]:
    """Route every shard's events to their owning shard. ``batches[s]`` is
    source shard ``s``'s batch (global token ids) on its device; returns,
    for each destination shard, its locally owned batch (capacity
    ``n_shards * bucket``, on the destination's device) with local token
    ids (the owner's offset subtracted), and the overflow count of that
    shard's own bucketing, as JAX's does."""
    if len(batches) != n_shards:
        raise ValueError(f"{len(batches)} batches for {n_shards} shards")
    bucketed = [_bucket_events(b, n_shards, tokens_per_shard, bucket) for b in batches]
    out = []
    for d in range(n_shards):
        dev = batches[d].valid.device
        lo, hi = d * bucket, (d + 1) * bucket
        cols = {f.name: torch.cat([getattr(src, f.name)[lo:hi].to(dev)
                                   for src, _ in bucketed])
                for f in dataclasses.fields(EventBatch) if f.name != "seq"}
        cols["seq"] = torch.arange(n_shards * bucket, dtype=torch.int32, device=dev)
        cols["token_id"] = torch.where(cols["valid"],
                                       cols["token_id"] - d * tokens_per_shard,
                                       NULL_ID).to(torch.int32)
        out.append(ExchangeResult(batch=EventBatch(**cols), n_overflow=bucketed[d][1]))
    return out
