"""Multi-process bootstrap helpers of the multi-shard engines (port of
``sitewhere_tpu/parallel/multihost.py``).

* :func:`initialize` joins a ``torch.distributed`` job (JAX's
  ``jax.distributed.initialize``); nothing tells a program of a cluster,
  so the address, world size and rank are given, or the process stays
  single.
* :func:`local_shard_ids` — which shards of a mesh this process feeds. A
  mesh is a list of this process's ``torch.device``s, so every shard of
  it is local.
* :func:`assemble_stacked_batch` — the per-shard batches, each on its
  shard's device (the port's stacked form: a list, one batch a shard).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sitewhere_tpu_torch.core.events import EventBatch


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join a multi-process job through ``torch.distributed`` (NCCL with a
    GPU, gloo without); returns False when single-process (no argument
    given). ``coordinator_address`` is ``host:port`` of rank 0's store.
    Explicit arguments raise on failure."""
    if coordinator_address is None and num_processes is None and process_id is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator_address, num_processes "
                         "and process_id together")
    import torch.distributed as dist

    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id)
    return True


def local_shard_ids(mesh: list[torch.device]) -> list[int]:
    """The shard indices this process feeds: all of a mesh of its own
    devices."""
    return list(range(len(mesh)))


def assemble_stacked_batch(mesh: list[torch.device],
                           shard_batches: dict[int, EventBatch]) -> list[EventBatch]:
    """The per-shard batches of a sharded step, each shard's rows copied
    from its host batch (numpy or tensor columns) onto the shard's device.
    ``shard_batches`` maps shard index -> that shard's batch and must hold
    every local shard (raises otherwise). JAX's ``template`` (shapes for a
    process that owns no shard) has no use: every shard of a mesh is
    local."""
    mine = local_shard_ids(mesh)
    missing = set(mine) - set(shard_batches)
    if missing:
        raise ValueError(f"missing batches for local shards {sorted(missing)}")

    def put(x, dev):
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        return t.to(dev)

    return [EventBatch(**{f.name: put(getattr(shard_batches[i], f.name), mesh[i])
                          for f in dataclasses.fields(EventBatch)})
            for i in mine]
