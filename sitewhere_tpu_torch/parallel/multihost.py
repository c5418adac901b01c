"""Multi-process bootstrap helpers of the multi-shard engines (port of
``sitewhere_tpu/parallel/multihost.py``).

* :func:`initialize` joins a ``torch.distributed`` job (JAX's
  ``jax.distributed.initialize``); nothing tells a program of a cluster,
  so the address, world size and rank are given, or the process stays
  single.
* :func:`local_shard_ids` — which shards of the job this process feeds.
  A mesh is a list of this process's own ``torch.device``s. JAX numbers
  the shards of one global mesh that spans every process; the port does
  so when the caller names the process ``group`` the shards span: with
  a mesh of the same length in each process, process ``r`` of the group
  owns the global shards ``r * len(mesh) ... (r + 1) * len(mesh) - 1``.
  Without a group the shards are this process's alone, ``0 ...
  len(mesh) - 1``, whatever default group the process has joined for
  other work.
* :func:`assemble_stacked_batch` — the per-shard batches of this
  process's shards, keyed by shard id, each on its shard's device (the
  port's stacked form: a list, one batch a local shard).
* :func:`all_sum` — integers summed over the group (int64 host tensors),
  the cross-process reduction of counts that JAX's global arrays give.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sitewhere_tpu_torch.core.events import EventBatch


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> bool:
    """Join a multi-process job through ``torch.distributed``; returns False
    when single-process (no argument given). ``coordinator_address`` is
    ``host:port`` of rank 0's TCP store, or a ``file://`` URL of a store
    file every process can reach (no port to probe). ``backend`` defaults
    to NCCL with a GPU and gloo without; NCCL refuses two ranks on one
    GPU, so processes that share a card, or that reduce only host
    integers, pass ``"gloo"``. Explicit arguments raise on failure."""
    if coordinator_address is None and num_processes is None and process_id is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator_address, num_processes "
                         "and process_id together")
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = (coordinator_address if coordinator_address.startswith("file://")
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    return True


def group_span(group=None) -> tuple[int, int]:
    """(rank, size) of this process in ``group``, a ``torch.distributed``
    process group (``dist.group.WORLD`` for the default one); (0, 1) for
    None: this process alone."""
    if group is None:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def local_shard_ids(mesh: list[torch.device], group=None) -> list[int]:
    """The shard ids this process feeds: ``rank * len(mesh)`` on, its rank
    in ``group`` (every process's mesh has the same length, as every host
    of a JAX mesh addresses the same number of devices); from 0 without a
    group."""
    off = group_span(group)[0] * len(mesh)
    return list(range(off, off + len(mesh)))


def all_sum(values, group=None) -> list[int]:
    """Integers summed over every process of ``group`` (one all-reduce of
    an int64 host tensor); the values themselves without a group."""
    vals = [int(v) for v in values]
    if group_span(group)[1] == 1:
        return vals
    import torch.distributed as dist

    t = torch.tensor(vals, dtype=torch.int64)
    dist.all_reduce(t, group=group)
    return [int(v) for v in t.tolist()]


def assemble_stacked_batch(mesh: list[torch.device],
                           shard_batches: dict[int, EventBatch],
                           group=None) -> list[EventBatch]:
    """The per-shard batches of a sharded step, each shard's rows copied
    from its host batch (numpy or tensor columns) onto the shard's device.
    ``shard_batches`` maps shard id (:func:`local_shard_ids` over the same
    ``group``) -> that shard's batch and must hold every local shard
    (raises otherwise); the list comes back in local shard order. JAX's
    ``template`` (shapes for a process that owns no shard) has no use:
    every process owns ``len(mesh)`` shards."""
    mine = local_shard_ids(mesh, group)
    missing = set(mine) - set(shard_batches)
    if missing:
        raise ValueError(f"missing batches for local shards {sorted(missing)}")

    def put(x, dev):
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        return t.to(dev)

    return [EventBatch(**{f.name: put(getattr(shard_batches[g], f.name), dev)
                          for f in dataclasses.fields(EventBatch)})
            for g, dev in zip(mine, mesh)]
