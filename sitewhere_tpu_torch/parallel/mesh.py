"""The shard mesh of the multi-shard engines (port of
``sitewhere_tpu/parallel/mesh.py``).

JAX builds a 1-D ``Mesh`` over its devices and places a stacked
``[n_shards, ...]`` state on it through a ``NamedSharding`` of the leading
axis. Eager torch has no sharding object: the mesh is the ordered list of
``torch.device``s the shards live on, one per shard, and a multi-shard
engine keeps one state per shard on its shard's device
(``parallel/sharded.py``). That placement takes the place of JAX's
``shard_leading`` / ``stack_sharding``: shard ``s`` of a stacked value
lives on ``mesh[s]``, and each per-shard tensor is moved there with
``.to(mesh[s])``. ``make_mesh`` is the one placement rule of both
engines: a bare ``"cuda"`` spreads the shards over the visible GPUs in
turn (one card holds them all), any other device holds every shard.
"""

from __future__ import annotations

import torch

from sitewhere_tpu_torch.compat import resolve_device

SHARD_AXIS = "shard"


def make_mesh(n_shards: int | None = None,
              devices: list | str | torch.device = "cuda") -> list[torch.device]:
    """The devices of ``n_shards`` shards, in shard order. ``devices`` is a
    list, taken as it is (the same device repeated included; ``n_shards``
    defaults to its length, more shards than devices raises), or one
    device: a bare ``"cuda"`` puts shard ``s`` on GPU ``s % n_gpus`` of the
    visible ones (``n_shards`` defaults to ``n_gpus``), and raises when no
    GPU is visible (there is no CPU default); any other device holds every
    shard (``n_shards`` defaults to 1)."""
    if not isinstance(devices, (list, tuple)):
        dev = resolve_device(devices)
        if dev.type == "cuda" and dev.index is None:
            n_gpus = torch.cuda.device_count()
            n = n_shards or n_gpus
            devices = [torch.device("cuda", i % n_gpus) for i in range(n)]
        else:
            devices = [dev] * (n_shards or 1)
    devs = [resolve_device(d) for d in devices]
    if n_shards is None:
        n_shards = len(devs)
    if not 1 <= n_shards <= len(devs):
        raise ValueError(f"make_mesh: {n_shards} shards over {len(devs)} devices")
    return devs[:n_shards]
