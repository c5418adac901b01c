"""The multi-shard side of the port (``sitewhere_tpu/parallel/``):

* ``sharded`` — ``SpmdEngine``, the engine over several shards (one state
  a shard, each on its device of the mesh; every shard on one card, or one
  a GPU), and the stripped-down ``ShardedEngine``; ``mesh``, ``router``,
  ``exchange``, ``placement`` (the token slot map) and ``multihost`` are
  what they stand on;
* ``ring_attention`` — sequence parallelism over ``torch.distributed``;
* ``distributed`` — ``DistributedEngine``, the mesh product engine (string
  tokens routed ``gid % n_shards``, admin, reads, the feed, snapshot and
  WAL recovery) over ``ShardedEngine``; ``reshard`` rewrites its snapshot
  for another shard count.

The cluster planes are not ported yet.
"""
