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
  for another shard count;
* the cluster planes — ``cluster`` (``ClusterEngine``, a facade that
  routes, forwards and fans out over ranks of ``DistributedEngine`` on
  loopback or network RPC), ``forward`` (durable cross-rank forwarding),
  ``replication`` (standby stores, failover reads, fire-over),
  ``placement`` (the epoch-fenced slot map, handoff, join and drain),
  ``entity_sync`` (the replicated entity plane), ``cluster_reshard``
  (offline rank-count change), ``rank_runtime`` (one rank from one
  config) and ``cluster_demo`` (the two-process job).
"""
