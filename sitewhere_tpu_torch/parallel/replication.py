"""Replication posture (port of ``sitewhere_tpu/parallel/replication.py``,
its health payload only).

The replica feed, the standby applier and failover belong to the cluster
planes, which the port has not taken yet; what the servers and the debug
bundle read of them is this one payload, and every engine of the port
answers it with ``{"clustered": False}``."""

from __future__ import annotations


def cluster_health_payload(engine) -> dict:
    """Rank-LOCAL health/replication view (no peer fan-out — it must
    answer instantly mid-partition): peer up/suspect/down states, the
    feed's posture, and each standby's staleness watermark. The ONE
    payload behind REST /api/instance/cluster/health, the
    Instance.clusterHealth RPC, and Cluster.health."""
    health = getattr(engine, "health", None)
    if health is None:
        return {"clustered": False}
    out = {"clustered": True, "rank": engine.rank,
           "health": health.snapshot(),
           "replicationFactor": getattr(engine, "replication_factor", 1)}
    feed = getattr(engine, "replica_feed", None)
    if feed is not None:
        out["feed"] = feed.metrics()
    applier = getattr(engine, "replica_applier", None)
    if applier is not None:
        out["standbys"] = applier.standbys_status()
    return out
