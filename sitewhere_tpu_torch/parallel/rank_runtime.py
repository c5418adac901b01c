"""One-call rank bootstrap: ``run_rank(config)`` composes a whole rank.

The reference never hand-wires a service: its microservice framework
composes Kafka pipeline, gRPC server, tenant engines, and lifecycle in one
bootstrap (service-inbound-processing/.../InboundProcessingMicroservice.java:94-111
builds the full component graph; the k8s operator just runs it). An earlier
cluster demo hand-wired ~10 pieces per rank instead — engine, cluster RPC
loop/thread, instance, REST, command service, search index, sweep loops —
and a partial wiring (no command service, no search index, shared RPC/REST
event loop) surfaced only at the first failing RPC. This module is that
framework bootstrap for the port:

  * builds (or crash-recovers) the rank's DistributedEngine, wraps it in
    the ClusterEngine router, composes the full SiteWhereTpuInstance over
    it, and VALIDATES the wiring before serving — a missing command
    service, missing search index, or WAL-less durable rank fails at
    startup with a list of problems, not at the first cross-rank call;
  * serves the cluster RPC on its OWN event loop (deployment rule 1 in
    parallel/cluster.py — a shared loop deadlocks two fanning-out ranks),
    and the REST gateway + background pumps (outbound, rank-LOCAL
    presence sweep, analytics) + scheduler tick on a second loop;
  * exposes readiness at the public ``/api/instance/health`` route: the
    rank, peers, and component statuses appear there the moment the rank
    can serve (the reference's k8s readiness probe).

``spawn_cluster_demo`` and the cluster tests boot ranks through this
entry point, so the demo is configuration + ``run_rank``, nothing else.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import pathlib
import threading

from sitewhere_tpu_torch.instance.instance import InstanceConfig, SiteWhereTpuInstance
from sitewhere_tpu_torch.parallel.cluster import (ClusterConfig, ClusterEngine,
                                            build_cluster_rpc)
from sitewhere_tpu_torch.parallel.distributed import recover_distributed

logger = logging.getLogger(__name__)


class RankWiringError(RuntimeError):
    """The composed rank is not a complete product node; raised at
    startup with every problem listed (fail fast, fail loud)."""


@dataclasses.dataclass
class RankConfig:
    """Everything one rank needs — the cluster topology plus the local
    serving surfaces. The rank's engine, a recovered one and its
    standbys live on ``cluster.engine.device``."""

    cluster: ClusterConfig
    instance: InstanceConfig = dataclasses.field(default_factory=InstanceConfig)
    rest_host: str = "127.0.0.1"
    rest_port: int = 0                  # 0 = ephemeral
    rpc_host: str = "127.0.0.1"
    instance_rpc_port: int | None = None  # control-plane RPC (rpc/server.py)
    snapshot_dir: str | None = None     # recover from here when it exists
    presence_interval_s: float = 600.0
    analytics_interval_s: float = 5.0
    scheduler_tick_s: float = 1.0
    require_wal: bool = True            # a durable rank must journal ingest
    entity_log_dir: str | None = None   # entity-op journal; None derives
                                        # "<wal_dir>-entities"
    entity_sync_interval_s: float = 5.0  # anti-entropy pull period
    forward_dir: str | None = None      # cross-rank spill queue; None
                                        # derives "<wal_dir>-forward"
    forward_retry_interval_s: float = 0.5
    forward_retry_budget_s: float = 300.0
    # event-plane replication (RF>=2): each rank streams its WAL-durable
    # ingest to rf-1 followers; their standbys serve reads + schedule
    # fire-over while this rank is dead. 1 disables.
    replication_factor: int = 2
    replica_dir: str | None = None      # feed state (epoch); None derives
                                        # "<wal_dir>-replica"
    replica_heartbeat_s: float = 0.5
    replica_detect_s: float = 5.0       # feed-silence budget before a
                                        # follower declares the owner dead


class _LoopThread:
    """A dedicated event loop on a daemon thread (the cluster RPC and the
    REST gateway each get one — deployment rule 1)."""

    def __init__(self, name: str):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name=name, daemon=True)
        self.thread.start()

    def run(self, coro, timeout_s: float = 60.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout_s)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)


def _validate_wiring(cfg: RankConfig, cluster: ClusterEngine,
                     inst: SiteWhereTpuInstance) -> None:
    problems = []
    if cluster.command_service is None:
        problems.append(
            "no command-delivery service attached: cross-rank "
            "invocations (Cluster.invokeCommand) would fail at the first "
            "routed command")
    if cluster.search_index is None:
        problems.append(
            "no event-search index attached: Cluster.searchEvents from "
            "peers would return None and every cluster-wide search "
            "would fail loudly")
    if cfg.require_wal and not cfg.cluster.engine.wal_dir:
        problems.append(
            "no WAL configured (cluster.engine.wal_dir): a crash loses "
            "every event since the last snapshot — set require_wal=False "
            "only for throwaway ranks")
    n = cfg.cluster.n_ranks
    if len(cfg.cluster.peers) != n:
        problems.append(
            f"peers list has {len(cfg.cluster.peers)} entries for "
            f"n_ranks={n}")
    if not 0 <= cfg.cluster.rank < n:
        problems.append(f"rank {cfg.cluster.rank} outside 0..{n - 1}")
    if problems:
        raise RankWiringError(
            "rank wiring incomplete:\n  - " + "\n  - ".join(problems))


class RankRuntime:
    """A running rank: engine + cluster RPC + REST + pumps + scheduler.
    ``stop()`` tears everything down in reverse order."""

    def __init__(self, cfg: RankConfig, cluster: ClusterEngine,
                 inst: SiteWhereTpuInstance, recovered: bool,
                 replicator=None):
        self.cfg = cfg
        self.cluster = cluster
        self.instance = inst
        self.recovered = recovered
        self.replicator = replicator
        self.rank = cfg.cluster.rank
        self.rest_port: int | None = None
        self.instance_rpc_port: int | None = None
        self._rpc_loop: _LoopThread | None = None
        self._main_loop: _LoopThread | None = None
        self._cluster_srv = None
        self._instance_srv = None
        self._server_handle = None
        self._bg_tasks: list = []
        self._stopped = False

    # -- composed by run_rank ---------------------------------------------
    def _serve(self) -> None:
        cfg = self.cfg
        secret = cfg.cluster.secret
        rpc_port = int(cfg.cluster.peers[self.rank].rsplit(":", 1)[1])

        # 1) cluster data-plane RPC on its OWN loop: handlers bind to the
        # local engine only, so this loop can always answer a peer even
        # while the REST loop blocks inside a fan-out (rule 1)
        self._rpc_loop = _LoopThread(f"rank{self.rank}-cluster-rpc")
        self._cluster_srv = build_cluster_rpc(self.cluster.local, secret)
        if self.replicator is not None:
            # the entity-replication surface rides the same
            # authenticated cluster RPC server
            self.replicator.register_rpc(self._cluster_srv)
        if self.cluster.replica_applier is not None:
            from sitewhere_tpu_torch.parallel.replication import (
                register_replication_rpc)

            register_replication_rpc(self._cluster_srv,
                                     self.cluster.replica_applier)
        self._rpc_loop.run(
            self._cluster_srv.start(host=cfg.rpc_host, port=rpc_port))

        # 2) optional instance control-plane RPC (all 9 API families)
        if cfg.instance_rpc_port is not None:
            from sitewhere_tpu_torch.rpc.server import build_instance_rpc

            self._instance_srv = build_instance_rpc(self.instance)
            self._rpc_loop.run(self._instance_srv.start(
                host=cfg.rpc_host, port=cfg.instance_rpc_port))
            self.instance_rpc_port = self._instance_srv.port

        # 3) REST gateway + background pumps + scheduler on the serving
        # loop; instance lifecycle drives every child component
        from sitewhere_tpu_torch.web.rest import start_server

        self._main_loop = _LoopThread(f"rank{self.rank}-serving")

        async def boot():
            await self.instance.initialize()
            await self.instance.start()
            handle = await start_server(
                self.instance, cfg.rest_host, cfg.rest_port,
                analytics_interval_s=cfg.analytics_interval_s,
                presence_interval_s=cfg.presence_interval_s)
            self.instance.scheduler.tick_s = cfg.scheduler_tick_s
            await self.instance.scheduler.start()
            if self.replicator is not None and cfg.cluster.n_ranks > 1:
                rep = self.replicator

                async def entity_sync_loop():
                    # pull-based anti-entropy: catches up everything this
                    # rank missed while down (pushes it never saw) and
                    # the initial cold-start backlog, without blocking
                    # startup on unreachable peers
                    while True:
                        try:
                            await asyncio.to_thread(rep.sync_from_peers,
                                                    True)
                            # the pull refreshed every peer's receipt
                            # vector — the safe horizon tombstone GC
                            # needs (never resurrects: see gc_tombstones)
                            await asyncio.to_thread(rep.gc_tombstones)
                        except Exception:
                            logger.exception("entity anti-entropy failed")
                        await asyncio.sleep(cfg.entity_sync_interval_s)

                self._bg_tasks.append(
                    asyncio.create_task(entity_sync_loop()))
            return handle

        self._server_handle = self._main_loop.run(boot())
        self.rest_port = self._server_handle.port
        if self.cluster.forward_queue is not None:
            self.cluster.forward_queue.start()   # background redelivery
        if self.cluster.replica_feed is not None:
            self.cluster.replica_feed.start()    # follower streaming
        # readiness surfaces on the public health route
        self.instance.health_extra = {
            "rank": self.rank,
            "nRanks": cfg.cluster.n_ranks,
            "peers": list(cfg.cluster.peers),
            "recovered": self.recovered,
            "restPort": self.rest_port,
            "clusterRpcPort": rpc_port,
            "ready": True,
        }

    def pump_outbound(self) -> int:
        """Drive one outbound pump synchronously (tests/demos; the
        background pump loop does this continuously)."""
        return self._main_loop.run(self.instance.pump_outbound())

    def run_on_serving_loop(self, coro, timeout_s: float = 60.0):
        return self._main_loop.run(coro, timeout_s)

    def hard_kill(self) -> None:
        """Simulated SIGKILL for chaos tests: sever every serving socket
        and background thread WITHOUT flushing, saving, or closing the
        engine — on-disk state is left exactly as a real kill would
        (whatever the WAL fsync'd). The process-local python objects are
        abandoned; recovery is ``run_rank`` over the same dirs."""
        self._stopped = True
        if self.cluster.replica_feed is not None:
            self.cluster.replica_feed.stop()
        if self.cluster.forward_queue is not None:
            self.cluster.forward_queue.stop()
        if self._rpc_loop is not None:
            for srv in (self._instance_srv, self._cluster_srv):
                if srv is not None:
                    try:
                        self._rpc_loop.run(srv.stop(), 10.0)
                    except Exception:
                        pass
            self._rpc_loop.close()
        if self._main_loop is not None:
            self._main_loop.close()
        self.cluster.close()

    def stop(self, timeout_s: float = 30.0) -> None:
        if self._stopped:
            return
        self._stopped = True
        if self._main_loop is not None:
            async def teardown():
                for task in self._bg_tasks:
                    task.cancel()
                for task in self._bg_tasks:
                    try:
                        await task
                    except (asyncio.CancelledError, Exception):
                        pass
                await self.instance.scheduler.stop()
                if self._server_handle is not None:
                    await self._server_handle.cleanup()
                await self.instance.stop()

            try:
                self._main_loop.run(teardown(), timeout_s)
            finally:
                self._main_loop.close()
        if self._rpc_loop is not None:
            try:
                for srv in (self._instance_srv, self._cluster_srv):
                    if srv is not None:
                        self._rpc_loop.run(srv.stop(), timeout_s)
            finally:
                self._rpc_loop.close()
        if self.replicator is not None:
            self.replicator.close()
        if self.cluster.replica_feed is not None:
            self.cluster.replica_feed.stop()
        if self.cluster.replica_applier is not None:
            self.cluster.replica_applier.close()
        if self.cluster.forward_queue is not None:
            self.cluster.forward_queue.stop()
        reg = getattr(self.cluster.local, "spill_registry", None)
        if reg is not None:
            reg.close()
        self.cluster.close()


def run_rank(cfg: RankConfig) -> RankRuntime:
    """Compose and serve one rank. Crash-recovers from
    ``cfg.snapshot_dir`` + the WAL when a snapshot exists there;
    validates the wiring BEFORE serving; returns a running
    ``RankRuntime``."""
    local = None
    recovered = False
    if cfg.snapshot_dir is not None and (
            pathlib.Path(cfg.snapshot_dir) /
            "sharded_manifest.json").exists():
        # adopt_wal: a serving rank must journal new ingest even when the
        # snapshot (migrated/resharded) carries no wal_dir of its own
        local = recover_distributed(cfg.snapshot_dir,
                                    cfg.cluster.engine.wal_dir,
                                    adopt_wal=True,
                                    device=cfg.cluster.engine.device)
        recovered = True
    elif cfg.cluster.engine.wal_dir and sorted(
            pathlib.Path(cfg.cluster.engine.wal_dir).glob("segment-*.log")
            if pathlib.Path(cfg.cluster.engine.wal_dir).exists() else []):
        # no snapshot but a WAL from a previous life: cold recovery is
        # replay-from-empty (recover_distributed handles snapshot=None
        # via the WAL alone only when given a snapshot dir; here the
        # fresh engine replays because DistributedEngine re-opens the
        # WAL and the caller migrates explicitly). Flag it rather than
        # silently double-logging history into the live WAL.
        logger.warning(
            "rank %d: WAL %s exists but no snapshot at %s — starting "
            "FRESH over the existing log (records are preserved; run "
            "recovery explicitly to replay them)", cfg.cluster.rank,
            cfg.cluster.engine.wal_dir, cfg.snapshot_dir)
    cluster = None
    replicator = None
    try:
        cluster = ClusterEngine(cfg.cluster, local=local)
        inst = SiteWhereTpuInstance(cfg.instance, engine=cluster)
        _validate_wiring(cfg, cluster, inst)
        from sitewhere_tpu_torch.parallel.entity_sync import EntityReplicator

        elog = cfg.entity_log_dir
        if elog is None and cfg.cluster.engine.wal_dir:
            wd = pathlib.Path(cfg.cluster.engine.wal_dir)
            elog = str(wd.with_name(wd.name + "-entities"))
        replicator = EntityReplicator(cluster, inst, log_dir=elog)
        replicator.attach()   # replays the journal (SIGKILL recovery)
        if cfg.cluster.n_ranks > 1:
            from sitewhere_tpu_torch.parallel.forward import (ForwardQueue,
                                                        SpillRegistry)

            fdir = cfg.forward_dir
            if fdir is None and cfg.cluster.engine.wal_dir:
                wd = pathlib.Path(cfg.cluster.engine.wal_dir)
                fdir = str(wd.with_name(wd.name + "-forward"))
            if fdir is not None:
                cluster.attach_forwarding(
                    ForwardQueue(
                        cluster, fdir,
                        retry_interval_s=cfg.forward_retry_interval_s,
                        retry_budget_s=cfg.forward_retry_budget_s),
                    SpillRegistry(pathlib.Path(fdir) / "registry"))
        if cfg.cluster.n_ranks > 1 and cfg.replication_factor > 1:
            rdir = cfg.replica_dir
            if rdir is None and cfg.cluster.engine.wal_dir:
                wd = pathlib.Path(cfg.cluster.engine.wal_dir)
                rdir = str(wd.with_name(wd.name + "-replica"))
            if rdir is None:
                logger.warning(
                    "rank %d: replication_factor=%d requested but no WAL/"
                    "replica dir — event-plane replication disabled "
                    "(the feed ships WAL-durable batches; a WAL-less "
                    "rank has nothing durable to ship)",
                    cfg.cluster.rank, cfg.replication_factor)
            else:
                from sitewhere_tpu_torch.parallel.replication import (
                    ReplicaApplier, ReplicaFeed, install_fireover)

                feed = ReplicaFeed(cluster, rdir,
                                   rf=cfg.replication_factor,
                                   heartbeat_s=cfg.replica_heartbeat_s)
                applier = ReplicaApplier(cluster,
                                         rf=cfg.replication_factor,
                                         detect_s=cfg.replica_detect_s)
                cluster.attach_replication(feed, applier)
                # a fenced leader pulls entity state (follower-updated
                # schedule fired marks) before resuming its own firing
                rep = replicator
                feed.on_fenced = lambda: rep.sync_from_peers(True)
                install_fireover(inst.scheduler, cluster)
    except Exception:
        # fail-fast must not leak the constructed engine or journals: a
        # supervisor retrying run_rank in-process would otherwise
        # accumulate open segment handles on every attempt
        if replicator is not None:
            replicator.close()
        eng = cluster.local if cluster is not None else local
        if cluster is not None:
            cluster.close()
        if eng is not None and getattr(eng, "wal", None) is not None:
            eng.wal.close()
        raise
    rt = RankRuntime(cfg, cluster, inst, recovered, replicator=replicator)
    try:
        rt._serve()
    except Exception:
        rt.stop()
        raise
    logger.info("rank %d serving: REST :%s, cluster RPC %s",
                cfg.cluster.rank, rt.rest_port,
                cfg.cluster.peers[cfg.cluster.rank])
    return rt
