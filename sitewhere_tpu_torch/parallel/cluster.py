"""Multi-process product runtime: DistributedEngine replicas + router.

The reference deploys every service as horizontally scaled replicas over
partitioned Kafka consumer groups — each replica runs the FULL product
behavior for its partitions
(service-outbound-connectors/.../kafka/KafkaOutboundConnectorHost.java:43-257),
and gRPC routers dispatch calls into the right engine from any node
(service-device-state/.../grpc/DeviceStateRouter.java:62-72). This module
is that deployment model for the port:

  * every rank runs a complete ``DistributedEngine`` — string tokens, WAL,
    archive, feeds — over ITS chips, for the devices it OWNS;
  * ownership is a stable hash of the device-token STRING
    (``owner_rank``), not interner order — so every rank routes the same
    token to the same owner without any shared state. This is the
    token-keyed Kafka partitioner (EventSourcesManager.java:183) applied
    at the process level;
  * ingest accepted at any rank forwards the raw payload bytes of
    remote-owned events to their owner over the authenticated control
    RPC (rpc/protocol.py) — decode, WAL, dedup, and registration all
    happen exactly once, AT the owner, in its own dictionary space.
    Interner federation therefore needs no cross-rank translation
    tables: the owning rank's interners are authoritative by
    construction (route-then-decode, like a Kafka producer sending raw
    bytes to the partition's broker);
  * reads from any rank route (device/state lookups → owner) or fan out
    and merge (event queries, state search, metrics) — the
    ``DeviceStateRouter`` pattern — so REST served from ANY rank returns
    identical results;
  * event ids are cluster-global: ``local_id * n_ranks + rank`` —
    bijective, so by-id lookups route without coordination.

Within a rank, scaling stays on the card (ShardedEngine's per-shard
steps); ACROSS ranks the data plane is this replica model over the
network, mirroring Kafka's role at the host boundary (SURVEY.md §2.9).

Deployment rules:

1. Serve the cluster RPC on its OWN event loop (thread), separate from
   any loop whose handlers call the ClusterEngine facade (e.g. the REST
   gateway). Facade calls block synchronously on peer RPC; if the
   blocked loop is also the only one answering incoming cluster RPC,
   two ranks fanning out at each other deadlock. ``register_cluster_rpc``
   handlers bind to the local engine only, so a dedicated RPC loop can
   always answer (cluster_demo.py wires it this way).
2. Scope: this layer clusters the ENGINE surface — devices, events,
   state, feeds, metrics. Instance-level management entities (device
   types, areas/customers, assets, schedules, users/tenants) live in
   each rank's EntityStores, mirroring how the reference keeps them in
   per-service databases shared by replicas: in a multi-rank deployment,
   apply management mutations through the instance control-plane RPC
   (rpc/server.py build_instance_rpc — every family is exposed) against
   each rank, the way the reference's per-service gRPC is reachable
   from every node. Tenant LANES need no broadcast: forwarded ingest
   interns the tenant at the owner, and fan-out queries resolve tenant
   names rank-locally.
3. Rank count is part of the topology (ownership = token-hash %
   n_ranks, exactly Kafka's partition semantics): change it like a
   topology change — drain, stand up the new rank set, and migrate with
   ``reshard_cluster`` (replay every old rank's WAL through the new
   partitioner: each event re-routes exactly once to its new owner and
   re-logs in that owner's WAL) — not by adding ranks to a live cluster.

A port of ``sitewhere_tpu/parallel/cluster.py``. Each rank's engine is
the port's ``DistributedEngine`` on ``ClusterConfig.engine.device`` (the
card unless the caller asks for the CPU). A cluster enters that engine
from threads that did not build it — the RPC loop, the forward pump,
off-loop handoff work — so the rank's RPC server (``CardRpcServer``) and
the pump run their engine calls under the CUDA streams current where
the rank was built (``card_streams``), as the wire edge's flusher does.
``owner_rank`` is ``placement.owner_rank``: one slot map for both.
"""

from __future__ import annotations

import asyncio
import base64
import concurrent.futures
import dataclasses
import functools
import inspect
import logging
import threading
import time
from pathlib import Path as pathlib_Path
from typing import Any

from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import AssignmentInfo, DeviceInfo
from sitewhere_tpu_torch.search.index import event_order_key
from sitewhere_tpu_torch.parallel.distributed import (DistributedConfig,
                                                      DistributedEngine)
# one slot map for both packages' layouts: placement.py owns the hash
from sitewhere_tpu_torch.parallel.placement import owner_rank  # noqa: F401
from sitewhere_tpu_torch.rpc.server import RpcServer
from sitewhere_tpu_torch.utils.streams import card_streams, on_streams

logger = logging.getLogger(__name__)

# resolved once, like replication's instruments: the forward-hop
# histogram sits on the per-sub-batch forward path
_CLUSTER_INSTRUMENTS: dict | None = None


def _cluster_instruments() -> dict:
    global _CLUSTER_INSTRUMENTS
    if _CLUSTER_INSTRUMENTS is None:
        from sitewhere_tpu_torch.utils.metrics import cluster_metrics_instruments

        _CLUSTER_INSTRUMENTS = cluster_metrics_instruments()
    return _CLUSTER_INSTRUMENTS


def _bind_streams(fn, streams: list):
    """A sync handler ``fn`` run under ``streams``; the signature is kept
    (``functools.wraps``), which the RPC server reads for the tenant and
    attachment parameters. An async handler is returned as it is: the
    loop thread interleaves other tasks, so it hands its engine work to
    a thread under ``on_streams`` itself (``placement.py``)."""
    if not streams or inspect.iscoroutinefunction(fn):
        return fn

    @functools.wraps(fn)
    def bound(*a, **kw):
        with on_streams(streams):
            return fn(*a, **kw)

    return bound


class CardRpcServer(RpcServer):
    """An ``RpcServer`` whose handlers — every one registered on it, by
    any plane — run under fixed CUDA streams."""

    def __init__(self, streams: list, **kw):
        super().__init__(**kw)
        self.streams = list(streams)

    def register(self, name, fn, authority=None) -> None:
        super().register(name, _bind_streams(fn, self.streams), authority)


@dataclasses.dataclass
class ClusterConfig:
    """One rank's view of the cluster. ``n_ranks``/``peers`` are the
    PROVISIONED rank set (addresses known up front, stateful-set style);
    which ranks are ACTIVE — own tenant slots — is the placement map's
    job: ``initial_ranks`` narrows the genesis map to a
    subset so provisioned-but-inactive ranks can JOIN later through the
    epoch-fenced handoff, and :func:`placement.drain_rank` retires an
    active rank under live traffic. ``slots_per_rank`` fixes the slot
    space at genesis (``n_slots = n_ranks * slots_per_rank``); the
    default map is byte-identical to the legacy ``owner_rank``
    partitioner. ``placement_dir`` persists the installed map (defaults
    to ``<wal_dir>/placement`` when the engine journals)."""

    rank: int
    n_ranks: int
    peers: list[str]                  # RPC "host:port" per rank
    secret: str                       # shared JWT secret (cross-rank auth)
    epoch_base_unix_s: float          # ONE epoch base for the whole
                                      # cluster so merged timestamps agree
    engine: DistributedConfig = dataclasses.field(
        default_factory=DistributedConfig)
    connect_timeout_s: float = 30.0
    slots_per_rank: int = 8
    initial_ranks: "list[int] | None" = None
    placement_dir: "str | None" = None


class _SyncPeer:
    """Synchronous facade over one RpcClient: a background event loop owns
    the connection; ``call()`` blocks the calling thread only (the engine
    surface is synchronous, like the reference's blocking gRPC stubs)."""

    def __init__(self, addr: str, token_factory, timeout_s: float = 30.0,
                 src_rank: int = -1, dst_rank: int = -1):
        host, _, port = addr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        # (src, dst) identify this link for the chaos fault seam
        # (utils/faults.py) — a no-op attribute read unless a plan is
        # installed
        self.src_rank, self.dst_rank = src_rank, dst_rank
        # a FACTORY, not a token: JwtService.validate enforces exp, so a
        # token minted once at engine construction would turn every
        # reconnect after its 24h expiry into a permanent 401 — mint
        # fresh per connection attempt instead
        self.token_factory = token_factory
        self.timeout_s = timeout_s
        self.grace_s = 30.0     # server-side processing allowance on top
                                # of the connect timeout
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        daemon=True)
        self._thread.start()
        self._client = None
        self._lock = threading.Lock()

    def _run(self, coro):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(self.timeout_s + self.grace_s)
        except (TimeoutError, concurrent.futures.TimeoutError) as e:
            # the coroutine is still running on the background loop —
            # cancel it so the shared client isn't left with a pending
            # future silently consuming the next response off the wire
            fut.cancel()
            if isinstance(e, TimeoutError):
                raise
            # Python < 3.11: the futures TimeoutError is NOT the builtin
            # one — normalize so every downstream handler catches it
            raise TimeoutError(*e.args) from None

    def _connect(self):
        from sitewhere_tpu_torch.rpc.client import RpcClient

        deadline = time.monotonic() + self.timeout_s
        last: Exception | None = None
        while time.monotonic() < deadline:
            try:
                return self._run(RpcClient(
                    host=self.host, port=self.port,
                    auth_token=self.token_factory()).connect())
            except (ConnectionError, OSError, TimeoutError) as e:
                # TimeoutError: half-open peer accepted TCP but never
                # answered the handshake — retry like any connect failure
                last = e
                time.sleep(0.1)
        raise ConnectionError(
            f"peer {self.host}:{self.port} unreachable: {last}")

    def _reconnect(self, stale) -> "Any":
        """Drop ``stale`` (connection state indeterminate after an error
        or timeout) and return a fresh client. If the fresh connect
        fails, the slot is left empty so the next caller retries from
        scratch instead of reusing a closed client."""
        with self._lock:
            if self._client is stale:
                try:
                    self._run(stale.close())
                except Exception:
                    pass
                self._client = None
            if self._client is None:
                self._client = self._connect()
            return self._client

    def _timed_out(self, client, method: str) -> "Any":
        """A timed-out call is INDETERMINATE: the peer may still be
        executing it, so auto-retrying would double-execute
        non-idempotent RPCs (invokeCommand, registerDevice). Reconnect
        so the NEXT caller gets a clean connection (the cancelled future
        must not eat a later response), then surface the timeout —
        idempotent callers retry themselves."""
        try:
            self._reconnect(client)
        except ConnectionError:
            pass   # slot left empty; the next call() reconnects
        raise TimeoutError(
            f"peer {self.host}:{self.port} timed out on {method} "
            f"after {self.timeout_s + self.grace_s:.1f}s (result "
            "indeterminate — not auto-retried)") from None

    def call(self, method: str, **params: Any) -> Any:
        from sitewhere_tpu_torch.utils import faults

        faults.check(self.src_rank, self.dst_rank, method)
        # capture the CALLING thread's traceparent here: the coroutine
        # runs on the background loop, whose context never sees it —
        # this one line threads trace context through every cluster and
        # entity-sync peer call without touching their call sites
        if "_tp" not in params:
            from sitewhere_tpu_torch.utils.tracing import current_traceparent

            tp = current_traceparent()
            if tp is not None:
                params["_tp"] = tp
        with self._lock:
            if self._client is None:
                self._client = self._connect()
            client = self._client
        try:
            return self._run(client.call(method, **params))
        except ConnectionError:
            # one retry over a fresh connection: the peer may have
            # restarted (crash recovery) — the reference's gRPC channels
            # reconnect the same way
            client = self._reconnect(client)
            try:
                return self._run(client.call(method, **params))
            except TimeoutError:
                # the RETRY timing out needs the same indeterminate
                # handling (an except clause does not catch exceptions
                # raised by its sibling)
                self._timed_out(client, method)
        except TimeoutError:
            self._timed_out(client, method)

    def close(self) -> None:
        with self._lock:
            if self._client is not None:
                try:
                    self._run(self._client.close())
                except Exception:
                    pass
                self._client = None
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)


def _unb64(payloads: list[str]) -> list[bytes]:
    return [base64.b64decode(p) for p in payloads]


def _split_blob(blob: bytes, lens: list) -> list[bytes]:
    """Inverse of the sender's b"".join: one attachment blob back into
    payload list form. Rejects non-integer/negative lengths BEFORE the
    sum check (a float that sums right would silently misalign every
    boundary after int() truncation)."""
    import operator

    lens = [operator.index(n) for n in lens]   # raises on floats/strings
    if any(n < 0 for n in lens) or sum(lens) != len(blob):
        raise ValueError(
            f"attachment length {len(blob)} does not match lens")
    out, off = [], 0
    for n in lens:
        out.append(bytes(blob[off:off + n]))
        off += n
    return out


def _wire_payloads(payloads=None, lens=None, _attachment=None) -> list[bytes]:
    """Payload list from either wire form: raw attachment blob + lens
    (the hot path — no base64, no json escaping) or the b64 list (spill
    records, older senders). An attachment WITHOUT lens is malformed and
    must fail loudly — silently ingesting zero events would report
    success to a sender that shipped data."""
    if _attachment is not None:
        if lens is None:
            raise ValueError("attachment requires lens")
        return _split_blob(_attachment, lens)
    return _unb64(payloads or [])


def _merge_counts(dicts: list[dict]) -> dict:
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = out.get(k, 0) + v
            elif isinstance(v, list):
                out.setdefault(k, []).extend(v)
            else:
                out.setdefault(k, v)
    return out


class _MergedDevices:
    """Read-only merged view of every rank's device mirror
    (``.values()`` / ``len`` fan out to every rank). There is NO by-id
    ``get``: device ids are rank-scoped, so the same integer names a
    DIFFERENT device on every rank — a dict-shaped ``get`` would answer
    from whichever rank it ran on and silently alias. By-id lookups are
    either local by construction (feed/connector/analytics records of
    THIS rank — use ``get_local`` / ``local_device_info``) or routed by
    token (``ClusterEngine.get_device``)."""

    def __init__(self, cluster: "ClusterEngine"):
        self._c = cluster

    def values(self):
        out = _owned_device_infos(self._c.local)
        for r in self._c._data_ranks():
            if r == self._c.rank:
                continue
            out.extend(DeviceInfo(**d) for d in
                       self._c._peer(r).call("Cluster.listDeviceInfos"))
        return out

    def get(self, key, default=None):
        raise TypeError(
            "device ids are rank-local: the same integer names a "
            "different device on every rank, so a cluster-wide by-id "
            "get() cannot exist. Use devices.get_local(id) for records "
            "produced by THIS rank (feeds/connectors/analytics), or "
            "engine.get_device(token) for a routed lookup.")

    def get_local(self, key, default=None):
        """This rank's mirror only — correct for local ids (this rank's
        feed records, analytics tables, dead letters)."""
        return self._c.local.devices.get(key, default)

    def __len__(self) -> int:
        n = len(_owned_device_infos(self._c.local))
        for r in self._c._data_ranks():
            if r != self._c.rank:
                n += self._c._peer(r).call("Cluster.deviceCount")
        return n


class _ClusterFeed:
    """Wraps a rank-local feed consumer, translating event ids to the
    cluster-global id space so records can be re-fetched via
    ``ClusterEngine.get_event`` from ANY rank."""

    def __init__(self, feed, rank: int, n_ranks: int):
        self._feed = feed
        self._rank = rank
        self._n = n_ranks

    def poll(self, *a, **kw):
        return [dataclasses.replace(
            rec, event_id=rec.event_id * self._n + self._rank)
            for rec in self._feed.poll(*a, **kw)]

    def commit(self, events) -> None:
        # commit() decodes (arena, position) from the event id — it must
        # see the LOCAL id, or every commit over-advances ~n_ranks x and
        # silently skips events the consumer never delivered
        self._feed.commit([
            dataclasses.replace(ev, event_id=ev.event_id // self._n)
            for ev in events])

    def __getattr__(self, name):
        return getattr(self._feed, name)


class ClusterEngine:
    """The any-rank product surface: a local DistributedEngine for owned
    devices plus RPC routing/fan-out to peers. Everything not overridden
    here (config, interners, staging, WAL, archive, feeds) delegates to
    the local engine — handlers registered by ``register_cluster_rpc``
    always bind to ``.local``, so routed calls never recurse."""

    def __init__(self, config: ClusterConfig,
                 local: DistributedEngine | None = None):
        self.cluster_config = config
        self.rank = config.rank
        self.n_ranks = config.n_ranks
        if local is not None:
            # a pre-built engine (recover_distributed) carries the epoch
            # base its snapshot/WAL were written under; silently replacing
            # it with a drifted configured base would shift every stored
            # relative timestamp — refuse instead
            base = getattr(local.epoch, "base_unix_s", None)
            if base is not None and abs(base - config.epoch_base_unix_s) > 1e-3:
                raise ValueError(
                    f"recovered engine epoch base {base} != configured "
                    f"cluster base {config.epoch_base_unix_s}: the cluster "
                    "must keep the base its history was written under")
            self.local = local
        else:
            self.local = DistributedEngine(config.engine)
        self.local.epoch = EpochBase(config.epoch_base_unix_s)
        self.epoch = self.local.epoch
        # the rank stamps every flight record (and trace-id generation),
        # so cross-rank trace views attribute records correctly
        self.local.flight.rank = config.rank
        # ditto for the span tracer: timeline events carry pid=rank, the
        # stitch key of the multi-rank Perfetto view
        self.local.tracer.rank = config.rank
        self.search_index = None          # see attach_search_index
        self.command_service = None       # see attach_command_service
        self.forward_queue = None         # see attach_forwarding
        self.replica_feed = None          # see attach_replication
        self.replica_applier = None       # see attach_replication
        self.replication_factor = 1
        # peer health (up/suspect/down + probe backoff) fed by every
        # transport outcome — the failover read path and fire-over
        # detection both key on it
        from sitewhere_tpu_torch.parallel.replication import PeerHealth

        self.health = PeerHealth()
        # versioned tenant placement: every ownership read on
        # this rank — facade routing, owner-side guards, fire-over,
        # replica-ring derivation — resolves through THIS manager's
        # installed map, so all surfaces agree on one epoch. Attached to
        # the local engine too (the forward_queue pattern) so cluster
        # RPC handlers reach it.
        from sitewhere_tpu_torch.parallel.placement import (PlacementManager,
                                                      PlacementMap)

        pdir = config.placement_dir
        if pdir is None and config.engine.wal_dir:
            pdir = str(pathlib_Path(config.engine.wal_dir) / "placement")
        self.placement = PlacementManager(
            self, PlacementMap.initial(config.n_ranks,
                                       config.slots_per_rank,
                                       config.initial_ranks),
            directory=pdir)
        self.local.placement = self.placement
        self._peers: dict[int, _SyncPeer] = {}
        self._peers_lock = threading.Lock()
        self._fid_seq = 0
        # assignment-token -> owning rank. Ownership is IMMUTABLE (the
        # assignment lives where its device's shards are, and device
        # ownership is a pure token hash), so entries never go stale;
        # capped so a scan-heavy workload can't grow it without bound.
        self._assignment_ranks: dict[str, int] = {}
        self._token_factory = lambda: cluster_system_jwt(config.secret)

    # ------------------------------------------------------------- plumbing
    def __getattr__(self, name):
        return getattr(self.local, name)

    def _peer(self, rank: int) -> _SyncPeer:
        # locked: concurrent REST/executor threads racing the lazy create
        # would each spawn (and one would leak) a client loop thread
        with self._peers_lock:
            peer = self._peers.get(rank)
            if peer is None:
                peer = self._peers[rank] = _SyncPeer(
                    self.cluster_config.peers[rank], self._token_factory,
                    self.cluster_config.connect_timeout_s,
                    src_rank=self.rank, dst_rank=rank)
            return peer

    def _peer_call(self, rank: int, method: str, **params):
        """Peer call that feeds the health tracker: transport failures
        (refusal/timeout — result unknown either way) count against the
        rank, successes reset it."""
        try:
            res = self._peer(rank).call(method, **params)
        except (ConnectionError, TimeoutError):
            self.health.record_failure(rank)
            raise
        self.health.record_success(rank)
        return res

    def owner(self, token: str) -> int:
        """Owning rank per the installed PLACEMENT map: the
        token hashes into a fixed slot, the epoch-numbered map names
        the slot's rank. The genesis map reproduces the legacy
        ``owner_rank(token, n_ranks)`` byte-for-byte."""
        return self.placement.owner(token)

    def _data_ranks(self) -> list[int]:
        """Ranks a DATA fan-out must cover: every slot-owning rank plus
        this one. A drained rank leaves this set at its commit epoch, so
        its departure (and eventual shutdown) never fails a query; a
        joining rank enters it with its first owned slot. Health/status
        surfaces keep fanning over the full provisioned set — operators
        need to see inactive ranks."""
        return self.placement.data_ranks()

    def _route(self, _token: str, _local_fn, _method: str, **params):
        r = self.owner(_token)
        if r == self.rank:
            return _local_fn()
        return self._peer(r).call(_method, **params)

    def close(self) -> None:
        for peer in self._peers.values():
            peer.close()
        self._peers.clear()

    # --------------------------------------------------------------- ingest
    def _partition_payloads(self, payloads: list[bytes],
                            kind: str) -> dict[int, list[bytes]]:
        """Owner-rank partition (the Kafka producer partitioner analog).
        Every implementation must route a payload IDENTICALLY — the
        authoritative semantics are the scanner's (it is also how the
        batch decoder reads envelopes). Fast path: ONE native C call
        hashes every token; fallback: the byte-exact Python port in
        native/route_fallback.py. Unroutable payloads (-1) stay local,
        where the engine's dead-letter path owns them."""
        by_rank: dict[int, list[bytes]] = {}
        me = self.rank
        from sitewhere_tpu_torch.native.binding import route_payloads

        # placement-era routing: the native/Python scanners hash the
        # token into the FIXED slot space (same FNV, n_slots instead of
        # n_ranks) and the installed map's slot->rank table resolves the
        # owner — with this rank's fences substituted by their targets,
        # so mid-handoff payloads head for the new owner's durable queue
        slot_rank = self.placement.slot_routing()
        n_slots = len(slot_rank)
        ranks = route_payloads(payloads, n_slots,
                               binary=(kind == "binary"))
        if ranks is not None:
            for p, s in zip(payloads, ranks.tolist()):
                by_rank.setdefault(me if s < 0 else slot_rank[s],
                                   []).append(p)
            return by_rank
        from sitewhere_tpu_torch.native.route_fallback import (route_binary_payload,
                                                         route_json_payload)

        route_one = (route_binary_payload if kind == "binary"
                     else route_json_payload)
        for p in payloads:
            s = route_one(p, n_slots)
            by_rank.setdefault(me if s < 0 else slot_rank[s], []).append(p)
        return by_rank

    def attach_forwarding(self, queue, registry) -> None:
        """Durable cross-rank forwarding (parallel/forward.py): the spill
        QUEUE is this rank's sender-side buffer; the REGISTRY is placed
        on the local engine so the rank's cluster RPC handlers suppress
        redelivered forward ids (register_cluster_rpc binds engines, not
        this facade)."""
        self.forward_queue = queue
        self.local.forward_queue = queue     # rank metrics see the queue
        self.local.spill_registry = registry

    def attach_replication(self, feed, applier) -> None:
        """Event-plane replication (parallel/replication.py): the FEED is
        this rank's leader role (streams WAL-durable batches to its
        followers — placed on the local engine so _wal_append publishes),
        the APPLIER its follower role (standby stores + failover reads).
        Either may be None on asymmetric topologies."""
        self.replica_feed = feed
        self.replica_applier = applier
        self.local.replica_feed = feed
        self.local.replica_applier = applier
        rf = max(getattr(feed, "rf", 1), getattr(applier, "rf", 1))
        self.replication_factor = max(self.replication_factor, rf)

    # ------------------------------------------------- failover read plumbing
    def _try_peer(self, rank: int) -> bool:
        """Spend a real attempt on this rank? Always, until replication
        gives the read path somewhere else to go; with replicas attached
        a DOWN rank is skipped between probe windows so failover reads
        don't pay a connect timeout each."""
        if self.replica_applier is None and self.replica_feed is None:
            return True
        return (not self.health.is_down(rank)
                or self.health.should_probe(rank))

    def _replica_read(self, owner: int, method: str, local_attr: str,
                      **params):
        """Serve a dead owner's partition from its most-caught-up
        follower: the local standby when this rank follows the owner
        (no RPC), else the owner's followers in ring order (ring order
        is also fire-over order, so the first live follower is the one
        already acting for the owner). Returns None when nobody can
        serve."""
        from sitewhere_tpu_torch.parallel.replication import replica_ring

        ring = replica_ring(owner, self.n_ranks, self.replication_factor)
        for f in ring:
            if f == self.rank:
                applier = self.replica_applier
                if applier is None:
                    continue
                res = getattr(applier, local_attr)(owner, **params)
                if res is not None:
                    return res
                continue
            if self.health.is_down(f) and not self.health.should_probe(f):
                continue
            try:
                res = self._peer_call(f, method, leader=owner, **params)
            except (ConnectionError, TimeoutError):
                continue
            if res is not None and not (isinstance(res, dict)
                                        and res.get("unknown")):
                return res
        return None

    def _next_fid(self) -> str:
        """Unique forward id: rank + wall-clock ns + in-process seq —
        unique across restarts without coordination."""
        self._fid_seq += 1
        return f"{self.rank}-{time.time_ns()}-{self._fid_seq}"

    def _adopt_redirect_map(self, e, replier: int) -> None:
        """Converge placement from a ``code=473`` redirect: adopt the
        replier's attached map when its epoch is newer; when OURS is
        newer (the replier missed the commit broadcast), push it so the
        next delivery lands. Either way the higher epoch wins — epochs
        only move forward."""
        data = getattr(e, "data", None) or {}
        peer_map = data.get("map")
        if peer_map is None:
            return
        my_epoch = self.placement.epoch
        if int(peer_map.get("epoch", 0)) > my_epoch:
            self.placement.install(peer_map)
        elif int(peer_map.get("epoch", 0)) < my_epoch:
            try:
                self._peer(replier).call(
                    "Placement.install",
                    map=self.placement.map().to_dict())
            except (ConnectionError, TimeoutError):
                pass

    def _forward_batch(self, r: int, kind: str, plist: list[bytes],
                       tenant: str, _redirected: bool = False) -> dict:
        """One remote sub-batch. With a forward queue attached, delivery
        is durable: tagged for owner-side dedup, spilled on failure
        (returned as {"spilled": n}) instead of raising mid-batch with
        part of the batch already applied locally. Payload bytes ride the
        frame as a RAW attachment blob (protocol.py ATTACH_BIT) — the
        base64-in-JSON form cost ~10x the owner's actual decode."""
        from sitewhere_tpu_torch.rpc.protocol import MAX_FRAME, RpcError

        lens = [len(p) for p in plist]
        if sum(lens) > MAX_FRAME - (1 << 16) and len(plist) > 1:
            # split BEFORE any join so an oversized batch never copies
            # its full byte payload at every recursion level
            mid = len(plist) // 2
            return _merge_counts([
                self._forward_batch(r, kind, plist[:mid], tenant,
                                    _redirected),
                self._forward_batch(r, kind, plist[mid:], tenant,
                                    _redirected)])
        hop = _cluster_instruments()["forward_hop"]
        if self.forward_queue is None:
            from sitewhere_tpu_torch.parallel.placement import REDIRECT_CODE

            method = ("Cluster.ingestJson" if kind == "json"
                      else "Cluster.ingestBinary")
            with self.local.tracer.begin("forward.hop", dst=r,
                                         payloads=len(plist)):
                t0 = time.perf_counter()
                try:
                    res = self._peer(r).call(method, lens=lens,
                                             tenant=tenant,
                                             _attachment=b"".join(plist))
                except RpcError as e:
                    if (getattr(e, "code", None) != REDIRECT_CODE
                            or _redirected):
                        raise
                    # ownership moved under us (no durable queue to
                    # spill into): adopt the replier's map and re-route
                    # the sub-batch once through the normal partitioner
                    self._adopt_redirect_map(e, r)
                    return self._ingest_routed(plist, tenant, kind,
                                               _redirected=True)
                hop.observe(time.perf_counter() - t0, dst=str(r))
            return res
        fid = self._next_fid()
        tracer = self.local.tracer
        if self.forward_queue.circuit_open(r):
            # a known-down peer: spill without paying the connect
            # timeout (or the blob join) per batch; the retry pump
            # closes the circuit
            self.forward_queue.spill(r, kind, tenant, fid,
                                     payloads=plist)
            with tracer.begin("forward.spill", dst=r, fid=fid,
                              reason="circuit_open",
                              payloads=len(plist)):
                pass
            return {"spilled": len(plist)}
        # the with-block (not bare begin/end) closes the span on EVERY
        # exit — an exception type this except-ladder doesn't catch must
        # not leave an open span on the forwarding thread's stack
        with tracer.begin("forward.hop", dst=r,
                          payloads=len(plist)) as hop_sp:
            try:
                t0 = time.perf_counter()
                res = self._peer(r).call(
                    "Cluster.ingestForward", fid=fid, lens=lens,
                    tenant=tenant, encoding=kind,
                    _attachment=b"".join(plist))
                hop.observe(time.perf_counter() - t0, dst=str(r))
                return res
            except (ConnectionError, TimeoutError):
                hop_sp.annotate(error="transport", spilled=True)
                self.forward_queue.trip(r)
                self.forward_queue.spill(r, kind, tenant, fid,
                                         payloads=plist)
                return {"spilled": len(plist)}
            except RpcError as e:
                from sitewhere_tpu_torch.parallel.placement import REDIRECT_CODE

                if getattr(e, "code", None) == REDIRECT_CODE:
                    # ownership redirect. MOVED (map
                    # attached): adopt the newer epoch and spill each
                    # payload group toward its CURRENT owner — the
                    # mid-flight re-route. FENCED (commit in flight):
                    # spill back to the same rank with the owner's
                    # short defer; the post-commit redelivery gets the
                    # map and re-routes then.
                    self._adopt_redirect_map(e, r)
                    data = getattr(e, "data", None) or {}
                    if data.get("fenced"):
                        hop_sp.annotate(error="fence_473", spilled=True)
                        self.forward_queue.spill(
                            r, kind, tenant, fid, payloads=plist,
                            defer_s=getattr(e, "retry_after_s", None)
                            or 0.05)
                        return {"spilled": len(plist),
                                "fence_deferred": len(plist)}
                    hop_sp.annotate(error="redirect_473", spilled=True)
                    out = {"redirected": len(plist)}
                    local_ingest = (self.local.ingest_json_batch
                                    if kind == "json"
                                    else self.local.ingest_binary_batch)
                    for r2, pl2 in self._partition_payloads(
                            plist, kind=kind).items():
                        if r2 == self.rank:
                            # a drain moved the slot TO this rank: the
                            # redirected share is ours now — apply it
                            # (under the ingest gate, so a fence racing
                            # in cannot slip this apply past its tail)
                            with self.placement.ingest_gate():
                                out = _merge_counts(
                                    [out, local_ingest(pl2, tenant)])
                        else:
                            self.forward_queue.spill(
                                r2, kind, tenant, self._next_fid(),
                                payloads=pl2)
                            out["spilled"] = (out.get("spilled", 0)
                                              + len(pl2))
                    return out
                if getattr(e, "code", None) == 429:
                    # owner-side load shed: the batch is
                    # already accepted at THIS edge, so it spills for
                    # deferred redelivery honoring the OWNER's
                    # Retry-After — an app-level reject by
                    # classification (the retry pump counts it in
                    # retry_app_rejects, never
                    # retry_transport_failures, and never toward the
                    # poison budget). The owner's hint propagates to
                    # the caller as retry_after_s backpressure.
                    ra = getattr(e, "retry_after_s", None)
                    hop_sp.annotate(error="shed_429", spilled=True)
                    self.forward_queue.spill(r, kind, tenant, fid,
                                             payloads=plist,
                                             defer_s=ra)
                    out = {"spilled": len(plist),
                           "shed_deferred": len(plist)}
                    if ra is not None:
                        out["retry_after_s"] = ra
                    return out
                # oversize single payload (unsplittable) or an
                # owner-side application error: spill WITHOUT tripping
                # the circuit (the peer is up) — the retry pump
                # re-attempts and the retry budget dead-letters a
                # poison batch; data is never lost to an exception
                # racing out of a half-applied ingest call
                hop_sp.annotate(error="app_reject", spilled=True)
                self.forward_queue.spill(r, kind, tenant, fid,
                                         payloads=plist)
                return {"spilled": len(plist)}

    def _ingest_routed(self, payloads: list[bytes], tenant: str,
                       kind: str, _redirected: bool = False) -> dict:
        """Shared facade ingest: ONE trace spans the partition, the local
        sub-batch, and every cross-rank forward. The route record lives in
        the local rank's flight recorder; owner-side records join the same
        trace id via the RPC frame's traceparent, so
        `/api/instance/trace/<id>` reconstructs the full journey from any
        rank."""
        from sitewhere_tpu_torch.utils.tracing import (bind_traceparent,
                                                 current_traceparent,
                                                 new_traceparent)

        from sitewhere_tpu_torch.utils.qos import ShedError

        if self.placement.has_fences:
            # a fence window is short (WAL-tail flush + verify): a batch
            # that actually TOUCHES a fenced slot waits the fence out
            # here — costing those payloads the fence DURATION, not a
            # spill/redeliver round trip — while unrelated traffic sails
            # through. On timeout the partitioner's fence-target
            # substitution takes over and the durable queue converges
            # the stragglers.
            from sitewhere_tpu_torch.parallel.placement import _payload_slots

            fenced = set(self.placement.fenced_slots())
            if fenced:
                touched = fenced.intersection(_payload_slots(
                    payloads, kind, self.placement.map().n_slots))
                if touched:
                    self.placement.wait_unfenced(list(touched),
                                                 timeout_s=2.0)
                    if (self.forward_queue is None
                            and set(self.placement.fenced_slots())
                            & touched):
                        # no durable queue to park the frame in: answer
                        # the caller with the typed retryable shed (REST
                        # maps it to 429 + Retry-After) instead of a
                        # doomed redirect loop — the handoff target
                        # cannot accept until the commit epoch lands
                        from sitewhere_tpu_torch.utils.qos import ShedError

                        raise ShedError(
                            f"tenant {tenant!r}: slots {sorted(touched)}"
                            " are mid-handoff and no durable forward "
                            "queue is attached — retry shortly",
                            tenant=tenant, retry_after_s=0.1,
                            reason="handoff_fence")
        tp = current_traceparent() or new_traceparent(self.rank)
        route_rec = self.local.flight.begin(
            "route", tenant=tenant, n_payloads=len(payloads),
            traceparent=tp)
        with bind_traceparent(tp):
            # the ingest gate (placement.py) spans the fence check —
            # the partitioner — and the LOCAL engine apply: a fence
            # registered mid-batch waits for this batch's WAL append
            # before capturing its tail extents. Forwards run OUTSIDE
            # the gate (they apply at their owner, under ITS gate).
            summaries = []
            with self.placement.ingest_gate():
                by_rank = self._partition_payloads(payloads, kind=kind)
                route_rec.mark("commit")   # partition decided
                local_ingest = (self.local.ingest_json_batch
                                if kind == "json"
                                else self.local.ingest_binary_batch)
                qos = getattr(self.local, "qos", None)
                local_plist = by_rank.get(self.rank)
                if qos is not None and local_plist:
                    # the facade IS the edge for its own sub-batch, and
                    # it decides BEFORE any forward leaves this rank: a
                    # local shed refuses the whole call with a typed
                    # ShedError (REST answers 429 + Retry-After) while
                    # nothing has been applied, forwarded, or spilled
                    # yet — the caller retries the full batch. A shed
                    # decided mid-call would instead silently drop the
                    # local payloads next to remote-owned ones the
                    # forward queue durably redelivers.
                    d = qos.admit(tenant, len(local_plist))
                    if not d.admitted:
                        raise ShedError(
                            f"tenant {tenant!r} shed at facade "
                            f"({d.reason}): retry after "
                            f"{d.retry_after_s:.3f}s", tenant=tenant,
                            retry_after_s=d.retry_after_s,
                            reason=d.reason or "shed")
                if local_plist:
                    summaries.append(local_ingest(local_plist, tenant,
                                                  traceparent=tp))
            forwarded = 0
            for r, plist in by_rank.items():
                if r == self.rank:
                    continue
                forwarded += len(plist)
                summaries.append(self._forward_batch(
                    r, kind, plist, tenant, _redirected))
            if forwarded:
                route_rec.add("forwarded", forwarded)
                route_rec.add("forward_ranks",
                              sorted(r for r in by_rank if r != self.rank))
                route_rec.mark("dispatch")   # last forward left this rank
        # retry_after_s is a HINT, not a count: surface the largest one
        # instead of letting the numeric merge sum hints across ranks
        retry_hints = [s.pop("retry_after_s") for s in summaries
                       if isinstance(s, dict) and "retry_after_s" in s]
        merged = _merge_counts(summaries)
        if retry_hints:
            merged["retry_after_s"] = max(retry_hints)
        if route_rec.trace_id is not None:
            route_rec.add_counts(merged)
            merged["trace_id"] = route_rec.trace_id
        return merged

    def ingest_json_batch(self, payloads: list[bytes],
                          tenant: str = "default") -> dict:
        """Partition the batch by owning rank (token-hash, like the Kafka
        producer partitioner) and forward raw remote payloads — WAL,
        decode, and registration happen once, at each owner."""
        return self._ingest_routed(payloads, tenant, kind="json")

    def ingest_binary_batch(self, payloads: list[bytes],
                            tenant: str = "default") -> dict:
        return self._ingest_routed(payloads, tenant, kind="binary")

    def process(self, req, _redirected: bool = False) -> None:
        tok = req.device_token
        if self.placement.has_fences:
            slot = self.placement.slot_of(tok)
            self.placement.wait_unfenced([slot], timeout_s=2.0)
            fences = self.placement.fenced_slots()
            if slot in fences:
                # fence outlived the wait. With a durable queue, park
                # the envelope for the handoff TARGET with a short defer
                # — it owns the slot at the commit epoch and the pump
                # converges via redirects either way. Without one, the
                # target's guard would deterministically refuse until
                # commit, so answer the caller with the typed retryable
                # shed instead of a doomed redirect loop.
                if self.forward_queue is not None:
                    from sitewhere_tpu_torch.ingest.decoders import (
                        envelope_from_request)

                    self.forward_queue.spill(
                        fences[slot], "envelope", req.tenant,
                        self._next_fid(),
                        envelope=envelope_from_request(req),
                        defer_s=0.1)
                    return
                from sitewhere_tpu_torch.utils.qos import ShedError

                raise ShedError(
                    f"device {tok!r}: slot {slot} is mid-handoff and "
                    "no durable forward queue is attached — retry "
                    "shortly", tenant=req.tenant, retry_after_s=0.1,
                    reason="handoff_fence")
            r = self.owner(tok)
        else:
            r = self.owner(tok)
        if r == self.rank:
            with self.placement.ingest_gate():
                return self.local.process(req)
        from sitewhere_tpu_torch.parallel.placement import REDIRECT_CODE
        from sitewhere_tpu_torch.rpc.protocol import RpcError

        from sitewhere_tpu_torch.ingest.decoders import envelope_from_request

        env = envelope_from_request(req)
        if self.forward_queue is None:
            try:
                self._peer(r).call("Cluster.processEnvelope", envelope=env,
                                   tenant=req.tenant)
            except RpcError as e:
                if (getattr(e, "code", None) != REDIRECT_CODE
                        or _redirected):
                    raise
                self._adopt_redirect_map(e, r)
                return self.process(req, _redirected=True)
            return
        fid = self._next_fid()
        if self.forward_queue.circuit_open(r):
            self.forward_queue.spill(r, "envelope", req.tenant, fid,
                                     envelope=env)
            return
        try:
            self._peer(r).call("Cluster.forwardEnvelope", fid=fid,
                               envelope=env, tenant=req.tenant)
        except (ConnectionError, TimeoutError):
            self.forward_queue.trip(r)
            self.forward_queue.spill(r, "envelope", req.tenant, fid,
                                     envelope=env)
        except RpcError as e:
            if getattr(e, "code", None) != REDIRECT_CODE or _redirected:
                raise
            # ownership redirect on the synchronous single-request path:
            # adopt the newer map and re-route once, keeping the
            # all-or-nothing contract (a deterministic refusal at the
            # NEW owner still reaches the caller)
            self._adopt_redirect_map(e, r)
            return self.process(req, _redirected=True)
        # an owner-side application error (RpcError) RAISES here, unlike
        # the batch path's spill: this is the synchronous all-or-nothing
        # single-request contract — a deterministic validation refusal
        # must reach the caller exactly as it does for a locally-owned
        # device, not turn into a false success + a poison spill record
        # that head-of-line blocks the peer's queue until dead-letter

    def _fanout_keyed(self, local_result, method: str,
                      tolerant: bool = False, ranks=None,
                      **params) -> dict:
        """Local result + the same call on every peer, keyed by rank —
        the one idiom behind flush/metrics/sweeps/status; timeout,
        parallelism, and down-peer policy live here once. ``tolerant``
        marks an unreachable peer with a ``PeerDown`` sentinel (checking
        the forward circuit first, so a known-dead peer costs nothing)
        instead of raising — the scrape surfaces must degrade, queries
        must stay loud. ``ranks`` narrows the sweep (data surfaces pass
        ``_data_ranks()`` so a drained rank's departure never fails a
        query; status surfaces keep the full provisioned set)."""
        out = {self.rank: local_result}
        for r in (range(self.n_ranks) if ranks is None else ranks):
            if r == self.rank:
                continue
            if (tolerant and self.forward_queue is not None
                    and self.forward_queue.circuit_open(r)):
                out[r] = PeerDown("forward circuit open")
                continue
            try:
                out[r] = self._peer(r).call(method, **params)
            except (ConnectionError, TimeoutError) as e:
                if not tolerant:
                    raise
                out[r] = PeerDown(str(e))
        return out

    def _fanout(self, local_result, method: str, ranks=None,
                **params) -> list:
        """List form of ``_fanout_keyed`` (local first, then peers)."""
        return list(self._fanout_keyed(local_result, method, ranks=ranks,
                                       **params).values())

    def flush(self) -> dict:
        """Flush every DATA rank — after this, queries anywhere see
        everything accepted anywhere (the test/REST consistency
        point)."""
        out = self._fanout(self.local.flush(), "Cluster.flush",
                           ranks=self._data_ranks())
        return _merge_counts([s for s in out if s])

    # ---------------------------------------------------------------- admin
    def register_device(self, token: str, device_type: str | None = None,
                        tenant: str = "default", area: str | None = None,
                        customer: str | None = None,
                        metadata: dict | None = None):
        r = self.owner(token)
        if r == self.rank:
            return self.local.register_device(token, device_type, tenant,
                                              area, customer, metadata)
        self._peer(r).call("Cluster.registerDevice", token=token,
                           deviceType=device_type, tenant=tenant, area=area,
                           customer=customer, metadata=metadata)

    def update_device(self, token: str, device_type: str | None = None,
                      area: str | None = None, customer: str | None = None,
                      metadata: dict | None = None):
        r = self.owner(token)
        if r == self.rank:
            return self.local.update_device(token, device_type, area,
                                            customer, metadata)
        res = self._peer(r).call(
            "Cluster.updateDevice", token=token, deviceType=device_type,
            area=area, customer=customer, metadata=metadata)
        if res is None:
            raise KeyError(token)

    def delete_device(self, token: str) -> bool:
        return self._route(
            token, lambda: self.local.delete_device(token),
            "Cluster.deleteDevice", token=token)

    # ---------------------------------------------------------------- reads
    def get_device(self, token: str) -> DeviceInfo | None:
        d = self._route(token, lambda: self.local.get_device(token),
                        "Cluster.getDevice", token=token)
        if d is None or isinstance(d, DeviceInfo):
            return d
        return DeviceInfo(**d)

    def list_assignments(self, device_token: str | None = None,
                         **kw) -> list[AssignmentInfo]:
        if device_token is not None:
            res = self._route(
                device_token,
                lambda: self.local.list_assignments(device_token, **kw),
                "Cluster.listAssignments", token=device_token, **kw)
            return [a if isinstance(a, AssignmentInfo) else
                    AssignmentInfo(**a) for a in res]
        parts = self._fanout(self.local.list_assignments(None, **kw),
                             "Cluster.listAssignments",
                             ranks=self._data_ranks(), token=None, **kw)
        return [a if isinstance(a, AssignmentInfo) else AssignmentInfo(**a)
                for part in parts for a in part]

    def get_device_state(self, token: str) -> dict | None:
        """Owner-routed read with failover: when the owner rank is
        unreachable, the most-caught-up follower serves its standby copy
        with an explicit ``stale_ms`` watermark."""
        r = self.owner(token)
        if r == self.rank:
            return self.local.get_device_state(token)
        err: Exception | None = None
        if self._try_peer(r):
            try:
                return self._peer_call(r, "Cluster.getDeviceState",
                                       token=token)
            except (ConnectionError, TimeoutError) as e:
                err = e
        res = self._replica_read(r, "Cluster.replicaDeviceState",
                                 "device_state", token=token)
        if res is None:
            raise err if err is not None else ConnectionError(
                f"rank {r} down and no replica holds its partition")
        if res.get("missing"):
            return None
        return res

    # ----------------------------------------------------- assignments
    # Assignments live at their DEVICE's owner rank (they expand on its
    # shards), but assignment TOKENS don't encode the device — writes
    # route by device token, by-token reads/updates resolve local-first
    # then ask peers (Assignments.java REST surface, any-rank semantics).
    def _as_info(self, a) -> AssignmentInfo | None:
        if a is None or isinstance(a, AssignmentInfo):
            return a
        return AssignmentInfo(**a)

    def create_assignment(self, device_token: str, token: str | None = None,
                          asset: str | None = None, area: str | None = None,
                          customer: str | None = None,
                          metadata: dict | None = None) -> AssignmentInfo:
        info = self._as_info(self._route(
            device_token,
            lambda: self.local.create_assignment(device_token, token,
                                                 asset, area, customer,
                                                 metadata),
            "Cluster.createAssignment", deviceToken=device_token,
            token=token, asset=asset, area=area, customer=customer,
            metadata=metadata))
        self._cache_assignment_rank(info.token, self.owner(device_token))
        return info

    def _cache_assignment_rank(self, token: str, rank: int) -> None:
        if len(self._assignment_ranks) > 65536:
            self._assignment_ranks.clear()   # cap: a cache, not a table
        self._assignment_ranks[token] = rank

    def _assignment_rank(self, token: str) -> "int | None":
        cached = self._assignment_ranks.get(token)
        if cached is not None:
            return cached
        if self.local.get_assignment(token) is not None:
            self._cache_assignment_rank(token, self.rank)
            return self.rank
        for r in self._data_ranks():
            if r != self.rank and self._peer(r).call(
                    "Cluster.getAssignment", token=token) is not None:
                self._cache_assignment_rank(token, r)
                return r
        return None

    def get_assignment(self, token: str) -> AssignmentInfo | None:
        cached = self._assignment_ranks.get(token)
        if cached is not None and cached != self.rank:
            d = self._peer(cached).call("Cluster.getAssignment",
                                        token=token)
            if d is None:
                self._assignment_ranks.pop(token, None)   # deleted
            return self._as_info(d)
        a = self.local.get_assignment(token)
        if a is not None:
            self._cache_assignment_rank(token, self.rank)
            return a
        for r in self._data_ranks():
            if r != self.rank:
                d = self._peer(r).call("Cluster.getAssignment", token=token)
                if d is not None:
                    self._cache_assignment_rank(token, r)
                    return self._as_info(d)
        return None

    def _assignment_op(self, token: str, local_fn, method: str, **params):
        r = self._assignment_rank(token)
        if r is None:
            raise KeyError(f"assignment {token!r} not found")
        if r == self.rank:
            return local_fn()
        return self._peer(r).call(method, token=token, **params)

    def release_assignment(self, token: str) -> AssignmentInfo:
        return self._as_info(self._assignment_op(
            token, lambda: self.local.release_assignment(token),
            "Cluster.releaseAssignment"))

    def mark_assignment_missing(self, token: str) -> AssignmentInfo:
        return self._as_info(self._assignment_op(
            token, lambda: self.local.mark_assignment_missing(token),
            "Cluster.markAssignmentMissing"))

    def update_assignment(self, token: str, asset: str | None = None,
                          area: str | None = None,
                          customer: str | None = None,
                          metadata: dict | None = None) -> AssignmentInfo:
        return self._as_info(self._assignment_op(
            token,
            lambda: self.local.update_assignment(token, asset, area,
                                                 customer, metadata),
            "Cluster.updateAssignment", asset=asset, area=area,
            customer=customer, metadata=metadata))

    def delete_assignment(self, token: str) -> bool:
        r = self._assignment_rank(token)
        if r is None:
            return False
        self._assignment_ranks.pop(token, None)
        if r == self.rank:
            return self.local.delete_assignment(token)
        return self._peer(r).call("Cluster.deleteAssignment", token=token)

    def search_device_states(self, **kw) -> list[dict]:
        out = self.placement.filter_rows(
            list(self.local.search_device_states(**kw)), key="device")
        for r in self._data_ranks():
            if r == self.rank:
                continue
            part, err = None, None
            if self._try_peer(r):
                try:
                    part = self._peer_call(r, "Cluster.searchDeviceStates",
                                           **kw)
                except (ConnectionError, TimeoutError) as e:
                    err = e
            if part is None:
                # a dead rank's slice comes from its follower's standby
                # (rows carry stale_ms); queries stay loud only when
                # NOBODY can serve the partition
                part = self._replica_read(r, "Cluster.replicaSearchStates",
                                          "search_states", **kw)
                if part is None:
                    raise err if err is not None else ConnectionError(
                        f"rank {r} down and no replica holds its "
                        "partition")
            out.extend(part)
        limit = kw.get("limit")
        if limit is not None:
            out = out[:limit]
        return out

    def query_events(self, **kw) -> dict:
        """Fan out to every rank, merge newest-first — the cross-partition
        query the reference's REST tier performs over per-service gRPC.
        String filters (device/tenant/area/customer/alternate_id) resolve
        per rank; raw interner-id filters cannot cross ranks."""
        if kw.get("aux0") is not None or kw.get("aux1") is not None:
            raise ValueError(
                "aux0/aux1 are rank-local interner ids and mean different "
                "strings on other ranks — use command_responses() or "
                "alternate_id instead")
        results = [_placement_filtered_query(self.local, kw)]
        stale_ms = None
        for r in self._data_ranks():
            if r == self.rank:
                continue
            res, err = None, None
            if self._try_peer(r):
                try:
                    res = self._peer_call(r, "Cluster.queryEvents", **kw)
                except (ConnectionError, TimeoutError) as e:
                    err = e
            if res is None:
                # owner unreachable: its partition serves from the most-
                # caught-up follower's standby, and the merged response
                # carries the replica's staleness watermark
                res = self._replica_read(r, "Cluster.replicaQueryEvents",
                                         "query_events", **kw)
                if res is None:
                    raise err if err is not None else ConnectionError(
                        f"rank {r} down and no replica holds its "
                        "partition")
                stale_ms = max(stale_ms or 0.0,
                               float(res.get("stale_ms", 0.0)))
            results.append(res)
        events = [e for res in results for e in res["events"]]
        events.sort(key=event_order_key)
        limit = kw.get("limit", 100)
        out = {"total": sum(res["total"] for res in results),
               "events": events[:limit]}
        if stale_ms is not None:
            # explicit degradation marker: part of this result is a
            # follower's standby view, at most stale_ms behind the acked
            # history of the dead owner
            out["stale_ms"] = stale_ms
        return out

    def get_event(self, event_id: int,
                  tenant: str | None = None) -> dict | None:
        """Cluster-global by-id lookup: ids are ``local * n_ranks + rank``
        so the owning rank is recoverable from the id alone."""
        if event_id < 0:
            return None
        r = event_id % self.n_ranks
        local_id = event_id // self.n_ranks
        if r == self.rank:
            ev = self.local.get_event(local_id, tenant=tenant)
        else:
            ev = self._peer(r).call("Cluster.getEvent", eventId=local_id,
                                    tenant=tenant)
        if ev is not None:
            ev["eventId"] = event_id
        return ev

    def get_trace(self, trace_id: str) -> dict:
        """Cluster-wide trace resolution: a batch forwarded across ranks
        left lifecycle records on EVERY rank it touched, all under one
        trace id — collect them from the local recorder plus every
        reachable peer (tolerant: a down rank degrades the view, it
        must not 500 the trace endpoint)."""
        keyed = self._fanout_keyed(
            self.local.flight.records_of(trace_id), "Cluster.traceGet",
            tolerant=True, traceId=trace_id)
        records: list[dict] = []
        for r, res in keyed.items():
            if isinstance(res, PeerDown) or not res:
                continue
            records.extend(res)
        records.sort(key=lambda d: d.get("startedMs", 0))
        return {"traceId": trace_id, "records": records}

    def recent_traces(self, limit: int = 50) -> list[dict]:
        """This rank's recent batch records (per-rank surface, like the
        reference scraping one replica; cross-rank journeys resolve via
        get_trace)."""
        return self.local.flight.recent(limit)

    def get_trace_timeline(self, trace_id: str) -> dict:
        """One trace id -> ONE stitched multi-rank Chrome-trace timeline
       : each rank contributes its local events (flight-record
        lifecycle intervals + live spans, pid = rank) through the same
        tolerant fan-out as get_trace, and the merge renumbers pids/tids
        with process/thread metadata so Perfetto shows one lane group per
        rank. A down rank degrades the view; it must not 500 the
        endpoint."""
        from sitewhere_tpu_torch.utils.tracing import (finish_timeline,
                                                 timeline_events)

        keyed = self._fanout_keyed(
            timeline_events(self.local, trace_id),
            "Cluster.traceTimeline", tolerant=True, traceId=trace_id)
        events: list[dict] = []
        for r, res in keyed.items():
            if isinstance(res, PeerDown) or not res:
                continue
            events.extend(res)
        return finish_timeline(trace_id, events)

    def make_feed_consumer(self, group_id: str, **kw):
        """Rank-local feed (outbound connectors run per-rank over the
        rank's partition, exactly as the reference's connector hosts
        consume per-partition Kafka groups), with event ids translated to
        the cluster-global space."""
        return _ClusterFeed(self.local.make_feed_consumer(group_id, **kw),
                            self.rank, self.n_ranks)

    def presence_sweep(self) -> list[str]:
        """Cluster-wide presence sweep: each rank marks ITS devices
        missing (per-partition, like the reference's per-tenant-engine
        DevicePresenceManager); one trigger reaches every rank so the
        REST admin surface behaves identically from any node. The
        per-rank BACKGROUND loop should sweep its local engine only —
        N ranks each fanning out would sweep N^2 times per interval."""
        return [t for part in self._fanout(
            self.local.presence_sweep(), "Cluster.presenceSweep",
            ranks=self._data_ranks())
            for t in part]

    def presence_sweep_local(self) -> list[str]:
        """This rank's sweep only — what the per-rank background loop
        calls (the N^2-avoidance policy lives HERE, not in the web
        tier)."""
        return self.local.presence_sweep()

    def attach_command_service(self, svc) -> None:
        """Wire this rank's command-delivery service into the cluster
        surface: remotely-routed invocations land in ITS pending set so
        the rank's own delivery pump can deliver them (per-partition
        consumers, reference-style). Placed on the local engine so the
        rank's RPC server can reach it."""
        self.command_service = svc
        self.local.command_service = svc

    def tag_invocation_id(self, local_id: int) -> int:
        """Cluster-global invocation id: ``local * n_ranks + rank`` (the
        event-id scheme) — histories/pending sets/device acks can never
        collide across ranks."""
        return local_id * self.n_ranks + self.rank

    def command_responses(self, invocation_id: str,
                          limit: int = 100) -> list[dict]:
        """Command responses for one invocation, resolved PER RANK: the
        originating-id string interns into each rank's own id space, so
        the integer must never cross rank boundaries."""
        from sitewhere_tpu_torch.commands.service import local_command_responses

        parts = self._fanout(
            local_command_responses(self.local, invocation_id, limit),
            "Cluster.commandResponses", ranks=self._data_ranks(),
            invocationId=invocation_id, limit=limit)
        docs = [d for part in parts for d in part]
        docs.sort(key=event_order_key)
        return docs[:limit]

    def fetch_invocation(self, invocation_id: int):
        """Resolve an invocation this rank never saw at its OWNING rank
        (the rank-tagged id encodes it) — GET /api/invocations/{id}
        answers identically from every rank, not just originator/owner."""
        from sitewhere_tpu_torch.commands.model import CommandInvocation

        r = invocation_id % self.n_ranks
        if r == self.rank:
            return _owned_invocation(self.local, invocation_id)
        d = self._peer(r).call("Cluster.getInvocation",
                               invocationId=invocation_id)
        return CommandInvocation(**d) if d is not None else None

    def route_invocation(self, inv) -> "int | None":
        """Route a command invocation to its device's owning rank.
        Returns the owner-assigned invocation id, or None when the device
        is local (the caller stages it as usual)."""
        r = self.owner(inv.device_token)
        if r == self.rank:
            return None
        res = self._peer(r).call("Cluster.invokeCommand",
                                 invocation=dataclasses.asdict(inv))
        return int(res["invocationId"])

    def _stage_row(self, et, token_id, tenant_id, ts, now, values, mask,
                   aux0, aux1):
        """Direct row staging must never silently persist a remote-owned
        device's event on the wrong rank (the product paths — process(),
        ingest, route_invocation — all route BEFORE staging; this guards
        any other direct caller)."""
        tid = int(token_id)
        tok = (self.local.tokens.token(tid)
               if 0 <= tid < len(self.local.tokens) else None)
        if tok is not None and self.owner(tok) != self.rank:
            raise NotImplementedError(
                f"direct staging for {tok!r} (owned by rank "
                f"{self.owner(tok)}) would persist on the wrong rank — "
                "use the routed surfaces (process/ingest/invoke)")
        return self.local._stage_row(et, token_id, tenant_id, ts, now,
                                     values, mask, aux0, aux1)

    def attach_search_index(self, index) -> None:
        """Wire this rank's embedded event-search index into the cluster
        surface (each rank's connector indexes ITS partition — all-rank
        queries need the fan-out, like every replica feeding one Solr).
        Also placed on the local engine so the rank's cluster RPC server
        (bound to the engine) can serve Cluster.searchEvents."""
        self.search_index = index
        self.local.search_index = index

    def search_events(self, query: str,
                      max_results: int = 100) -> "list[dict] | None":
        """All-rank event search: fan out to every rank's embedded index,
        merge newest-first. Returns None when no index is attached here
        (the caller falls back to its local provider); a PEER without an
        index fails the call loudly — a silent partial merge would read
        as complete."""
        if self.search_index is None:
            return None
        data_ranks = self._data_ranks()
        parts = self._fanout(
            self.search_index.search(query, max_results,
                                     order="eventDate"),
            "Cluster.searchEvents", ranks=data_ranks, query=query,
            maxResults=max_results)
        for r, part in zip([self.rank] + [r for r in data_ranks
                                          if r != self.rank], parts):
            if part is None:
                raise RuntimeError(
                    f"cluster search incomplete: rank {r} has no search "
                    "index attached")
        docs = [d for part in parts for d in part]
        docs.sort(key=event_order_key)
        return docs[:max_results]

    # metric keys that merge as MAX, not sum (ages/watermarks: a summed
    # "oldest" is an age no spill has)
    _MAX_MERGED = ("forward_queue_oldest_ms", "replica_max_stale_ms",
                   "forward_dedup_horizon_age_ms")

    def metrics(self) -> dict:
        """Cluster-merged counters PLUS per-rank attribution: the summed
        view answers "how much", ``by_rank`` answers "which rank is hot"
       . Rank-local extras (forward queue, entity replication)
        ride each rank's own metrics via ``local_rank_metrics``. A DOWN
        peer degrades to an ``unreachable`` entry instead of failing the
        whole scrape — the operator needs this surface most exactly when
        a rank is missing."""
        keyed = self._fanout_keyed(local_rank_metrics(self.local),
                                   "Cluster.metrics", tolerant=True)
        up = {str(r): m for r, m in keyed.items()
              if not isinstance(m, PeerDown)}
        merged = _merge_counts(list(up.values()))
        for key in self._MAX_MERGED:
            vals = [m[key] for m in up.values() if key in m]
            if vals:
                merged[key] = max(vals)
        merged["by_rank"] = dict(up)
        for r, m in keyed.items():
            if isinstance(m, PeerDown):
                merged["by_rank"][str(r)] = {"unreachable": 1,
                                             "reason": m.reason}
        return merged

    def tenant_metrics(self) -> dict:
        """Cluster-wide per-tenant event counts (each rank counts ITS
        partition; sums merge) — the Prometheus per-tenant series must
        cover the same corpus as the rank=\"all\" counters on the same
        page. Down peers degrade like metrics()."""
        keyed = self._fanout_keyed(self.local.tenant_metrics(),
                                   "Cluster.tenantMetrics", tolerant=True,
                                   ranks=self._data_ranks())
        merged: dict[str, dict[str, int]] = {}
        for res in keyed.values():
            if isinstance(res, PeerDown):
                continue
            for ten, counts in res.items():
                slot = merged.setdefault(ten, {})
                for etype, n in counts.items():
                    slot[etype] = slot.get(etype, 0) + n
        return merged

    def cluster_metrics(self) -> str:
        """ONE federated Prometheus exposition for the whole cluster,
        served from any rank: every live rank exports its own
        engine into its registry and ships the text; samples re-export
        under a ``rank`` label with HELP/TYPE deduped across ranks, and
        histogram bucket lines keep their trace-id exemplars. A DOWN
        rank degrades to ``swtpu_cluster_rank_up{rank=...} 0`` instead
        of failing the scrape — the operator needs this surface most
        exactly when a rank is missing."""
        from sitewhere_tpu_torch.utils.metrics import (REGISTRY, _escape_label,
                                                 export_engine_metrics,
                                                 federate_expositions)

        export_engine_metrics(self.local)
        local_text = REGISTRY.expose_text(exemplars=True)
        keyed = self._fanout_keyed(local_text, "Cluster.metricsText",
                                   tolerant=True)
        parts = {r: t for r, t in keyed.items()
                 if not isinstance(t, PeerDown)}
        lines = [federate_expositions(parts).rstrip("\n"),
                 "# HELP swtpu_cluster_rank_up 1 if the rank answered "
                 "the federated scrape",
                 "# TYPE swtpu_cluster_rank_up gauge"]
        for r in sorted(keyed):
            up = 0 if isinstance(keyed[r], PeerDown) else 1
            lines.append(
                f'swtpu_cluster_rank_up{{rank="{_escape_label(r)}"}} {up}')
        _cluster_instruments()["scrapes"].inc()
        return "\n".join(lines) + "\n"

    def conservation(self) -> dict:
        """Cluster-wide conservation audit: every live
        rank's ledger + verdict under its rank key, plus a cluster
        roll-up of the violation count. Rank ledgers are NEVER merged
        into one snapshot — each rank's equations balance against its
        own device counters; a DOWN rank degrades to an ``unreachable``
        entry instead of failing the audit surface."""
        from sitewhere_tpu_torch.utils.conservation import conservation_payload

        keyed = self._fanout_keyed(conservation_payload(self),
                                   "Cluster.conservation", tolerant=True,
                                   ranks=self._data_ranks())
        by_rank: dict[str, dict] = {}
        violations = 0
        for r, res in keyed.items():
            if isinstance(res, PeerDown):
                by_rank[str(r)] = {"unreachable": True,
                                   "reason": res.reason}
            else:
                by_rank[str(r)] = res
                violations += len(res.get("violations", ()))
        return {"clustered": self.n_ranks > 1, "rank": self.rank,
                "byRank": by_rank, "violations": violations,
                "balanced": violations == 0}

    def spmd_heat(self) -> dict:
        """Cluster-wide shard heat & skew: every live rank's
        heat document under its rank key (rank-labeled federation, the
        conservation() shape). Heat maps never merge — each rank's
        shards are its own mesh; a DOWN rank degrades to an
        ``unreachable`` entry."""
        from sitewhere_tpu_torch.utils.shardobs import spmd_heat_payload

        keyed = self._fanout_keyed(spmd_heat_payload(self),
                                   "Cluster.spmdHeat", tolerant=True,
                                   ranks=self._data_ranks())
        by_rank: dict[str, dict] = {}
        spmd_any = False
        for r, res in keyed.items():
            if isinstance(res, PeerDown):
                by_rank[str(r)] = {"unreachable": True,
                                   "reason": res.reason}
            else:
                by_rank[str(r)] = res
                spmd_any = spmd_any or bool(res.get("spmd"))
        return {"clustered": self.n_ranks > 1, "rank": self.rank,
                "spmd": spmd_any, "byRank": by_rank}

    def cluster_status(self) -> dict:
        """The operator's cluster page: this rank's identity, every
        rank's reachability + device count, and the durability gauges.
        A peer with an OPEN forward circuit reports DOWN without paying
        a connect timeout on the scrape."""
        keyed = self._fanout_keyed(len(_owned_device_infos(self.local)),
                                   "Cluster.deviceCount", tolerant=True)
        ranks: dict[str, dict] = {}
        for r, res in keyed.items():
            if isinstance(res, PeerDown):
                ranks[str(r)] = {"status": "DOWN", "local": False,
                                 "reason": res.reason}
            else:
                ranks[str(r)] = {"status": "UP", "local": r == self.rank,
                                 "devices": res}
        out = {"clustered": self.n_ranks > 1, "rank": self.rank,
               "nRanks": self.n_ranks,
               "peers": list(self.cluster_config.peers), "ranks": ranks,
               "activeRanks": self.placement.map().active_ranks(),
               "placementEpoch": self.placement.epoch,
               "owned_devices": len(_owned_device_infos(self.local))}
        if self.forward_queue is not None:
            out["forwarding"] = self.forward_queue.metrics()
        rep = getattr(self, "entity_replicator", None)
        if rep is not None:
            out["entities"] = rep.metrics()
        # explicit health states (up/suspect/down) + replication posture:
        # the operator's first stop during a partition event. The
        # per-LEADER staleness watermarks ride the health block so a
        # single lagging follower is visible here before a failover
        # read ever hits it (same series as
        # swtpu_replication_stale_ms{leader=...}).
        out["health"] = {"peers": self.health.snapshot()}
        if self.replica_applier is not None:
            out["health"]["replicationStaleMs"] = {
                str(r): ms
                for r, ms in self.replica_applier.stale_by_leader().items()}
        out["replicationFactor"] = self.replication_factor
        if self.replica_feed is not None:
            out["replicaFeed"] = self.replica_feed.metrics()
        if self.replica_applier is not None:
            out["replicaStandbys"] = self.replica_applier.standbys_status()
        return out

    @property
    def devices(self) -> _MergedDevices:
        return _MergedDevices(self)


class ClusterSearchProvider:
    """The cluster-wide face of the embedded event index: same
    ``.search``/``.info`` surface as EventSearchIndex, backed by the
    all-rank fan-out — the instance registers THIS as its "embedded"
    provider so the REST tier stays a pure provider lookup with no
    engine-topology branches."""

    def __init__(self, cluster: ClusterEngine, local_index):
        self._cluster = cluster
        self._local = local_index

    @property
    def provider_id(self) -> str:
        return self._local.provider_id

    @provider_id.setter
    def provider_id(self, value: str) -> None:
        self._local.provider_id = value

    @property
    def info(self):
        """Cluster-wide provider info: ``docs`` sums every rank's corpus
        (the listing must describe what ``search()`` actually searches,
        not the local slice). A peer whose index isn't attached yet
        counts 0, and an UNREACHABLE peer is skipped — the listing is a
        health surface, not a query, so it must not raise (search()
        itself stays loud about incomplete merges)."""
        from sitewhere_tpu_torch.search.index import SearchProviderInfo

        c = self._cluster
        docs = len(self._local.docs)
        for r in range(c.n_ranks):
            if r == c.rank:
                continue
            try:
                docs += c._peer(r).call("Cluster.searchInfo") or 0
            except (ConnectionError, TimeoutError):
                pass
        return SearchProviderInfo(
            provider_id=self._local.provider_id,
            name="Embedded event index (cluster)", docs=docs)

    def search(self, query: str, max_results: int = 100) -> list[dict]:
        docs = self._cluster.search_events(query, max_results)
        if docs is None:   # facade has no index attached: local behavior
            return self._local.search(query, max_results)
        return docs


class PeerDown:
    """Tolerant-fanout sentinel: the peer at this rank was unreachable."""

    def __init__(self, reason: str):
        self.reason = reason


def local_rank_metrics(engine) -> dict:
    """One rank's full metric set: engine counters plus the durability
    components attached to it (forward queue, spill registry, entity
    replicator) — the single source both the facade's local leg and the
    Cluster.metrics RPC handler report, so every rank's entry in
    ``by_rank`` carries the same schema."""
    m = engine.metrics()
    fq = getattr(engine, "forward_queue", None)
    if fq is not None:
        m.update(fq.metrics())
    reg = getattr(engine, "spill_registry", None)
    if reg is not None:
        m.update(reg.metrics())
    rep = getattr(engine, "entity_replicator", None)
    if rep is not None:
        m.update(rep.metrics())
    feed = getattr(engine, "replica_feed", None)
    if feed is not None:
        m.update(feed.metrics())
    applier = getattr(engine, "replica_applier", None)
    if applier is not None:
        m.update(applier.metrics())
    return m


def _placement_filtered_query(engine, kw: dict) -> dict:
    """Event query with the placement read-side filter applied:
    after a slot moves away, this rank's dead copies must not
    double-count in fan-out merges. A device-token query for a
    not-owned token short-circuits to an empty page (exact); a global
    query filters its page rows and subtracts them from the total
    (best-effort — the device-side total cannot cheaply exclude dead
    rows, so post-move global totals are an upper bound until the
    source compacts). Zero-cost until the first move ever lands."""
    pm = getattr(engine, "placement", None)
    if pm is None or not pm.ever_moved:
        return engine.query_events(**kw)
    tok = kw.get("device_token")
    if tok is not None and not pm.owns_token(tok):
        return {"total": 0, "events": []}
    res = engine.query_events(**kw)
    events = pm.filter_rows(res.get("events", []))
    dropped = len(res.get("events", [])) - len(events)
    if dropped:
        res = dict(res, events=events,
                   total=max(0, int(res.get("total", 0)) - dropped))
    return res


def _owned_device_infos(engine) -> list:
    """This rank's device mirror restricted to tokens it still OWNS
    (the moved-away entries stay in the mirror as dead records until
    compaction; listing them would double-count against the new
    owner's copy)."""
    infos = list(engine.devices.values())
    pm = getattr(engine, "placement", None)
    if pm is None or not pm.ever_moved:
        return infos
    m = pm.map()
    me = pm.cluster.rank
    return [i for i in infos if m.owner(i.token) == me]


def _owned_invocation(engine, invocation_id: int):
    """The owner-side invocation lookup (one copy for the facade's local
    branch and the Cluster.getInvocation RPC handler)."""
    svc = getattr(engine, "command_service", None)
    return svc.history.get(invocation_id) if svc is not None else None


def replay_wal_through(cluster: ClusterEngine, wal_dir,
                       after_cursor: int = -1) -> int:
    """Replay one (foreign, read-only) rank WAL through the cluster
    router: every record re-routes to its owner under the CURRENT
    partitioner and re-logs in that owner's live WAL. This is the
    rank-count elasticity tool — changing n_ranks re-partitions devices
    (ownership is token-hash % n_ranks, Kafka partition semantics), and
    replaying every old rank's WAL into a fresh cluster migrates the
    whole history exactly once per event to its new owner (the consumer-
    group re-partition-by-replay analog; SURVEY §5.4). Returns records
    replayed.

    PRECONDITION: the source WAL must be complete (never pruned) — replay
    IS the history. A log whose oldest segment was pruned after a
    snapshot no longer carries the full stream, and replaying only its
    tail would silently drop the snapshot-covered events; that case is
    refused."""
    import pathlib

    from sitewhere_tpu_torch.utils.checkpoint import replay_records
    from sitewhere_tpu_torch.utils.ingestlog import IngestLog

    segs = sorted(pathlib.Path(wal_dir).glob("segment-*.log"))
    if segs and int(segs[0].stem.split("-")[1]) != 0:
        raise ValueError(
            f"WAL {wal_dir} was pruned (oldest segment is {segs[0].name}): "
            "it no longer carries the full history — reshard_cluster "
            "needs complete WALs (disable pruning on clusters that want "
            "rank-count elasticity by replay)")
    wal = IngestLog(wal_dir, readonly=True)
    try:
        count = replay_records(wal, cluster.ingest_json_batch,
                               cluster.ingest_binary_batch,
                               after_cursor=after_cursor)
    finally:
        wal.close()
    cluster.flush()
    return count


def reshard_cluster(cluster: ClusterEngine, old_wal_dirs) -> int:
    """Migrate an old cluster's full history into ``cluster`` (fresh
    ranks, any new rank count) by replaying every old rank's WAL through
    the new partitioner. Run from ONE rank; forwarding distributes the
    records. Returns total records replayed."""
    return sum(replay_wal_through(cluster, d) for d in old_wal_dirs)


def cluster_system_jwt(secret: str) -> str:
    """System token for cross-rank calls, minted from the shared cluster
    secret (the reference's system-user JWT context)."""
    from sitewhere_tpu_torch.instance.auth import DEFAULT_ROLES, JwtService

    return JwtService(secret=secret.encode(), expiration_s=24 * 3600)\
        .generate("cluster-system", DEFAULT_ROLES["admin"])


def register_cluster_rpc(srv, engine: DistributedEngine) -> None:
    """Register the cross-rank data/admin plane over the LOCAL engine —
    the per-service gRPC surface peers dispatch into
    (DeviceStateRouter.java:62-72). Handlers bind to the concrete engine,
    never the ClusterEngine facade, so routed calls cannot recurse."""

    def _admit(tenant: str, n: int) -> None:
        """Owner-side admission: the OWNER of a forwarded
        batch enforces its tenant buckets/saturation valve — shedding at
        the edge rank alone would let forwards bypass the owner's
        discipline. A shed raises a typed ``code=429`` RpcError carrying
        the owner's Retry-After, which the sender's ForwardQueue
        classifies as an APP reject (deferred + retried, never a
        transport failure, never poison-dead-lettered)."""
        qos = getattr(engine, "qos", None)
        if qos is None:
            return
        d = qos.admit(tenant or "default", n)
        if not d.admitted:
            from sitewhere_tpu_torch.rpc.protocol import RpcError

            raise RpcError(
                f"tenant {tenant!r} shed at owner ({d.reason}): retry "
                f"after {d.retry_after_s:.3f}s", 429,
                retry_after_s=d.retry_after_s)

    def _guard_payloads(plist: list, kind: str) -> None:
        """Owner-side placement guard: a batch containing
        any slot this rank does not currently own (or is fencing)
        redirects WHOLE with a typed code=473 BEFORE anything applies
        — the no-dual-ownership half of the handoff protocol. Runs
        before admission so a redirected batch burns no tokens."""
        pm = getattr(engine, "placement", None)
        if pm is not None:
            pm.guard_payloads(plist, kind)

    def _guard_tokens(tokens) -> None:
        pm = getattr(engine, "placement", None)
        if pm is not None:
            pm.guard_tokens(tokens)

    import contextlib

    def _gate():
        """The owner-side ingest gate (placement.py): the guard check
        and the engine apply happen under one in-flight token, so a
        fence registered between them waits for this batch's WAL
        append before shipping its tail."""
        pm = getattr(engine, "placement", None)
        return pm.ingest_gate() if pm is not None \
            else contextlib.nullcontext()

    def ingest_json(payloads: list = None, tenant: str = "default",
                    lens: list = None, _attachment: bytes = None):
        plist = _wire_payloads(payloads, lens, _attachment)
        with _gate():
            _guard_payloads(plist, "json")
            _admit(tenant, len(plist))
            return engine.ingest_json_batch(plist, tenant)

    def ingest_binary(payloads: list = None, tenant: str = "default",
                      lens: list = None, _attachment: bytes = None):
        plist = _wire_payloads(payloads, lens, _attachment)
        with _gate():
            _guard_payloads(plist, "binary")
            _admit(tenant, len(plist))
            return engine.ingest_binary_batch(plist, tenant)

    def ingest_forward(fid: str, payloads: list = None,
                       tenant: str = "default", encoding: str = "json",
                       lens: list = None, _attachment: bytes = None):
        """Tagged forward: the id registry suppresses redeliveries (a
        retry after a lost response or a sender/owner restart must not
        double-ingest). Record AFTER ingest: a crash in between costs a
        duplicate (at-least-once), never a loss. A fid OLDER than the
        registry's eviction watermark can no longer be proven un-applied
        — it dead-letters (preserved, counted) instead of re-applying.
        Admission runs AFTER the dedup verdict (a duplicate redelivery
        must not burn tokens) and BEFORE any ingest (a shed is
        all-or-nothing for the sub-batch, so a later redelivery applies
        it exactly once)."""
        reg = getattr(engine, "spill_registry", None)
        if reg is not None:
            verdict = reg.check(fid)
            if verdict == "duplicate":
                return {"duplicate_forward": 1}
            if verdict == "stale":
                plist = _wire_payloads(payloads, lens, _attachment)
                reg.deadletter(fid, {
                    "fid": fid, "tenant": tenant, "encoding": encoding,
                    "payloads": [base64.b64encode(p).decode()
                                 for p in plist]})
                return {"stale_forward": len(plist)}
        plist = _wire_payloads(payloads, lens, _attachment)
        with _gate():
            _guard_payloads(plist, encoding)
            _admit(tenant, len(plist))
            if encoding == "binary":
                summary = engine.ingest_binary_batch(plist, tenant)
            else:
                summary = engine.ingest_json_batch(plist, tenant)
        if reg is not None:
            reg.record(fid)
        return summary

    def process_envelope(envelope: dict, tenant: str = "default"):
        from sitewhere_tpu_torch.ingest.decoders import request_from_envelope

        req = request_from_envelope(envelope)
        req.tenant = tenant
        with _gate():
            _guard_tokens([req.device_token])
            _admit(tenant, 1)
            engine.process(req)
        return {"accepted": True}

    def forward_envelope(fid: str, envelope: dict,
                         tenant: str = "default"):
        reg = getattr(engine, "spill_registry", None)
        if reg is not None:
            verdict = reg.check(fid)
            if verdict == "duplicate":
                return {"duplicate_forward": 1}
            if verdict == "stale":
                reg.deadletter(fid, {"fid": fid, "tenant": tenant,
                                     "envelope": envelope})
                return {"stale_forward": 1}
        res = process_envelope(envelope, tenant)
        if reg is not None:
            reg.record(fid)
        return res

    def register_device(token: str, deviceType: str = None,
                        tenant: str = "default", area: str = None,
                        customer: str = None, metadata: dict = None):
        _guard_tokens([token])
        engine.register_device(token, deviceType, tenant, area, customer,
                               metadata)
        return {"registered": True}

    def update_device(token: str, deviceType: str = None, area: str = None,
                      customer: str = None, metadata: dict = None):
        _guard_tokens([token])
        try:
            engine.update_device(token, deviceType, area, customer, metadata)
        except KeyError:
            return None
        return {"updated": True}

    def delete_device(token: str):
        _guard_tokens([token])
        return engine.delete_device(token)

    def get_device(token: str):
        info = engine.get_device(token)
        return dataclasses.asdict(info) if info is not None else None

    def list_assignments(token: str = None, **kw):
        return [dataclasses.asdict(a)
                for a in engine.list_assignments(token, **kw)]

    def get_device_state(token: str):
        return engine.get_device_state(token)

    def create_assignment(deviceToken: str, token: str = None,
                          asset: str = None, area: str = None,
                          customer: str = None, metadata: dict = None):
        _guard_tokens([deviceToken])
        return dataclasses.asdict(engine.create_assignment(
            deviceToken, token, asset, area, customer, metadata))

    def get_assignment(token: str):
        a = engine.get_assignment(token)
        return dataclasses.asdict(a) if a is not None else None

    def release_assignment(token: str):
        return dataclasses.asdict(engine.release_assignment(token))

    def mark_assignment_missing(token: str):
        return dataclasses.asdict(engine.mark_assignment_missing(token))

    def update_assignment(token: str, asset: str = None, area: str = None,
                          customer: str = None, metadata: dict = None):
        return dataclasses.asdict(engine.update_assignment(
            token, asset, area, customer, metadata))

    def delete_assignment(token: str):
        return engine.delete_assignment(token)

    def search_device_states(**kw):
        rows = engine.search_device_states(**kw)
        pm = getattr(engine, "placement", None)
        if pm is not None:
            rows = pm.filter_rows(rows, key="device")
        return rows

    def query_events(**kw):
        return _placement_filtered_query(engine, kw)

    def get_event(eventId: int, tenant: str = None):
        return engine.get_event(eventId, tenant=tenant)

    def list_device_infos():
        return [dataclasses.asdict(i) for i in _owned_device_infos(engine)]

    def device_count():
        return len(_owned_device_infos(engine))

    def metrics():
        return local_rank_metrics(engine)

    def metrics_text():
        """This rank's registry exposition (exemplars kept — the caller
        is the federated scrape, which re-labels by rank). The export
        runs HERE, against the local engine, so each rank's text
        reflects its own partition."""
        from sitewhere_tpu_torch.utils.metrics import (REGISTRY,
                                                 export_engine_metrics)

        export_engine_metrics(engine)
        return REGISTRY.expose_text(exemplars=True)

    def tenant_metrics():
        return engine.tenant_metrics()

    def presence_sweep():
        return engine.presence_sweep()

    def command_responses(invocationId: str, limit: int = 100):
        from sitewhere_tpu_torch.commands.service import local_command_responses

        return local_command_responses(engine, invocationId, limit)

    def get_invocation(invocationId: int):
        inv = _owned_invocation(engine, invocationId)
        return dataclasses.asdict(inv) if inv is not None else None

    def invoke_command(invocation: dict):
        svc = getattr(engine, "command_service", None)
        if svc is None:
            raise ValueError(
                "no command-delivery service attached on this rank")
        from sitewhere_tpu_torch.commands.model import CommandInvocation

        return {"invocationId": svc.accept_remote(
            CommandInvocation(**invocation))}

    def search_info():
        idx = getattr(engine, "search_index", None)
        return len(idx.docs) if idx is not None else None

    def search_events(query: str, maxResults: int = 100):
        # the rank's embedded index attaches AFTER server construction
        # (instance wiring) — resolve lazily; None (vs []) tells the
        # caller this rank cannot serve search, never "no matches"
        idx = getattr(engine, "search_index", None)
        return (idx.search(query, maxResults, order="eventDate")
                if idx is not None else None)

    def flush():
        return engine.flush()

    def conservation():
        """This rank's conservation ledger + verdict — the
        facade's ``conservation()`` fans these out into one by-rank
        document; rank ledgers never merge into one snapshot (each
        rank's equations balance against its OWN device counters)."""
        from sitewhere_tpu_torch.utils.conservation import conservation_payload

        return conservation_payload(engine)

    def spmd_heat():
        """This rank's shard heat & skew document — the
        facade's ``spmd_heat()`` fans these out into one by-rank
        document; heat maps never merge (each rank's shards are its
        OWN mesh)."""
        from sitewhere_tpu_torch.utils.shardobs import spmd_heat_payload

        return spmd_heat_payload(engine)

    def trace_get(traceId: str):
        return engine.flight.records_of(traceId)

    def trace_recent(limit: int = 50):
        return engine.flight.recent(limit)

    def trace_timeline(traceId: str):
        # rank-LOCAL chrome events (pid = this rank); the calling
        # facade stitches rank lists into one timeline document
        from sitewhere_tpu_torch.utils.tracing import timeline_events

        return timeline_events(engine, traceId)

    for name, fn in {
        "Cluster.ingestJson": ingest_json,
        "Cluster.ingestBinary": ingest_binary,
        "Cluster.ingestForward": ingest_forward,
        "Cluster.processEnvelope": process_envelope,
        "Cluster.forwardEnvelope": forward_envelope,
        "Cluster.registerDevice": register_device,
        "Cluster.updateDevice": update_device,
        "Cluster.deleteDevice": delete_device,
        "Cluster.getDevice": get_device,
        "Cluster.listAssignments": list_assignments,
        "Cluster.createAssignment": create_assignment,
        "Cluster.getAssignment": get_assignment,
        "Cluster.releaseAssignment": release_assignment,
        "Cluster.markAssignmentMissing": mark_assignment_missing,
        "Cluster.updateAssignment": update_assignment,
        "Cluster.deleteAssignment": delete_assignment,
        "Cluster.getDeviceState": get_device_state,
        "Cluster.searchDeviceStates": search_device_states,
        "Cluster.queryEvents": query_events,
        "Cluster.getEvent": get_event,
        "Cluster.listDeviceInfos": list_device_infos,
        "Cluster.deviceCount": device_count,
        "Cluster.metrics": metrics,
        "Cluster.metricsText": metrics_text,
        "Cluster.tenantMetrics": tenant_metrics,
        "Cluster.presenceSweep": presence_sweep,
        "Cluster.invokeCommand": invoke_command,
        "Cluster.getInvocation": get_invocation,
        "Cluster.commandResponses": command_responses,
        "Cluster.searchEvents": search_events,
        "Cluster.searchInfo": search_info,
        "Cluster.traceGet": trace_get,
        "Cluster.traceRecent": trace_recent,
        "Cluster.traceTimeline": trace_timeline,
        "Cluster.conservation": conservation,
        "Cluster.spmdHeat": spmd_heat,
        "Cluster.flush": flush,
    }.items():
        srv.register(name, fn)


def build_cluster_rpc(engine: DistributedEngine, secret: str):
    """The rank's RPC server: cluster data plane, authenticated with the
    shared cluster secret (unauthenticated peers are rejected exactly like
    the instance RPC). Its handlers run under the CUDA streams current on
    the calling thread (``CardRpcServer``): build it where the engine was
    built."""
    from sitewhere_tpu_torch.instance.auth import JwtService

    jwt = JwtService(secret=secret.encode(), expiration_s=24 * 3600)
    srv = CardRpcServer(card_streams(engine), authenticator=jwt.validate)
    register_cluster_rpc(srv, engine)
    from sitewhere_tpu_torch.parallel.placement import register_placement_rpc

    register_placement_rpc(srv, engine)
    return srv
