"""Elastic tenant placement: versioned ownership + epoch-fenced handoff.

Ownership before this module was the static partitioner
``owner_rank(token, n_ranks)`` (parallel/cluster.py) — Kafka partition
semantics, where the only topology change is the OFFLINE path (drain
every rank, ``migrate_cluster_snapshots``, restart). A production fleet
adds and drains hosts under live traffic. This module is that
capability, built from pieces the repo already trusts: WAL replay for
catch-up, the forward queue's spill/redelivery discipline for in-flight
re-routing, and the conservation ledger to prove nothing was lost.

The model
---------

* The cluster's PROVISIONED rank set (``ClusterConfig.peers``) is fixed
  — addresses are known up front, exactly like a stateful set's
  ordinals. Elasticity is which provisioned ranks are ACTIVE (own
  slots), and that is the placement map's job. Event-id tagging
  (``local * n_ranks + rank``) therefore never changes shape.
* Tokens hash into a FIXED slot space: ``slot = owner_rank(token,
  n_slots)`` with ``n_slots = n_ranks * slots_per_rank`` chosen at
  cluster genesis (Redis-Cluster-style hash slots). The INITIAL map
  assigns ``slot -> slot % n_ranks``, which — because ``n_ranks``
  divides ``n_slots`` — is byte-identical to the legacy
  ``owner_rank(token, n_ranks)`` partitioner: adopting the placement
  plane re-routes nothing.
* A :class:`PlacementMap` is immutable and EPOCH-numbered. Every
  ownership read (facade routing, forward partitioning, owner-side
  guards, scheduler fire-over, replica-ring derivation) resolves
  through the rank's installed map, so all surfaces agree on one epoch
  at any instant (pinned by tests/test_placement.py). A rank never
  adopts a lower epoch.

The handoff protocol (one move = one source rank, >= 1 slots, one
target rank; coordinated from any rank)
---------------------------------------

1. **catch-up** — the target first builds a CONTENT FILTER from its
   own WAL (``handoff_prepare``: the multiset of moving-slot records it
   already holds — so a range returning to a former owner, or a retried
   move whose earlier attempt partially applied, never re-ingests what
   is already there). The source then replays its WAL records whose
   token hashes into a moving slot straight into the target's LIVE
   engine (``Placement.handoffApply``: decode + WAL + dedup happen at
   the target, in its own interner space — the route-then-decode rule).
   Shipments carry position-deterministic forward ids, so a
   killed-and-retried pass is suppressed by the target's SpillRegistry,
   never re-applied.
   Repeated passes ship only the delta (the cursor is "matching records
   shipped so far"; WAL order is append-only and stable). A PRUNED
   source WAL is refused loudly BEFORE anything ships — pruned history
   lives in snapshots/archives, which is the offline
   (``cluster_reshard``) path's job.
2. **fence** — the source, under its engine lock, fences the moving
   slots: ingest for them now fails with a typed ``code=473`` redirect
   (never applied, never lost — the sender's ForwardQueue spills and
   re-routes; the facade's own payloads briefly wait on the fence).
   The WAL tail since the catch-up cursor then ships, and the target
   VERIFIES the applied watermark (every shipped forward id recorded)
   before the fence round returns.
3. **commit** — the coordinator installs ``map.with_moves(...)`` (epoch
   + 1) locally and broadcasts it (tolerant: a down rank adopts later
   from any redirect, which carries the replier's map). The commit
   install at the SOURCE is itself the completion: it drops the fences
   for the moved-away slots and closes the move, so a lost
   ``handoffFinish`` leaves nothing dangling. A coordinator dead BEFORE
   commit is covered by the fence deadline (an expired fence aborts the
   move — the map never changed, the source still owns, nothing was
   acked and lost), and the fence round itself re-verifies + re-arms
   its fences after the tail ship so an expiry mid-ship can never
   commit.

Crash matrix (chaos-gated in tests/test_placement.py and the bench
placement leg): source killed -> coordinator aborts, map unchanged,
target's partial copy is invisible (reads filter to owned slots);
target killed -> catch-up RPC fails, abort, source still sole owner;
coordinator killed pre-commit -> the fence deadline unfences the
source; coordinator killed post-partial-broadcast -> stale ranks
converge via redirect-with-map (the higher epoch always wins).

Known limits (documented, deliberate): a move re-ingests WAL history at
the target, so moved events get new rank-scoped ids and a fresh
``received_ms`` (event-time columns are payload-carried and survive
exactly — the offline reshard has the same contract); the source keeps
its dead rows (filtered from every read) until the operator compacts;
assignments created through the admin path are not WAL-carried and do
not migrate (the offline path, or re-creation, covers them); the
residual duplicate window of forwarding (owner applied + recorded, reply
lost, redelivery lands post-move at the target) is closed by the
engine-level alternate-id dedup exactly as before.

A port of ``sitewhere_tpu/parallel/placement.py``. ``owner_rank`` lives
here (``parallel/cluster.py`` imports it), so the slot map of the
multi-shard engines and of the cluster is one function.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import threading
import time

logger = logging.getLogger(__name__)

# ownership redirect: the typed "not mine" reject (HTTP has no exact
# analog; 473 sits in the 4xx "caller must re-route" family). The error
# frame's data payload carries the replier's placement map so a stale
# sender converges in one hop.
REDIRECT_CODE = 473

DEFAULT_SLOTS_PER_RANK = 8


_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_MASK64 = (1 << 64) - 1


def owner_rank(token: str, n_ranks: int) -> int:
    """Owning rank of a device token: FNV-1a over the token STRING —
    stable across processes, restarts, and interner orders (the process-
    level Kafka partitioner). ``cluster.owner_rank`` is this function."""
    h = _FNV_OFFSET
    for b in token.encode():
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h % n_ranks


def _slot_of(token: str, n_slots: int) -> int:
    return owner_rank(token, n_slots)


def slot_for_token(token: str, n_shards: int,
                   slots_per_rank: int = DEFAULT_SLOTS_PER_RANK) -> int:
    """The placement SLOT a token hashes into in an SPMD store's slot
    space (``n_slots = n_shards * slots_per_rank``) — the identity the
    shard heat plane attributes routed rows to, and the unit
    ``decide_balance`` moves."""
    return _slot_of(token, n_shards * slots_per_rank)


def shard_for_token(token: str, n_shards: int,
                    slots_per_rank: int = DEFAULT_SLOTS_PER_RANK) -> int:
    """THE slot -> shard map of the SPMD store: tokens hash
    into the same fixed slot space as cluster placement (``n_slots =
    n_shards * slots_per_rank``) and shards take the genesis assignment
    ``slot % n_shards``. Because ``n_shards`` divides ``n_slots`` this
    is byte-identical to the legacy ``owner_rank(token, n_shards)``
    partitioner — a token lands on the same index whether "index" means
    a cluster rank or an SPMD mesh shard, so placement tooling and the
    conservation ledger carry over unmodified."""
    return slot_for_token(token, n_shards, slots_per_rank) % n_shards


@dataclasses.dataclass(frozen=True)
class PlacementMap:
    """Immutable, epoch-numbered slot->rank directory. ``n_slots`` is
    fixed at cluster genesis; elasticity is re-assigning slots, never
    re-hashing tokens."""

    epoch: int
    n_slots: int
    assignment: tuple[int, ...]

    @staticmethod
    def initial(n_ranks: int,
                slots_per_rank: int = DEFAULT_SLOTS_PER_RANK,
                active_ranks: "list[int] | None" = None) -> "PlacementMap":
        """The genesis map. With every provisioned rank active the
        assignment is ``slot -> slot % n_ranks`` — byte-identical to the
        legacy ``owner_rank(token, n_ranks)`` partitioner (``n_ranks``
        divides ``n_slots``). With ``active_ranks`` a strict subset
        (ranks provisioned for a later join), slots round-robin over the
        active set only."""
        n_slots = n_ranks * max(1, int(slots_per_rank))
        if active_ranks is None:
            assign = tuple(s % n_ranks for s in range(n_slots))
        else:
            act = sorted(set(int(r) for r in active_ranks))
            if not act or any(r < 0 or r >= n_ranks for r in act):
                raise ValueError(
                    f"active_ranks {active_ranks} outside provisioned "
                    f"range [0, {n_ranks})")
            assign = tuple(act[s % len(act)] for s in range(n_slots))
        return PlacementMap(epoch=1, n_slots=n_slots, assignment=assign)

    def slot_of(self, token: str) -> int:
        return _slot_of(token, self.n_slots)

    def owner_of_slot(self, slot: int) -> int:
        return self.assignment[slot]

    def owner(self, token: str) -> int:
        return self.assignment[self.slot_of(token)]

    def active_ranks(self) -> list[int]:
        return sorted(set(self.assignment))

    def slots_of(self, rank: int) -> list[int]:
        return [s for s, r in enumerate(self.assignment) if r == rank]

    def with_moves(self, moves: dict[int, int]) -> "PlacementMap":
        """The next epoch with ``{slot: new_rank}`` applied."""
        assign = list(self.assignment)
        for slot, rank in moves.items():
            if not (0 <= int(slot) < self.n_slots):
                raise ValueError(f"slot {slot} outside [0, {self.n_slots})")
            assign[int(slot)] = int(rank)
        return PlacementMap(epoch=self.epoch + 1, n_slots=self.n_slots,
                            assignment=tuple(assign))

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "nSlots": self.n_slots,
                "assignment": list(self.assignment)}

    @staticmethod
    def from_dict(d: dict) -> "PlacementMap":
        assign = tuple(int(r) for r in d["assignment"])
        n_slots = int(d["nSlots"])
        if len(assign) != n_slots:
            raise ValueError(
                f"placement assignment length {len(assign)} != nSlots "
                f"{n_slots}")
        return PlacementMap(epoch=int(d["epoch"]), n_slots=n_slots,
                            assignment=assign)


@dataclasses.dataclass
class _Move:
    """Source-side state of one in-flight handoff."""

    move_id: str
    slots: tuple[int, ...]
    target: int
    state: str = "catchup"          # catchup | fenced | done | aborted
    shipped_records: int = 0        # WAL-record cursor (matching records)
    shipped_batches: int = 0
    shipped_payloads: int = 0
    fids: list = dataclasses.field(default_factory=list)
    started_mono: float = dataclasses.field(default_factory=time.monotonic)
    fence_deadline: float | None = None


class PlacementManager:
    """One per rank: the installed map, the rank's fences, the
    source-side handoff machinery, and the counters every surface
    (metrics, conservation, debug bundle) reads. Attached to both the
    ClusterEngine facade and its local engine (the forward_queue
    pattern), so cluster RPC handlers — which bind to the engine —
    reach it."""

    def __init__(self, cluster, pmap: PlacementMap,
                 directory: "str | pathlib.Path | None" = None,
                 fence_timeout_s: float = 20.0,
                 move_timeout_s: float = 120.0):
        self.cluster = cluster
        self.dir = pathlib.Path(directory) if directory else None
        self.fence_timeout_s = float(fence_timeout_s)
        self.move_timeout_s = float(move_timeout_s)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._map = pmap
        self._cache_map_views(pmap)
        # target-side content filters of in-flight handoffs, keyed by
        # move id: a Counter of (kind, tenant, payload-digest) this rank
        # ALREADY holds for the moving slots (built by handoff_prepare
        # from its OWN WAL). The apply path consumes it so a replay
        # never re-ingests what a former ownership era (or an aborted
        # earlier attempt) already applied — the no-dual-apply half of
        # the protocol for RETURNING ranges.
        self._prepared: dict[str, dict] = {}
        # lock-free fast-path flag the facade reads per ingest batch:
        # True only while >= 1 slot is fenced here (rare, short)
        self.has_fences = False
        # in-flight ingest gate: every owner-side ingest (facade local
        # sub-batch, cluster RPC ingest handlers) holds it from its
        # fence/guard check through its engine apply. The fence step
        # registers fences FIRST, then waits for the gate to drain, so
        # a batch that checked pre-fence has finished its WAL append
        # before the tail extents are captured — without this, a racing
        # batch could slip an acked record past the shipped tail and
        # lose it to the commit (the dual-window this protocol exists
        # to close).
        self._inflight = 0
        # slot -> (target rank, move_id, deadline): writes for fenced
        # slots redirect (code 473, no map attached — "retry shortly")
        self._fences: dict[int, tuple[int, str, float]] = {}
        self._moves: dict[str, _Move] = {}
        # True once ANY epoch > genesis was seen here: the read-side
        # owned-slot filter arms only then, so the no-move fleet pays
        # nothing on the query path
        self.ever_moved = False
        # the bench's overhead estimator toggles enforcement per frame;
        # production never flips this
        self.enforce = True
        self.counters = {"moves_started": 0, "moves_completed": 0,
                         "moves_aborted": 0, "fenced_write_redirects": 0,
                         "stale_sender_redirects": 0,
                         "maps_installed": 0, "maps_refused": 0,
                         "handoff_shipped_batches": 0,
                         "handoff_shipped_payloads": 0}
        if self.dir is not None:
            self.dir.mkdir(parents=True, exist_ok=True)
            loaded = self._load()
            if loaded is not None and loaded.epoch > self._map.epoch:
                self._map = loaded
                self._cache_map_views(loaded)
                self.ever_moved = loaded.epoch > 1

    # ------------------------------------------------------------ map
    def _cache_map_views(self, pmap: PlacementMap) -> None:
        """Per-install caches for the per-batch hot paths: a numpy
        assignment table (the guard's vectorized ownership check) and
        the plain routing list (the partitioner's no-fence fast path).
        Replaced WHOLESALE with the map, so lock-free readers see a
        consistent view."""
        import numpy as np

        self._assign_np = np.asarray(pmap.assignment, dtype=np.int64)
        self._routing_nofence = list(pmap.assignment)

    def map(self) -> PlacementMap:
        # _map is replaced wholesale under the lock; a bare read is a
        # consistent snapshot (the per-batch hot paths ride this)
        return self._map

    @property
    def epoch(self) -> int:
        return self.map().epoch

    def owner(self, token: str) -> int:
        return self.map().owner(token)

    def slot_of(self, token: str) -> int:
        return self.map().slot_of(token)

    def data_ranks(self) -> list[int]:
        """The ranks a data fan-out (queries, flush, sweeps) must cover:
        every slot-owning rank plus this one. A drained rank leaves this
        set the instant the commit epoch lands, so its departure never
        fails a query."""
        m = self.map()
        return sorted(set(m.assignment) | {self.cluster.rank})

    def slot_routing(self) -> list[int]:
        """slot -> rank for INGEST routing: the installed map with this
        rank's fences substituted by their targets, so the facade's own
        payloads for a fencing slot head toward the new owner's durable
        spill queue instead of the fenced engine. Lock-free cached list
        on the (overwhelmingly common) no-fence path."""
        if not self.has_fences:
            return self._routing_nofence
        with self._lock:
            self._expire_fences_locked()
            routing = list(self._map.assignment)
            for slot, (target, _mid, _dl) in self._fences.items():
                routing[slot] = target
            return routing

    def _persist_locked(self) -> None:
        if self.dir is None:
            return
        tmp = self.dir / "placement.json.tmp"
        tmp.write_text(json.dumps(self._map.to_dict()))
        tmp.rename(self.dir / "placement.json")

    def _load(self) -> "PlacementMap | None":
        try:
            return PlacementMap.from_dict(json.loads(
                (self.dir / "placement.json").read_text()))
        except (OSError, ValueError, KeyError):
            return None

    def install(self, map_dict: dict) -> bool:
        """Adopt a map iff its epoch is strictly higher (same-epoch
        re-install is an idempotent no-op; a LOWER epoch is refused —
        fencing: a partitioned coordinator's stale commit can never
        roll ownership back). Dropping fences for slots this rank no
        longer owns happens here: once the commit epoch lands, the map
        itself routes the slot away."""
        new = PlacementMap.from_dict(map_dict)
        with self._cv:
            if new.epoch < self._map.epoch:
                self.counters["maps_refused"] += 1
                return False
            if new.epoch == self._map.epoch:
                if new.assignment != self._map.assignment:
                    self.counters["maps_refused"] += 1
                    logger.error(
                        "rank %d: refused placement epoch %d with a "
                        "DIFFERENT assignment than the installed one "
                        "(split-brain commit?)", self.cluster.rank,
                        new.epoch)
                    return False
                return True
            if new.n_slots != self._map.n_slots:
                self.counters["maps_refused"] += 1
                raise ValueError(
                    f"placement n_slots {new.n_slots} != configured "
                    f"{self._map.n_slots}: the slot space is fixed at "
                    "cluster genesis")
            self._map = new
            self._cache_map_views(new)
            if new.epoch > 1:
                self.ever_moved = True
            me = self.cluster.rank
            for slot in [s for s in self._fences
                         if new.assignment[s] != me]:
                self._fences.pop(slot, None)
            self.has_fences = bool(self._fences)
            # the commit epoch IS the completion: close any of OUR
            # in-flight moves this map realizes, so a lost
            # handoffFinish cannot leave a phantom "fenced" move
            # (its fences are gone, so no deadline would ever fire)
            for mv in self._moves.values():
                if (mv.state in ("catchup", "fenced") and mv.slots
                        and all(new.assignment[s] == mv.target
                                for s in mv.slots)):
                    mv.state = "done"
                    self.counters["moves_completed"] += 1
                    _placement_instruments()["moves"].inc(
                        state="completed")
            self.counters["maps_installed"] += 1
            self._persist_locked()
            self._cv.notify_all()
            logger.info("rank %d: placement epoch %d installed "
                        "(active ranks %s)", me, new.epoch,
                        new.active_ranks())
            return True

    def sync_from_peers(self) -> int:
        """Pull the highest placement epoch any reachable peer holds
        (join/boot convergence; redirects keep the steady state
        converged). Returns the epoch in force afterwards."""
        c = self.cluster
        for r in range(c.n_ranks):
            if r == c.rank:
                continue
            try:
                d = c._peer(r).call("Placement.get")
            except (ConnectionError, TimeoutError):
                continue
            if d and int(d.get("epoch", 0)) > self.map().epoch:
                self.install(d)
        return self.map().epoch

    # --------------------------------------------------------- fences
    def _expire_fences_locked(self) -> None:
        now = time.monotonic()
        for slot in [s for s, (_t, mid, dl) in self._fences.items()
                     if dl < now]:
            _t, mid, _dl = self._fences.pop(slot)
            self.has_fences = bool(self._fences)
            mv = self._moves.get(mid)
            if mv is not None and mv.state == "fenced":
                mv.state = "aborted"
                self.counters["moves_aborted"] += 1
                logger.warning(
                    "rank %d: fence for move %s expired without a "
                    "commit — move aborted, this rank still owns "
                    "slots %s", self.cluster.rank, mid, mv.slots)
        self._cv.notify_all()

    def fenced_slots(self) -> dict[int, int]:
        with self._lock:
            self._expire_fences_locked()
            return {s: t for s, (t, _m, _d) in self._fences.items()}

    def wait_unfenced(self, slots, timeout_s: float = 5.0) -> None:
        """Block until none of ``slots`` is fenced here (or timeout).
        The facade's own ingest path uses this so a fence window costs
        its payloads the fence DURATION, not a spill/redeliver round
        trip."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while True:
                self._expire_fences_locked()
                if not any(s in self._fences for s in slots):
                    return
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                self._cv.wait(min(left, 0.05))

    def ingest_gate(self):
        """Context manager every owner-side ingest path holds across
        its fence check AND engine apply (see ``_inflight``). One lock
        inc/dec per batch — negligible next to decode+dispatch."""
        return _IngestGate(self)

    def _drain_ingests(self, timeout_s: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    logger.warning(
                        "rank %d: %d ingest(s) still in flight after "
                        "%.1fs fence drain — proceeding (their records "
                        "land before the extents capture takes the "
                        "engine lock they hold)", self.cluster.rank,
                        self._inflight, timeout_s)
                    return False
                self._cv.wait(min(left, 0.05))
        return True

    # ---------------------------------------------------------- guard
    def redirect_error(self, reason: str, fenced: bool = False):
        """The typed ownership reject. A MOVED redirect attaches this
        rank's map (the sender adopts the higher epoch and re-routes in
        one hop); a FENCED redirect attaches a short retry hint instead
        — the commit is in flight and the sender must neither apply
        here nor guess the target early."""
        from sitewhere_tpu_torch.rpc.protocol import RpcError

        if fenced:
            self.counters["fenced_write_redirects"] += 1
            _placement_instruments()["redirects"].inc(kind="fenced")
            return RpcError(f"placement fence: {reason}", REDIRECT_CODE,
                            retry_after_s=0.05,
                            data={"fenced": True,
                                  "epoch": self.map().epoch})
        self.counters["stale_sender_redirects"] += 1
        _placement_instruments()["redirects"].inc(kind="stale")
        return RpcError(f"placement redirect: {reason}", REDIRECT_CODE,
                        data={"map": self.map().to_dict()})

    def guard_tokens(self, tokens) -> None:
        """Owner-side write guard for token-addressed surfaces
        (process/admin paths): every token must hash into a slot this
        rank owns and is not fencing, else the whole call redirects
        BEFORE anything applies (all-or-nothing, like the QoS shed)."""
        if not self.enforce:
            return
        m = self.map()
        me = self.cluster.rank
        with self._lock:
            self._expire_fences_locked()
            fences = set(self._fences)
        for tok in tokens:
            slot = m.slot_of(tok)
            if slot in fences:
                raise self.redirect_error(
                    f"slot {slot} ({tok!r}) is mid-handoff", fenced=True)
            if m.assignment[slot] != me:
                raise self.redirect_error(
                    f"slot {slot} ({tok!r}) owned by rank "
                    f"{m.assignment[slot]} at epoch {m.epoch}")

    def guard_payloads(self, payloads: list, kind: str) -> None:
        """Owner-side write guard for the batch ingest surfaces: one
        native route pass classifies every payload's slot; any
        not-owned or fenced slot redirects the WHOLE batch pre-ingest
        (the sender re-partitions under the newer map — a partial apply
        here would be exactly the dual-ownership window the protocol
        exists to prevent). Unroutable payloads (slot < 0) pass: the
        engine's dead-letter path owns them wherever they land. Hot
        path: one native route call + one vectorized gather — no lock
        unless a fence is up (the bench gates this <= 3%)."""
        if not self.enforce or not payloads:
            return
        import numpy as np
        from sitewhere_tpu_torch.native.binding import route_payloads

        m = self.map()
        me = self.cluster.rank
        fences = None
        if self.has_fences:
            with self._lock:
                self._expire_fences_locked()
                fences = set(self._fences)
        slots = route_payloads(payloads, m.n_slots,
                               binary=(kind == "binary"))
        if slots is not None and not fences:
            s = slots.astype(np.int64)
            owners = self._assign_np[np.clip(s, 0, m.n_slots - 1)]
            bad = s[(s >= 0) & (owners != me)]
            if not bad.size:
                return
            slot = int(bad[0])
            raise self.redirect_error(
                f"slot {slot} owned by rank {m.assignment[slot]} "
                f"at epoch {m.epoch}")
        slot_list = ([int(x) for x in slots.tolist()]
                     if slots is not None
                     else _payload_slots(payloads, kind, m.n_slots))
        for slot in slot_list:
            if slot < 0:
                continue
            if fences and slot in fences:
                raise self.redirect_error(
                    f"slot {slot} is mid-handoff", fenced=True)
            if m.assignment[slot] != me:
                raise self.redirect_error(
                    f"slot {slot} owned by rank {m.assignment[slot]} "
                    f"at epoch {m.epoch}")

    # ------------------------------------------------- read filtering
    def owns_token(self, token: str) -> bool:
        return self.map().owner(token) == self.cluster.rank

    def filter_rows(self, rows: list, key: str = "deviceToken") -> list:
        """Drop rows whose token's slot this rank no longer owns — the
        read-side half of single ownership: after a move, the source's
        dead copies (and a target's pre-commit partial copy after an
        abort) must not double-count in fan-out merges. Zero-cost until
        the first move ever lands (``ever_moved``)."""
        if not self.ever_moved:
            return rows
        m = self.map()
        me = self.cluster.rank
        return [row for row in rows
                if (tok := row.get(key)) is None
                or m.owner(tok) == me]

    # ----------------------------------------------- source-side moves
    def _move(self, move_id: str) -> _Move:
        with self._lock:
            mv = self._moves.get(move_id)
            if mv is None:
                raise KeyError(f"unknown move {move_id!r}")
            return mv

    def _gc_moves_locked(self) -> None:
        now = time.monotonic()
        for mid in [m for m, mv in self._moves.items()
                    if mv.state == "catchup"
                    and now - mv.started_mono > self.move_timeout_s]:
            self._moves[mid].state = "aborted"
            self.counters["moves_aborted"] += 1
            logger.warning("rank %d: move %s timed out in catch-up — "
                           "aborted", self.cluster.rank, mid)

    def handoff_start(self, move_id: str, slots: list, target: int) -> dict:
        """Source-side move registration (idempotent). Refuses slots
        this rank does not own, a target outside the provisioned set,
        and — loudly, before anything ships — a PRUNED WAL: catch-up IS
        WAL replay, and a pruned log no longer carries the full acked
        history (the offline snapshot path owns that case)."""
        m = self.map()
        me = self.cluster.rank
        slots = tuple(sorted(int(s) for s in slots))
        for s in slots:
            if m.assignment[s] != me:
                raise ValueError(
                    f"slot {s} is owned by rank {m.assignment[s]}, not "
                    f"this rank ({me}) — cannot hand off")
        if not (0 <= int(target) < self.cluster.n_ranks):
            raise ValueError(f"target rank {target} not provisioned")
        if int(target) == me:
            raise ValueError("target rank is the source rank")
        eng = self.cluster.local
        wal = getattr(eng, "wal", None)
        if wal is not None:
            segs = sorted(pathlib.Path(wal.dir).glob("segment-*.log"))
            if segs and int(segs[0].stem.split("-")[1]) != 0:
                raise ValueError(
                    f"rank {me} WAL was pruned (oldest segment "
                    f"{segs[0].name}): online handoff replays the WAL "
                    "and would silently drop the pruned span — use the "
                    "offline cluster_reshard path")
        with self._lock:
            self._gc_moves_locked()
            mv = self._moves.get(move_id)
            if mv is None:
                mv = self._moves[move_id] = _Move(move_id, slots,
                                                 int(target))
                self.counters["moves_started"] += 1
                _placement_instruments()["moves"].inc(state="started")
            if mv.state == "aborted":
                raise ValueError(f"move {move_id} already aborted")
        return {"moveId": move_id, "slots": list(slots),
                "target": int(target), "state": mv.state}

    def _wal_extents(self) -> dict:
        """Durable byte extents of the source WAL, captured under the
        engine lock (the ReplicaFeed resync discipline: nothing beyond
        the durable watermark, no torn user-space tail)."""
        eng = self.cluster.local
        wal = getattr(eng, "wal", None)
        with eng.lock:
            if wal is None:
                return {}
            if wal.group_commit:
                wal.wait_durable(getattr(eng, "_wal_last_seq", 0))
                return wal.durable_view()
            wal.flush()
            return {p.name: p.stat().st_size
                    for p in sorted(wal.dir.glob("segment-*.log"))}

    def _ship_delta(self, mv: _Move, chunk: int = 256) -> int:
        """Ship every not-yet-shipped WAL record whose token hashes into
        a moving slot (the cursor is a count over MATCHING records —
        WAL order is append-only and stable, so skip-then-ship is
        exact). Returns records shipped this pass. Deterministic fids
        (`<move>-<idx>`) make retries idempotent at the target."""
        from sitewhere_tpu_torch.parallel.replication import _read_wal_records

        eng = self.cluster.local
        wal = getattr(eng, "wal", None)
        if wal is None:
            return 0
        extents = self._wal_extents()
        n_slots = self.map().n_slots
        moving = set(mv.slots)
        wal_dir = pathlib.Path(wal.dir)
        seen = shipped = 0
        batch: list[bytes] = []
        batch_key: "tuple[str, str] | None" = None
        batch_start = 0   # cursor position of the batch's first record

        def flush_batch():
            """Ship one batch with a POSITION-deterministic fid: a
            retried pass (target briefly down, response lost) re-ships
            the SAME records under the SAME fid, so the target's
            registry suppresses the duplicate instead of re-applying.
            The cursor advances only on a confirmed apply — a mid-pass
            failure resumes exactly where durability stopped."""
            nonlocal batch, shipped
            if not batch:
                return
            kind, tenant = batch_key
            fid = f"{mv.move_id}-r{batch_start:09d}"
            self.cluster._peer(mv.target).call(
                "Placement.handoffApply", moveId=mv.move_id, fid=fid,
                encoding=kind, tenant=tenant,
                lens=[len(p) for p in batch],
                _attachment=b"".join(batch))
            if fid not in mv.fids:
                mv.fids.append(fid)
            mv.shipped_batches += 1
            mv.shipped_payloads += len(batch)
            mv.shipped_records = batch_start + len(batch)
            self.counters["handoff_shipped_batches"] += 1
            self.counters["handoff_shipped_payloads"] += len(batch)
            shipped += len(batch)
            batch = []

        # chunked native routing over a record window keeps the hash in
        # C for the common (large-history) case
        window: list[tuple[str, str, bytes]] = []

        def drain_window():
            nonlocal window, seen, batch_key, batch_start
            if not window:
                return
            slots = _payload_slots([p for _k, _t, p in window],
                                   "mixed", n_slots,
                                   kinds=[k for k, _t, _p in window])
            for (kind, tenant, payload), slot in zip(window, slots):
                if slot < 0 or slot not in moving:
                    continue
                seen += 1
                if seen <= mv.shipped_records:
                    continue   # shipped by an earlier pass
                key = (kind, tenant)
                if batch and (key != batch_key or len(batch) >= chunk):
                    flush_batch()
                if not batch:
                    batch_start = seen - 1
                batch_key = key
                batch.append(payload)
            window = []

        for rec in _read_wal_records(wal_dir, extents):
            window.append(rec)
            if len(window) >= 512:
                drain_window()
        drain_window()
        flush_batch()
        return shipped

    def handoff_catchup(self, move_id: str, chunk: int = 256) -> dict:
        """One catch-up pass; the coordinator repeats until the delta
        reaches zero, then fences. Safe to re-run after any failure."""
        mv = self._move(move_id)
        if mv.state not in ("catchup", "fenced"):
            raise ValueError(f"move {move_id} is {mv.state}")
        shipped = self._ship_delta(mv, chunk=chunk)
        return {"moveId": move_id, "shipped": shipped,
                "shippedRecords": mv.shipped_records,
                "shippedBatches": mv.shipped_batches}

    def handoff_fence(self, move_id: str) -> dict:
        """Fence the moving slots (writes for them now redirect — never
        applied here again), ship the WAL tail that raced the last
        catch-up pass, and verify the target's applied watermark (every
        shipped fid recorded there). After this returns, the target
        holds the full acked history of the moving slots and the
        coordinator may commit the epoch."""
        mv = self._move(move_id)
        if mv.state == "aborted":
            raise ValueError(f"move {move_id} already aborted")
        deadline = time.monotonic() + self.fence_timeout_s
        with self._lock:
            for s in mv.slots:
                self._fences[s] = (mv.target, move_id, deadline)
            self.has_fences = True
            mv.state = "fenced"
            mv.fence_deadline = deadline
        # drain the in-flight ingest gate: every batch that passed its
        # fence check BEFORE the registration above finishes its engine
        # apply (and WAL append) before the tail extents are captured —
        # new batches see the fence and route to the target's queue
        self._drain_ingests()
        tail = self._ship_delta(mv)
        reply = self.cluster._peer(mv.target).call(
            "Placement.handoffVerify", moveId=move_id, fids=mv.fids)
        if not reply.get("applied"):
            raise RuntimeError(
                f"move {move_id}: target rank {mv.target} is missing "
                f"shipped batches {reply.get('missing')} — refusing to "
                "commit")
        # the tail ship + verify may have outlasted the fence deadline
        # (huge WAL, slow target): an EXPIRED fence means writes may
        # have resumed here, so committing would lose them — refuse,
        # loudly, and make the coordinator abort. Otherwise RE-ARM the
        # deadline so the coordinator has a full window to commit
        # (commit is a handful of millisecond-scale RPCs; a coordinator
        # that cannot install within fence_timeout_s is as good as
        # dead, and the expiry abort keeps the source authoritative).
        with self._lock:
            live = all(self._fences.get(s, (None, None, 0.0))[1]
                       == move_id for s in mv.slots)
            if not live or mv.state != "fenced":
                raise RuntimeError(
                    f"move {move_id}: fence expired during the tail "
                    "ship — writes may have resumed at the source; "
                    "refusing to commit (retry the move)")
            redeadline = time.monotonic() + self.fence_timeout_s
            for s in mv.slots:
                self._fences[s] = (mv.target, move_id, redeadline)
            mv.fence_deadline = redeadline
        return {"moveId": move_id, "tail": tail,
                "shippedBatches": mv.shipped_batches,
                "shippedPayloads": mv.shipped_payloads,
                "applied": True}

    def handoff_finish(self, move_id: str) -> dict:
        """Commit acknowledgement from the coordinator: drop the fences
        (the installed map now routes the slots away) and close the
        move."""
        mv = self._move(move_id)
        with self._cv:
            for s in mv.slots:
                self._fences.pop(s, None)
            self.has_fences = bool(self._fences)
            if mv.state in ("catchup", "fenced"):
                # normally already "done" via the commit install; a
                # move the fence deadline ABORTED stays aborted — the
                # counters must never double-book one move
                mv.state = "done"
                self.counters["moves_completed"] += 1
                _placement_instruments()["moves"].inc(state="completed")
            self._cv.notify_all()
        return {"moveId": move_id, "state": mv.state}

    def handoff_abort(self, move_id: str) -> dict:
        """Coordinator-side abort (target unreachable, operator cancel):
        unfence, keep ownership, count it. The target's partial copy is
        invisible to reads (owned-slot filter) and gets overwritten by
        any later successful move's replay (fid-deduped)."""
        try:
            mv = self._move(move_id)
        except KeyError:
            return {"moveId": move_id, "state": "unknown"}
        with self._cv:
            for s in mv.slots:
                f = self._fences.get(s)
                if f is not None and f[1] == move_id:
                    self._fences.pop(s)
            self.has_fences = bool(self._fences)
            if mv.state not in ("done", "aborted"):
                mv.state = "aborted"
                self.counters["moves_aborted"] += 1
                _placement_instruments()["moves"].inc(state="aborted")
            self._cv.notify_all()
        return {"moveId": move_id, "state": mv.state}

    # ------------------------------------------------- target helpers
    def handoff_prepare(self, move_id: str, slots: list) -> dict:
        """TARGET-side content filter, built BEFORE any catch-up batch
        arrives: scan this rank's OWN WAL for records whose token hashes
        into the moving slots and remember their content multiset
        ((kind, tenant, payload digest) -> count). The apply path
        consumes it, so the incoming replay re-ingests ONLY what this
        rank does not already hold — the no-dual-apply guarantee for a
        range RETURNING to a former owner, and for a retried move whose
        earlier attempt partially applied under different forward ids.
        Exact multiset semantics: a legitimately duplicated payload
        (same bytes sent twice across eras) is dropped once per copy
        already held."""
        import hashlib

        eng = self.cluster.local
        wal = getattr(eng, "wal", None)
        counter: dict = {}
        total = 0
        if wal is not None:
            from sitewhere_tpu_torch.parallel.replication import (
                _read_wal_records)

            extents = self._wal_extents()
            moving = set(int(s) for s in slots)
            n_slots = self.map().n_slots
            window: list = []

            def drain():
                nonlocal window, total
                if not window:
                    return
                slist = _payload_slots(
                    [p for _k, _t, p in window], "mixed", n_slots,
                    kinds=[k for k, _t, _p in window])
                for (kind, tenant, payload), slot in zip(window, slist):
                    if slot in moving:
                        key = (kind, tenant,
                               hashlib.blake2b(payload,
                                               digest_size=16).digest())
                        counter[key] = counter.get(key, 0) + 1
                        total += 1
                window = []

            for rec in _read_wal_records(pathlib.Path(wal.dir), extents):
                window.append(rec)
                if len(window) >= 512:
                    drain()
            drain()
        with self._lock:
            now = time.monotonic()
            for mid in [m for m, (ts, _c) in self._prepared.items()
                        if now - ts > self.move_timeout_s]:
                self._prepared.pop(mid)
            self._prepared[move_id] = (now, counter)
        return {"moveId": move_id, "alreadyHeld": total}

    def consume_prepared(self, move_id: str, kind: str, tenant: str,
                         plist: list) -> list:
        """Filter one incoming handoff batch against the prepared
        content multiset (decrementing matches). Without a prepared
        entry (manager absent, prepare skipped by an old coordinator)
        the batch passes through unchanged."""
        import hashlib

        with self._lock:
            ent = self._prepared.get(move_id)
            if ent is None:
                return plist
            counter = ent[1]
            out = []
            for p in plist:
                key = (kind, tenant,
                       hashlib.blake2b(p, digest_size=16).digest())
                n = counter.get(key, 0)
                if n > 0:
                    counter[key] = n - 1
                else:
                    out.append(p)
            return out

    def handoff_verify(self, move_id: str, fids: list) -> dict:
        """Target-side applied-watermark check: every fid the source
        shipped must be recorded in this rank's spill registry (the
        handoffApply handler records AFTER ingest, so a recorded fid is
        an applied batch)."""
        reg = getattr(self.cluster.local, "spill_registry", None)
        if reg is None:
            # no registry attached: the synchronous apply RPCs were the
            # confirmation; nothing further to check
            return {"moveId": move_id, "applied": True, "missing": []}
        missing = [f for f in fids if not reg.seen(f)]
        return {"moveId": move_id, "applied": not missing,
                "missing": missing}

    # -------------------------------------------------------- surfaces
    def ledger_stage(self) -> dict:
        """The conservation ledger's placement stage: one lock-consistent
        read of the move accounting (started == completed + aborted +
        in-flight is the new equation) plus the epoch/fence posture."""
        with self._lock:
            self._gc_moves_locked()
            self._expire_fences_locked()
            in_flight = sum(1 for mv in self._moves.values()
                            if mv.state in ("catchup", "fenced"))
            return {
                "epoch": self._map.epoch,
                "moves_started": self.counters["moves_started"],
                "moves_completed": self.counters["moves_completed"],
                "moves_aborted": self.counters["moves_aborted"],
                "moves_in_flight": in_flight,
                "fenced_slots": len(self._fences),
                "fenced_write_redirects":
                    self.counters["fenced_write_redirects"],
                "stale_sender_redirects":
                    self.counters["stale_sender_redirects"],
            }

    def payload(self) -> dict:
        """THE document behind ``GET /api/instance/placement``, the
        ``Instance.placement`` RPC, and the debug bundle's placement
        section: the installed map, per-range handoff state, and the
        counters."""
        with self._lock:
            self._gc_moves_locked()
            self._expire_fences_locked()
            moves = [{
                "moveId": mv.move_id, "slots": list(mv.slots),
                "target": mv.target, "state": mv.state,
                "shippedBatches": mv.shipped_batches,
                "shippedPayloads": mv.shipped_payloads,
            } for mv in self._moves.values()]
            return {
                "rank": self.cluster.rank,
                "map": self._map.to_dict(),
                "activeRanks": self._map.active_ranks(),
                "slots": {str(r): self._map.slots_of(r)
                          for r in self._map.active_ranks()},
                "fences": {str(s): {"target": t, "moveId": mid}
                           for s, (t, mid, _dl) in self._fences.items()},
                "moves": moves,
                "counters": dict(self.counters),
            }

    def metrics(self) -> dict:
        with self._lock:
            return {"placement_epoch": self._map.epoch,
                    "placement_fenced_slots": len(self._fences),
                    **{f"placement_{k}": v
                       for k, v in self.counters.items()}}


def _payload_slots(payloads: list, kind: str, n_slots: int,
                   kinds: "list[str] | None" = None) -> list[int]:
    """Slot per payload (-1 = unroutable). ONE native route call for a
    homogeneous batch; the byte-exact Python port otherwise. Routing by
    ``n_slots`` instead of ``n_ranks`` is the only difference from the
    legacy partitioner — same hash, same envelope scan."""
    from sitewhere_tpu_torch.native.binding import route_payloads

    if kinds is None:
        ranks = route_payloads(payloads, n_slots,
                               binary=(kind == "binary"))
        if ranks is not None:
            return [int(r) for r in ranks.tolist()]
        kinds = [kind] * len(payloads)
    from sitewhere_tpu_torch.native.route_fallback import (route_binary_payload,
                                                     route_json_payload)

    return [(route_binary_payload if k == "binary" else route_json_payload)
            (p, n_slots) for k, p in zip(kinds, payloads)]


# --------------------------------------------------------------------------
# coordination: move / join / drain (run from any rank)
# --------------------------------------------------------------------------

def _placement_call(cluster, rank: int, method: str, **params):
    """Dispatch a Placement.* step: direct manager call when the step
    targets THIS rank (the coordinator is often also the source), RPC
    otherwise."""
    if rank == cluster.rank:
        pm = cluster.placement
        local = {
            "Placement.handoffStart": lambda moveId, slots, target:
                pm.handoff_start(moveId, slots, target),
            "Placement.handoffPrepare": lambda moveId, slots:
                pm.handoff_prepare(moveId, slots),
            "Placement.handoffCatchup": lambda moveId:
                pm.handoff_catchup(moveId),
            "Placement.handoffFence": lambda moveId:
                pm.handoff_fence(moveId),
            "Placement.handoffFinish": lambda moveId:
                pm.handoff_finish(moveId),
            "Placement.handoffAbort": lambda moveId:
                pm.handoff_abort(moveId),
            "Placement.install": lambda map:
                {"installed": pm.install(map), "epoch": pm.epoch},
            "Placement.get": lambda: pm.map().to_dict(),
        }
        return local[method](**params)
    return cluster._peer(rank).call(method, **params)


def move_slots(cluster, slots, target: int,
               max_catchup_rounds: int = 32) -> dict:
    """THE handoff orchestration: move ``slots`` to ``target`` with zero
    acked loss and no dual-ownership window. Slots may span several
    current owners; each (source, target) pair runs the full
    catch-up -> fence -> verify -> commit -> finish sequence. Any
    failure before commit aborts that source's move (ownership
    unchanged); the commit itself is a single map install + tolerant
    broadcast, after which redirects converge every straggler."""
    pm = cluster.placement
    stats = {"moves": [], "epoch_before": pm.epoch}
    by_src: dict[int, list[int]] = {}
    m = pm.map()
    for s in sorted(set(int(x) for x in slots)):
        src = m.owner_of_slot(s)
        if src != int(target):
            by_src.setdefault(src, []).append(s)
    for src, sl in sorted(by_src.items()):
        move_id = f"mv{cluster.rank}-{time.time_ns()}"
        rec = {"moveId": move_id, "source": src, "target": int(target),
               "slots": sl}
        try:
            _placement_call(cluster, src, "Placement.handoffStart",
                            moveId=move_id, slots=sl, target=int(target))
            _placement_call(cluster, int(target),
                            "Placement.handoffPrepare",
                            moveId=move_id, slots=sl)
            for _ in range(max_catchup_rounds):
                r = _placement_call(cluster, src,
                                    "Placement.handoffCatchup",
                                    moveId=move_id)
                if r["shipped"] == 0:
                    break
            f = _placement_call(cluster, src, "Placement.handoffFence",
                                moveId=move_id)
            rec.update(shippedBatches=f["shippedBatches"],
                       shippedPayloads=f["shippedPayloads"])
        except Exception as e:
            rec.update(state="aborted", error=repr(e))
            stats["moves"].append(rec)
            try:
                _placement_call(cluster, src, "Placement.handoffAbort",
                                moveId=move_id)
            except Exception:
                pass   # source unreachable: its fence deadline unfences
            logger.warning("placement move %s (rank %d -> %d) aborted: "
                           "%r", move_id, src, target, e)
            continue
        # commit: epoch+1 installed locally first (the coordinator is a
        # data rank; its routing flips atomically with the install),
        # then broadcast tolerant — stragglers converge via redirects
        new_map = pm.map().with_moves({s: int(target) for s in sl})
        pm.install(new_map.to_dict())
        for r in range(cluster.n_ranks):
            if r == cluster.rank:
                continue
            try:
                _placement_call(cluster, r, "Placement.install",
                                map=new_map.to_dict())
            except Exception:
                pass
        try:
            _placement_call(cluster, src, "Placement.handoffFinish",
                            moveId=move_id)
        except Exception:
            pass   # fence deadline covers a lost finish
        rec.update(state="done", epoch=new_map.epoch)
        stats["moves"].append(rec)
        logger.info("placement move %s: slots %s rank %d -> %d at "
                    "epoch %d", move_id, sl, src, target, new_map.epoch)
    stats["epoch_after"] = pm.epoch
    return stats


def join_rank(cluster, rank: int, share: "int | None" = None) -> dict:
    """Bring a provisioned-but-inactive rank into the active set by
    moving it an even share of slots (round-robin from the most-loaded
    current owners). The rank's process must already be serving its
    cluster RPC; it bootstraps by receiving handoff replay — the
    follower-then-owner sequence of the protocol docstring."""
    pm = cluster.placement
    m = pm.map()
    active = m.active_ranks()
    if rank in active:
        return {"joined": False, "reason": "already active",
                "epoch": m.epoch}
    if share is None:
        share = max(1, m.n_slots // (len(active) + 1))
    by_owner = sorted(((len(m.slots_of(r)), r) for r in active),
                      reverse=True)
    picked: list[int] = []
    donors = [r for _n, r in by_owner]
    di = 0
    while len(picked) < share and donors:
        r = donors[di % len(donors)]
        avail = [s for s in pm.map().slots_of(r) if s not in picked]
        if not avail:
            donors.remove(r)
            continue
        picked.append(avail[len(picked) % len(avail)])
        di += 1
    res = move_slots(cluster, picked, rank)
    res["joined"] = any(mv.get("state") == "done"
                        for mv in res["moves"])
    return res


def drain_rank(cluster, rank: int) -> dict:
    """Hand off EVERY slot ``rank`` owns (round-robin over the remaining
    active ranks), after which the rank owns nothing, leaves the data
    fan-out set, and can be stopped with zero acked loss."""
    pm = cluster.placement
    m = pm.map()
    targets = [r for r in m.active_ranks() if r != rank]
    if not targets:
        raise ValueError(f"rank {rank} is the only active rank — "
                         "nothing can absorb its slots")
    slots = m.slots_of(rank)
    results = []
    for i, t in enumerate(targets):
        chunk = slots[i::len(targets)]
        if chunk:
            results.append(move_slots(cluster, chunk, t))
    drained = not pm.map().slots_of(rank)
    return {"rank": rank, "drained": drained, "epoch": pm.epoch,
            "results": results}


# --------------------------------------------------------------------------
# the load-balancing half: hot-tenant detection -> proposed moves
# --------------------------------------------------------------------------

def decide_balance(tenant_p99_ms: dict, tenant_rank: dict,
                   tenant_slots: dict, pmap: PlacementMap,
                   p99_target_ms: float,
                   max_moves: int = 1,
                   slot_heat: dict | None = None) -> list[tuple[int, int]]:
    """PURE balancing policy (unit-testable like autotune.decide): given
    each tenant's worst e2e p99, its dominant owner rank, and the slots
    its devices hash into, propose up to ``max_moves`` (slot, target)
    moves that peel the hottest tenant's busiest slot off its rank onto
    the active rank with the fewest slots. No proposal when nothing
    breaches the target, when the hot tenant's rank is already the
    lightest, or when the hot slot is the rank's only slot (moving it
    would just relocate the problem).

    ``slot_heat`` is an optional ``{slot: events/s}`` map —
    the SPMD shard heat plane's slot EWMA — used to pick the ACTUAL
    busiest of the tenant's slots instead of the first. ``None`` keeps
    the decision byte-identical to the pre-heat policy (pure-function
    pin in tests/test_shardobs.py)."""
    breaches = sorted(((p, t) for t, p in tenant_p99_ms.items()
                       if p is not None and p > p99_target_ms),
                      reverse=True)
    if not breaches:
        return []
    active = pmap.active_ranks()
    load = {r: len(pmap.slots_of(r)) for r in active}
    moves: list[tuple[int, int]] = []
    for _p99, tenant in breaches:
        if len(moves) >= max_moves:
            break
        src = tenant_rank.get(tenant)
        slots = [s for s in tenant_slots.get(tenant, ())
                 if pmap.owner_of_slot(s) == src]
        if src is None or not slots or load.get(src, 0) <= 1:
            continue
        target = min((r for r in active if r != src),
                     key=lambda r: load[r], default=None)
        if target is None or load[target] >= load[src]:
            continue
        if slot_heat:
            # hottest of the tenant's slots by measured events/s; ties
            # (and unmeasured slots, heat 0.0) break toward the lowest
            # slot id, which is slots[0] when nothing is measured
            slot = max(slots, key=lambda s: (slot_heat.get(s, 0.0), -s))
        else:
            slot = slots[0]
        moves.append((slot, target))
        load[src] -= 1
        load[target] += 1
    return moves


def propose_moves(cluster, p99_target_ms: float = 250.0,
                  max_moves: int = 1,
                  heat: dict | None = None) -> list[tuple[int, int]]:
    """Gather the live inputs for :func:`decide_balance` from the SLO
    plane (the per-tenant ``swtpu_ingest_e2e_seconds`` histograms, PR
    7/9) and this rank's device registry, and return proposed
    ``(slot, target)`` moves. Advisory: the operator (or an autonomous
    loop) applies them through :func:`move_slots` — placement changes
    always ride the fenced protocol, never a side door.

    ``heat`` is an optional ``{slot: events/s}`` map — feed
    it the SPMD heat plane's top-K slot document (``spmd_heat_payload``
    "slots"/"topK", or a tracker's ``top_slots()``) so the hot tenant's
    ACTUAL busiest slot moves. ``None`` (the default) is byte-identical
    to the PR-15 policy."""
    from sitewhere_tpu_torch.utils.metrics import REGISTRY, slo_metrics

    hist = slo_metrics(REGISTRY)["ingest_e2e"]
    pm = cluster.placement
    m = pm.map()
    tenant_p99: dict = {}
    tenant_slots: dict = {}
    tenant_rank_votes: dict = {}
    for info in cluster.local.devices.values():
        ten = getattr(info, "tenant", None) or "default"
        slot = m.slot_of(info.token)
        tenant_slots.setdefault(ten, set()).add(slot)
        votes = tenant_rank_votes.setdefault(ten, {})
        r = m.owner_of_slot(slot)
        votes[r] = votes.get(r, 0) + 1
    for ten in tenant_slots:
        q = hist.quantile_where(0.99, tenant=ten)
        tenant_p99[ten] = None if q is None else q * 1e3
    tenant_rank = {t: max(v, key=v.get)
                   for t, v in tenant_rank_votes.items() if v}
    return decide_balance(tenant_p99, tenant_rank,
                          {t: sorted(s) for t, s in tenant_slots.items()},
                          m, p99_target_ms, max_moves=max_moves,
                          slot_heat=heat)


# --------------------------------------------------------------------------
# RPC surface + instruments
# --------------------------------------------------------------------------

def register_placement_rpc(srv, engine) -> None:
    """The placement plane on the rank's cluster RPC server. Handlers
    bind to the ENGINE (register_cluster_rpc discipline) and reach the
    manager via ``engine.placement``. The handoff data movers are ASYNC
    (off-loop via to_thread): a catch-up pass reads the whole WAL and
    makes outbound peer calls — running it synchronously would block
    this rank's RPC loop exactly as deployment rule 1
    (parallel/cluster.py) forbids. Each runs under the CUDA streams of
    the thread that built the server (``srv.streams``, the cluster's
    ``CardRpcServer``), as the sync handlers do."""
    import asyncio

    from sitewhere_tpu_torch.utils.streams import on_streams

    streams = list(getattr(srv, "streams", []))

    def _under_streams(fn, *args):
        with on_streams(streams):
            return fn(*args)

    def _off_loop(fn, *args):
        return asyncio.to_thread(_under_streams, fn, *args)

    def _pm() -> PlacementManager:
        pm = getattr(engine, "placement", None)
        if pm is None:
            raise ValueError("no placement manager on this rank")
        return pm

    def get():
        return _pm().map().to_dict()

    def install(map: dict):
        pm = _pm()
        return {"installed": pm.install(map), "epoch": pm.epoch}

    def status():
        return _pm().payload()

    async def handoff_start(moveId: str, slots: list, target: int):
        return await _off_loop(_pm().handoff_start, moveId, slots,
                              target)

    async def handoff_prepare(moveId: str, slots: list):
        return await _off_loop(_pm().handoff_prepare, moveId, slots)

    async def handoff_catchup(moveId: str):
        return await _off_loop(_pm().handoff_catchup, moveId)

    async def handoff_fence(moveId: str):
        return await _off_loop(_pm().handoff_fence, moveId)

    def handoff_finish(moveId: str):
        return _pm().handoff_finish(moveId)

    def handoff_abort(moveId: str):
        return _pm().handoff_abort(moveId)

    def handoff_verify(moveId: str, fids: list):
        return _pm().handoff_verify(moveId, fids)

    async def handoff_apply(moveId: str, fid: str, encoding: str,
                            tenant: str, lens: list,
                            _attachment: bytes = None,
                            payloads: list = None):
        """Target-side replay ingest: fid-deduped via the spill
        registry, NO placement guard (the slots are not ours YET — that
        is the point) and NO QoS admission (these events were admitted
        at their original edge and are already acked/durable; replay
        must re-apply unconditionally, the WAL-replay rule). Off-loop:
        a full ingest (decode + WAL + dispatch) must not block the RPC
        loop."""
        from sitewhere_tpu_torch.parallel.cluster import _wire_payloads

        def _run():
            reg = getattr(engine, "spill_registry", None)
            if reg is not None and reg.seen(fid):
                return {"duplicate_forward": 1}
            plist = _wire_payloads(payloads, lens, _attachment)
            pm = getattr(engine, "placement", None)
            held = 0
            if pm is not None:
                kept = pm.consume_prepared(moveId, encoding, tenant,
                                           plist)
                held = len(plist) - len(kept)
                plist = kept
            summary = {}
            if plist:
                if encoding == "binary":
                    summary = engine.ingest_binary_batch(plist, tenant)
                else:
                    summary = engine.ingest_json_batch(plist, tenant)
            if held:
                summary["handoff_already_held"] = held
            if reg is not None:
                reg.record(fid)
            return summary

        return await _off_loop(_run)

    for name, fn in {
        "Placement.get": get,
        "Placement.install": install,
        "Placement.status": status,
        "Placement.handoffStart": handoff_start,
        "Placement.handoffPrepare": handoff_prepare,
        "Placement.handoffCatchup": handoff_catchup,
        "Placement.handoffFence": handoff_fence,
        "Placement.handoffFinish": handoff_finish,
        "Placement.handoffAbort": handoff_abort,
        "Placement.handoffVerify": handoff_verify,
        "Placement.handoffApply": handoff_apply,
    }.items():
        srv.register(name, fn)


# resolved once: the redirect counter sits on the owner-side guard path
_INSTRUMENTS: dict | None = None


def _placement_instruments() -> dict:
    global _INSTRUMENTS
    if _INSTRUMENTS is None:
        from sitewhere_tpu_torch.utils.metrics import placement_metrics

        _INSTRUMENTS = placement_metrics()
    return _INSTRUMENTS


class _IngestGate:
    """See :meth:`PlacementManager.ingest_gate`."""

    __slots__ = ("_pm",)

    def __init__(self, pm: PlacementManager):
        self._pm = pm

    def __enter__(self):
        with self._pm._lock:
            self._pm._inflight += 1
        return self

    def __exit__(self, *exc):
        with self._pm._cv:
            self._pm._inflight -= 1
            self._pm._cv.notify_all()
        return False
