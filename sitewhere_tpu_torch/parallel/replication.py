"""Event-plane replication (RF>=2): follower feeds, health, fire-over.

In the reference, every replica serves all data because storage is a
shared DB — a SIGKILL'd pod costs nothing but capacity. Here the
event/device-state plane was RF=1 per rank: a dead rank's partition was
unreadable until restart, and replicated schedules pinned to that owner
silently stopped firing. This module closes the
gap with three pieces:

``ReplicaFeed`` (leader side)
    Streams the rank's WAL-durable ingest batches to ``rf - 1``
    followers chosen deterministically from the rank ring
    (:func:`replica_ring`). Publication happens at the WAL append (same
    engine-lock critical section, so feed order == WAL order), but the
    sender gates every transmission on ``wal.wait_durable(ticket)`` —
    a follower can never hold a frame the owner could still lose. A
    follower that gaps (restart, backlog overflow) is RESYNCED from the
    leader's own WAL segments, so the standby always converges to the
    full acked history. Every frame carries a monotonic OWNERSHIP EPOCH
    (persisted beside the WAL); a follower that took over schedule
    firing answers with a higher fencing epoch and the leader re-syncs
    entity state before firing again (no double-fire on recovery).

``ReplicaApplier`` (follower side)
    Applies feed batches IN ORDER into a standby ``DistributedEngine``
    built from the leader's own engine config (its JAX-package fields:
    the standby lives on the FOLLOWER's device), through the existing
    byte-identical decode path (the leader ships its staging clock per
    batch, so standby store bytes equal the owner's — pinned by
    tests/test_torch_replication.py). Serves failover reads
    (query_events / device_state / state search) from the standby with
    an explicit ``stale_ms`` watermark, and detects leader death from
    feed/heartbeat silence (``leader_alive``) — the signal scheduler
    fire-over keys on.

``PeerHealth``
    A small shared tracker with explicit UP / SUSPECT / DOWN states fed
    by ``_SyncPeer`` transport outcomes, plus exponential probe backoff
    so a dead rank doesn't cost a connect timeout per read.

A port of ``sitewhere_tpu/parallel/replication.py``: the feed's wire
format, the WAL framing it resyncs from (``utils/ingestlog.py``) and the
staging-clock pin (``engine.IngestHostMixin``) are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib
import struct
import threading
import time
import zlib
from collections import deque

logger = logging.getLogger(__name__)

UP, SUSPECT, DOWN = "up", "suspect", "down"


def replica_ring(rank: int, n_ranks: int, rf: int) -> list[int]:
    """The follower ranks of ``rank``: its ``rf - 1`` successors on the
    rank ring — deterministic from topology alone, so every rank (and
    every reader doing failover) agrees on who holds which standby
    without coordination."""
    rf = max(1, min(rf, n_ranks))
    return [(rank + i) % n_ranks for i in range(1, rf)]


class PeerHealth:
    """Explicit per-rank health: UP -> SUSPECT on the first transport
    failure, SUSPECT -> DOWN after ``down_after`` consecutive failures
    (a timeout counts like a refusal — both leave the result unknown).
    DOWN ranks are probed with exponential backoff so the read path
    re-discovers recovery without paying a connect timeout per call."""

    def __init__(self, down_after: int = 2, probe_base_s: float = 0.5,
                 probe_max_s: float = 10.0):
        self.down_after = down_after
        self.probe_base_s = probe_base_s
        self.probe_max_s = probe_max_s
        self._lock = threading.Lock()
        self._fails: dict[int, int] = {}
        self._state: dict[int, str] = {}
        self._next_probe: dict[int, float] = {}
        self.transitions = 0

    def record_success(self, rank: int) -> None:
        with self._lock:
            if self._state.get(rank, UP) != UP:
                self.transitions += 1
                logger.info("peer rank %d back UP", rank)
            self._state[rank] = UP
            self._fails[rank] = 0
            self._next_probe.pop(rank, None)

    def record_failure(self, rank: int) -> None:
        with self._lock:
            n = self._fails.get(rank, 0) + 1
            self._fails[rank] = n
            new = DOWN if n >= self.down_after else SUSPECT
            if self._state.get(rank, UP) != new:
                self.transitions += 1
                logger.warning("peer rank %d marked %s (%d consecutive "
                               "failures)", rank, new.upper(), n)
            self._state[rank] = new
            backoff = min(self.probe_max_s,
                          self.probe_base_s * (2 ** min(n - 1, 8)))
            self._next_probe[rank] = time.monotonic() + backoff

    def state(self, rank: int) -> str:
        with self._lock:
            return self._state.get(rank, UP)

    def is_down(self, rank: int) -> bool:
        return self.state(rank) == DOWN

    def mark_down(self, rank: int) -> None:
        """Force DOWN (the applier's feed-silence detector uses this so
        reads skip a rank whose feed died even before any read failed)."""
        with self._lock:
            if self._state.get(rank, UP) != DOWN:
                self.transitions += 1
            self._state[rank] = DOWN
            self._fails[rank] = max(self._fails.get(rank, 0),
                                    self.down_after)
            self._next_probe.setdefault(
                rank, time.monotonic() + self.probe_base_s)

    def should_probe(self, rank: int) -> bool:
        """True when a DOWN rank's backoff window has elapsed — the
        caller may spend one real attempt on it. SUSPECT/UP always
        probe (the state is not yet confident)."""
        with self._lock:
            if self._state.get(rank, UP) != DOWN:
                return True
            due = self._next_probe.get(rank, 0.0)
            if time.monotonic() >= due:
                # re-arm immediately so concurrent readers don't stampede
                self._next_probe[rank] = time.monotonic() + self.probe_base_s
                return True
            return False

    def snapshot(self) -> dict[str, str]:
        with self._lock:
            return {str(r): s for r, s in sorted(self._state.items())}


# --------------------------------------------------------------------------
# leader side: the replica feed
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Pub:
    seq: int
    kind: str                 # "json" | "binary"
    tenant: str
    payloads: list[bytes]
    ticket: int               # WAL append sequence (durability gate)
    now_ms: int               # leader staging clock (byte-identity pin)
    publish_ms: float
    tp: str | None = None     # originating batch's traceparent: the
                              # sender binds it around the apply RPC so
                              # the standby-apply span (and any standby
                              # records) join the ingest trace


def _standby_config(engine) -> dict:
    """The leader's engine config as shipped to followers: same shapes
    and semantics, but the standby must never journal, archive, or
    record flight lifecycles of its own."""
    from sitewhere_tpu_torch.parallel.distributed import _PORT_ONLY

    # the JAX package's fields only: the follower places its standby on
    # its own device (``ReplicaApplier.reset``)
    cfg = {k: v for k, v in dataclasses.asdict(engine.config).items()
           if k not in _PORT_ONLY}
    cfg["n_shards"] = engine.n_shards
    cfg["wal_dir"] = None
    cfg["archive_dir"] = None
    cfg["flight_recorder"] = False
    cfg["span_trace"] = False   # apply spans are recorded by the HOST
    #                             rank's tracer, on the ingest trace
    return cfg


class ReplicaFeed:
    """One per rank (the leader role): buffers WAL-order publications
    and streams them to each follower on its own sender thread."""

    def __init__(self, cluster, directory, rf: int = 2,
                 heartbeat_s: float = 0.5, max_buffer: int = 4096,
                 resync_chunk: int = 256, fence_grace_s: float = 10.0):
        self.cluster = cluster
        self.rank = cluster.rank
        self.rf = max(1, min(rf, cluster.n_ranks))
        self.followers = replica_ring(self.rank, cluster.n_ranks, self.rf)
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.heartbeat_s = heartbeat_s
        self.max_buffer = max_buffer
        self.resync_chunk = resync_chunk
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._buffer: deque[_Pub] = deque()
        self._seq = 0
        self._cursors = {f: 1 for f in self.followers}   # next seq to send
        self._needs_resync = {f: True for f in self.followers}
        self._acked = {f: 0 for f in self.followers}
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        # monotonic ownership epoch, persisted across restarts: a
        # follower that fired over fences the old epoch out, and the
        # recovering leader adopts the higher one before firing again
        self._epoch_path = self.dir / "epoch"
        try:
            self.epoch = int(self._epoch_path.read_text().strip())
        except (OSError, ValueError):
            self.epoch = 1
            self._persist_epoch()
        # fencing gate for the leader's OWN schedule firing: pending
        # until EVERY follower's round-trip confirms no outstanding
        # fence (or the grace expires with no follower reachable —
        # availability wins). One confirmed follower is not enough: with
        # rf >= 3 the fencing follower may simply not have been heard
        # yet while another answers first.
        self._fence_pending = bool(self.followers)
        self._fence_deadline = time.monotonic() + fence_grace_s
        self._fence_confirmed: set[int] = set()
        self.on_fenced = None      # callback: pull entity state before
        #                            resuming schedule firing
        self.counters = {"published": 0, "sent": 0, "heartbeats": 0,
                         "resyncs": 0, "send_failures": 0, "fenced": 0,
                         "buffer_overflows": 0}

    # ------------------------------------------------------------- publish
    def publish(self, tag: bytes, payloads: list[bytes], tenant: str,
                ticket: int, now_ms: int) -> None:
        """Record one WAL append for streaming. Called under the engine
        lock right after the append, so buffer order == WAL order; the
        sender thread still gates on ``wait_durable(ticket)`` before
        the bytes leave this host."""
        from sitewhere_tpu_torch.engine import WAL_JSON

        if not self.followers:
            return
        kind = "json" if tag == WAL_JSON else "binary"
        # the publishing thread is the ingest thread with its flight
        # record bound: carry the batch's trace so the follower's apply
        # span lands on the same timeline
        tp = None
        rec = self.cluster.local.flight.current()
        if rec.trace_id is not None:
            from sitewhere_tpu_torch.utils.tracing import new_traceparent

            tp = new_traceparent(self.rank, trace_id=rec.trace_id)
        with self._cv:
            self._seq += 1
            self._buffer.append(_Pub(self._seq, kind, tenant,
                                     list(payloads), ticket, int(now_ms),
                                     time.time() * 1000, tp))
            self.counters["published"] += 1
            _replication_instruments()["published"].inc()
            if len(self._buffer) > self.max_buffer:
                # a follower lagging past the buffer re-converges by WAL
                # resync; the buffer itself must stay bounded
                dropped = self._buffer.popleft()
                self.counters["buffer_overflows"] += 1
                for f in self.followers:
                    if self._cursors[f] <= dropped.seq:
                        self._needs_resync[f] = True
                        self._cursors[f] = dropped.seq + 1
            self._cv.notify_all()

    def _trim_locked(self) -> None:
        if not self._buffer:
            return
        floor = min(self._cursors.values())
        while self._buffer and self._buffer[0].seq < floor:
            self._buffer.popleft()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        for f in self.followers:
            t = threading.Thread(target=self._sender, args=(f,),
                                 name=f"replica-feed-{self.rank}-to-{f}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []

    # -------------------------------------------------------------- fencing
    def can_fire(self) -> bool:
        """May this rank fire its own schedules? False while a fencing
        round-trip is pending (restart before first follower contact) —
        a follower may have fired over and hold newer job state."""
        if not self._fence_pending:
            return True
        if time.monotonic() >= self._fence_deadline:
            # no follower reachable within the grace: availability over
            # strictness (documented failure-model tradeoff)
            self._fence_pending = False
            return True
        return False

    def _persist_epoch(self) -> None:
        tmp = self._epoch_path.with_suffix(".tmp")
        tmp.write_text(str(self.epoch))
        tmp.rename(self._epoch_path)

    def _handle_reply(self, follower: int, reply: dict) -> None:
        fence = reply.get("fence")
        if fence is not None and int(fence) > self.epoch:
            # a follower fired over while we were dead: adopt its epoch
            # and pull entity state (replicated last_fired_ms) BEFORE
            # resuming our own schedule firing — the no-double-fire half
            # of fire-over
            self.counters["fenced"] += 1
            logger.warning("rank %d fenced by follower %d (epoch %d -> "
                           "%d): syncing before resuming schedules",
                           self.rank, follower, self.epoch, int(fence))
            with self._lock:
                self._fence_pending = True
                self._fence_confirmed.clear()
            cb = self.on_fenced
            if cb is not None:
                try:
                    cb()
                except Exception:
                    # the follower's fired marks were NOT pulled: keep
                    # the fence up and retry on the next reply (the
                    # fence field rides every frame until adopted)
                    logger.exception("on_fenced sync failed; schedule "
                                     "firing stays fenced")
                    return
            self.epoch = int(fence)
            self._persist_epoch()
        with self._lock:
            self._fence_confirmed.add(follower)
            if self._fence_confirmed >= set(self.followers):
                self._fence_pending = False

    # --------------------------------------------------------------- sender
    def _sender(self, follower: int) -> None:
        backoff = 0.1
        while not self._stop.is_set():
            try:
                if self._needs_resync.get(follower):
                    self._resync(follower)
                    backoff = 0.1
                    continue
                pub = None
                with self._cv:
                    cur = self._cursors[follower]
                    for entry in self._buffer:
                        if entry.seq == cur:
                            pub = entry
                            break
                    if pub is None and not self._stop.is_set():
                        self._cv.wait(self.heartbeat_s)
                        for entry in self._buffer:
                            if entry.seq == cur:
                                pub = entry
                                break
                if self._stop.is_set():
                    return
                if pub is None:
                    self._heartbeat(follower)
                    backoff = 0.1
                    continue
                self._send(follower, pub)
                backoff = 0.1
            except (ConnectionError, TimeoutError, OSError) as e:
                self.counters["send_failures"] += 1
                self.cluster.health.record_failure(follower)
                logger.debug("replica feed to %d failed: %s", follower, e)
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 2.0)
            except Exception:
                self.counters["send_failures"] += 1
                logger.exception("replica feed to %d errored", follower)
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 2.0)

    def _send(self, follower: int, pub: _Pub) -> None:
        from sitewhere_tpu_torch.utils.tracing import (bind_traceparent,
                                                 trace_id_of)

        eng = self.cluster.local
        if eng.wal is not None:
            # the durability gate: a follower must never apply a frame
            # the owner could still lose to a crash
            eng.wal.wait_durable(pub.ticket)
        lens = [len(p) for p in pub.payloads]
        with self._lock:
            adv = self._seq
        t0 = time.perf_counter_ns()
        with bind_traceparent(pub.tp):
            # the bound traceparent rides the RPC frame: the follower's
            # handler (and its apply span) joins the batch's trace
            reply = self.cluster._peer(follower).call(
                "Cluster.replicaApply", leader=self.rank, seq=pub.seq,
                epoch=self.epoch, encoding=pub.kind, tenant=pub.tenant,
                lens=lens, nowMs=pub.now_ms, publishMs=pub.publish_ms,
                adv=adv, _attachment=b"".join(pub.payloads))
        tracer = getattr(eng, "tracer", None)
        if tracer is not None and tracer.enabled and pub.tp is not None:
            tracer.record("repl.send", t0, time.perf_counter_ns(),
                          trace_id=trace_id_of(pub.tp),
                          follower=follower, seq=pub.seq,
                          payloads=len(pub.payloads))
        self.cluster.health.record_success(follower)
        if reply.get("unknown"):
            self._needs_resync[follower] = True
            return
        if "expect" in reply:
            exp = int(reply["expect"])
            with self._cv:
                base = self._buffer[0].seq if self._buffer else self._seq + 1
                if exp >= base:
                    self._cursors[follower] = exp
                else:
                    self._needs_resync[follower] = True
            self._handle_reply(follower, reply)
            return
        with self._cv:
            self._cursors[follower] = pub.seq + 1
            self._acked[follower] = pub.seq
            self._trim_locked()
        self.counters["sent"] += 1
        self._handle_reply(follower, reply)

    def _heartbeat(self, follower: int) -> None:
        with self._lock:
            adv = self._seq
        reply = self.cluster._peer(follower).call(
            "Cluster.replicaHeartbeat", leader=self.rank, seq=adv,
            epoch=self.epoch)
        self.cluster.health.record_success(follower)
        self.counters["heartbeats"] += 1
        if reply.get("unknown"):
            self._needs_resync[follower] = True
            return
        self._handle_reply(follower, reply)

    # --------------------------------------------------------------- resync
    def _wal_extents(self) -> tuple[int, dict[str, int]]:
        """(base_seq, {segment name: readable bytes}) captured atomically
        against publications: taken under the ENGINE lock, so every
        publish <= base_seq is inside the extents and nothing beyond it
        is. Group-commit mode waits for the durable watermark (the
        extents must not include a torn user-space tail)."""
        eng = self.cluster.local
        wal = eng.wal
        with eng.lock:
            with self._lock:
                base_seq = self._seq
            if wal is None:
                return base_seq, {}
            if wal.group_commit:
                wal.wait_durable(getattr(eng, "_wal_last_seq", 0))
                return base_seq, wal.durable_view()
            wal.flush()
            return base_seq, {
                p.name: p.stat().st_size
                for p in sorted(wal.dir.glob("segment-*.log"))}

    def _resync(self, follower: int) -> None:
        """Rebuild the follower's standby from this rank's own WAL: the
        full acked history, not just the live tail — after this the
        standby can serve failover reads over everything the owner ever
        acknowledged."""
        self.counters["resyncs"] += 1
        eng = self.cluster.local
        base_seq, extents = self._wal_extents()
        peer = self.cluster._peer(follower)
        logger.info("replica resync rank %d -> %d (base seq %d, %d "
                    "segments)", self.rank, follower, base_seq,
                    len(extents))
        peer.call("Cluster.replicaReset", leader=self.rank,
                  config=_standby_config(eng),
                  epochBase=eng.epoch.base_unix_s, epoch=self.epoch)
        self.cluster.health.record_success(follower)
        wal_dir = pathlib.Path(eng.wal.dir) if eng.wal is not None else None
        if wal_dir is not None:
            chunk: list[bytes] = []
            chunk_key: tuple[str, str] | None = None
            idx = 0

            def ship(key, payloads):
                nonlocal idx
                idx += 1
                peer.call("Cluster.replicaWal", leader=self.rank,
                          idx=idx, encoding=key[0], tenant=key[1],
                          lens=[len(p) for p in payloads],
                          _attachment=b"".join(payloads))

            for kind, tenant, payload in _read_wal_records(wal_dir,
                                                           extents):
                key = (kind, tenant)
                if chunk and (key != chunk_key
                              or len(chunk) >= self.resync_chunk):
                    ship(chunk_key, chunk)
                    chunk = []
                chunk_key = key
                chunk.append(payload)
            if chunk:
                ship(chunk_key, chunk)
        peer.call("Cluster.replicaResume", leader=self.rank, seq=base_seq)
        with self._cv:
            self._cursors[follower] = base_seq + 1
            self._acked[follower] = max(self._acked.get(follower, 0),
                                        base_seq)
            self._needs_resync[follower] = False
            self._trim_locked()

    def watermarks(self) -> dict:
        """Feed-side conservation watermarks: publish seq,
        the published counter (the two must agree — checked by
        ``check_conservation``), per-follower acked seqs, and the
        retained buffer depth — one consistent read under the feed
        lock."""
        with self._lock:
            return {"seq": self._seq,
                    "published": self.counters["published"],
                    "acked": {str(f): self._acked.get(f, 0)
                              for f in self.followers},
                    "buffer": len(self._buffer)}

    # -------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        with self._lock:
            lag = {f: self._seq - self._acked.get(f, 0)
                   for f in self.followers}
            out = {"replica_feed_seq": self._seq,
                   "replica_feed_epoch": self.epoch,
                   "replica_feed_buffer": len(self._buffer),
                   "replica_feed_max_lag_batches":
                       max(lag.values()) if lag else 0,
                   **{f"replica_feed_{k}": v
                      for k, v in self.counters.items()}}
        return out

    def drained(self) -> bool:
        """Every follower acked every publication (test/bench barrier)."""
        with self._lock:
            return all(self._acked.get(f, 0) >= self._seq
                       and not self._needs_resync.get(f)
                       for f in self.followers)


def _read_wal_records(wal_dir: pathlib.Path, extents: dict[str, int]):
    """Yield ``(kind, tenant, payload)`` for every ingest record inside
    the byte extents (watermark records skipped) — the WAL's head framing
    is ``tag + tenant + b'\\x00' + payload`` (engine._wal_append)."""
    from sitewhere_tpu_torch.engine import WAL_JSON
    from sitewhere_tpu_torch.utils.ingestlog import _MAGIC, _WATERMARK

    for name in sorted(extents):
        cap = extents[name]
        path = wal_dir / name
        if cap <= 0 or not path.exists():
            continue
        with open(path, "rb") as fh:
            probe = fh.read(len(_MAGIC))
            checked = probe == _MAGIC
            if not checked:
                fh.seek(0)
            while fh.tell() < cap:
                head = fh.read(4)
                if len(head) < 4:
                    break
                (n,) = struct.unpack("<I", head)
                wm = n == _WATERMARK
                if wm:
                    head = fh.read(4)
                    if len(head) < 4:
                        break
                    (n,) = struct.unpack("<I", head)
                crc = None
                if checked:
                    raw = fh.read(4)
                    if len(raw) < 4:
                        break
                    (crc,) = struct.unpack("<I", raw)
                if fh.tell() + n > cap:
                    break   # record extends past the durable extent
                body = fh.read(n)
                if len(body) < n:
                    break
                if crc is not None and zlib.crc32(body) != crc:
                    break
                if wm or not body:
                    continue
                tag, rest = body[:1], body[1:]
                sep = rest.find(b"\x00")
                if sep < 0:
                    continue
                tenant = rest[:sep].decode("utf-8", "replace")
                kind = "json" if tag == WAL_JSON else "binary"
                yield kind, tenant, rest[sep + 1:]


# --------------------------------------------------------------------------
# follower side: the standby applier
# --------------------------------------------------------------------------

class _Standby:
    """One leader's standby: engine + stream position + liveness."""

    def __init__(self, engine, epoch: int):
        self.engine = engine
        self.applied_seq = 0
        self.advertised_seq = 0
        self.leader_epoch = epoch
        self.fence_epoch = 0
        self.lock = threading.Lock()
        self.created_mono = time.monotonic()
        self.last_feed_mono: float | None = None
        self.last_caughtup_mono: float | None = None
        self.takeover_mono: float | None = None
        self.applied_batches = 0
        self.applied_payloads = 0


class ReplicaApplier:
    """One per rank (the follower role): standby stores for each leader
    this rank follows, failover read serving, and leader-death detection
    for scheduler fire-over."""

    def __init__(self, cluster, rf: int = 2, detect_s: float = 5.0,
                 catchup_window_s: float = 120.0):
        self.cluster = cluster
        self.rank = cluster.rank
        self.rf = max(1, min(rf, cluster.n_ranks))
        self.detect_s = detect_s
        self.catchup_window_s = catchup_window_s
        self._lock = threading.Lock()
        self._standbys: dict[int, _Standby] = {}
        self.counters = {"applied_batches": 0, "applied_payloads": 0,
                         "resets": 0, "failover_reads": 0,
                         "fireovers": 0, "gap_rejects": 0}

    # the leaders this rank follows (inverse of replica_ring)
    def leaders(self) -> list[int]:
        return [r for r in range(self.cluster.n_ranks)
                if r != self.rank
                and self.rank in replica_ring(r, self.cluster.n_ranks,
                                              self.rf)]

    def follows(self, leader: int) -> bool:
        return leader in self._standbys or leader in self.leaders()

    def _standby(self, leader: int) -> "_Standby | None":
        with self._lock:
            return self._standbys.get(leader)

    # ----------------------------------------------------------- feed RPCs
    def reset(self, leader: int, config: dict, epoch_base: float,
              epoch: int) -> dict:
        from sitewhere_tpu_torch.core.events import EpochBase
        from sitewhere_tpu_torch.parallel.distributed import (DistributedConfig,
                                                        DistributedEngine)

        # the standby lives where this rank's own engine does
        local = getattr(self.cluster, "local", self.cluster)
        cfg = DistributedConfig(**config, device=local.config.device)
        engine = DistributedEngine(cfg)
        engine.epoch = EpochBase(epoch_base)
        st = _Standby(engine, epoch)
        with self._lock:
            old = self._standbys.get(leader)
            if old is not None:
                # the fencing epoch must survive a resync: a leader
                # restart re-streams, it does not un-fence
                st.fence_epoch = old.fence_epoch
                st.takeover_mono = old.takeover_mono
            self._standbys[leader] = st
        self.counters["resets"] += 1
        logger.info("rank %d: standby for leader %d reset (epoch %d)",
                    self.rank, leader, epoch)
        return {"ok": True}

    def _fence_fields(self, st: _Standby, epoch: int) -> dict:
        st.leader_epoch = max(st.leader_epoch, int(epoch))
        if st.fence_epoch > int(epoch):
            return {"fence": st.fence_epoch}
        return {}

    def _ingest(self, st: _Standby, encoding: str, tenant: str,
                payloads: list[bytes], now_ms: "int | None") -> None:
        eng = st.engine
        fn = (eng.ingest_binary_batch if encoding == "binary"
              else eng.ingest_json_batch)
        if now_ms is not None:
            eng._now_override = int(now_ms)
        try:
            fn(payloads, tenant)
        finally:
            eng._now_override = None

    def apply(self, leader: int, seq: int, epoch: int, encoding: str,
              tenant: str, lens: list, nowMs: int, publishMs: float,
              adv: int, _attachment: bytes = None,
              payloads: list = None) -> dict:
        from sitewhere_tpu_torch.parallel.cluster import _wire_payloads

        st = self._standby(leader)
        if st is None:
            return {"unknown": True}
        with st.lock:
            out = self._fence_fields(st, epoch)
            if seq != st.applied_seq + 1:
                self.counters["gap_rejects"] += 1
                return {"expect": st.applied_seq + 1, **out}
            plist = _wire_payloads(payloads, lens, _attachment)
            # standby-apply span: the sender bound the
            # originating batch's traceparent around this RPC, so the
            # span lands on the ingest trace — recorded into THIS
            # rank's tracer (the standby engine records nothing itself)
            from sitewhere_tpu_torch.utils.tracing import (current_traceparent,
                                                     trace_id_of)

            tracer = getattr(self.cluster.local, "tracer", None)
            tid = trace_id_of(current_traceparent())
            t0 = time.perf_counter_ns()
            self._ingest(st, encoding, tenant, plist, nowMs)
            if tracer is not None and tracer.enabled and tid is not None:
                tracer.record("repl.apply", t0, time.perf_counter_ns(),
                              trace_id=tid, leader=leader, seq=seq,
                              payloads=len(plist))
            st.applied_seq = seq
            st.advertised_seq = max(int(adv), seq)
            st.last_feed_mono = time.monotonic()
            st.applied_batches += 1
            st.applied_payloads += len(plist)
            if st.applied_seq >= st.advertised_seq:
                st.last_caughtup_mono = st.last_feed_mono
            self.counters["applied_batches"] += 1
            self.counters["applied_payloads"] += len(plist)
            _replication_instruments()["applied"].inc()
            return {"applied": seq, **out}

    def wal(self, leader: int, idx: int, encoding: str, tenant: str,
            lens: list, _attachment: bytes = None,
            payloads: list = None) -> dict:
        """One resync chunk (WAL-order records; no staging-clock pin —
        resync restores logical history, the live stream restores byte
        identity going forward)."""
        from sitewhere_tpu_torch.parallel.cluster import _wire_payloads

        st = self._standby(leader)
        if st is None:
            return {"unknown": True}
        with st.lock:
            plist = _wire_payloads(payloads, lens, _attachment)
            self._ingest(st, encoding, tenant, plist, None)
            st.last_feed_mono = time.monotonic()
            return {"ok": True, "idx": idx}

    def resume(self, leader: int, seq: int) -> dict:
        st = self._standby(leader)
        if st is None:
            return {"unknown": True}
        with st.lock:
            st.applied_seq = int(seq)
            st.advertised_seq = max(st.advertised_seq, int(seq))
            now = time.monotonic()
            st.last_feed_mono = now
            st.last_caughtup_mono = now
            return {"ok": True}

    def heartbeat(self, leader: int, seq: int, epoch: int) -> dict:
        st = self._standby(leader)
        if st is None:
            return {"unknown": True}
        with st.lock:
            out = self._fence_fields(st, epoch)
            st.advertised_seq = max(st.advertised_seq, int(seq))
            now = time.monotonic()
            st.last_feed_mono = now
            if st.applied_seq >= st.advertised_seq:
                st.last_caughtup_mono = now
            return {"applied": st.applied_seq, **out}

    # -------------------------------------------------------- failover reads
    def stale_ms(self, leader: int) -> float:
        """The explicit staleness watermark failover responses carry:
        milliseconds since this standby last provably reflected every
        acknowledged write of the leader."""
        st = self._standby(leader)
        if st is None:
            return -1.0
        anchor = st.last_caughtup_mono or st.created_mono
        return max(0.0, (time.monotonic() - anchor) * 1000.0)

    def applied(self, leader: int) -> int:
        st = self._standby(leader)
        return st.applied_seq if st is not None else -1

    def status(self, leader: int) -> dict:
        st = self._standby(leader)
        if st is None:
            return {"unknown": True}
        return {"applied": st.applied_seq,
                "advertised": st.advertised_seq,
                "staleMs": self.stale_ms(leader),
                "leaderAlive": self.leader_alive(leader),
                "fenceEpoch": st.fence_epoch}

    def _flushed_engine(self, st: _Standby):
        eng = st.engine
        with st.lock:
            if eng.staged_count or eng._pending_outs:
                eng.flush()
        return eng

    def query_events(self, leader: int, **kw) -> "dict | None":
        st = self._standby(leader)
        if st is None:
            return None
        res = self._flushed_engine(st).query_events(**kw)
        res["stale_ms"] = round(self.stale_ms(leader), 3)
        res["served_by_replica"] = self.rank
        self.counters["failover_reads"] += 1
        _replication_instruments()["failover_reads"].inc()
        return res

    def device_state(self, leader: int, token: str) -> "dict | None":
        st = self._standby(leader)
        if st is None:
            return None
        state = self._flushed_engine(st).get_device_state(token)
        self.counters["failover_reads"] += 1
        _replication_instruments()["failover_reads"].inc()
        if state is None:
            return {"stale_ms": round(self.stale_ms(leader), 3),
                    "missing": True}
        state["stale_ms"] = round(self.stale_ms(leader), 3)
        state["served_by_replica"] = self.rank
        return state

    def search_states(self, leader: int, **kw) -> "list | None":
        st = self._standby(leader)
        if st is None:
            return None
        out = self._flushed_engine(st).search_device_states(**kw)
        self.counters["failover_reads"] += 1
        _replication_instruments()["failover_reads"].inc()
        stale = round(self.stale_ms(leader), 3)
        for row in out:
            row["stale_ms"] = stale
            row["served_by_replica"] = self.rank
        return out

    # --------------------------------------------------------- fire-over
    def leader_alive(self, leader: int) -> bool:
        """Feed-silence liveness: the leader streamed or heartbeat
        within ``detect_s``. A standby that has NEVER heard from its
        leader counts alive for its first ``detect_s`` (boot grace)."""
        st = self._standby(leader)
        if st is None:
            return True   # not following: no opinion
        anchor = st.last_feed_mono or st.created_mono
        return (time.monotonic() - anchor) < self.detect_s

    def should_fire_over(self, owner: int) -> bool:
        """Should THIS rank fire schedules owned by ``owner``? Yes when
        the owner's feed went silent past the detection budget and this
        rank is the owner's first follower that is not itself down.
        Takeover bumps the fencing epoch so the recovering owner syncs
        before firing again."""
        st = self._standby(owner)
        if st is None:
            return False
        if self.leader_alive(owner):
            if st.takeover_mono is not None:
                logger.info("rank %d: leader %d back, ending schedule "
                            "fire-over", self.rank, owner)
                st.takeover_mono = None
            return False
        for f in replica_ring(owner, self.cluster.n_ranks, self.rf):
            if f == self.rank:
                break
            if not self.cluster.health.is_down(f):
                return False   # an earlier live follower owns fire-over
        if st.takeover_mono is None:
            with st.lock:
                if st.takeover_mono is None:
                    st.takeover_mono = time.monotonic()
                    st.fence_epoch = max(st.fence_epoch,
                                         st.leader_epoch) + 1
                    self.counters["fireovers"] += 1
                    _replication_instruments()["fireovers"].inc()
                    self.cluster.health.mark_down(owner)
                    logger.warning(
                        "rank %d: taking over schedule firing for dead "
                        "leader %d (fence epoch %d)", self.rank, owner,
                        st.fence_epoch)
        return True

    def in_catchup(self, owner: int) -> bool:
        """True while a fresh takeover may fire windows missed during
        detection (cron catch-up semantics in ScheduleManager)."""
        st = self._standby(owner)
        return (st is not None and st.takeover_mono is not None
                and (time.monotonic() - st.takeover_mono)
                < self.catchup_window_s)

    # -------------------------------------------------------------- metrics
    def standbys_status(self) -> dict:
        """Per-leader standby status keyed by rank string — THE standby
        block every health surface (REST, instance RPC, cluster RPC,
        cluster_status) serves."""
        with self._lock:
            leaders = list(self._standbys)
        return {str(r): self.status(r) for r in leaders}

    def stale_by_leader(self) -> dict[int, float]:
        """Staleness watermark PER LEADER this rank follows — the
        per-peer series behind ``swtpu_replication_stale_ms{leader=...}``
        and the cluster_status health block (a single lagging follower
        must be visible before a failover read hits it, not averaged
        into a max)."""
        with self._lock:
            leaders = list(self._standbys)
        return {r: round(self.stale_ms(r), 3) for r in leaders}

    def metrics(self) -> dict:
        with self._lock:
            leaders = dict(self._standbys)
        out = {f"replica_applier_{k}": v for k, v in self.counters.items()}
        out["replica_standbys"] = len(leaders)
        if leaders:
            out["replica_max_stale_ms"] = max(
                self.stale_ms(r) for r in leaders)
        return out

    def close(self) -> None:
        with self._lock:
            self._standbys.clear()


def install_fireover(scheduler, cluster) -> None:
    """Wire failure-aware schedule routing into a ScheduleManager:
    each schedule fires at its token's owner rank while that rank is
    alive, at its first live follower while it is dead (with missed-
    window catch-up), and never at both (fencing + replicated fired
    state)."""
    me = cluster.rank

    def fire_filter(token: str) -> bool:
        # ownership resolves through the PLACEMENT map, the
        # same epoch every other surface reads — a moved schedule token
        # fires at its new owner from the commit epoch on, and never at
        # both (the map is installed atomically per rank and a lower
        # epoch is never adopted)
        owner = cluster.owner(token)
        if owner == me:
            feed = cluster.replica_feed
            return feed is None or feed.can_fire()
        applier = cluster.replica_applier
        return applier is not None and applier.should_fire_over(owner)

    def catchup_filter(token: str) -> bool:
        owner = cluster.owner(token)
        applier = cluster.replica_applier
        return (owner != me and applier is not None
                and applier.in_catchup(owner))

    scheduler.fire_filter = fire_filter
    scheduler.catchup_filter = catchup_filter


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


def register_replication_rpc(srv, applier: ReplicaApplier) -> None:
    """The replica-feed + failover-read surface on the rank's cluster
    RPC server (rides the same authenticated channel as entity sync)."""
    cluster = applier.cluster

    def health():
        return cluster_health_payload(cluster)

    for name, fn in {
        "Cluster.replicaReset": lambda leader, config, epochBase, epoch:
            applier.reset(leader, config, epochBase, epoch),
        "Cluster.replicaApply": applier.apply,
        "Cluster.replicaWal": applier.wal,
        "Cluster.replicaResume": applier.resume,
        "Cluster.replicaHeartbeat": applier.heartbeat,
        "Cluster.replicaStatus": lambda leader: applier.status(leader),
        "Cluster.replicaQueryEvents": lambda leader, **kw:
            applier.query_events(leader, **kw),
        "Cluster.replicaDeviceState": lambda leader, token:
            applier.device_state(leader, token),
        "Cluster.replicaSearchStates": lambda leader, **kw:
            applier.search_states(leader, **kw),
        "Cluster.health": health,
    }.items():
        srv.register(name, fn)


# resolved once: publish runs inside the WAL-append critical section and
# apply/failover-read are the follower's hot paths — six registry
# lookups per event would be pure overhead (the registry returns the
# same instrument objects forever)
_INSTRUMENTS: dict | None = None


def _replication_instruments() -> dict:
    global _INSTRUMENTS
    if _INSTRUMENTS is None:
        from sitewhere_tpu_torch.utils.metrics import replication_metrics

        _INSTRUMENTS = replication_metrics()
    return _INSTRUMENTS
