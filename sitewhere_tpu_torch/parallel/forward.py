"""Durable cross-rank ingest forwarding: spill, retry, dead-letter.

In the reference, the ingest edge hands decoded events to a durable,
partitioned Kafka topic (DecodedEventsProducer.java:17-28) — a consumer
replica being down never loses data, because the broker holds the batch
until the partition's consumer returns. Without it the cluster forwarded raw
payloads over a synchronous RPC with one reconnect: a down owner rank
meant the remote share of the batch was simply gone. This module is
the broker-durability analog for the cluster:

  * every cross-rank forward is TAGGED with a unique forward id and the
    owner records applied ids (``SpillRegistry``), so a redelivery after
    a lost response or a crash-restart is suppressed, not re-ingested —
    at-least-once transport with near-exact application (the residual
    window: owner crash after WAL-ingest but before the id record; the
    engine-level alternate-id deduplicator closes even that);
  * when the owner is unreachable (connection error or timeout), the
    sub-batch SPILLS to a per-peer on-disk queue (CRC-stamped JSON files,
    atomic rename) instead of raising mid-batch; ``ingest_*_batch``
    reports it as ``{"spilled": n}`` in the summary;
  * a background pump retries oldest-first per peer, preserving the
    spill order; after a configurable retry budget the file moves to a
    ``deadletter/`` directory (data is never silently dropped) and a
    counter records it;
  * queue depth and oldest-age surface as metrics (the Kafka lag gauges
    of this path).
"""

from __future__ import annotations

import base64
import json
import logging
import os
import pathlib
import threading
import time
import zlib
from collections import OrderedDict

from sitewhere_tpu_torch.utils.streams import card_streams, on_streams

logger = logging.getLogger(__name__)


def _crc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


class SpillRegistry:
    """Owner-side record of applied forward ids. Appends are flushed (OS
    buffer) on every record and fsynced periodically: losing a record
    can only cause a duplicate (which the engine deduplicator absorbs),
    never a loss, so per-record fsync is not worth the hot-path cost.

    The in-memory set is CAPPED, so it has an explicit dedup HORIZON:
    when an entry evicts, the eviction watermark (the evicted fid's
    spill-time ns, persisted) advances — a redelivery carrying a fid
    OLDER than the watermark can no longer be distinguished from an
    already-applied forward, so it is REJECTED (dead-lettered + counted)
    instead of silently double-applied. The horizon exports as a gauge
    so an operator sees how much redelivery window the capacity buys."""

    def __init__(self, directory, capacity: int = 200_000,
                 fsync_every: int = 256):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "applied-forwards.log"
        self._horizon_path = self.dir / "horizon"
        self.capacity = capacity
        self.fsync_every = fsync_every
        self._lock = threading.Lock()
        self._seen: OrderedDict[str, None] = OrderedDict()
        self._since_sync = 0
        self._lines = 0
        self.horizon_ns = 0
        self.stale_rejects = 0
        try:
            self.horizon_ns = int(self._horizon_path.read_text().strip())
        except (OSError, ValueError):
            pass
        self._persisted_horizon_ns = self.horizon_ns
        if self.path.exists():
            loaded_horizon = self.horizon_ns
            for line in self.path.read_text().splitlines():
                fid = line.strip()
                if fid:
                    self._remember(fid)
                    self._lines += 1
            if self.horizon_ns != loaded_horizon:
                self._persist_horizon()
        self._fh = open(self.path, "a")

    @staticmethod
    def fid_time_ns(fid: str) -> "int | None":
        """Spill-clock component of a forward id (rank-time_ns-seq);
        None for foreign formats (treated as inside the horizon)."""
        parts = fid.split("-")
        if len(parts) >= 3:
            try:
                return int(parts[1])
            except ValueError:
                return None
        return None

    def _remember(self, fid: str) -> None:
        """Advances the in-memory horizon on eviction; the caller
        persists it ONCE per record (at steady-state capacity every
        record evicts, and a tmp-write+rename per eviction inside the
        lock would tax the hot dedup path — and the post-restart reload
        loop worst of all). A crash-stale horizon is safe: the reloaded
        _seen log still classifies those fids as duplicates."""
        self._seen[fid] = None
        while len(self._seen) > self.capacity:
            evicted, _ = self._seen.popitem(last=False)
            ns = self.fid_time_ns(evicted)
            if ns is not None and ns > self.horizon_ns:
                self.horizon_ns = ns

    def _persist_horizon(self) -> None:
        tmp = self._horizon_path.with_suffix(".tmp")
        tmp.write_text(str(self.horizon_ns))
        tmp.rename(self._horizon_path)
        self._persisted_horizon_ns = self.horizon_ns

    def seen(self, fid: str) -> bool:
        with self._lock:
            return fid in self._seen

    def check(self, fid: str) -> str:
        """Classify a delivery: "new" (apply it), "duplicate" (suppress),
        or "stale" (older than the eviction watermark — the registry can
        no longer prove it wasn't applied; the caller must dead-letter,
        not re-apply)."""
        with self._lock:
            if fid in self._seen:
                return "duplicate"
            ns = self.fid_time_ns(fid)
            if ns is not None and self.horizon_ns and ns <= self.horizon_ns:
                self.stale_rejects += 1
                return "stale"
            return "new"

    def deadletter(self, fid: str, record: dict) -> None:
        """Preserve a rejected (post-horizon) redelivery's payload on
        disk — rejection must never silently drop data."""
        dl = self.dir / "deadletter"
        dl.mkdir(parents=True, exist_ok=True)
        (dl / f"stale-{fid}.json").write_text(json.dumps(record))

    def metrics(self) -> dict:
        with self._lock:
            age_ms = ((time.time_ns() - self.horizon_ns) / 1e6
                      if self.horizon_ns else -1.0)
            return {"forward_dedup_entries": len(self._seen),
                    "forward_dedup_horizon_ns": self.horizon_ns,
                    "forward_dedup_horizon_age_ms": age_ms,
                    "forward_stale_rejects": self.stale_rejects}

    def record(self, fid: str) -> None:
        with self._lock:
            self._remember(fid)
            self._fh.write(fid + "\n")
            self._fh.flush()
            self._since_sync += 1
            self._lines += 1
            if self._since_sync >= self.fsync_every:
                os.fsync(self._fh.fileno())
                # persist the horizon on the same cadence as the fsync:
                # at steady-state capacity EVERY record evicts, and a
                # tmp+rename per record would tax the hot dedup path. A
                # crash-stale horizon only widens the window in which a
                # redelivery classifies via the reloaded _seen log.
                if self.horizon_ns != self._persisted_horizon_ns:
                    self._persist_horizon()
                self._since_sync = 0
            if self._lines > 2 * self.capacity:
                self._compact()

    def _compact(self) -> None:
        """Rewrite the log from the capped in-memory set (lock held):
        the file must not grow without bound on the happy path — one fid
        line lands per forwarded sub-batch, forever."""
        tmp = self.path.with_suffix(".tmp")
        with open(tmp, "w") as fh:
            fh.write("\n".join(self._seen) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        self._fh.close()
        tmp.rename(self.path)
        self._fh = open(self.path, "a")
        self._lines = len(self._seen)

    def close(self) -> None:
        with self._lock:
            if self.horizon_ns != self._persisted_horizon_ns:
                self._persist_horizon()
            self._fh.close()


class ForwardQueue:
    """Sender-side durable spill queue, one subdirectory per peer rank."""

    def __init__(self, cluster, directory, retry_interval_s: float = 0.5,
                 retry_budget_s: float = 300.0,
                 app_reject_attempts: int = 5):
        self.cluster = cluster
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._streams = card_streams(getattr(cluster, "local", cluster))
        self.retry_interval_s = retry_interval_s
        self.retry_budget_s = retry_budget_s
        # a deterministic owner-side reject (poison batch) dead-letters
        # after this many delivery attempts instead of wedging the peer
        # queue for the whole transport retry budget
        self.app_reject_attempts = app_reject_attempts
        self._attempts: dict[str, int] = {}
        # per-file redelivery deferrals (monotonic deadline): a 429
        # owner-shed honors the owner's Retry-After instead of hammering
        # a saturated peer every pump interval. In-memory on purpose: a
        # restart just earns one extra 429.
        self._defer: dict[str, float] = {}
        self.counters = {"spilled_batches": 0, "spilled_payloads": 0,
                         "redelivered_batches": 0, "deadlettered_batches": 0,
                         "retry_failures": 0, "retry_app_rejects": 0,
                         "retry_transport_failures": 0,
                         "deadlettered_poison": 0,
                         # placement redirects: 473 replies
                         # seen by the pump, and originals CONSUMED by a
                         # re-route (their payloads re-spill toward the
                         # new owner — a legal terminal disposition in
                         # the conservation forward-queue equation)
                         "retry_redirects": 0, "rerouted_batches": 0}
        self._seq = 0
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # circuit breaker: after one failed forward, later batches spill
        # IMMEDIATELY instead of each paying the peer connect timeout;
        # the retry pump's first successful delivery closes the circuit
        self._open_circuits: set[int] = set()

    def circuit_open(self, rank: int) -> bool:
        return rank in self._open_circuits

    def trip(self, rank: int) -> None:
        if rank not in self._open_circuits:
            logger.warning("forward circuit to rank %d OPEN "
                           "(spilling without attempting)", rank)
        self._open_circuits.add(rank)

    def reset(self, rank: int) -> None:
        if rank in self._open_circuits:
            logger.info("forward circuit to rank %d closed", rank)
            self._open_circuits.discard(rank)

    # ------------------------------------------------------------ spill
    def spill(self, rank: int, kind: str, tenant: str, fid: str,
              payloads: list[bytes] | None = None,
              envelope: dict | None = None,
              defer_s: float | None = None) -> None:
        """Persist one undeliverable forward (kind: "json" | "binary" |
        "envelope"). Atomic write: tmp + rename, CRC over the body. The
        bound traceparent rides the record so a redelivery hours later
        still joins the original batch's trace. ``defer_s`` (an owner
        Retry-After on a 429 shed) delays the first redelivery attempt."""
        from sitewhere_tpu_torch.utils.tracing import current_traceparent

        rec = {"fid": fid, "kind": kind, "tenant": tenant,
               "spilled_ms": time.time() * 1000}
        tp = current_traceparent()
        if tp is not None:
            rec["tp"] = tp
        if payloads is not None:
            rec["payloads"] = [base64.b64encode(p).decode() for p in payloads]
        if envelope is not None:
            rec["envelope"] = envelope
        body = json.dumps(rec).encode()
        doc = json.dumps({"crc": _crc(body),
                          "body": body.decode()}).encode()
        peer_dir = self.dir / f"rank-{rank}"
        peer_dir.mkdir(parents=True, exist_ok=True)
        with self._lock:
            self._seq += 1
            name = f"spill-{time.time_ns():020d}-{self._seq:06d}.json"
        tmp = peer_dir / (name + ".tmp")
        tmp.write_bytes(doc)
        with open(tmp, "rb") as fh:
            os.fsync(fh.fileno())
        tmp.rename(peer_dir / name)
        if defer_s is not None and defer_s > 0:
            self._defer[name] = time.monotonic() + defer_s
        self.counters["spilled_batches"] += 1
        self.counters["spilled_payloads"] += len(payloads or []) or 1
        logger.warning("forward to rank %d spilled (%s, %d payloads)",
                       rank, kind, len(payloads or []) or 1)

    @staticmethod
    def _load(path: pathlib.Path) -> "dict | None":
        try:
            doc = json.loads(path.read_bytes())
            body = doc["body"].encode()
            if _crc(body) != doc["crc"]:
                return None
            return json.loads(body)
        except (ValueError, KeyError, OSError):
            return None

    # ------------------------------------------------------------ retry
    def _deliver(self, rank: int, rec: dict) -> None:
        from sitewhere_tpu_torch.utils.tracing import bind_traceparent

        peer = self.cluster._peer(rank)
        kind = rec["kind"]
        # the spilled record's traceparent re-binds here, so the
        # redelivery span — possibly hours later — still
        # lands on the original batch's timeline
        from sitewhere_tpu_torch.utils.tracing import NULL_SPAN

        tracer = getattr(getattr(self.cluster, "local", self.cluster),
                         "tracer", None)
        with bind_traceparent(rec.get("tp")), \
                (tracer.begin("forward.redeliver", dst=rank,
                              fid=rec["fid"], kind=kind)
                 if tracer is not None else NULL_SPAN):
            if kind == "envelope":
                peer.call("Cluster.forwardEnvelope", fid=rec["fid"],
                          envelope=rec["envelope"], tenant=rec["tenant"])
            else:
                peer.call("Cluster.ingestForward", fid=rec["fid"],
                          payloads=rec["payloads"], tenant=rec["tenant"],
                          encoding=kind)

    def retry_once(self) -> int:
        """One pass over every peer queue, oldest-first; returns batches
        redelivered. Failures classify in two kinds with DIFFERENT
        ordering contracts:

        * TRANSPORT failures (connection refused / timeout — the peer
          itself is unreachable, every later batch would fail the same
          way): stop at the first failing file so spill order is
          preserved across the outage, dead-letter past the time budget.
        * APPLICATION rejects (``RpcError`` — the peer is UP and
          deterministically refused THIS batch): count the attempt,
          dead-letter the poison file after ``app_reject_attempts``, and
          CONTINUE to the next file — one poison batch must not
          head-of-line-block every batch behind it for the whole
          transport budget (up to 5 minutes before this fix).

        A ``code=429`` app reject (owner-side load shed) is
        retryABLE by design: it counts in ``retry_app_rejects`` like any
        app reject, but it NEVER counts toward the poison budget (an
        admitted batch must not dead-letter because the owner was
        briefly saturated) and its redelivery defers by the owner's
        Retry-After."""
        from sitewhere_tpu_torch.rpc.protocol import RpcError

        redelivered = 0
        for peer_dir in sorted(self.dir.glob("rank-*")):
            rank = int(peer_dir.name.split("-")[1])
            for path in sorted(peer_dir.glob("spill-*.json")):
                if self._defer.get(path.name, 0.0) > time.monotonic():
                    continue   # owner asked for backoff; later files
                               # may already be due (dedup + the ring
                               # absorb the reorder, like app rejects)
                rec = self._load(path)
                if rec is None:
                    logger.error("corrupt spill %s -> deadletter", path)
                    self._deadletter(path)
                    continue
                age_s = (time.time() * 1000 - rec["spilled_ms"]) / 1000
                try:
                    self._deliver(rank, rec)
                    self.reset(rank)
                except RpcError as e:
                    from sitewhere_tpu_torch.parallel.placement import (
                        REDIRECT_CODE)

                    if getattr(e, "code", None) == REDIRECT_CODE:
                        # placement redirect: the owner moved
                        # (or is fencing) while this frame sat spilled.
                        # A MOVED redirect carries the replier's map —
                        # adopt it and RE-ROUTE the frame toward the
                        # current owner(s); a FENCED redirect defers
                        # like a 429 (the commit lands within the fence
                        # window, and the next pass gets the map).
                        # Never the poison budget: the batch is fine,
                        # the address changed.
                        self.counters["retry_redirects"] += 1
                        data = getattr(e, "data", None) or {}
                        adopt = getattr(self.cluster,
                                        "_adopt_redirect_map", None)
                        if adopt is not None:
                            adopt(e, rank)
                        if data.get("fenced") or "map" not in data:
                            ra = (getattr(e, "retry_after_s", None)
                                  or self.retry_interval_s)
                            self._defer[path.name] = time.monotonic() + ra
                            continue
                        self._reroute(path, rec)
                        continue
                    self.counters["retry_failures"] += 1
                    self.counters["retry_app_rejects"] += 1
                    if getattr(e, "code", None) == 429:
                        ra = (getattr(e, "retry_after_s", None)
                              or self.retry_interval_s)
                        self._defer[path.name] = time.monotonic() + ra
                        logger.warning(
                            "forward to rank %d shed by owner (%s); "
                            "deferring %s for %.3fs", rank, e,
                            path.name, ra)
                        continue
                    n = self._attempts.get(path.name, 0) + 1
                    self._attempts[path.name] = n
                    if n >= self.app_reject_attempts:
                        logger.error(
                            "forward to rank %d rejected %d times (%s) "
                            "-> deadletter poison %s", rank, n, e,
                            path.name)
                        self._deadletter(path)
                        self.counters["deadlettered_poison"] += 1
                    continue   # the peer is up: later batches deliver
                except Exception as e:
                    self.counters["retry_failures"] += 1
                    self.counters["retry_transport_failures"] += 1
                    if age_s > self.retry_budget_s:
                        logger.error(
                            "forward to rank %d undeliverable after "
                            "%.0fs (%s) -> deadletter %s", rank, age_s,
                            e, path.name)
                        self._deadletter(path)
                        continue
                    break   # keep order: don't skip ahead of an outage
                self._attempts.pop(path.name, None)
                self._defer.pop(path.name, None)
                path.unlink()
                redelivered += 1
                self.counters["redelivered_batches"] += 1
        return redelivered

    def _reroute(self, path: pathlib.Path, rec: dict) -> None:
        """Re-route one spilled frame to its CURRENT owner(s) per the
        facade's installed placement map: payload batches
        re-partition (a mixed batch may split across owners — each
        share re-spills as a fresh durable record with a fresh forward
        id), envelopes route by their device token. The original file
        is CONSUMED by the re-route (``rerouted_batches``), never
        silently dropped — the conservation forward-queue equation
        counts re-route as a legal terminal disposition alongside
        redelivery and dead-letter."""
        from sitewhere_tpu_torch.utils.tracing import bind_traceparent

        cluster = self.cluster
        with bind_traceparent(rec.get("tp")):
            if rec["kind"] == "envelope":
                tok = (rec.get("envelope") or {}).get("deviceToken")
                owner = (cluster.owner(tok) if tok else None)
                if owner is None:
                    # unroutable: dead-letter preserves it (an acked
                    # frame must never silently vanish)
                    self._deadletter(path)
                    return
                # owner == this rank (a drain moved the slot HERE) is
                # fine: the self-spill redelivers over the loopback
                # Cluster.forwardEnvelope exactly like the batch branch
                self.spill(owner, "envelope", rec["tenant"],
                           cluster._next_fid(), envelope=rec["envelope"])
            else:
                payloads = [base64.b64decode(p) for p in rec["payloads"]]
                for r2, pl2 in cluster._partition_payloads(
                        payloads, kind=rec["kind"]).items():
                    self.spill(r2, rec["kind"], rec["tenant"],
                               cluster._next_fid(), payloads=pl2)
        self._attempts.pop(path.name, None)
        self._defer.pop(path.name, None)
        path.unlink()
        self.counters["rerouted_batches"] += 1
        logger.info("spilled forward %s re-routed per placement epoch "
                    "%d", path.name,
                    getattr(getattr(cluster, "placement", None),
                            "epoch", -1))

    def _deadletter(self, path: pathlib.Path) -> None:
        dl = self.dir / "deadletter"
        dl.mkdir(parents=True, exist_ok=True)
        path.rename(dl / path.name)
        self._attempts.pop(path.name, None)
        self._defer.pop(path.name, None)
        self.counters["deadlettered_batches"] += 1

    # ------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._pump,
                                        name="forward-retry", daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        while not self._stop.wait(self.retry_interval_s):
            try:
                # the building thread's CUDA streams: a redelivery that lands on
                # this rank (the slot moved here) runs engine work
                with on_streams(self._streams):
                    self.retry_once()
            except Exception:
                logger.exception("forward retry pass failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # --------------------------------------------------------- metrics
    def metrics(self) -> dict:
        depth = 0
        oldest_ms = None
        now_ns = time.time_ns()
        for peer_dir in self.dir.glob("rank-*"):
            names = [p.name for p in peer_dir.glob("spill-*.json")]
            depth += len(names)
            if names:
                # the filename encodes spill time_ns — no file reads on
                # the scrape path even with a deep backlog
                spilled_ns = int(min(names).split("-")[1])
                age = (now_ns - spilled_ns) / 1e6
                if oldest_ms is None or age > oldest_ms:
                    oldest_ms = age
        out = {"forward_queue_depth": depth,
               "forward_open_circuits": len(self._open_circuits),
               **{f"forward_{k}": v for k, v in self.counters.items()}}
        if oldest_ms is not None:
            out["forward_queue_oldest_ms"] = oldest_ms
        return out
