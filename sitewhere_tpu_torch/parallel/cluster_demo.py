"""Two-process PRODUCT runtime job: DistributedEngine per rank + crash.

This is the deployment proof for the cluster layer (parallel/cluster.py):
two OS processes, each running a complete DistributedEngine — string
tokens, WAL, feeds — plus its authenticated cluster RPC server and a full
REST gateway. Both ranks ingest batches naming devices of BOTH ranks (raw
payloads forward to owners, the Kafka-producer analog), then each rank
logs in to BOTH REST gateways over HTTP basic auth and asserts the
listings/state agree byte-for-byte regardless of which rank serves them
(KafkaOutboundConnectorHost.java:43-257 replicas +
DeviceStateRouter.java:62-72 routing). Then rank 1 is crashed (os._exit
with events that live only in its WAL tail), restarted in recovery mode,
and the cluster must serve the FULL pre-crash history from either rank
and stay writable — the durability story the reference delegates to
Kafka offsets + k8s restarts (SURVEY.md §5.4/5.5).

Phases hand off through marker files in the shared scratch dir; the
parent (``spawn_cluster_demo``) orchestrates the crash/restart.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

N_PER_RANK = 3          # devices owned per rank in the demo traffic
PHASE_TIMEOUT_S = 120.0


def _wait_for(path: pathlib.Path, timeout_s: float = PHASE_TIMEOUT_S) -> None:
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"phase marker {path.name} never appeared")
        time.sleep(0.05)


def _tokens_for(rank: int, n_ranks: int, n: int) -> list[str]:
    from sitewhere_tpu_torch.parallel.cluster import owner_rank

    out, i = [], 0
    while len(out) < n:
        tok = f"cd-{i}"
        if owner_rank(tok, n_ranks) == rank:
            out.append(tok)
        i += 1
    return out


def _meas(token: str, name: str, value: float, ts_ms: int) -> bytes:
    return json.dumps({
        "deviceToken": token, "type": "DeviceMeasurements",
        "request": {"measurements": {name: value},
                    "eventDate": ts_ms}}).encode()


def _http_json(url: str, headers: dict | None = None,
               timeout_s: float = 60.0) -> dict:
    """GET ``url`` and decode its JSON body (stdlib client: the worker
    needs no HTTP package)."""
    import urllib.request

    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        assert r.status == 200, (url, r.status)
        return json.loads(r.read())


def worker_main(rank: int, scratch: str, rpc0: int, rpc1: int, rest0: int,
                rest1: int, base_s: float, devices_per_proc: int = 2,
                recover: bool = False, device: str = "cuda") -> None:
    """One rank of the 2-process product job, booted entirely through
    ``run_rank`` (config in, serving rank out), its engine's
    ``devices_per_proc`` shards on ``device``.
    Prints CLUSTER_OK / CLUSTER_RECOVERED lines; any assertion failure
    exits nonzero."""
    import logging

    logging.basicConfig(level=logging.WARNING)  # surface handler errors

    from sitewhere_tpu_torch.engine import EngineConfig
    from sitewhere_tpu_torch.instance.instance import InstanceConfig
    from sitewhere_tpu_torch.parallel.cluster import ClusterConfig
    from sitewhere_tpu_torch.parallel.distributed import DistributedConfig
    from sitewhere_tpu_torch.parallel.rank_runtime import RankConfig, run_rank

    scratch_p = pathlib.Path(scratch)
    peers = [f"127.0.0.1:{rpc0}", f"127.0.0.1:{rpc1}"]
    rests = [rest0, rest1]
    secret = "cluster-demo-secret"
    base_ms = int(base_s * 1000)
    ecfg = DistributedConfig(
        n_shards=devices_per_proc, device_capacity_per_shard=64,
        token_capacity_per_shard=128, assignment_capacity_per_shard=128,
        store_capacity_per_shard=512, channels=4,
        batch_capacity_per_shard=16, device=device,
        wal_dir=str(scratch_p / f"wal-r{rank}"))
    # connect timeout bounds the ONE stall a dead-peer forward pays
    # before the circuit opens and everything spills instantly
    ccfg = ClusterConfig(rank=rank, n_ranks=2, peers=peers, secret=secret,
                         epoch_base_unix_s=base_s, engine=ecfg,
                         connect_timeout_s=15.0)
    # the WHOLE rank — engine (or crash recovery), cluster RPC on its own
    # loop, REST + pumps + presence + scheduler — from one config
    rt = run_rank(RankConfig(
        cluster=ccfg, instance=InstanceConfig(engine=EngineConfig()),
        rest_port=rests[rank],
        snapshot_dir=str(scratch_p / f"snap-r{rank}") if recover else None,
        presence_interval_s=600.0, forward_retry_interval_s=0.3))
    cluster, inst = rt.cluster, rt.instance
    assert rt.recovered == recover
    toks0 = _tokens_for(0, 2, N_PER_RANK)
    toks1 = _tokens_for(1, 2, N_PER_RANK)
    both = toks0 + toks1

    def rest_snapshot(port: int) -> dict:
        """Login (basic auth, the reference's BasicAuthForJwt flow) and
        read the event listing + per-device state from one gateway."""
        import base64

        base = f"http://127.0.0.1:{port}"
        basic = base64.b64encode(b"admin:password").decode()
        jwt = _http_json(f"{base}/api/authapi/jwt",
                         {"Authorization": f"Basic {basic}"})["token"]
        h = {"Authorization": f"Bearer {jwt}"}
        out: dict = {}
        listing = _http_json(f"{base}/api/events?pageSize=100", h)
        out["events"] = [(e["deviceToken"], e["eventDateMs"],
                          e.get("measurements"))
                         for e in listing["events"]]
        out["total"] = listing["total"]
        found = _http_json(f"{base}/api/search/events?q=*:*&pageSize=100", h)
        out["search"] = [(d["deviceToken"], d["eventDateMs"])
                         for d in found["results"]]
        out["state"] = {}
        for t in both:
            st = _http_json(f"{base}/api/devices/{t}/state", h)
            out["state"][t] = (st["measurements"], st["presence"])
        return out

    def both_snapshots() -> tuple:
        return rest_snapshot(rests[rank]), rest_snapshot(rests[1 - rank])

    def health(port: int) -> dict:
        return _http_json(f"http://127.0.0.1:{port}/api/instance/health")

    # phases run on the MAIN thread: facade calls block on peer RPC, and
    # run_rank serves cluster RPC + REST on their own loops, so blocking
    # here can never deadlock the peer's forwarded ingest (rule 1)
    if not recover:
        # the readiness probe carries the composed-rank facts
        h = health(rests[rank])
        assert h["status"] == "UP" and h["ready"], h
        assert h["rank"] == rank and h["nRanks"] == 2, h
        # ---- phase 1: mixed ingest from BOTH ranks --------------------
        cluster.ingest_json_batch(
            [_meas(t, "temp", rank * 100.0 + i, base_ms + 1000 * rank + i)
             for i, t in enumerate(both)])
        (scratch_p / f"ingested-r{rank}").touch()
        _wait_for(scratch_p / f"ingested-r{1 - rank}")
        cluster.flush()
        # index this rank's partition (the per-rank search connector),
        # then barrier so both indexes are populated before the
        # cross-rank search-equality snapshot
        rt.pump_outbound()
        (scratch_p / f"indexed-r{rank}").touch()
        _wait_for(scratch_p / f"indexed-r{1 - rank}")
        mine, theirs = both_snapshots()
        assert mine == theirs, (rank, mine, theirs)
        assert mine["total"] == 2 * len(both), mine["total"]
        assert len(mine["search"]) == 2 * len(both), mine["search"]
        # the first metrics fan-out can catch the peer busy on a starved
        # host — retry unreachable peers within the phase budget instead
        # of failing on the first window
        deadline = time.monotonic() + PHASE_TIMEOUT_S
        while True:
            m = cluster.metrics()
            unreachable = any(isinstance(v, dict) and v.get("unreachable")
                              for v in m.get("by_rank", {}).values())
            if not unreachable or time.monotonic() > deadline:
                break
            time.sleep(1.0)
        assert m["persisted"] == 2 * len(both), m
        # ---- entity plane: admin ONCE at rank 0, usable at rank 1 -----
        # (the reference's shared management DB; entity_sync.py)
        if rank == 0:
            inst.device_management.create_device_type("demo-type",
                                                      "Demo type")
            # pushes run on a background thread: drain before signaling
            # the peer that the type is available
            rt.replicator.drain_pushes()
            (scratch_p / "entity-r0").touch()
        else:
            _wait_for(scratch_p / "entity-r0")
            # the replicated type validates rank 1's create_device, and
            # the new device routes to its owner as usual
            inst.device_management.create_device("cd-extra", "demo-type")
        print(f"CLUSTER_OK rank={rank} phase=1 "
              f"total={mine['total']} persisted={m['persisted']} "
              f"rest_agree=1 entity_plane=1", flush=True)

        if rank == 1:
            # snapshot, then wait for rank 0's extra (WAL-tail-only)
            # traffic and crash WITHOUT closing anything
            cluster.local.save(scratch_p / "snap-r1")
            (scratch_p / "r1-snapshotted").touch()
            _wait_for(scratch_p / "extra-sent")
            # the forwarded events are in OUR WAL (logged at ingest
            # accept time) but NOT in the snapshot — the recovery has
            # real work to do
            print("CLUSTER_CRASHING rank=1", flush=True)
            sys.stdout.flush()
            os._exit(17)    # simulated crash: no clean shutdown
        else:
            _wait_for(scratch_p / "r1-snapshotted")
            cluster.ingest_json_batch(
                [_meas(toks1[0], "temp", 777.0, base_ms + 7777)])
            cluster.flush()
            (scratch_p / "extra-sent").touch()
            # ---- phase 1.5: owner DEAD, ingest keeps accepting --------
            # (durable forwarding: the remote share spills to disk
            # instead of raising mid-batch; DecodedEventsProducer's
            # Kafka-durability analog)
            _wait_for(scratch_p / "r1-dead")
            s = cluster.ingest_json_batch(
                [_meas(toks1[1], "temp", 999.0, base_ms + 9999)])
            assert s.get("spilled") == 1, s
            fm = cluster.forward_queue.metrics()
            assert fm["forward_queue_depth"] == 1, fm
            (scratch_p / "spill-sent").touch()
            # ---- phase 2: peer crashed; wait for its recovery ---------
            _wait_for(scratch_p / "r1-recovered",
                      timeout_s=PHASE_TIMEOUT_S * 2)
            q = cluster.query_events(device_token=toks1[0])
            assert q["total"] == 3, q   # 2 original + WAL-tail event
            assert q["events"][0]["measurements"]["temp"] == 777.0
            # the cluster stays writable through the recovered rank
            cluster.ingest_json_batch(
                [_meas(toks1[0], "temp", 888.0, base_ms + 8888)])
            cluster.flush()
            # the background retry pump must redeliver the spilled event
            # to the recovered owner — ZERO loss across the SIGKILL
            deadline = time.monotonic() + 30.0
            while cluster.query_events(
                    device_token=toks1[1])["total"] < 3:
                assert time.monotonic() < deadline, "spill not redelivered"
                time.sleep(0.2)
            fm = cluster.forward_queue.metrics()
            assert fm["forward_redelivered_batches"] >= 1, fm
            assert fm["forward_queue_depth"] == 0, fm
            rt.pump_outbound()
            (scratch_p / "r0-pumped").touch()
            _wait_for(scratch_p / "r1-pumped")
            mine, theirs = both_snapshots()
            assert mine == theirs, (mine, theirs)
            assert mine["total"] == 2 * len(both) + 3
            # the recovered rank re-indexed its partition from its
            # rebuilt feed: search is complete again cluster-wide
            assert len(mine["search"]) == mine["total"], mine["search"]
            print(f"CLUSTER_OK rank=0 phase=2 "
                  f"total={mine['total']} "
                  f"recovered_peer_serves_history=1 "
                  f"spill_redelivered=1", flush=True)
            (scratch_p / "r0-done").touch()
            rt.stop()
    else:
        # ---- restarted rank 1: WAL replayed over the snapshot ---------
        h = health(rests[rank])
        assert h["recovered"] is True, h
        q = cluster.local.query_events(device_token=toks1[0])
        assert q["total"] == 3, q   # snapshot(2) + WAL tail(1)
        assert q["events"][0]["measurements"]["temp"] == 777.0
        # the entity plane survived the SIGKILL too: the replicated
        # device type replayed from this rank's entity journal
        assert "demo-type" in inst.device_management.device_types
        print(f"CLUSTER_RECOVERED rank=1 "
              f"replayed_total={q['total']} entity_replayed=1", flush=True)
        (scratch_p / "r1-recovered").touch()
        # re-index this rank's partition (fresh in-memory index after
        # the crash; the rebuilt feed replays it) for rank 0's
        # phase-2 search-equality snapshot, then wait for the final
        # post-recovery write to index it too
        _wait_for(scratch_p / "r0-pumped", timeout_s=PHASE_TIMEOUT_S * 2)
        rt.pump_outbound()
        (scratch_p / "r1-pumped").touch()
        _wait_for(scratch_p / "r0-done", timeout_s=PHASE_TIMEOUT_S * 2)
        rt.stop()


def free_ports(n: int) -> list[int]:
    """``n`` loopback ports that were free a moment ago (bound to port 0)."""
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    out = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return out


def _spawn(rank: int, scratch: str, ports: list[int], base_s: float,
           devices_per_proc: int, recover: bool,
           device: str) -> subprocess.Popen:
    env = dict(os.environ)
    # the package's parent on the path, wherever the caller runs from
    root = str(pathlib.Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    code = (
        "from sitewhere_tpu_torch.parallel.cluster_demo import worker_main;"
        f"worker_main({rank}, {scratch!r}, {ports[0]}, {ports[1]}, "
        f"{ports[2]}, {ports[3]}, {base_s}, {devices_per_proc}, "
        f"recover={recover}, device={device!r})")
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def spawn_cluster_demo(devices_per_proc: int = 2,
                       timeout_s: float = 300.0,
                       device: str = "cuda") -> list[str]:
    """Run the 2-process product job incl. the crash/recover phase, each
    rank's shards on ``device`` (``"cpu"`` without a card). Returns the
    marker lines (CLUSTER_OK x3, CLUSTER_RECOVERED)."""
    import tempfile

    with tempfile.TemporaryDirectory() as scratch:
        ports = free_ports(4)
        base_s = float(int(time.time()))
        p0 = _spawn(0, scratch, ports, base_s, devices_per_proc, False,
                    device)
        p1 = _spawn(1, scratch, ports, base_s, devices_per_proc, False,
                    device)
        deadline = time.monotonic() + timeout_s

        def finish(p: subprocess.Popen, name: str) -> tuple[str, str]:
            try:
                return p.communicate(timeout=max(5.0, deadline -
                                                 time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in (p0, p1):
                    q.kill()
                    q.wait()
                raise RuntimeError(f"{name} timed out")

        # rank 1 crashes itself with code 17 after phase 1
        out1, err1 = finish(p1, "rank1")
        if p1.returncode != 17 or "CLUSTER_CRASHING" not in out1:
            p0.kill()
            p0.wait()
            raise RuntimeError(
                f"rank1 phase1 failed rc={p1.returncode}\n{out1}\n"
                f"{err1[-2000:]}")
        # rank 1 is REAPED (truly dead): let rank 0 ingest against the
        # dead owner — the durable forward queue must spill, not lose —
        # BEFORE the replacement process comes up
        pathlib.Path(scratch, "r1-dead").touch()
        _wait_for(pathlib.Path(scratch, "spill-sent"),
                  timeout_s=max(5.0, deadline - time.monotonic()))
        p1b = _spawn(1, scratch, ports, base_s, devices_per_proc, True,
                     device)
        out1b, err1b = finish(p1b, "rank1-recovered")
        out0, err0 = finish(p0, "rank0")
        errs = []
        if p0.returncode != 0 or "CLUSTER_OK rank=0 phase=2" not in out0:
            errs.append(f"rank0 rc={p0.returncode}\n{out0}\n{err0[-2000:]}")
        if p1b.returncode != 0 or "CLUSTER_RECOVERED" not in out1b:
            errs.append(
                f"rank1b rc={p1b.returncode}\n{out1b}\n{err1b[-2000:]}")
        if errs:
            raise RuntimeError("cluster demo failed:\n" + "\n".join(errs))
        lines = [ln for out in (out0, out1, out1b)
                 for ln in out.splitlines()
                 if ln.startswith(("CLUSTER_OK", "CLUSTER_RECOVERED"))]
        return lines
