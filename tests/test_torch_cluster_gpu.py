"""The cluster planes on the card from threads that did not build the
engines (``parallel/cluster.py``'s ``CardRpcServer``, the forward pump,
the replica applier): a card test, kept apart from the JAX twins of
``tests/test_torch_cluster.py`` (this file imports no JAX and no
``tests`` helper; its clusters are ``chip_smoke.ClusterRig``'s). It skips
without a CUDA device; on the GPU machine run
``python -m pytest tests/test_torch_cluster_gpu.py -m gpu``."""

import json
import threading
import time

import pytest
import torch

from sitewhere_tpu_torch.parallel.cluster import owner_rank

BASE_S = 1_750_000_000.0
MESH = dict(n_shards=2, device_capacity_per_shard=64, token_capacity_per_shard=128,
            assignment_capacity_per_shard=128, store_capacity_per_shard=512, channels=4,
            batch_capacity_per_shard=16)


def _meas(token, value, ts):
    return json.dumps({"deviceToken": token, "type": "DeviceMeasurements",
                       "request": {"measurements": {"temp": value},
                                   "eventDate": int(BASE_S * 1000) + ts}}).encode()


def _cluster(device, root):
    """Two ranks on ``device`` with forwarding and RF = 2 and pinned
    clocks, built on this thread (under whatever stream is current here);
    RPC on a loop thread."""
    from chip_smoke import ClusterRig

    return ClusterRig(device, root, MESH, rf=2, base_s=BASE_S, now_ms=60_000,
                      retry_s=0.05)


def _drive(cl, batches, spill_batch):
    """Mixed-owner batches at rank 0; rank 1's server stopped for
    ``spill_batch`` (spilled) and restarted, the forward pump redelivering;
    returns the answers."""
    c0 = cl.clusters[0]
    for b in batches:
        c0.ingest_json_batch(b)
    c0.flush()
    cl.stop_server(1)
    s = c0.ingest_json_batch(spill_batch)
    assert s.get("spilled", 0) > 0, s
    cl.start_server(1)
    cl.queues[0].start()
    deadline = time.monotonic() + 60
    while cl.queues[0].metrics()["forward_queue_depth"]:
        assert time.monotonic() < deadline, "spill not redelivered"
        time.sleep(0.05)
    for c in cl.clusters:
        c.flush()
    assert cl.drain_feeds(), "replica feeds did not drain"
    toks = sorted({json.loads(p)["deviceToken"] for b in batches for p in b})
    out = {"pages": [c.query_events(limit=200) for c in cl.clusters],
           "states": [c0.get_device_state(t) for t in toks],
           "standby_rows": []}
    for a in cl.appliers:
        for leader, st in sorted(a._standbys.items()):
            st.engine.flush()
            out["standby_rows"].append((a.rank, leader,
                                        st.engine.query_events(limit=200)))
    return out


@pytest.mark.gpu
def test_cluster_planes_run_on_the_building_threads_stream(tmp_path):
    """A 2-rank cluster built under a side stream: forwarded ingest on the
    RPC loop's thread, the standby applier and the forward pump's
    redelivery all run under that stream on the card, and the cluster
    answers as the same cluster on CPU engines."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    toks = [f"g-{i}" for i in range(12)]
    assert {owner_rank(t, 2) for t in toks} == {0, 1}
    batches = [[_meas(t, float(k * 12 + i), k * 100 + i) for i, t in enumerate(toks)]
               for k in range(4)]
    spill = [_meas(t, 99.0, 900 + i) for i, t in enumerate(toks) if owner_rank(t, 2) == 1]
    side = torch.cuda.Stream(dev)
    seen = []
    with torch.cuda.stream(side):
        card = _cluster(dev, tmp_path / "card")
    try:
        r1 = card.clusters[1].local
        call = r1.ingest_json_batch

        def spy(payloads, tenant="default", **kw):
            seen.append(("forwarded", threading.current_thread().name,
                         torch.cuda.current_stream(dev)))
            return call(payloads, tenant, **kw)

        r1.ingest_json_batch = spy
        for a in card.appliers:
            apply = a._ingest

            def spy_apply(st, *args, _apply=apply):
                seen.append(("standby", threading.current_thread().name,
                             torch.cuda.current_stream(dev)))
                return _apply(st, *args)

            a._ingest = spy_apply
        retry = card.queues[0].retry_once

        def spy_retry():
            seen.append(("pump", threading.current_thread().name,
                         torch.cuda.current_stream(dev)))
            return retry()

        card.queues[0].retry_once = spy_retry
        with torch.cuda.stream(side):
            got = _drive(card, batches, spill)
        torch.cuda.synchronize()
        devices = {str(d) for c in card.clusters for d in c.local.mesh}
        devices |= {str(d) for a in card.appliers for st in a._standbys.values()
                    for d in st.engine.mesh}
    finally:
        card.close()
    kinds = {k for k, _, _ in seen}
    assert kinds == {"forwarded", "standby", "pump"}, kinds
    assert all(s == side for _, _, s in seen), [(k, n) for k, n, s in seen if s != side]
    assert any(n == "forward-retry" for k, n, _ in seen if k == "pump")
    assert devices == {"cuda:0"}
    host = _cluster("cpu", tmp_path / "cpu")
    try:
        want = _drive(host, batches, spill)
    finally:
        host.close()
    assert got == want
