"""Twins of ``tests/test_cluster.py``: the port's cluster facade
(``sitewhere_tpu_torch/parallel/cluster.py``) over two CPU ranks on real
loopback RPC, held to the JAX package's.

An answer twin (``torch_cluster.twin``) runs the JAX test and its port
copy with every rank's clock pinned, and holds the two logs of facade
answers equal — query pages, device states, by-id lookups from either
rank, searches. A property twin runs the port copy of the JAX test
(``torch_cluster.port_tests``): the same assertions on the port. Three
cases are written out here: the REST one (the port's gateway is not an
aiohttp app), the surrogate-pair one (the port's native decoder builds
or raises; it has no ``native_available``) and the spawned two-process
job (slow; its ranks on the CPU).
"""

import asyncio
import base64
import json

import pytest

from tests.torch_cluster import fresh_dirs, port_tests, twin

PORT = port_tests("test_cluster")


def test_owner_rank_is_stable_and_covers_ranks():
    """``test_cluster.py:163``, the port copy."""
    PORT.test_owner_rank_is_stable_and_covers_ranks()


def test_cluster_mixed_ingest_queries_agree(tmp_path, monkeypatch):
    """``test_cluster.py:171``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_cluster_mixed_ingest_queries_agree", fresh_dirs(tmp_path))


def test_cluster_admin_routing(tmp_path, monkeypatch):
    """``test_cluster.py:225``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_cluster_admin_routing", fresh_dirs(tmp_path))


def test_cluster_event_ids_route_from_any_rank(tmp_path, monkeypatch):
    """``test_cluster.py:251``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_cluster_event_ids_route_from_any_rank", fresh_dirs(tmp_path))


def test_cluster_rank_crash_recovery(tmp_path, monkeypatch):
    """``test_cluster.py:334``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_cluster_rank_crash_recovery",
         fresh_dirs(tmp_path), masked=('receivedDateMs',))


def test_cluster_rpc_rejects_unauthenticated(tmp_path):
    """``test_cluster.py:399``, the port copy."""
    PORT.test_cluster_rpc_rejects_unauthenticated(tmp_path)


def test_cluster_presence_sweep_spans_ranks(tmp_path, monkeypatch):
    """``test_cluster.py:428``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_cluster_presence_sweep_spans_ranks", fresh_dirs(tmp_path))


def test_instance_rpc_serves_cluster_from_any_rank(tmp_path, monkeypatch):
    """``test_cluster.py:450``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_instance_rpc_serves_cluster_from_any_rank", fresh_dirs(tmp_path))


def test_protocol_edge_routes_across_cluster(tmp_path, monkeypatch):
    """``test_cluster.py:502``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_protocol_edge_routes_across_cluster", fresh_dirs(tmp_path))


def _rest_bodies(root: str, module, tmp_path) -> list:
    """``test_cluster.py:273``'s drive against package ``root``: two
    ranks, one instance each behind its own gateway (``start_server``),
    mixed-owner ingest at both ranks, then the listing, every device's
    state and the device list read from each rank over HTTP. Asserts the
    JAX test's properties; returns the bodies."""
    import importlib

    import aiohttp

    inst_mod = importlib.import_module(f"{root}.instance.instance")
    engine_mod = importlib.import_module(f"{root}.engine")
    rest = importlib.import_module(f"{root}.web.rest")
    clusters, host, _ = module._mk_cluster(tmp_path)
    c0, c1 = clusters
    loop = asyncio.new_event_loop()
    try:
        insts = [inst_mod.SiteWhereTpuInstance(
            inst_mod.InstanceConfig(engine=engine_mod.EngineConfig()), engine=c)
            for c in clusters]
        toks = module.tokens_owned_by(0, 2, prefix="rr") + \
            module.tokens_owned_by(1, 2, prefix="rr")
        c0.ingest_json_batch(
            [module.meas(t, "temp", float(i), 500 + i) for i, t in enumerate(toks)])
        c1.ingest_json_batch(
            [module.meas(t, "hum", 50.0 + i, 800 + i) for i, t in enumerate(toks)])
        c0.flush()

        async def drive():
            out = []
            basic = base64.b64encode(b"admin:password").decode()
            async with aiohttp.ClientSession() as cl:
                for inst in insts:
                    server = await rest.start_server(inst)
                    base = f"http://127.0.0.1:{server.port}"
                    try:
                        async with cl.get(f"{base}/api/authapi/jwt", headers={
                                "Authorization": f"Basic {basic}"}) as r:
                            h = {"Authorization":
                                 f"Bearer {(await r.json())['token']}"}
                        async with cl.get(f"{base}/api/events?pageSize=50",
                                          headers=h) as r:
                            assert r.status == 200, await r.text()
                            listing = await r.json()
                        states = {}
                        for t in toks:
                            async with cl.get(f"{base}/api/devices/{t}/state",
                                              headers=h) as r:
                                assert r.status == 200, await r.text()
                                states[t] = await r.json()
                        async with cl.get(f"{base}/api/devices?pageSize=50",
                                          headers=h) as r:
                            assert r.status == 200
                            devices = await r.json()
                        out.append((listing, states, devices))
                    finally:
                        await server.cleanup()
            return out

        (l0, s0, d0), (l1, s1, d1) = loop.run_until_complete(drive())
        assert l0["total"] == l1["total"] == 8
        assert [(e["deviceToken"], e["eventDateMs"]) for e in l0["events"]] == \
               [(e["deviceToken"], e["eventDateMs"]) for e in l1["events"]]
        assert s0 == s1
        assert {d["token"] for d in d0["results"]} == \
               {d["token"] for d in d1["results"]} == set(toks)
        return [l0, s0, d0, l1, s1, d1]
    finally:
        loop.close()
        module._close(clusters, host)


def test_cluster_rest_identical_from_any_rank(tmp_path, monkeypatch):
    """``test_cluster.py:273``: both ranks' gateways answer alike, in
    each package, and the port's bodies equal the JAX package's (every
    clock pinned)."""
    import tests.test_cluster as jax_tests
    from tests.torch_cluster import pinned_clusters
    from tests.torch_parity import plain

    pinned_clusters(monkeypatch, "sitewhere_tpu", "sitewhere_tpu_torch")
    dirs = fresh_dirs(tmp_path)
    jax_bodies = _rest_bodies("sitewhere_tpu", jax_tests, dirs())
    port_bodies = _rest_bodies("sitewhere_tpu_torch", PORT, dirs())
    assert plain(port_bodies) == plain(jax_bodies)


@pytest.mark.slow
def test_two_process_product_job_with_crash_recovery():
    """``test_cluster.py:538``, the port copy."""
    PORT.test_two_process_product_job_with_crash_recovery()


def test_cluster_event_search_spans_ranks(tmp_path, monkeypatch):
    """``test_cluster.py:560``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_cluster_event_search_spans_ranks", fresh_dirs(tmp_path))


def test_merged_devices_by_id_get_is_explicitly_local(tmp_path):
    """``test_cluster.py:619``, the port copy."""
    PORT.test_merged_devices_by_id_get_is_explicitly_local(tmp_path)


def test_cluster_search_fails_loudly_without_peer_index(tmp_path, monkeypatch):
    """``test_cluster.py:650``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_cluster_search_fails_loudly_without_peer_index", fresh_dirs(tmp_path))


def test_cluster_command_invocation_delivers_at_owning_rank(tmp_path, monkeypatch):
    """``test_cluster.py:667``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_cluster_command_invocation_delivers_at_owning_rank",
         fresh_dirs(tmp_path))


def test_cluster_feed_commit_does_not_skip_events(tmp_path, monkeypatch):
    """``test_cluster.py:769``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_cluster_feed_commit_does_not_skip_events", fresh_dirs(tmp_path))


def test_batch_command_operation_spans_cluster(tmp_path, monkeypatch):
    """``test_cluster.py:799``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_batch_command_operation_spans_cluster", fresh_dirs(tmp_path))


def test_invocation_readable_from_third_rank(tmp_path):
    """``test_cluster.py:842``, the port copy."""
    PORT.test_invocation_readable_from_third_rank(tmp_path)


def test_cluster_rank_count_reshard_by_wal_replay(tmp_path, monkeypatch):
    """``test_cluster.py:884``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_cluster_rank_count_reshard_by_wal_replay", fresh_dirs(tmp_path))


def test_envelope_round_trip():
    """``test_cluster.py:966``, the port copy."""
    PORT.test_envelope_round_trip()


def test_native_route_matches_python_partitioner():
    """``test_cluster.py:1003``, the port copy."""
    PORT.test_native_route_matches_python_partitioner()


def test_surrogate_pair_tokens_intern_identically():
    """``test_cluster.py:1093``: escaped and raw UTF-8 forms of a
    non-BMP token decode to the same device through the port's native
    decoder (which builds or raises: the port has no quiet fallback to
    ask ``native_available`` about)."""
    from sitewhere_tpu_torch.engine import Engine, EngineConfig

    eng = Engine(EngineConfig(
        device_capacity=32, token_capacity=64, assignment_capacity=64,
        store_capacity=512, batch_capacity=8, channels=4), device="cpu")
    assert eng._native_decoder is not None
    tok = "\U0001F600-dev"
    base = int(eng.epoch.base_unix_s * 1000)
    raw = json.dumps({"deviceToken": tok, "type": "DeviceMeasurement",
                      "request": {"name": "t", "value": 1.0,
                                  "eventDate": base + 1}},
                     ensure_ascii=False).encode()
    esc = json.dumps({"deviceToken": tok, "type": "DeviceMeasurement",
                      "request": {"name": "t", "value": 2.0,
                                  "eventDate": base + 2}},
                     ensure_ascii=True).encode()
    assert b"\\ud83d" in esc and b"\\u" not in raw
    res = eng.ingest_json_batch([raw, esc])
    assert res["failed"] == 0
    eng.flush()
    assert eng.metrics()["registered"] == 1   # one device, not two
    st = eng.get_device_state(tok)
    assert st["measurements"]["t"]["value"] == 2.0


def test_binary_token_of():
    """``test_cluster.py:1126``, the port copy."""
    PORT.test_binary_token_of()


def test_cluster_engine_refuses_epoch_base_drift(tmp_path):
    """``test_cluster.py:1139``, the port copy."""
    PORT.test_cluster_engine_refuses_epoch_base_drift(tmp_path)


def test_sync_peer_mints_fresh_token_per_connection(tmp_path):
    """``test_cluster.py:1158``, the port copy."""
    PORT.test_sync_peer_mints_fresh_token_per_connection(tmp_path)


def test_sync_peer_timeout_reconnects_cleanly(tmp_path):
    """``test_cluster.py:1194``, the port copy."""
    PORT.test_sync_peer_timeout_reconnects_cleanly(tmp_path)


def test_run_rank_validates_wiring_before_serving(tmp_path):
    """``test_cluster.py:1234``, the port copy."""
    PORT.test_run_rank_validates_wiring_before_serving(tmp_path)


def test_run_rank_boots_a_serving_rank_from_one_config(tmp_path, monkeypatch):
    """``test_cluster.py:1251``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_run_rank_boots_a_serving_rank_from_one_config", fresh_dirs(tmp_path))


def test_assignments_administered_from_any_rank(tmp_path):
    """``test_cluster.py:1298``, the port copy."""
    PORT.test_assignments_administered_from_any_rank(tmp_path)


def test_cluster_metrics_carry_rank_attribution(tmp_path):
    """``test_cluster.py:1333``, the port copy."""
    PORT.test_cluster_metrics_carry_rank_attribution(tmp_path)


def test_run_rank_three_rank_cluster_from_one_config(tmp_path, monkeypatch):
    """``test_cluster.py:1371``, answer twin."""
    twin(monkeypatch, "test_cluster",
         "test_run_rank_three_rank_cluster_from_one_config", fresh_dirs(tmp_path))
