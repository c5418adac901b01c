"""Twins of the REST cases over the mesh product engine
(``tests/test_distributed.py:217``, ``tests/test_archive_migration.py:166``):
an instance of each package over its ``DistributedEngine`` (the port's
shards on the CPU), held equal as in ``tests/torch_servers.py``."""

import json

import pytest

from tests.torch_servers import compare_mesh, mesh_engine, pin_servers, run_twin


@pytest.fixture
def twin(monkeypatch):
    pin_servers(monkeypatch)
    return run_twin


# ---------------------------------------------- tests/test_distributed.py:217
def test_instance_and_rest_over_distributed_engine(twin):
    """The product surface serves from the sharded mesh state when the
    instance is built over a DistributedEngine."""
    def make(P):
        I = P.mod("instance.instance")
        deng = mesh_engine(P)
        inst = I.SiteWhereTpuInstance(I.InstanceConfig(), engine=deng)
        assert inst.engine is deng
        return inst

    def case(S):
        call = S.call
        status, _ = call("POST", "/api/devices", {"token": "dr-1"})
        assert status == 201
        status, _ = call("POST", "/api/devices/dr-1/events", {
            "deviceToken": "dr-1", "type": "DeviceMeasurement",
            "request": {"name": "temp", "value": 21.0}})
        assert status == 201
        S.inst.engine.flush()
        _, body = call("GET", "/api/devices/dr-1/state")
        assert body["measurements"]["temp"]["value"] == 21.0
        _, body = call("GET", "/api/events")
        assert body["total"] >= 1
        status, _ = call("PUT", "/api/devices/dr-1",
                         {"deviceType": "default", "metadata": {"k": "v"}})
        assert status == 200
        status, _ = call("POST", "/api/assignments",
                         {"deviceToken": "dr-1", "token": "dr-1:x"})
        assert status == 201
        status, body = call("PUT", "/api/assignments/dr-1:x", {"assetToken": "pump"})
        assert status == 200 and body["assetToken"] == "pump"
        status, _ = call("POST", "/api/assignments/dr-1:x/missing")
        assert status == 200
        status, _ = call("DELETE", "/api/assignments/dr-1:x")
        assert status == 200
        evs = S.inst.engine.make_feed_consumer("rest-ev").poll()
        assert evs
        status, body = call("GET", f"/api/events/id/{evs[0].event_id}")
        assert status == 200 and body["deviceToken"] == "dr-1"

    twin(case, make=make, engines=compare_mesh)


# ------------------------------------ tests/test_archive_migration.py:166
def test_migrated_history_serves_over_rest(twin, tmp_path):
    """Pre-reshard history through the REST event listings after a 4 -> 2
    topology change of a mesh engine with an archive."""
    from tests.torch_spmd import FixedEpoch, TorchFixedEpoch

    def make(P):
        d = tmp_path / P.root
        dist = P.mod("parallel.distributed")
        kw = dict(n_shards=4, device_capacity_per_shard=64,
                  token_capacity_per_shard=256, assignment_capacity_per_shard=256,
                  store_capacity_per_shard=64, channels=4,
                  batch_capacity_per_shard=16, archive_dir=str(d / "arch"),
                  archive_segment_rows=8)
        eng = dist.DistributedEngine(dist.DistributedConfig(
            **kw, **({"device": "cpu"} if P.port else {})))
        eng.epoch = TorchFixedEpoch() if P.port else FixedEpoch()
        base = int(eng.epoch.base_unix_s * 1000)
        for r in range(40):
            eng.ingest_json_batch([json.dumps({
                "deviceToken": f"mig-{k}", "type": "DeviceMeasurements",
                "request": {"measurements": {"m": float(r)},
                            "eventDate": base + r * 100 + k}}).encode()
                for k in range(24)])
            if r % 8 == 7:
                eng.flush_async()
        eng.flush()
        eng.save(d / "snap")
        P.mod("parallel.reshard").reshard_snapshot(
            d / "snap", d / "resnap", 2, archive_dir=d / "arch",
            archive_dst=d / "arch2")
        if P.port:
            eng2 = dist.restore_distributed(d / "resnap", device="cpu",
                                            epoch_cls=TorchFixedEpoch)
        else:
            eng2 = dist.restore_distributed(d / "resnap")
            eng2.epoch = FixedEpoch()
        I = P.mod("instance.instance")
        return I.SiteWhereTpuInstance(I.InstanceConfig(), engine=eng2)

    def case(S):
        status, listing = S.call("GET", "/api/events",
                                 params={"sinceMs": "0", "untilMs": "399",
                                         "pageSize": "200"})
        assert status == 200 and listing["total"] == 24 * 4
        status, dev = S.call("GET", "/api/devices/mig-7/events",
                             params={"pageSize": "100"})
        assert status == 200 and dev["total"] == 40

    twin(case, make=make, engines=None)
