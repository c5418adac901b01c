"""``loadgen.py``'s wire legs (``WireLoadSpec``, ``build_wire_schedule``,
``wire_schedule_fingerprint``, ``run_wire_load``) and its ``main``, held to
the JAX package's ``sitewhere_tpu/loadgen.py``.

The schedule is a pure function of the spec: the port's frames and
fingerprint equal JAX's for several seeds and specs. ``run_wire_load``
holds 8 MQTT connections of 4 QoS 1 frames each against a port edge on a
CPU engine; every frame is acked, and a JAX engine fed the same batch-ingest
calls (the edge's arrival windows, recorded) ends equal byte for byte. The
port's client against the JAX package's edge acks every frame too.
"""

import asyncio
import json

import jax
import pytest
import torch

from sitewhere_tpu import loadgen as jlg
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.ingest import wire_edge as jwe
from sitewhere_tpu_torch import loadgen as tlg
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest import wire_edge as twe
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation
from tests.test_wire_edge import FixedEpoch
from tests.torch_parity import assert_tree_equal
from tests.torch_spmd import TorchFixedEpoch

CFG = dict(device_capacity=64, token_capacity=128, assignment_capacity=128,
           store_capacity=2048, batch_capacity=32, channels=4)
SPECS = [dict(n_connections=8, frames_per_conn=4, n_devices=20, seed=0),
         dict(n_connections=3, frames_per_conn=7, n_devices=5, seed=7, tenant="t2"),
         dict(n_connections=1, frames_per_conn=1, n_devices=1, seed=123,
              device_prefix="dp"),
         dict(n_connections=50, frames_per_conn=12, n_devices=200, seed=7)]


@pytest.mark.parametrize("spec", SPECS)
def test_wire_schedule_and_fingerprint_match_jax(spec):
    t = tlg.build_wire_schedule(tlg.WireLoadSpec(**spec))
    j = jlg.build_wire_schedule(jlg.WireLoadSpec(**spec))
    assert t == j
    assert tlg.wire_schedule_fingerprint(t) == jlg.wire_schedule_fingerprint(j)
    assert [len(f) for f in t] == [spec["frames_per_conn"]] * spec["n_connections"]
    assert dataclass_fields(tlg.WireLoadSpec) == dataclass_fields(jlg.WireLoadSpec)
    assert dataclass_fields(tlg.WireLoadResult) == dataclass_fields(jlg.WireLoadResult)


def dataclass_fields(cls) -> list:
    import dataclasses

    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_wire_fingerprint_moves_with_one_frame():
    sched = tlg.build_wire_schedule(tlg.WireLoadSpec(**SPECS[0]))
    fp = tlg.wire_schedule_fingerprint(sched)
    sched[3][2] = sched[3][2] + b" "
    assert tlg.wire_schedule_fingerprint(sched) != fp
    assert tlg.wire_schedule_fingerprint(sched) == jlg.wire_schedule_fingerprint(sched)


class Recorder:
    """The port engine's batch-ingest calls, recorded as the edge makes
    them (the flusher's arrival windows)."""

    def __init__(self, eng):
        self.calls = []
        self._call = eng.ingest_json_batch
        eng.ingest_json_batch = self.ingest

    def ingest(self, payloads, tenant="default", **kw):
        self.calls.append((list(payloads), tenant))
        return self._call(payloads, tenant=tenant, **kw)


def test_run_wire_load_acks_every_frame_and_matches_jax():
    spec = tlg.WireLoadSpec(n_connections=8, frames_per_conn=4, n_devices=20, seed=3)
    sched = tlg.build_wire_schedule(spec)
    eng = Engine(EngineConfig(**CFG), device="cpu")
    eng.epoch = TorchFixedEpoch()
    rec = Recorder(eng)

    async def run():
        edge = twe.WireEdge(eng, twe.WireEdgeConfig(mqtt_port=0, flush_rows=8,
                                                     flush_interval_s=0.005))
        await edge.start()
        try:
            res = await asyncio.wait_for(
                tlg.run_wire_load("127.0.0.1", edge.mqtt_port, sched, connect_wave=3), 60)
            eng.flush()
            violations = check_conservation(build_ledger(eng))
            snap = edge.snapshot()
        finally:
            await edge.stop()
        return res, violations, snap

    res, violations, snap = asyncio.run(run())
    assert (res.connections, res.events, res.acked) == (8, 32, 32)
    assert res.events_per_s > 0 and res.publish_p50_ms is not None
    assert violations == []
    assert snap["frames_received"] == snap["rows_submitted"] == 32
    assert snap["connections_opened"] == snap["connections_peak"] == 8
    assert sorted(p for c in rec.calls for p in c[0]) == sorted(p for f in sched for p in f)
    # a JAX engine fed the same windows ends equal to the port's
    jeng = JaxEngine(JaxEngineConfig(**CFG))
    jeng.epoch = FixedEpoch()
    for payloads, tenant in rec.calls:
        jeng.ingest_json_batch(payloads, tenant=tenant)
    jeng.flush()
    eng.flush()
    assert eng.metrics() == jeng.metrics()
    assert_tree_equal(jax.device_get(jeng.state), eng.state)
    assert eng.metrics()["persisted"] == 32


def test_port_client_against_the_jax_edge():
    """The port's ``run_wire_load`` against the JAX package's edge, and
    JAX's against the port's: the same acks and counts either way."""
    sched = tlg.build_wire_schedule(tlg.WireLoadSpec(n_connections=4, frames_per_conn=3,
                                                     n_devices=6, seed=9))
    results = {}
    for name, we, make, client in (
            ("port_on_jax", jwe, lambda: JaxEngine(JaxEngineConfig(**CFG)), tlg.run_wire_load),
            ("jax_on_port", twe, lambda: Engine(EngineConfig(**CFG), device="cpu"),
             jlg.run_wire_load)):
        eng = make()

        async def run():
            edge = we.WireEdge(eng, we.WireEdgeConfig(mqtt_port=0, flush_rows=4,
                                                      flush_interval_s=0.005))
            await edge.start()
            try:
                res = await asyncio.wait_for(client("127.0.0.1", edge.mqtt_port, sched), 60)
            finally:
                await edge.stop()
            return res

        res = asyncio.run(run())
        eng.flush()
        results[name] = (res.connections, res.events, res.acked, eng.metrics()["persisted"])
    assert results["port_on_jax"] == results["jax_on_port"] == (4, 12, 12, 12)


def test_main_defaults_to_the_card_and_runs_on_the_cpu_when_asked(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tlg.main(["--batches", "1", "--batch-size", "8", "--devices", "4"])
    tlg.main(["--batches", "2", "--batch-size", "64", "--devices", "50", "--device", "cpu"])
    closed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert closed["events_sent"] == 128 and closed["events_failed"] == 0
    tlg.main(["--open-loop", "--rate", "400", "--duration", "0.25", "--batch-size", "64",
              "--devices", "50", "--shards", "2", "--device", "cpu", "--seed", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spec = jlg.OpenLoopSpec(tenants=(jlg.TenantLoad("default", 400.0, n_devices=50,
                                                    query_every=8, mutate_every=16),),
                            duration_s=0.25, frame_size=64, seed=4)
    assert out["schedule_fingerprint"] == jlg.schedule_fingerprint(
        jlg.build_open_loop_schedule(spec))
    assert out["events"] > 0 and out["ingest_path"]["staged_copy_rows"] == 0
