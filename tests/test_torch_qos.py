"""QoS and fair tenancy of the port (``utils/qos.py``, the engine's
weighted-fair turn, admission edge and ``fair_tenancy`` batch formation)
held to the JAX package on the CPU.

Byte for byte with the JAX package: admission decisions and bucket fills
under a ``ManualClock``, the weighted-fair picker's rounds and the gate's
virtual clocks on one thread, the open-loop generator's sheds, and engine
state and host mirrors with ``fair_tenancy`` (and with ``qos``) on over a
multi-tenant stream. Port-only behaviour pinned: the gate's 2:1 ratio
under saturation, an arena stall translated into a typed shed, and a
shed-then-recover cycle that leaves the WAL holding exactly the admitted
payloads.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.loadgen import OpenLoopSpec as JaxSpec
from sitewhere_tpu.loadgen import TenantLoad as JaxTenantLoad
from sitewhere_tpu.loadgen import build_open_loop_schedule as jax_schedule
from sitewhere_tpu.loadgen import run_open_loop as jax_run_open_loop
from sitewhere_tpu.utils import qos as jqos
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.arena import ArenaStallError
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.loadgen import (OpenLoopSpec, TenantLoad,
                                         build_open_loop_schedule,
                                         run_open_loop)
from sitewhere_tpu_torch.utils import qos as tqos
from sitewhere_tpu_torch.utils.ingestlog import IngestLog
from tests.test_torch_ingest_wire import (SIZES, assert_engines_equal,
                                          engines, json_stream, pinned)
from tests.torch_parity import strip_trace


def _meas(token, seq=0, value=1.0):
    return json.dumps({
        "deviceToken": token, "type": "DeviceMeasurement",
        "request": {"name": "t", "value": value,
                    "metadata": {"seq": str(seq)}}}).encode()


# ------------------------------------------------------------- admission
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_decisions_and_fills_match_jax_under_manual_clock(seed):
    """The same seeded trace of admits, clock advances and backlog
    readings gives the same decisions, retry hints, bucket fills and
    counters in both packages (the saturation valve included)."""
    rng = np.random.default_rng(seed)
    backlog = [0]
    ctrls = []
    for mod in (jqos, tqos):
        clk = mod.ManualClock(10.0)
        ctrls.append((clk, mod.AdmissionController(
            tenant_rates={"a": 50.0, "b": 7.5}, default_rate_eps=20.0,
            burst_s=0.5, shed_threshold=100, backlog_fn=lambda: backlog[0],
            clock=clk, min_retry_after_s=0.01)))
    for _ in range(400):
        tenant = ["a", "b", "c", "d"][int(rng.integers(0, 4))]
        n = int(rng.integers(1, 40))
        dt = float(rng.exponential(0.05))
        backlog[0] = int(rng.integers(0, 130))
        stall = rng.random() < 0.05
        out = []
        for clk, ctrl in ctrls:
            clk.advance(dt)
            d = ctrl.admit(tenant, n)
            if stall:
                ctrl.note_shed(tenant, 3, "stall")
            out.append((dataclasses.asdict(d), ctrl.bucket_fill()))
        assert out[0] == out[1]
    (_, j), (_, t) = ctrls
    for attr in ("offered_events", "admitted_events", "shed_events",
                 "shed_noted", "shed_by_tenant"):
        assert getattr(t, attr) == getattr(j, attr), attr


def test_admit_or_raise_sheds_typed_and_passes_without_qos():
    eng = Engine(EngineConfig(**SIZES), device="cpu")
    tqos.admit_or_raise(eng, "x", 10**6)          # QoS off: no-op
    clk = tqos.ManualClock()
    eng.qos = tqos.AdmissionController(tenant_rates={"x": 1.0}, burst_s=1.0,
                                       clock=clk)
    tqos.admit_or_raise(eng, "x", 1)
    with pytest.raises(tqos.ShedError) as ei:
        tqos.admit_or_raise(eng, "x", 1)
    assert ei.value.reason == "rate" and ei.value.retry_after_s > 0


# ------------------------------------------------------ weighted-fair rules
@pytest.mark.parametrize("seed", [3, 4])
def test_wfq_picker_rounds_match_jax(seed):
    """Round membership of the query batcher's picker: the same queues
    give the same rounds and virtual clocks."""
    rng = np.random.default_rng(seed)
    weights = {"q-a": 3.0, "q-b": 1.0, "q-c": 0.5}
    pj, pt = jqos.WFQPicker(weights), tqos.WFQPicker(weights)
    queue = []
    for i in range(300):
        queue.append({"tenant": ["q-a", "q-b", "q-c", None][int(rng.integers(0, 4))],
                      "i": i})
        if rng.random() < 0.2:
            k = int(rng.integers(1, 9))
            sj, rj = pj.pick(queue, k)
            st, rt = pt.pick(queue, k)
            assert [e["i"] for e in st] == [e["i"] for e in sj]
            assert [e["i"] for e in rt] == [e["i"] for e in rj]
            assert pt.vtimes() == pj.vtimes()
            queue = rt


def test_wfq_gate_turns_match_jax_on_one_thread():
    """Uncontended turns in the same order charge the same virtual times
    and grants in both packages; a late tenant starts at the gate's clock."""
    weights = {"g-a": 2.0, "g-b": 1.0}
    gj, gt = jqos.WeightedFairGate(weights), tqos.WeightedFairGate(weights)
    for tenant, cost in [("g-a", 16), ("g-b", 3), ("g-a", 1), ("g-c", 40),
                         ("g-b", 128), ("g-a", 0), (None, 5)]:
        for g in (gj, gt):
            with g.turn(tenant, cost):
                pass
        assert gt.vtimes() == gj.vtimes() and gt.grants == gj.grants


def test_wfq_gate_two_to_one_ratio_under_saturation():
    """2:1 weights give ~2:1 granted turns while both tenants always have a
    waiter. The run stops on a grant count, not on time; each turn sleeps
    a little so the GIL rotates and both tenants really contend."""
    gate = tqos.WeightedFairGate({"wfq-a": 2.0, "wfq-b": 1.0})
    stop = threading.Event()
    start = threading.Barrier(4)

    def hammer(tenant):
        start.wait()
        while not stop.is_set():
            with gate.turn(tenant, 1):
                time.sleep(0.0005)
                if gate.grants.get("wfq-a", 0) + gate.grants.get("wfq-b", 0) >= 600:
                    stop.set()

    ts = [threading.Thread(target=hammer, args=(t,))
          for t in ("wfq-a", "wfq-b") for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    ratio = gate.grants["wfq-a"] / max(1, gate.grants["wfq-b"])
    assert 1.5 <= ratio <= 2.7, gate.grants


# ------------------------------------------------------------ the engine
def _multi_tenant_frames(k, rng):
    """Frame k of a three-tenant stream: the base stream's batch under a
    tenant that rotates, one tenant's frames bursting to three times the
    others'."""
    tenant = ["t-a", "t-b", "t-c"][k % 3]
    pay = json_stream(k, rng)
    if tenant == "t-c":
        pay = pay + json_stream(k + 100, rng) + json_stream(k + 200, rng)
    return tenant, pay


@pytest.mark.parametrize("path", ["native", "python", "scan3"])
def test_fair_tenancy_state_matches_jax(path):
    """With ``fair_tenancy`` on, a multi-tenant stream forms its batches
    across the tenants' queues identically: state, host mirrors, every
    summary and the per-tenant backlog are byte for byte the JAX
    engine's, on the native copy path, the Python path and a scan chunk;
    per-request ``process()`` rows go through the same queues."""
    kw = {"native": {}, "python": dict(use_native=False),
          "scan3": dict(scan_chunk=3)}[path]
    jeng, teng = engines(fair_tenancy=True, **kw)
    rng = np.random.default_rng(5)
    for k in range(6):
        tenant, pay = _multi_tenant_frames(k, rng)
        ref = strip_trace(jeng.ingest_json_batch(pay, tenant))
        assert strip_trace(teng.ingest_json_batch(pay, tenant)) == ref
        for t in ("t-a", "t-b", "t-c"):
            assert teng.fair_backlog(t) == jeng.fair_backlog(t)
        assert teng.staged_count == jeng.staged_count
        if k == 3:
            jreq = dict(type=RequestType.DEVICE_MEASUREMENT, device_token="p-1",
                        tenant="t-b", measurements={"m3": 2.5})
            from sitewhere_tpu.ingest.requests import DecodedRequest as JaxRequest
            from sitewhere_tpu.ingest.requests import RequestType as JaxType

            jeng.process(JaxRequest(**{**jreq, "type": JaxType.DEVICE_MEASUREMENT}))
            teng.process(DecodedRequest(**jreq))
    ref = jeng.flush()
    assert teng.flush() == ref
    assert_engines_equal(jeng, teng)
    assert teng._fair_queued == jeng._fair_queued == 0


def test_qos_engine_matches_jax_with_admission_at_the_edge():
    """A QoS engine fed through the admission edge under a manual clock
    admits the same frames as the JAX engine and ends in the same state;
    the device-side accepted counters equal the admitted counts."""
    jeng, teng = engines(qos=True, tenant_weights={"t-a": 2.0, "t-b": 1.0})
    for eng, mod in ((jeng, jqos), (teng, tqos)):
        eng.qos = mod.AdmissionController(
            tenant_rates={"t-b": 300.0}, burst_s=0.5, clock=mod.ManualClock())
    rng = np.random.default_rng(8)
    admitted = {}
    for k in range(8):
        tenant = "t-a" if k % 2 else "t-b"
        pay = [_meas(f"{tenant}-{i % 16}", seq=i) for i in range(60 + 10 * k)]
        dt = float(rng.exponential(0.1))
        verdicts = []
        for eng, mod in ((jeng, jqos), (teng, tqos)):
            eng.qos._clock.advance(dt)
            try:
                mod.admit_or_raise(eng, tenant, len(pay))
                verdicts.append(True)
            except mod.ShedError:
                verdicts.append(False)
        assert verdicts[0] == verdicts[1]
        if verdicts[0]:
            admitted[tenant] = admitted.get(tenant, 0) + len(pay)
            ref = strip_trace(jeng.ingest_json_batch(pay, tenant))
            assert strip_trace(teng.ingest_json_batch(pay, tenant)) == ref
    jeng.flush()
    teng.flush()
    assert_engines_equal(jeng, teng)
    counters = teng.tenant_pipeline_counters()
    assert {t: counters[t]["accepted"] for t in admitted} == admitted
    assert teng.qos.shed_by_tenant == jeng.qos.shed_by_tenant
    assert not any(k.startswith("qos") or "shed" in k for k in teng.metrics())


def test_open_loop_sheds_match_jax_under_a_stopped_clock():
    """The open-loop generator is the admission edge: with the controllers'
    clock stopped, the victim/abuser schedule of the bench's fairness
    leg sheds the same frames in both packages, and every admitted event
    is accepted exactly once on the device."""
    def spec(mod_tl, mod_spec):
        return mod_spec(tenants=(
            mod_tl("victim", 1200.0, n_devices=32),
            mod_tl("abuser", 2500.0, n_devices=32, abusive_mult=2.0,
                   abusive_period_s=0.4, abusive_burst_s=0.2)),
            duration_s=0.3, frame_size=128, seed=90)

    results = []
    cfg = dict(SIZES, device_capacity=256, token_capacity=1024,
               assignment_capacity=1024, store_capacity=1 << 13, qos=True,
               fair_tenancy=True, tenant_weights={"victim": 2.0, "abuser": 1.0})
    jeng = JaxEngine(JaxEngineConfig(**cfg))
    teng = Engine(EngineConfig(**cfg), device="cpu")
    jeng.epoch, teng.epoch = pinned(JaxEpoch), pinned(EpochBase)
    for eng, mod, sched, run in (
            (jeng, jqos, jax_schedule(spec(JaxTenantLoad, JaxSpec)), jax_run_open_loop),
            (teng, tqos, build_open_loop_schedule(spec(TenantLoad, OpenLoopSpec)),
             run_open_loop)):
        eng.qos = mod.AdmissionController(tenant_rates={"abuser": 250.0},
                                          burst_s=0.25, clock=mod.ManualClock())
        res = run(eng, sched, checkpoint_frames=4, time_scale=0.0)
        results.append({t: (v["events"], v["shed"]) for t, v in res.per_tenant.items()})
    assert results[0] == results[1]
    admitted = {t: ev for t, (ev, _) in results[1].items()}
    assert results[1]["abuser"][1] > 0
    counters = teng.tenant_pipeline_counters()
    assert {t: counters.get(t, {}).get("accepted", 0) for t in admitted} == admitted
    assert_engines_equal(jeng, teng)


def test_engine_translates_arena_stall_to_shed():
    """A wedged arena recycle surfaces as a typed shed, reason "stall",
    counted against the tenant."""
    eng = Engine(EngineConfig(**SIZES, qos=True, arena_stall_timeout_s=0.02,
                              tenant_rates={}), device="cpu")

    def stall(timeout_s=None):
        raise ArenaStallError("wedged")

    eng._arena_pool.acquire = stall
    with pytest.raises(tqos.ShedError) as ei:
        eng.ingest_json_batch([_meas("st-0")], "st-t")
    assert ei.value.reason == "stall" and ei.value.retry_after_s >= 1.0
    assert eng._stall_sheds == 1
    assert eng.qos.shed_by_tenant.get("st-t") == 1
    assert eng.qos.shed_noted == 1


def test_shed_then_recover_no_loss_no_dup_wal_clean(tmp_path):
    """A shed/retry cycle loses nothing and applies nothing twice: the
    edge retries shed frames until admitted; the accepted count then
    equals the admitted count and the WAL holds exactly one record per
    admitted payload (a shed frame never reaches it)."""
    clk = tqos.ManualClock()
    eng = Engine(EngineConfig(**{**SIZES, "store_capacity": 8192}, qos=True,
                              wal_dir=str(tmp_path / "wal")), device="cpu")
    eng.qos = tqos.AdmissionController(tenant_rates={"sr-t": 40.0},
                                       burst_s=1.0, clock=clk)
    backlog = [[_meas(f"sr-{j}", seq=i * 10 + j) for j in range(10)]
               for i in range(12)]
    admitted = sheds = rounds = 0
    while backlog and rounds < 100:
        rounds += 1
        still = []
        for f in backlog:
            if eng.qos.admit("sr-t", len(f)).admitted:
                eng.ingest_json_batch(f, "sr-t")
                admitted += len(f)
            else:
                sheds += 1
                still.append(f)
        backlog = still
        clk.advance(0.5)
    assert not backlog and sheds > 0
    eng.flush()
    assert admitted == 120
    counters = eng.tenant_pipeline_counters()["sr-t"]
    assert counters["accepted"] == 120
    assert counters.get("dedup_dropped", 0) == 0
    eng.wal.sync()
    assert len(list(IngestLog(tmp_path / "wal", readonly=True).replay())) == 120
    eng.wal.close()


def test_query_rounds_follow_weights_under_overflow():
    """With QoS on, an overflowing query round takes its members in the
    tenants' weighted order, as the JAX batcher does."""
    jeng, teng = engines(qos=True, query_coalesce=2,
                         tenant_weights={"t-a": 2.0, "t-b": 1.0})
    assert teng._query_batcher._wfq is not None
    entries = [{"tenant": t, "i": i} for i, t in enumerate(
        ["t-b", "t-b", "t-b", "t-a", "t-a", "t-b"])]
    sj, _ = jeng._query_batcher._wfq.pick(list(entries), 2)
    st, _ = teng._query_batcher._wfq.pick(list(entries), 2)
    assert [e["i"] for e in st] == [e["i"] for e in sj]


def test_facade_single_event_edge_admits_per_owner(tmp_path):
    """``tests/test_qos.py:649`` on the port (its copy through
    ``tests.torch_cluster.port_tests``): the REST edge over a forwarding
    cluster facade charges only locally owned devices to the local bucket,
    forwards remote-owned ones untouched, and answers a local shed 429."""
    from tests.torch_cluster import port_tests

    port_tests("test_qos").test_facade_single_event_edge_admits_per_owner(tmp_path)
