"""The port's engine read side against the JAX Engine on one payload stream.

The same JSON payloads (measurements, locations inside and outside the
geofence zones and without coordinates, alerts with alternate ids, state
changes, command responses, a registration envelope, undecodable payloads,
two tenants) go through ``sitewhere_tpu.engine.Engine(use_native=False)``
and ``sitewhere_tpu_torch.engine.Engine(device="cpu")`` via
``ingest_json_batch``, with the clock pinned, zones and a rule set
installed, and a ring small enough to wrap. Every read surface must return
equal dicts: ``query_events`` (every filter), ``get_event`` (live, evicted,
unwritten and tenant-scoped ids), ``search_device_states``,
``tenant_metrics``, ``tenant_pipeline_counters``, ``presence_sweep``,
``metrics()`` and ``RulesManager.poll``/``read_rollup``; the state stays
byte-identical. A JAX state with zones and rules installed converts and
steps identically on both sides.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sitewhere_tpu_torch.engine as engine_mod
from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.core.events import EventBatch as JaxBatch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.pipeline import PipelineConfig as JaxConfig
from sitewhere_tpu.pipeline import make_pipeline_step
from sitewhere_tpu.rules import RulesManager as JaxRulesManager
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.core.events import EpochBase, EventBatch
from sitewhere_tpu_torch.core.types import EventType
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.pipeline import PipelineConfig, pipeline_step
from sitewhere_tpu_torch.rules import RulesManager
from tests.torch_parity import assert_tree_equal, strip_trace

BASE_S = 1_700_000_000.0
BASE_MS = int(BASE_S * 1000)
SIZES = dict(device_capacity=32, token_capacity=64, assignment_capacity=64,
             store_capacity=256, batch_capacity=32, channels=4,
             presence_missing_s=2.0, rule_groups=16, rollup_buckets=4)
ZONES = [[(0.0, 0.0), (0.0, 10.0), (10.0, 10.0), (10.0, 0.0)],
         [(20.0, 20.0), (30.0, 25.0), (20.0, 30.0)]]
RULES = {"rules": [
    {"name": "hot", "kind": "threshold", "channel": "temp", "op": ">",
     "value": 90.0, "cooldownMs": 1000},
    {"name": "quiet", "kind": "absence", "channel": "temp",
     "deadlineMs": 4000, "scope": "tenant"}],
    "rollups": [{"name": "t-2s", "channel": "temp", "windowMs": 2000}]}


class Clock:
    """A pinned engine clock the test moves by hand."""

    now = 6_000


def _pin(cls):
    class Pinned(cls):
        def now_ms(self):
            return Clock.now

    return Pinned(BASE_S)


def payloads(k: int, rng) -> list[bytes]:
    """Batch k of the stream: 40 events over 9 devices, halves only."""
    out = []
    for i in range(40):
        d = int(rng.integers(0, 9))
        ts = BASE_MS + 100 * k + i // 4          # 4-way event-time ties
        kind = rng.random()
        if kind < 0.55:
            req = {"type": "DeviceMeasurements", "request": {
                "measurements": {"temp": float(rng.integers(0, 200)) * 0.5,
                                 "rpm": float(rng.integers(0, 9))},
                "eventDate": ts}}
        elif kind < 0.7:
            lat, lon = (rng.uniform(0.5, 9.5, 2) if rng.random() < 0.5
                        else rng.uniform(11, 19, 2))
            req = {"type": "DeviceLocation", "request": {
                "latitude": float(lat), "longitude": float(lon),
                "elevation": 3.0, "eventDate": ts}}
        elif kind < 0.75:
            req = {"type": "DeviceLocation", "request": {
                "latitude": None, "longitude": None, "eventDate": ts}}
        elif kind < 0.85:
            req = {"type": "DeviceAlert", "request": {
                "type": f"a{i % 3}", "level": "Warning", "eventDate": ts,
                "alternateId": f"alt-{k}-{i % 5}"}}
        elif kind < 0.92:
            req = {"type": "DeviceStateChange", "request": {
                "attribute": "mode", "type": "eco", "eventDate": ts}}
        else:
            req = {"type": "Acknowledge", "request": {
                "originatingEventId": f"cmd-{i}", "eventDate": ts}}
        out.append(json.dumps({"deviceToken": f"d-{d}", **req}).encode())
    out += [b"{not json", b"[1, 2]", json.dumps({"type": "DeviceAlert"}).encode(),
            b"\xff\xfe"]
    if k == 1:
        out.append(json.dumps({"deviceToken": "gw-1", "type": "RegisterDevice",
                               "request": {"deviceTypeToken": "gateway",
                                           "areaToken": "north"}}).encode())
    return out


def _engines():
    jeng = JaxEngine(JaxEngineConfig(**SIZES, use_native=False))
    teng = Engine(EngineConfig(**SIZES, use_native=False), device="cpu")
    jeng.epoch, teng.epoch = _pin(JaxEpoch), _pin(EpochBase)
    for eng in (jeng, teng):
        eng.register_device("d-0", tenant="t2", area="north", customer="acme",
                            device_type="thermostat")
    return jeng, teng


@pytest.fixture(scope="module")
def driven():
    jeng, teng = _engines()
    jmgr, tmgr = JaxRulesManager(jeng), RulesManager(teng)
    jmgr.load(RULES, precompile=False)
    tmgr.load(RULES)
    summaries, alerts = [], []
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    for k in range(12):
        if k == 3:
            jeng.set_geofence_zones(ZONES)
            teng.set_geofence_zones(ZONES)
        tenant = "t2" if k % 4 == 3 else "default"
        j = strip_trace(jeng.ingest_json_batch(payloads(k, rng_j), tenant))
        t = strip_trace(teng.ingest_json_batch(payloads(k, rng_t), tenant))
        summaries.append((j, t))
        if k % 5 == 4:
            alerts.append((jmgr.poll(flush=True), tmgr.poll(flush=True)))
    jeng.flush()
    teng.flush()
    return jeng, teng, jmgr, tmgr, summaries, alerts


def test_ingest_json_batch_summaries_match(driven):
    _, _, _, _, summaries, _ = driven
    for ref, got in summaries:
        assert got == ref
    assert all(got["failed"] == 4 for _, got in summaries)


def test_state_matches_jax_byte_for_byte(driven):
    jeng, teng, *_ = driven
    assert_tree_equal(jax.device_get(jeng.state), teng.state)
    assert teng.metrics() == jeng.metrics()
    assert int(teng.state.store.epoch[0]) > 0          # the ring wrapped


QUERIES = [
    {}, dict(limit=7), dict(limit=1000), dict(device_token="d-3"),
    dict(device_token="d-0", limit=3), dict(etype=EventType.ALERT),
    dict(etype=EventType.LOCATION, limit=20), dict(tenant="t2"),
    dict(tenant="default", since_ms=500, until_ms=900),
    dict(since_ms=1100), dict(until_ms=300), dict(assignment_id=2),
    dict(aux0=0, etype=EventType.ALERT), dict(area="north"),
    dict(customer="acme"), dict(alternate_id="alt-7-2"),
    dict(etype=EventType.STATE_CHANGE), dict(etype=EventType.COMMAND_RESPONSE),
    dict(device_token="ghost"), dict(tenant="ghost"), dict(area="ghost"),
    dict(customer="ghost"), dict(alternate_id="ghost"),
]


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_query_events_matches_jax(driven, q):
    jeng, teng, *_ = driven
    kw = QUERIES[q]
    assert teng.query_events(**kw) == jeng.query_events(**kw)


def test_get_event_matches_jax(driven):
    jeng, teng, *_ = driven
    head = int(teng.state.store.epoch[0]) * 256 + int(teng.state.store.cursor[0])
    ids = [-1, 0, 5, head - 257, head - 256, head - 255, head - 1, head,
           head + 10] + list(range(head - 40, head - 1, 3))
    for i in ids:
        for tenant in (None, "t2", "default", "ghost"):
            assert teng.get_event(i, tenant) == jeng.get_event(i, tenant), (i, tenant)
    assert teng.get_event(head - 1) is not None
    assert teng.get_event(head - 257) is None            # evicted


@pytest.mark.parametrize("kw", [
    {}, dict(limit=3), dict(last_interaction_before_ms=800),
    dict(presence="present"), dict(device_tokens=["d-1", "d-4", "nobody"]),
    dict(area="north"), dict(area="ghost"), dict(device_type="default"),
    dict(device_type="thermostat"), dict(device_type="ghost")])
def test_search_device_states_matches_jax(driven, kw):
    jeng, teng, *_ = driven
    assert teng.search_device_states(**kw) == jeng.search_device_states(**kw)


def test_tenant_reads_match_jax(driven):
    jeng, teng, *_ = driven
    assert teng.tenant_metrics() == jeng.tenant_metrics()
    got = teng.tenant_pipeline_counters()
    assert got == jeng.tenant_pipeline_counters()
    assert sum(v["geofence_hit"] for v in got.values()) > 0
    assert sum(v["dedup_dropped"] for v in got.values()) > 0


def test_rules_surface_matches_jax(driven):
    jeng, teng, jmgr, tmgr, _, alerts = driven
    for ref, got in alerts:
        assert got == ref
    assert any(got for _, got in alerts)
    assert teng.rule_counters() == jeng.rule_counters()
    for group in (None, "d-0", "d-3", "ghost"):
        assert tmgr.read_rollup("t-2s", group=group) == \
            jmgr.read_rollup("t-2s", group=group)
    status, ref = tmgr.status(), jmgr.status()
    assert status == {k: ref[k] for k in status}
    # the emitted alerts landed in the ring and are queryable by their key
    key = next(a for _, got in alerts for a in got)["alternateId"]
    assert teng.query_events(alternate_id=key)["total"] == 1


def test_presence_sweep_matches_jax():
    """Runs last in its own engines: the sweep moves the pinned clock."""
    jeng, teng = _engines()
    rng_j, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    for k in range(3):
        Clock.now = 1_000 * k
        jeng.ingest_json_batch(payloads(k, rng_j))
        teng.ingest_json_batch(payloads(k, rng_t))
    try:
        for now in (2_000, 3_500, 3_500, 60_000):
            Clock.now = now
            got, ref = teng.presence_sweep(), jeng.presence_sweep()
            assert got == ref, now
        assert_tree_equal(jax.device_get(jeng.state), teng.state)
        assert teng.search_device_states(presence="missing") == \
            jeng.search_device_states(presence="missing")
        assert teng.search_device_states(presence="missing")
    finally:
        Clock.now = 6_000


def test_query_runs_off_the_engine_lock_and_coalesces(driven, monkeypatch):
    """The readback and every row's formatting run with the engine lock
    released; queries arriving while a round waits ride the next round,
    and every caller still gets its own page."""
    _, teng, *_ = driven
    batcher = teng._query_batcher
    gate = threading.Event()
    orig_fetch = engine_mod._fetch_query_result

    def slow_fetch(res):
        assert not teng.lock._is_owned()
        gate.wait(5.0)
        return orig_fetch(res)

    orig_fmt = Engine._format_event

    def fmt(self, *a, **k):
        assert not self.lock._is_owned()
        return orig_fmt(self, *a, **k)

    serial = {i: teng.query_events(device_token=f"d-{i}", limit=50)
              for i in range(8)}
    monkeypatch.setattr(engine_mod, "_fetch_query_result", slow_fetch)
    monkeypatch.setattr(Engine, "_format_event", fmt)
    programs0 = batcher.programs
    results, errors = {}, []

    def query(i):
        try:
            results[i] = teng.query_events(device_token=f"d-{i}", limit=50)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=query, args=(i,)) for i in range(8)]
    threads[0].start()
    while batcher.programs == programs0 and threads[0].is_alive():
        threading.Event().wait(0.005)
    for t in threads[1:]:
        t.start()
    for _ in range(500):
        if len(batcher._queue) == 7:
            break
        threading.Event().wait(0.01)
    gate.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert not errors, errors
    assert results == serial
    assert batcher.max_coalesced >= 2
    assert batcher.programs - programs0 < 8
    monkeypatch.undo()
    with teng.lock:               # re-entrant caller: its own round
        assert teng.query_events(device_token="d-1", limit=50) == serial[1]


def test_converted_state_with_zones_and_rules_steps_like_jax(driven):
    jeng, *_ = driven
    jstate = jax.device_get(jeng.state)
    assert jstate.zones is not None and jstate.rules is not None
    tstate = convert.pipeline_state_from_numpy(jstate, "cpu")
    assert_tree_equal(jstate, tstate)
    rng = np.random.default_rng(2)
    b, c = SIZES["batch_capacity"], SIZES["channels"]
    cols = dict(valid=np.arange(b) < 27,
                etype=rng.choice([0, 1], b).astype(np.int32),
                token_id=rng.integers(0, 12, b).astype(np.int32),
                tenant_id=np.zeros(b, np.int32),
                ts_ms=(2_000 + rng.integers(0, 50, b)).astype(np.int32),
                received_ms=np.full(b, 9, np.int32),
                values=(rng.integers(-40, 200, (b, c)) * 0.5).astype(np.float32),
                vmask=rng.random((b, c)) < 0.9,
                aux=np.full((b, 2), -1, np.int32),
                seq=np.arange(b, dtype=np.int32))
    # the JAX step donates its input: step a copy, never the engine's state
    jcopy = jax.tree_util.tree_map(jnp.array, jstate)
    jnext, _ = make_pipeline_step(JaxConfig())(jcopy, JaxBatch(**cols))
    tnext, _ = pipeline_step(tstate, EventBatch.from_numpy("cpu", **cols),
                             PipelineConfig())
    assert_tree_equal(jax.device_get(jnext), tnext, "after one step")


def test_ruleless_and_zoneless_state_reads_none():
    _, teng = _engines()
    assert teng.poll_rule_fires() is None
    assert teng.rule_counters() == {}
    teng.set_geofence_zones([])
    assert teng.state.zones is None and teng.state.rules is None
