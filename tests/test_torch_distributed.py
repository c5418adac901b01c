"""The port's mesh product engine (``parallel/distributed.DistributedEngine``)
held to the JAX package's on the CPU.

Each runnable case of ``tests/test_distributed.py`` has a twin here: the same
seeded payloads go to a JAX and a port ``DistributedEngine`` at
``small_config()`` (4 shards; the JAX engine over the 8 virtual CPU devices,
the port's shards all on the CPU), both clocks pinned, and the twin compares
the stacked state byte for byte, the summaries, query pages, device-state
dicts, mirrors, metrics, dead letters and presence results, besides the JAX
test's own assertions. The REST and command-delivery cases wait for the
instance and command ports. Then the outbound feed, the event-id layout
(Hypothesis), the staging-clock pin, the stacked staging buffer, the
native-build rule, the tie order of a merged page and the compile posture.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import sitewhere_tpu.parallel.distributed as jdist
import sitewhere_tpu_torch.parallel.distributed as tdist
from sitewhere_tpu.ingest.decoders import encode_binary_request as jax_encode_binary
from sitewhere_tpu.ingest.requests import DecodedRequest as JaxRequest
from sitewhere_tpu.ingest.requests import RequestType as JaxRequestType
from sitewhere_tpu_torch.core.types import EventType
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from tests.test_distributed import meas_payload
from tests.torch_parity import BATCH_FIELDS, assert_leaf_equal
from tests.torch_spmd import FixedEpoch, TorchFixedEpoch, assert_state_equal


def small_config(**kw) -> dict:
    base = dict(n_shards=4, device_capacity_per_shard=64,
                token_capacity_per_shard=128, assignment_capacity_per_shard=128,
                store_capacity_per_shard=512, channels=4,
                batch_capacity_per_shard=64, use_native=True)
    base.update(kw)
    return base


def engines(**kw):
    """A JAX and a port DistributedEngine of one config, clocks pinned."""
    j = jdist.DistributedEngine(jdist.DistributedConfig(**small_config(**kw)))
    t = tdist.DistributedEngine(tdist.DistributedConfig(**small_config(**kw),
                                                        device="cpu"))
    j.epoch, t.epoch = FixedEpoch(), TorchFixedEpoch()
    return j, t


@pytest.fixture
def pair():
    return engines()


def both(j, t, fn):
    """``fn`` on both engines; the results (trace ids dropped) must be
    equal. Returns the port's."""
    a, b = fn(j), fn(t)
    if isinstance(a, dict):
        a, b = ({k: v for k, v in x.items() if k != "trace_id"} for x in (a, b))
    assert a == b
    return b


def mirrors(eng) -> dict:
    return {"devices": {k: dataclasses.asdict(v) for k, v in eng.devices.items()},
            "token_device": dict(eng.token_device),
            "assignments": {k: dataclasses.asdict(v)
                            for k, v in eng.assignments.items()},
            "assignment_tokens": dict(eng.assignment_tokens),
            "device_slots": {k: list(v) for k, v in eng.device_slots.items()},
            "next_device": [int(x) for x in eng._next_device],
            "next_assignment": [int(x) for x in eng._next_assignment],
            "dead_letters": list(eng.dead_letters),
            "tokens": [eng.tokens.token(i) for i in range(len(eng.tokens))]}


def assert_engines_equal(j, t) -> None:
    """Stacked state byte for byte, mirrors, counters and tenant grids."""
    assert_state_equal(j, t)
    assert mirrors(j) == mirrors(t)
    assert j.metrics() == t.metrics()
    assert j.shard_metrics() == t.shard_metrics()
    assert j.tenant_metrics() == t.tenant_metrics()
    assert j.tenant_pipeline_counters() == t.tenant_pipeline_counters()


def set_now(ms: int, *engs) -> None:
    for e in engs:
        e.epoch._now = ms


# ------------------------------------------------ twins of test_distributed.py

def test_json_ingest_routes_across_shards(pair):
    j, t = pair
    payloads = [meas_payload(f"dev-{i}", 20.0 + i) for i in range(32)]
    summary = both(j, t, lambda e: e.ingest_json_batch(payloads))
    assert summary["decoded"] == 32 and summary["failed"] == 0
    out = both(j, t, lambda e: e.flush())
    assert out["registered"] == 32
    m = t.metrics()
    assert m["found"] == 32 and m["persisted"] == 32
    per_shard = [s["devices"] for s in t.shard_metrics()]
    assert all(n > 0 for n in per_shard) and sum(per_shard) == 32
    assert_engines_equal(j, t)


def test_device_state_readback(pair):
    j, t = pair
    both(j, t, lambda e: e.ingest_json_batch([meas_payload("dev-a", 21.5)]))
    both(j, t, lambda e: e.flush())
    st = both(j, t, lambda e: e.get_device_state("dev-a"))
    assert st["presence"] == "PRESENT"
    assert st["measurements"]["temp.celsius"]["value"] == pytest.approx(21.5)
    assert st["event_counts"]["MEASUREMENT"] == 1
    infos = [dataclasses.asdict(e.get_device("dev-a")) for e in (j, t)]
    assert infos[0] == infos[1] and infos[1]["auto_registered"]
    assert_engines_equal(j, t)


def test_query_events_global_merge(pair):
    j, t = pair
    payloads = [meas_payload(f"dev-{i}", float(i), ts_ms=i * 1000) for i in range(16)]
    both(j, t, lambda e: e.ingest_json_batch(payloads))
    both(j, t, lambda e: e.flush())
    res = both(j, t, lambda e: e.query_events(limit=8))
    assert res["total"] == 16 and len(res["events"]) == 8
    ts = [e["eventDateMs"] for e in res["events"]]
    assert ts == sorted(ts, reverse=True)
    assert res["events"][0]["deviceToken"] == "dev-15"
    one = both(j, t, lambda e: e.query_events(device_token="dev-3"))
    assert one["total"] == 1
    assert one["events"][0]["measurements"]["temp.celsius"] == pytest.approx(3.0)
    for kw in (dict(since_ms=4000, until_ms=9000), dict(tenant="default", limit=3),
               dict(etype=EventType.MEASUREMENT, limit=100),
               dict(tenant="nobody"), dict(device_token="nobody")):
        both(j, t, lambda e, kw=kw: e.query_events(**kw))
    assert_engines_equal(j, t)


def _process(e, **kw):
    """``process()`` of one request built in the engine's own package."""
    if isinstance(e, jdist.DistributedEngine):
        kw["type"] = JaxRequestType[kw["type"].name]
        return e.process(JaxRequest(**kw))
    return e.process(DecodedRequest(**kw))


def test_admin_register_and_slow_path(pair):
    j, t = pair
    gdid = both(j, t, lambda e: e.register_device("adm-1", tenant="acme",
                                                  area="plant"))
    assert t.get_device("adm-1").tenant == "acme"
    assert both(j, t, lambda e: e.register_device("adm-1")) == gdid
    for e in (j, t):
        _process(e, type=RequestType.DEVICE_MEASUREMENT, device_token="adm-1",
                 tenant="acme", measurements={"pressure": 3.5})
    out = both(j, t, lambda e: e.flush())
    assert out["found"] == 1 and out["registered"] == 0
    st = both(j, t, lambda e: e.get_device_state("adm-1"))
    assert st["measurements"]["pressure"]["value"] == pytest.approx(3.5)
    assert_engines_equal(j, t)


def test_assignment_lifecycle(pair):
    j, t = pair
    both(j, t, lambda e: e.register_device("asg-1", tenant="t1"))
    a = [dataclasses.asdict(e.create_assignment("asg-1", token="asg-1:extra",
                                                asset="pump")) for e in (j, t)]
    assert a[0] == a[1]
    assert t.get_assignment("asg-1:extra").asset == "pump"
    assert len(t.list_assignments(device_token="asg-1")) == 2
    rel = [dataclasses.asdict(e.release_assignment("asg-1:extra")) for e in (j, t)]
    assert rel[0] == rel[1] and rel[1]["status"] == "RELEASED"
    for e in (j, t):
        _process(e, type=RequestType.DEVICE_MEASUREMENT, device_token="asg-1",
                 tenant="t1", measurements={"x": 1.0})
    out = both(j, t, lambda e: e.flush())
    assert out["persisted"] == 1
    assert ([dataclasses.asdict(x) for x in j.list_assignments()]
            == [dataclasses.asdict(x) for x in t.list_assignments()])
    assert_engines_equal(j, t)


def test_map_device_cross_and_same_shard(pair):
    j, t = pair
    toks = [f"map-{i}" for i in range(t.n_shards + 1)]
    for tok in toks:
        both(j, t, lambda e, tok=tok: e.register_device(tok))
    infos = [e.map_device(toks[t.n_shards], toks[0]) for e in (j, t)]   # same shard
    assert infos[1].metadata["parentToken"] == toks[0]
    infos = [e.map_device(toks[1], toks[0]) for e in (j, t)]            # cross shard
    assert infos[1].metadata["parentToken"] == toks[0]
    for e in (j, t):
        with pytest.raises(ValueError):
            e.map_device(toks[0], toks[0])
    assert_engines_equal(j, t)


def test_dead_letters_without_auto_register():
    j, t = engines(auto_register=False)
    both(j, t, lambda e: e.ingest_json_batch([meas_payload("ghost-1", 1.0)]))
    out = both(j, t, lambda e: e.flush())
    assert out["missed"] == 1 and out["registered"] == 0
    assert "ghost-1" in t.dead_letters
    assert_engines_equal(j, t)


def test_presence_sweep_marks_missing():
    j, t = engines(presence_missing_s=0.0)
    both(j, t, lambda e: e.ingest_json_batch(
        [meas_payload(f"pres-{i}", 1.0) for i in range(8)]))
    both(j, t, lambda e: e.flush())
    set_now(500_010, j, t)   # the pinned clocks move past the events
    tokens = both(j, t, lambda e: e.presence_sweep())
    assert set(tokens) == {f"pres-{i}" for i in range(8)}
    states = both(j, t, lambda e: e.search_device_states(presence="MISSING"))
    assert len(states) == 8
    both(j, t, lambda e: e.search_device_states(last_interaction_before_ms=600_000,
                                                limit=3))
    assert both(j, t, lambda e: e.presence_sweep()) == []
    assert_engines_equal(j, t)


def test_fair_tenancy_quota():
    j, t = engines(fair_tenancy=True, batch_capacity_per_shard=32)
    for i in range(64):
        both(j, t, lambda e, i=i: e.ingest_json_batch([meas_payload(f"a-{i}", 1.0)],
                                                      tenant="bulk"))
    for i in range(4):
        both(j, t, lambda e, i=i: e.ingest_json_batch([meas_payload(f"b-{i}", 2.0)],
                                                      tenant="tiny"))
    both(j, t, lambda e: e.flush())
    assert t.fair_backlog("bulk") == 0 and t.fair_backlog("tiny") == 0
    assert t.metrics()["persisted"] == 68
    both(j, t, lambda e: e.get_device_state("b-0"))
    assert_engines_equal(j, t)


def test_binary_wire_ingest(pair):
    j, t = pair
    payloads = [jax_encode_binary(JaxRequest(
        type=JaxRequestType.DEVICE_MEASUREMENT, device_token=f"bin-{i}",
        tenant="default", measurements={"v": float(i)})) for i in range(8)]
    summary = both(j, t, lambda e: e.ingest_binary_batch(payloads))
    assert summary["decoded"] == 8
    both(j, t, lambda e: e.flush())
    assert t.metrics()["persisted"] == 8
    st = both(j, t, lambda e: e.get_device_state("bin-3"))
    assert st["measurements"]["v"]["value"] == 3.0
    assert_engines_equal(j, t)


def test_multi_batch_steady_state(pair):
    j, t = pair
    rng = np.random.default_rng(1)
    total = 0
    for _ in range(6):
        n = int(rng.integers(10, 40))
        payloads = [meas_payload(f"ss-{rng.integers(0, 50)}", 1.0) for _ in range(n)]
        both(j, t, lambda e: e.ingest_json_batch(payloads))
        for e in (j, t):
            e.flush_async()
        total += n
    both(j, t, lambda e: e.flush())
    m = t.metrics()
    assert m["persisted"] == total and m["processed"] == total
    assert_engines_equal(j, t)


def test_query_events_by_assignment_scopes_to_one_assignment(pair):
    j, t = pair
    for i in range(2 * t.n_shards):
        both(j, t, lambda e, i=i: e.register_device(f"aq-{i}", tenant="t1"))
    both(j, t, lambda e: e.flush())
    asgs = [t.list_assignments(device_token=f"aq-{i}")[0]
            for i in range(2 * t.n_shards)]
    by_shard: dict[int, list] = {}
    for a in asgs:
        by_shard.setdefault(t._split_gdid(a.id)[0], []).append(a)
    shard, (a0, a1, *_) = next((s, v) for s, v in by_shard.items() if len(v) >= 2)
    payloads = ([meas_payload(a0.device_token, 1.0 + i, ts_ms=1000 + i) for i in range(3)]
                + [meas_payload(a1.device_token, 2.0 + i, ts_ms=2000 + i)
                   for i in range(2)])
    both(j, t, lambda e: e.ingest_json_batch(payloads, tenant="t1"))
    both(j, t, lambda e: e.flush())
    r0 = both(j, t, lambda e: e.query_events(assignment_id=a0.id))
    r1 = both(j, t, lambda e: e.query_events(assignment_id=a1.id))
    assert r0["total"] == 3 and r1["total"] == 2
    assert all(e["assignmentId"] == a0.id for e in r0["events"])
    assert all(e["deviceToken"] == a0.device_token for e in r0["events"])
    both_f = both(j, t, lambda e: e.query_events(device_token=a0.device_token,
                                                 assignment_id=a0.id))
    assert both_f["total"] == 3
    other = next(a for a in asgs if t._split_gdid(a.id)[0] != shard)
    assert both(j, t, lambda e: e.query_events(device_token=a0.device_token,
                                               assignment_id=other.id))["total"] == 0
    assert_engines_equal(j, t)


def test_distributed_assignment_admin_parity(pair):
    j, t = pair
    both(j, t, lambda e: e.register_device("adm-1", tenant="t1"))
    for e in (j, t):
        e.create_assignment("adm-1", token="adm-1:x", asset="pump")
    upd = [dataclasses.asdict(e.update_assignment("adm-1:x", asset="valve",
                                                  metadata={"k": "v"}))
           for e in (j, t)]
    assert upd[0] == upd[1]
    assert upd[1]["asset"] == "valve" and upd[1]["metadata"] == {"k": "v"}
    miss = [e.mark_assignment_missing("adm-1:x").status for e in (j, t)]
    assert miss == ["MISSING", "MISSING"]
    both(j, t, lambda e: e.ingest_json_batch([meas_payload("adm-1", 7.0)], tenant="t1"))
    out = both(j, t, lambda e: e.flush())
    assert out["persisted"] == 2
    dev = [dataclasses.asdict(e.update_device("adm-1", area="hall", customer="c1",
                                              metadata={"m": 1})) for e in (j, t)]
    assert dev[0] == dev[1]
    assert both(j, t, lambda e: e.delete_assignment("adm-1:x")) is True
    assert t.get_assignment("adm-1:x") is None
    assert both(j, t, lambda e: e.delete_assignment("adm-1:x")) is False
    both(j, t, lambda e: e.query_events(area="hall"))
    assert both(j, t, lambda e: e.delete_device("adm-1")) is True
    assert_engines_equal(j, t)


def test_distributed_get_event_roundtrip(pair):
    j, t = pair
    both(j, t, lambda e: e.ingest_json_batch([meas_payload(f"ge-{i}", 10.0 + i)
                                              for i in range(6)]))
    both(j, t, lambda e: e.flush())
    evs = tdist.DistributedFeedConsumer(t, "ge-grp").poll()
    assert len(evs) == 6
    for src in evs:
        ev = both(j, t, lambda e, i=src.event_id: e.get_event(i))
        assert ev["deviceToken"] == src.device_token
        assert ev["eventDateMs"] == src.ts_ms
        assert ev["measurements"] == src.measurements
        both(j, t, lambda e, i=src.event_id: e.get_event(i, tenant="default"))
        assert both(j, t, lambda e, i=src.event_id: e.get_event(i, tenant="x")) is None
    assert both(j, t, lambda e: e.get_event(-1)) is None
    assert both(j, t, lambda e: e.get_event(10**9)) is None


# ------------------------------------------------------------------ the feed

def _feed_events(evs) -> list[tuple]:
    return [(e.event_id, e.etype, e.device_token, e.device_id, e.assignment_id,
             e.tenant, e.ts_ms, e.received_ms, e.measurements, e.values, e.aux0,
             e.aux1) for e in evs]


@pytest.mark.parametrize("archive", [False, True])
def test_feed_consumer_matches_jax(tmp_path, archive):
    """Both feeds deliver the same events under the same ids, a commit
    empties them, and after a ring wrap a lagging consumer replays the
    archive (``lag_lost`` 0) or counts the overwritten rows."""
    kw = dict(store_capacity_per_shard=64, batch_capacity_per_shard=16)
    j, t = engines(**kw, **({"archive_dir": str(tmp_path / "jarch"),
                              "archive_segment_rows": 8} if archive else {}))
    if archive:
        t.config.archive_dir = str(tmp_path / "tarch")
        t2 = tdist.DistributedEngine(dataclasses.replace(t.config))
        t2.epoch = TorchFixedEpoch()
        t = t2
    fj, ft = jdist.DistributedFeedConsumer(j, "g"), tdist.DistributedFeedConsumer(t, "g")
    first = [meas_payload(f"fd-{i}", float(i), ts_ms=i) for i in range(12)]
    both(j, t, lambda e: e.ingest_json_batch(first))
    both(j, t, lambda e: e.flush())
    a, b = fj.poll(), ft.poll()
    assert _feed_events(a) == _feed_events(b) and len(b) == 12
    assert len({e.event_id for e in b}) == 12
    assert _feed_events(fj.poll()) == _feed_events(ft.poll())   # no commit: again
    fj.commit(a)
    ft.commit(b)
    assert fj.poll() == [] and ft.poll() == []
    lag_j = jdist.DistributedFeedConsumer(j, "lag", max_batch=4096)
    lag_t = tdist.DistributedFeedConsumer(t, "lag", max_batch=4096)
    for k in range(8):   # 8 x 64 events over 16 tokens: every ring wraps
        wire = [meas_payload(f"w-{i % 16}", float(i), ts_ms=100 + 64 * k + i)
                for i in range(64)]
        both(j, t, lambda e: e.ingest_json_batch(wire))
        both(j, t, lambda e: e.flush())
    for c in (fj, ft, lag_j, lag_t):
        c.poll()
    got_j, got_t = lag_j.poll(), lag_t.poll()
    assert _feed_events(got_j) == _feed_events(got_t)
    assert lag_j.lag_lost == lag_t.lag_lost
    if archive:
        assert lag_t.lag_lost == 0 and len(got_t) == 12 + 8 * 64
    else:
        assert lag_t.lag_lost > 0 and len(got_t) + lag_t.lag_lost == 12 + 8 * 64
    lag_j.commit(got_j)
    lag_t.commit(got_t)
    np.testing.assert_array_equal(lag_j.offsets, lag_t.offsets)
    late_j = jdist.DistributedFeedConsumer(j, "late", start_from_latest=True)
    late_t = tdist.DistributedFeedConsumer(t, "late", start_from_latest=True)
    np.testing.assert_array_equal(late_j.offsets, late_t.offsets)
    assert late_t.poll() == []
    if archive:
        for kw in (dict(limit=600), dict(device_token="w-3", limit=50),
                   dict(since_ms=150, until_ms=300, limit=40)):
            both(j, t, lambda e, kw=kw: e.query_events(**kw))
        for ev in got_t[:: 37]:
            both(j, t, lambda e, i=ev.event_id: e.get_event(i))
        assert j.metrics() == t.metrics()
    assert_state_equal(j, t)


@settings(max_examples=200, deadline=None)
@given(pos=st.integers(0, 2**40), shards=st.integers(1, 64), arenas=st.integers(1, 16),
       data=st.data())
def test_event_id_layout_round_trips_and_matches_jax(pos, shards, arenas, data):
    shard = data.draw(st.integers(0, shards - 1))
    arena = data.draw(st.integers(0, arenas - 1))
    eid = tdist.encode_event_id(pos, shard, arena, shards, arenas)
    assert eid == jdist.encode_event_id(pos, shard, arena, shards, arenas)
    assert tdist.split_event_id(eid, shards, arenas) == (pos, shard, arena)
    assert jdist.split_event_id(eid, shards, arenas) == (pos, shard, arena)


# --------------------------------------------------------- staging-clock pin

def test_staging_clock_pin_stages_identical_rows():
    """A pinned ``process()`` call stamps the pin (not the clock) on both
    packages' rows; a nested call (the per-request path of a batch, run
    under ``_wal_suppress``) keeps the outer pin, and the top-level call
    clears it."""
    j, t = engines()
    set_now(777_000, j, t)
    for e in (j, t):
        with e.lock:
            e._now_override = 123_456
            _process(e, type=RequestType.DEVICE_MEASUREMENT, device_token="pin-1",
                     measurements={"t": 1.0})
        assert e._now_override is None and e._staging_now() == 777_000
        with e.lock:
            e._now_override = 223_344
            with e._wal_suppress():
                _process(e, type=RequestType.DEVICE_MEASUREMENT,
                         device_token="pin-2", measurements={"t": 2.0})
            assert e._now_override == 223_344 and e._staging_now() == 223_344
            e._clear_now_pin()
        assert e._now_override is None
        e.ingest_json_batch([meas_payload("pin-3", 3.0)])   # the clock, no pin
    both(j, t, lambda e: e.flush())
    pages = both(j, t, lambda e: e.query_events(limit=10))
    assert sorted(ev["receivedDateMs"] for ev in pages["events"]) == [
        123_456, 223_344, 777_000]
    assert_engines_equal(j, t)


def test_staging_clock_pin_on_the_single_card_batch_paths():
    """The single-card engine's batch paths (arena, copy, Python) stamp
    the pin and clear it when the call ends."""
    from sitewhere_tpu_torch.engine import Engine, EngineConfig

    sizes = dict(device_capacity=64, token_capacity=128, assignment_capacity=128,
                 store_capacity=256, batch_capacity=32, channels=4)
    for kw in (dict(), dict(ingest_arenas=-1), dict(use_native=False)):
        eng = Engine(EngineConfig(**sizes, **kw), device="cpu")
        eng.epoch = TorchFixedEpoch(9_000)
        with eng.lock:
            eng._now_override = 4_321
            eng.ingest_json_batch([meas_payload(f"p-{i}", 1.0) for i in range(5)])
            assert eng._now_override is None
        eng.ingest_json_batch([meas_payload("p-9", 1.0)])
        eng.flush()
        got = sorted(ev["receivedDateMs"] for ev in eng.query_events()["events"])
        assert got == [4_321] * 5 + [9_000], kw


# ------------------------------------------------------------- host staging

def test_stacked_buffer_emit_matches_jax():
    """Rows appended to both packages' stacked staging buffers emit the
    same ``[S, B, ...]`` columns, and the buffer starts over empty."""
    jb, tb = jdist._StackedBuffer(3, 8, 4), tdist._StackedBuffer(3, 8, 4)
    rng = np.random.default_rng(4)
    for _ in range(14):
        s = int(rng.integers(0, 3))
        vals = rng.random(4).astype(np.float32)
        mask = rng.random(4) < 0.5
        row = (s, int(rng.integers(0, 6)), int(rng.integers(0, 40)), 1,
               int(rng.integers(0, 99)), 5, vals if mask.any() else None,
               mask if mask.any() else None, int(rng.integers(-1, 3)), -1)
        assert jb.append_row(*row) == tb.append_row(*row)
    assert jb.total() == tb.total() and jb.room(0) == tb.room(0)
    a, b = jb.emit(), tb.emit()
    for f in BATCH_FIELDS:
        assert_leaf_equal(np.asarray(getattr(a, f)), getattr(b, f), f)
    assert tb.total() == 0 and (tb.token_id == -1).all()


# ------------------------------------------------------------ pinned rules

def test_native_build_failure_raises_with_no_fallback(monkeypatch):
    """The port's rule: a failed native build raises (the JAX engine falls
    back to the Python interner); ``use_native=False`` is the Python
    path."""
    from sitewhere_tpu_torch.native import binding

    def broken(*a, **kw):
        raise OSError("no native library")

    monkeypatch.setattr(binding, "NativeInterner", broken)
    with pytest.raises(OSError):
        tdist.DistributedEngine(tdist.DistributedConfig(**small_config(),
                                                        device="cpu"))
    eng = tdist.DistributedEngine(tdist.DistributedConfig(
        **small_config(use_native=False), device="cpu"))
    assert eng._native_decoder is None


def test_merged_page_tie_order_across_shards(pair):
    """Rows of equal timestamps on every shard merge shard-major, then in
    page order, as the JAX engine's stable argsort does."""
    j, t = pair
    payloads = [meas_payload(f"tie-{i}", float(i), ts_ms=5_000 + (i % 3))
                for i in range(40)]
    both(j, t, lambda e: e.ingest_json_batch(payloads))
    both(j, t, lambda e: e.flush())
    page = both(j, t, lambda e: e.query_events(limit=25))
    shards = [ev["shard"] for ev in page["events"] if ev["eventDateMs"] == 5_002]
    assert shards == sorted(shards) and len(set(shards)) == t.n_shards


def test_no_admin_compile_family_in_eager_torch():
    """The pinned divergence: the JAX module watches its stacked admin
    updaters as the ``distributed.admin`` devicewatch family; the port's
    updaters are the single-card functions applied to one shard's state,
    eager torch compiles nothing, and the compile posture stays empty."""
    from sitewhere_tpu_torch import engine as teng
    from sitewhere_tpu_torch.utils import devicewatch as tdw

    assert jdist._admin_create_device_stacked.scope.family == "distributed.admin"
    assert tdist._admin_create_device is teng._admin_create_device
    eng = tdist.DistributedEngine(tdist.DistributedConfig(**small_config(),
                                                          device="cpu"))
    eng.register_device("cf-1")
    assert tdw.compile_posture() == {}


def test_conservation_ledger_matches_jax(tmp_path):
    """The conservation ledger of the mesh engine, with a WAL and an
    archive, rows still staged and after a flush: the ingest, device,
    WAL and archive stages equal the JAX engine's and every equation
    balances."""
    from sitewhere_tpu.utils.conservation import build_ledger as jax_ledger
    from sitewhere_tpu.utils.conservation import check_conservation as jax_check
    from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation

    kw = dict(store_capacity_per_shard=64, batch_capacity_per_shard=16,
              archive_segment_rows=8)
    j = jdist.DistributedEngine(jdist.DistributedConfig(**small_config(
        **kw, wal_dir=str(tmp_path / "jw"), archive_dir=str(tmp_path / "ja"))))
    t = tdist.DistributedEngine(tdist.DistributedConfig(**small_config(
        **kw, wal_dir=str(tmp_path / "tw"), archive_dir=str(tmp_path / "ta")),
        device="cpu"))
    j.epoch, t.epoch = FixedEpoch(), TorchFixedEpoch()
    for k in range(5):
        wire = [meas_payload(f"cv-{i % 24}", float(i), ts_ms=70 * k + i) for i in range(70)]
        both(j, t, lambda e: e.ingest_json_batch(wire))
        ledgers = [jax_ledger(j), build_ledger(t)]
        for stage in ("ingest", "device", "wal", "archive"):
            assert ledgers[0]["stages"][stage] == ledgers[1]["stages"][stage], stage
        assert jax_check(ledgers[0]) == [] and check_conservation(ledgers[1]) == []
    both(j, t, lambda e: e.flush())
    led = build_ledger(t)
    assert led["stages"]["ingest"]["backlog_rows"] == 0
    assert check_conservation(led) == []
    assert_engines_equal(j, t)
