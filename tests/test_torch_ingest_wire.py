"""The port's wire ingest against the JAX engine's, both on the native path.

The same seeded JSON and binary payload streams — measurements with more
names than channels, alerts with alternate ids, locations, registration
and mapping envelopes in mid-batch, payloads that do not decode — go
through ``sitewhere_tpu.engine.Engine`` and
``sitewhere_tpu_torch.engine.Engine(device="cpu")`` with both clocks
pinned, on the arena path and the copy path, at ``scan_chunk`` 1 and 3,
``dispatch_depth`` 1 and 2, one and two decode threads, and a single
arena. Summaries, ``metrics()``, ``host_counters``, the host mirrors and
every state leaf must be equal. Strict channels reject a batch without
leaking lanes; MapDevice lands in ``device_parent`` through ``process()``
and through a batch envelope; a dispatched arena can be overwritten
without touching the state; the arena pool waits on the oldest ticket.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import ChannelCapacityError as JaxChannelCapacityError
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.ingest.requests import DecodedRequest as JaxRequest
from sitewhere_tpu.ingest.requests import RequestType as JaxRequestType
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import ChannelCapacityError, Engine, EngineConfig
from sitewhere_tpu_torch.ingest.arena import ArenaPool, ArenaStallError
from sitewhere_tpu_torch.ingest.decoders import encode_binary_request
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.loadgen import generate_measurements_message, run_engine_load
from tests.torch_parity import assert_tree_equal, strip_trace

BASE_S = 1_700_000_000.0
BASE_MS = int(BASE_S * 1000)
SIZES = dict(device_capacity=64, token_capacity=256, assignment_capacity=256,
             store_capacity=512, batch_capacity=64, channels=4)
BATCHES = 5


def pinned(cls, now: int = 6_000):
    class Pinned(cls):
        def now_ms(self):
            return now

    return Pinned(BASE_S)


def json_stream(k: int, rng) -> list[bytes]:
    """Batch k: 150 events over 30 devices, 7 measurement names on 4
    channels, a registration in mid-batch, a mapping of a device of an
    earlier batch under the previous batch's gateway, broken payloads."""
    out = []
    for i in range(150):
        d = int(rng.integers(0, 30))
        ts = BASE_MS + 100 * k + i // 3
        kind = rng.random()
        if kind < 0.6:
            req = {"type": "DeviceMeasurements", "request": {
                "measurements": {f"m{int(rng.integers(0, 7))}": float(i % 40) * 0.5,
                                 "m0": float(k)}, "eventDate": ts}}
        elif kind < 0.75:
            req = {"type": "DeviceLocation", "request": {
                "latitude": float(rng.uniform(-9, 9)), "longitude": float(i),
                "eventDate": ts}}
        elif kind < 0.9:
            req = {"type": "DeviceAlert", "request": {
                "type": f"a{i % 3}", "level": ["Info", "Error", 3][i % 3],
                "eventDate": ts, "alternateId": f"alt-{k}-{i % 7}"}}
        else:
            req = {"type": "DeviceMeasurement", "request": {
                "name": "m1", "value": 1.5, "alternateId": f"alt-{i % 4}"}}
        out.append(json.dumps({"deviceToken": f"d-{d}", **req}).encode())
    out.insert(40, json.dumps({"deviceToken": f"gw-{k}", "type": "RegisterDevice",
                               "request": {"deviceTypeToken": "gateway",
                                           "areaToken": "north"}}).encode())
    if k:
        out.insert(90, json.dumps({"deviceToken": f"d-{k}", "type": "MapDevice",
                                   "request": {"parentToken": f"gw-{k - 1}"}}).encode())
    out += [b"{broken", b'{"type": "DeviceAlert"}']
    return out


def binary_stream(k: int, rng) -> list[bytes]:
    """The binary twin: measurements, locations, alerts and a registration
    in mid-batch, plus a frame that does not decode."""
    out = []
    for i in range(150):
        d = f"d-{int(rng.integers(0, 30))}"
        ts = BASE_MS + 100 * k + i // 3
        kind = i % 4
        if kind < 2:
            req = DecodedRequest(type=RequestType.DEVICE_MEASUREMENT, device_token=d,
                                 event_ts_ms=ts, measurements={
                                     f"m{int(rng.integers(0, 7))}": float(i) * 0.5})
        elif kind == 2:
            req = DecodedRequest(type=RequestType.DEVICE_LOCATION, device_token=d,
                                 event_ts_ms=ts, latitude=1.5, longitude=float(i))
        else:
            req = DecodedRequest(type=RequestType.DEVICE_ALERT, device_token=d,
                                 event_ts_ms=ts, alert_type=f"a{i % 3}",
                                 alert_level=i % 4)
        out.append(encode_binary_request(req))
    out.insert(70, encode_binary_request(DecodedRequest(
        type=RequestType.REGISTER_DEVICE, device_token=f"gw-{k}",
        extras={"deviceTypeToken": "gateway"})))
    return out + [b"\x01\x09\x00\x00"]


def engines(**kw):
    jeng = JaxEngine(JaxEngineConfig(**SIZES, **kw))
    teng = Engine(EngineConfig(**SIZES, **kw), device="cpu")
    jeng.epoch, teng.epoch = pinned(JaxEpoch), pinned(EpochBase)
    return jeng, teng


def assert_engines_equal(jeng, teng):
    assert_tree_equal(jax.device_get(jeng.state), teng.state)
    # arena_pool_waits counts waits for a dispatch still running: a CPU
    # engine of the port has run its step when the dispatch returns, the
    # JAX engine's CPU step runs asynchronously
    mt, mj = teng.metrics(), jeng.metrics()
    assert mt.pop("arena_pool_waits", 0) == 0
    mj.pop("arena_pool_waits", None)
    assert mt == mj
    assert teng.host_counters == jeng.host_counters
    assert ({k: dataclasses.asdict(v) for k, v in teng.devices.items()}
            == {k: dataclasses.asdict(v) for k, v in jeng.devices.items()})
    assert teng.token_device == jeng.token_device
    assert teng.dead_letters == jeng.dead_letters
    for name in ("tokens", "tenants", "alert_types", "event_ids"):
        a, b = getattr(jeng, name), getattr(teng, name)
        assert [b.token(i) for i in range(len(b))] == [a.token(i) for i in range(len(a))]


CONFIGS = {
    "arena": {},
    "copy": dict(ingest_arenas=-1),
    "scan3": dict(scan_chunk=3),
    "scan3_copy": dict(scan_chunk=3, ingest_arenas=-1),
    "depth2": dict(dispatch_depth=2),
    "depth2_scan3": dict(dispatch_depth=2, scan_chunk=3),
    "one_thread": dict(ingest_workers=1),
    "two_threads": dict(ingest_workers=2, scan_chunk=3),   # arenas of 192 rows
    "one_arena": dict(ingest_arenas=1, dispatch_depth=2),
}


@pytest.mark.parametrize("wire", ["json", "binary"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_wire_stream_matches_jax(name, wire):
    jeng, teng = engines(**CONFIGS[name])
    make = json_stream if wire == "json" else binary_stream
    rng = np.random.default_rng(11)
    for k in range(BATCHES):
        pay = make(k, rng)
        tenant = "t2" if k == 3 else "default"
        fn = "ingest_json_batch" if wire == "json" else "ingest_binary_batch"
        ref = strip_trace(getattr(jeng, fn)(pay, tenant))
        assert strip_trace(getattr(teng, fn)(pay, tenant)) == ref
        if k == 2:
            jeng.flush_async()
            teng.flush_async()
        assert teng.staged_count == jeng.staged_count
    ref = jeng.flush()
    assert teng.flush() == ref
    assert_engines_equal(jeng, teng)
    if CONFIGS[name].get("ingest_arenas") != -1:
        assert teng.host_counters["arena_rows"] > 0
        assert teng.host_counters.get("staged_copy_rows", 0) == 0
    if name == "two_threads":
        assert teng._sharder.sharded_batches > 0


@pytest.mark.parametrize("arenas", [0, -1])
def test_strict_channels_reject_leaks_no_lanes(arenas):
    """A batch whose names exceed the channels is refused whole on both
    sides: the names it interned roll back and nothing stages."""
    sizes = dict(SIZES, channels=3)
    jeng = JaxEngine(JaxEngineConfig(**sizes, strict_channels=True, ingest_arenas=arenas))
    teng = Engine(EngineConfig(**sizes, strict_channels=True, ingest_arenas=arenas),
                  device="cpu")
    jeng.epoch, teng.epoch = pinned(JaxEpoch), pinned(EpochBase)

    def meas(tok, names):
        return json.dumps({"deviceToken": tok, "type": "DeviceMeasurements",
                           "request": {"measurements": {n: 1.5 for n in names}}}).encode()

    ok = [meas(f"s-{i % 8}", ["a", "b"]) for i in range(40)]
    assert strip_trace(teng.ingest_json_batch(ok)) == strip_trace(jeng.ingest_json_batch(ok))
    refused = [meas("s-x", ["c", "d"])]
    with pytest.raises(JaxChannelCapacityError):
        jeng.ingest_json_batch(refused)
    with pytest.raises(ChannelCapacityError):
        teng.ingest_json_batch(refused)
    assert len(teng.channel_map.names) == len(jeng.channel_map.names) == 2
    # the refusal left no lane behind: one new name still fits
    assert teng.ingest_json_batch([meas("s-1", ["e"])])["failed"] == 0
    jeng.ingest_json_batch([meas("s-1", ["e"])])
    jeng.flush()
    teng.flush()
    assert_engines_equal(jeng, teng)
    assert teng.metrics()["persisted"] == 41


def test_map_device_matches_jax():
    """MapDevice through ``process()`` and through a batch envelope sets
    the child's ``device_parent`` and metadata as the JAX engine does; an
    unknown parent raises from ``process()`` and counts failed in a batch."""
    jeng, teng = engines()
    for eng, req_cls, rtype in ((jeng, JaxRequest, JaxRequestType),
                                (teng, DecodedRequest, RequestType)):
        for tok in ("gw", "child-1", "child-2"):
            eng.register_device(tok)
        eng.process(req_cls(type=rtype.MAP_DEVICE, device_token="child-1",
                            extras={"parentToken": "gw"}))
        with pytest.raises(KeyError):
            eng.process(req_cls(type=rtype.MAP_DEVICE, device_token="child-1",
                                extras={"parentToken": "ghost"}))
    batch = [json.dumps({"deviceToken": "child-2", "type": "MapDevice",
                         "request": {"parentHardwareId": "gw"}}).encode(),
             json.dumps({"deviceToken": "child-1", "type": "MapDevice",
                         "request": {"parentToken": "ghost"}}).encode(),
             generate_measurements_message("child-2", 1)]
    ref = strip_trace(jeng.ingest_json_batch(batch))
    assert strip_trace(teng.ingest_json_batch(batch)) == ref == {"decoded": 2, "failed": 1,
                                                                 "staged": 1}
    jeng.flush()
    teng.flush()
    assert_engines_equal(jeng, teng)
    parent = teng.state.registry.device_parent
    assert parent[1].item() == parent[2].item() == 0
    assert teng.get_device("child-2").metadata == {"parentToken": "gw"}


def _leaves(obj):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v)
        elif v is not None and hasattr(v, "clone"):
            yield v


def test_dispatched_arena_can_be_overwritten():
    """On the CPU an arena's batch is the arena's own tensors: the step
    must keep no view of them in the state, so garbage written into every
    arena after the dispatch leaves the state as it was."""
    eng = Engine(EngineConfig(**SIZES, ingest_arenas=2, analytics_devices=16,
                              analytics_window=8), device="cpu")
    eng.epoch = pinned(EpochBase)
    eng.ingest_json_batch([generate_measurements_message(f"r-{i % 9}", i)
                           for i in range(SIZES["batch_capacity"])])
    assert eng._arena_fill is None and eng._arena_dispatches == 1
    state = eng.state
    before = [t.clone() for t in _leaves(state)]
    pool = eng._arena_pool
    for arena in [a for a, _ in pool._inflight] + pool._free:
        for t in arena.tensors.values():
            t.fill_(7)
    assert eng.state is state
    assert all(a.equal(b) for a, b in zip(before, _leaves(state)))


class FakeTicket:
    """A dispatch that completes only when waited on."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_arena_pool_waits_on_the_oldest_ticket():
    pool = ArenaPool(2, 64, 8)
    a1 = pool.acquire()
    t1 = FakeTicket()
    pool.retire(a1, t1)
    a2 = pool.acquire()
    t2 = FakeTicket()
    pool.retire(a2, t2)
    a1.cursor = 5
    a1.valid[:5] = True
    a3 = pool.acquire()            # both in flight: waits on the oldest
    assert pool.waits == 1 and t1.done and not t2.done
    assert a3 is a1 and a3.cursor == 0 and not a3.valid.any()
    t2.done = True
    pool.retire(a3, None)          # a CPU dispatch: already done
    assert pool.acquire() in (a2, a3) and pool.waits == 1


def test_arena_pool_stall_times_out():
    pool = ArenaPool(1, 64, 8)
    pool.retire(pool.acquire(), FakeTicket())
    with pytest.raises(ArenaStallError):
        pool.acquire(timeout_s=0.01)
    assert pool.inflight_count == 1


def test_run_engine_load_on_a_small_cpu_engine():
    eng = Engine(EngineConfig(**SIZES, dispatch_depth=2), device="cpu")
    stats = run_engine_load(eng, n_batches=4, batch_size=64, n_devices=40,
                            warmup_batches=1, pipelined=True)
    assert stats.events_sent == stats.events_decoded == 256
    assert stats.events_failed == 0 and stats.events_per_s > 0
    assert stats.latency_p50_ms <= stats.latency_p99_ms <= stats.latency_max_ms
    eng.flush()
    m = eng.metrics()
    assert m["persisted"] == 5 * 64 == m["arena_rows"]
    assert m.get("staged_copy_rows", 0) == 0
