"""The port's native decoder against the JAX package's, on the same payloads.

Both packages build ``native/src/swtpu.cpp`` (each into its own build
directory) and bind it with ctypes. The same seeded JSON and binary
payloads — measurements with more names than channels, alerts of every
level, alternate ids, locations with and without coordinates, state
changes, acknowledgements, registration and mapping envelopes, and
payloads that do not decode — must give byte-identical ``DecodedArrays``,
interners, staging-arena rows, and sharded decodes equal to one thread's.
A failed build raises.
"""

import json

import numpy as np
import pytest

from sitewhere_tpu.ingest.arena import StagingArena as JaxArena
from sitewhere_tpu.ingest.decoders import BinaryEventDecoder as JaxBinaryDecoder
from sitewhere_tpu.ingest.decoders import encode_binary_request as jax_encode
from sitewhere_tpu.ingest.fast_decode import NativeBatchDecoder as JaxDecoder
from sitewhere_tpu.ingest.requests import DecodedRequest as JaxRequest
from sitewhere_tpu.ingest.requests import RequestType as JaxRequestType
from sitewhere_tpu.native.binding import NativeInterner as JaxInterner
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.arena import StagingArena
from sitewhere_tpu_torch.ingest.decoders import (BinaryEventDecoder,
                                                 binary_token_of,
                                                 encode_binary_request)
from sitewhere_tpu_torch.ingest.fast_decode import NativeBatchDecoder
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.ingest.workers import ShardedArenaDecoder
from sitewhere_tpu_torch.native import binding
from sitewhere_tpu_torch.native.binding import NativeInterner
from tests.torch_parity import strip_trace

CHANNELS = 4
BASE_MS = 1_700_000_000_000
LEVELS = ["Info", "Warning", "Error", "Critical", 2]


def json_payloads(rng, n: int = 300) -> list[bytes]:
    """Seeded JSON payloads of every envelope kind; 9 measurement names
    over 4 channels (collisions), and broken payloads."""
    out = []
    for i in range(n):
        tok = f"dev-{int(rng.integers(0, 40))}"
        kind = rng.random()
        ts = BASE_MS + i if rng.random() < 0.8 else None
        if kind < 0.45:
            names = rng.choice([f"m{k}" for k in range(9)],
                               int(rng.integers(1, 4)), replace=False)
            req = {"measurements": {str(m): float(rng.integers(-50, 50)) * 0.25
                                    for m in names}, "eventDate": ts}
            env = {"type": "DeviceMeasurements", "request": req}
        elif kind < 0.55:
            env = {"type": "DeviceMeasurement", "request": {
                "name": f"m{int(rng.integers(0, 9))}", "value": float(i) * 0.5,
                "eventDate": ts, "alternateId": f"alt-{i % 17}"}}
        elif kind < 0.65:
            coords = ({"latitude": float(rng.uniform(-80, 80)),
                       "longitude": float(rng.uniform(-170, 170))}
                      if rng.random() < 0.8 else
                      {"latitude": None, "longitude": None})
            env = {"type": "DeviceLocation", "request": {
                **coords, "elevation": 12.5, "eventDate": ts}}
        elif kind < 0.78:
            env = {"type": "DeviceAlert", "request": {
                "type": f"alarm-{i % 5}", "level": LEVELS[i % len(LEVELS)],
                "message": "m", "eventDate": ts,
                "alternateId": f"alt-{i % 11}"}}
        elif kind < 0.84:
            env = {"type": "DeviceStateChange", "request": {
                "attribute": "mode", "type": "eco", "eventDate": ts}}
        elif kind < 0.89:
            env = {"type": "Acknowledge", "request": {
                "originatingEventId": f"cmd-{i}", "response": "ok"}}
        elif kind < 0.93:
            env = {"type": "RegisterDevice", "request": {
                "deviceTypeToken": "gateway", "areaToken": "north"}}
        elif kind < 0.96:
            env = {"type": "MapDevice", "request": {"parentToken": "dev-0"}}
        else:
            env = None
        if env is None:
            out.append([b"{broken", b"[1, 2]", b'{"type": "DeviceAlert"}',
                        b"\xff\xfe"][i % 4])
            continue
        key = "hardwareId" if i % 13 == 0 else "deviceToken"
        out.append(json.dumps({key: tok, **env}).encode())
    return out


def requests(rng, n: int = 240) -> list[tuple]:
    """Seeded requests of every type the binary format carries, as
    (type name, field dict) so each package can build its own."""
    out = []
    for i in range(n):
        tok = f"dev-{int(rng.integers(0, 40))}"
        ts = BASE_MS + i if rng.random() < 0.8 else None
        kind = i % 5
        if kind == 0:
            names = rng.choice([f"m{k}" for k in range(9)],
                               int(rng.integers(1, 4)), replace=False)
            out.append(("DEVICE_MEASUREMENT", dict(
                device_token=tok, event_ts_ms=ts,
                measurements={str(m): float(rng.integers(-50, 50)) * 0.25
                              for m in names})))
        elif kind == 1:
            has = rng.random() < 0.8
            out.append(("DEVICE_LOCATION", dict(
                device_token=tok, event_ts_ms=ts,
                latitude=float(rng.uniform(-80, 80)) if has else None,
                longitude=float(rng.uniform(-170, 170)) if has else None,
                elevation=3.0)))
        elif kind == 2:
            out.append(("DEVICE_ALERT", dict(
                device_token=tok, event_ts_ms=ts, alert_type=f"alarm-{i % 5}",
                alert_level=i % 4, alert_message="hot" if i % 2 else None)))
        elif kind == 3:
            out.append(("ACKNOWLEDGE", dict(
                device_token=tok, event_ts_ms=ts,
                originating_event_id=f"cmd-{i}", response="done")))
        else:
            out.append(("REGISTER_DEVICE", dict(
                device_token=f"new-{i}", extras={"deviceTypeToken": "gw",
                                                 "areaToken": "south"})))
    return out


def binary_payloads(rng) -> tuple[list[bytes], list[bytes]]:
    """The same requests encoded by each package, plus broken frames."""
    reqs = requests(rng)
    port = [encode_binary_request(DecodedRequest(type=RequestType[t], **kw))
            for t, kw in reqs]
    ref = [jax_encode(JaxRequest(type=JaxRequestType[t], **kw)) for t, kw in reqs]
    bad = [b"", b"\x02\x01\x00\x00", b"\x01\x09\x01\x00x" + b"\x00" * 8]
    return port + bad, ref + bad


def _interners(dec):
    return [[it.token(i) for i in range(len(it))]
            for it in (dec.tokens, dec.names, dec.alert_types, dec.event_ids)]


def _decoders(channels: int = CHANNELS):
    return (NativeBatchDecoder(NativeInterner(1 << 10), channels),
            JaxDecoder(JaxInterner(1 << 10), channels))


def assert_decoded_equal(got, ref):
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(got, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


def test_binary_encoding_matches_jax():
    port, ref = binary_payloads(np.random.default_rng(3))
    assert port == ref
    for p in port[:-3]:
        got = BinaryEventDecoder().decode(p, {})[0]
        want = JaxBinaryDecoder().decode(p, {})[0]
        assert (got.type.value, got.device_token, got.event_ts_ms, got.measurements,
                got.latitude, got.longitude, got.alert_type, got.extras,
                got.originating_event_id) == (
                    want.type.value, want.device_token, want.event_ts_ms,
                    want.measurements, want.latitude, want.longitude,
                    want.alert_type, want.extras, want.originating_event_id)
        assert binary_token_of(p) == got.device_token
    assert binary_token_of(b"\x02\x01") is None


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_decoded_arrays_match_jax(wire):
    rng = np.random.default_rng(0)
    pay = (json_payloads(rng) if wire == "json" else binary_payloads(rng)[0])
    port, ref = _decoders()
    failed = 0
    for chunk in (pay[:120], pay[120:], tuple(pay[:50])):   # a tuple: packed ABI
        fn = "decode" if wire == "json" else "decode_binary"
        got, want = getattr(port, fn)(chunk), getattr(ref, fn)(chunk)
        assert_decoded_equal(got, want)
        assert _interners(port) == _interners(ref)
        failed += int(np.sum(want.rtype < 0))
    assert failed > 0          # the broken payloads failed on both sides


def test_decode_counts_collisions_past_the_channels():
    pay = [json.dumps({"deviceToken": "d", "type": "DeviceMeasurements",
                       "request": {"measurements": {f"m{k}": 1.0
                                                    for k in range(9)}}}).encode()]
    port, ref = _decoders()
    got, want = port.decode(pay), ref.decode(pay)
    assert got.collisions == want.collisions == 9 - CHANNELS


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_decode_into_arena_rows_match_jax(wire):
    rng = np.random.default_rng(1)
    pay = (json_payloads(rng) if wire == "json" else binary_payloads(rng)[0])
    port, ref = _decoders()
    arena, jarena = StagingArena(512, CHANNELS), JaxArena(512, CHANNELS)
    lo = 37
    for start in (0, 150):
        chunk = pay[start:start + 150]
        got = port.decode_into(chunk, arena, lo, binary=wire == "binary")
        want = ref.decode_into(chunk, jarena, lo, binary=wire == "binary")
        assert got == want
        hi = lo + len(chunk)
        for col in ("rtype", "token_id", "ts64", "values", "vmask", "aux", "level"):
            a, b = getattr(jarena, col)[lo:hi], getattr(arena, col)[lo:hi]
            assert a.dtype == b.dtype and np.array_equal(a, b), col
        lo = hi
    assert _interners(port) == _interners(ref)
    with pytest.raises(ValueError):
        port.decode_into(pay[:100], arena, 450)


def _arena_columns(arena):
    return {c: getattr(arena, c).copy()
            for c in ("rtype", "token_id", "ts64", "values", "vmask", "aux", "level")}


@pytest.mark.parametrize("workers", [2, 3])
@pytest.mark.parametrize("wire", ["json", "binary"])
def test_sharded_decode_equals_single_thread(wire, workers):
    rng = np.random.default_rng(7 + workers)
    pay = (json_payloads(rng, 600) if wire == "json"
           else binary_payloads(rng)[0] * 3)
    binary = wire == "binary"
    single, multi = _decoders()[0], _decoders()[0]
    sharded = ShardedArenaDecoder(multi, workers)
    a1, a2 = StagingArena(2048, CHANNELS), StagingArena(2048, CHANNELS)
    for arena in (a1, a2):       # garbage a decode must fully overwrite
        arena.rtype[:] = 99
        arena.token_id[:] = 12345
    lo = 0
    for start in range(0, len(pay), 300):
        chunk = pay[start:start + 300]
        got = sharded.decode_into(chunk, a2, lo, binary=binary)
        want = single.decode_into(chunk, a1, lo, binary=binary)
        assert got == want
        lo += len(chunk)
    assert sharded.sharded_batches > 0
    c1, c2 = _arena_columns(a1), _arena_columns(a2)
    for col in c1:
        assert np.array_equal(c1[col][:lo], c2[col][:lo]), col
    assert _interners(single) == _interners(multi)
    sharded.close()


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's message; an engine
    asked for the native path (the default) raises when the library cannot
    be built, and the Python path runs only when asked for."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native build of broken failed"):
        binding._build("broken", [bad], [])
    assert not list((tmp_path / "build").glob("*.so"))

    def refuse(*args):
        raise RuntimeError("native build of swtpu failed (g++ exit 1)")

    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_build", refuse)
    cfg = dict(device_capacity=8, token_capacity=8, assignment_capacity=8,
               store_capacity=64, batch_capacity=8)
    with pytest.raises(RuntimeError, match="native build"):
        Engine(EngineConfig(**cfg), device="cpu")
    eng = Engine(EngineConfig(**cfg, use_native=False), device="cpu")
    assert eng._native_decoder is None and eng._arena_pool is None
    assert strip_trace(eng.ingest_json_batch([b"{broken"])) == {"decoded": 0, "failed": 1}
