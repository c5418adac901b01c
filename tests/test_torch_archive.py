"""The port's archive tier against the JAX Engine's.

The same seeded JSON stream — measurements, locations, alerts with
alternate ids, two tenants — goes through ``sitewhere_tpu.engine.Engine``
and ``sitewhere_tpu_torch.engine.Engine(device="cpu")`` (native decode,
both clocks pinned) past several wraps of a small ring, with the archive
uncompressed and compressed, on the arena path, the copy path with a scan
chunk, and with two tenant arenas. Byte for byte: every spilled segment's
columns (and their on-disk dtypes: ``vmask`` and ``valid`` bool, the id
and time columns int32), two-tier ``query_events`` pages, ``get_event`` of
evicted ids, the ``metrics()`` archive counters, ``FeedConsumer``
deliveries (redelivery before a commit included), and the conservation
ledger's archive stage. Each package reads the archive directory the other
wrote, and a JAX snapshot with ``archive_dir`` restores into the port and
keeps answering from the archive.
"""

import dataclasses
import json
import shutil
import threading

import jax
import numpy as np
import pytest

import sitewhere_tpu.utils.checkpoint as jax_checkpoint
from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.utils.archive import EventArchive as JaxArchive
from sitewhere_tpu.utils.conservation import build_ledger as jax_build_ledger
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.core.types import EventType
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.utils.archive import _COLUMNS, EventArchive
from sitewhere_tpu_torch.utils.checkpoint import restore_engine
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation
from tests.test_torch_ingest_wire import BASE_MS, pinned
from tests.test_torch_wal import PortClock
from tests.torch_parity import assert_tree_equal, strip_trace

SIZES = dict(device_capacity=64, token_capacity=256, assignment_capacity=256,
             store_capacity=128, batch_capacity=16, channels=4,
             archive_segment_rows=16)
CONFIGS = {
    "plain": {},
    "compressed": dict(archive_compress=True),
    "scan2_copy": dict(scan_chunk=2, ingest_arenas=-1),
    "arenas": dict(tenant_arenas=2),
}
BATCHES = 14
INT_COLUMNS = ("etype", "device", "assignment", "tenant", "area", "customer",
               "asset", "ts_ms", "received_ms", "aux")


def stream(k: int, rng) -> list[bytes]:
    """Batch k: 30 events over 9 devices; event times rise with k, ties
    inside a batch."""
    out = []
    for i in range(30):
        tok = f"d-{int(rng.integers(0, 9))}"
        ts = BASE_MS + 100 * k + i // 2
        kind = rng.random()
        if kind < 0.7:
            req = {"type": "DeviceMeasurements", "request": {
                "measurements": {f"m{int(rng.integers(0, 3))}": float(i) * 0.5,
                                 "m3": float(k)}, "eventDate": ts}}
        elif kind < 0.85:
            req = {"type": "DeviceLocation", "request": {
                "latitude": float(rng.uniform(-9, 9)), "longitude": float(i),
                "eventDate": ts}}
        else:
            req = {"type": "DeviceAlert", "request": {
                "type": f"a{i % 3}", "level": "Error", "eventDate": ts,
                "alternateId": f"alt-{k}-{i}"}}
        out.append(json.dumps({"deviceToken": tok, **req}).encode())
    return out


def drive(tmp_path, name: str, **kw):
    """Both engines over the same stream; tenant t2 on every third batch."""
    cfg = {**SIZES, **CONFIGS.get(name, {}), **kw}
    jeng = JaxEngine(JaxEngineConfig(**cfg, archive_dir=str(tmp_path / "jax")))
    teng = Engine(EngineConfig(**cfg, archive_dir=str(tmp_path / "port")),
                  device="cpu")
    jeng.epoch, teng.epoch = pinned(JaxEpoch), pinned(EpochBase)
    rng = np.random.default_rng(5)
    for k in range(BATCHES):
        pay = stream(k, rng)
        tenant = "t2" if k % 3 == 2 else "default"
        ref = strip_trace(jeng.ingest_json_batch(pay, tenant))
        assert strip_trace(teng.ingest_json_batch(pay, tenant)) == ref
    jeng.flush()
    teng.flush()
    return jeng, teng


def segment_columns(arch, seg) -> dict:
    return arch._cols_or_drop(seg, _COLUMNS)


def assert_archives_equal(ja, ta):
    assert [dataclasses.asdict(s) for s in ta.segments] == \
        [dataclasses.asdict(s) for s in ja.segments]
    for js, ts in zip(ja.segments, ta.segments):
        jc, tc = segment_columns(ja, js), segment_columns(ta, ts)
        for col in _COLUMNS:
            assert jc[col].dtype == tc[col].dtype, col
            assert np.array_equal(jc[col], tc[col]), (ts.path, col)
    assert ta.lost_rows == ja.lost_rows == 0


QUERIES = [
    dict(limit=1000),
    dict(limit=40),
    dict(since_ms=100, until_ms=700, limit=200),
    dict(until_ms=350, limit=15),
    dict(device_token="d-3", limit=500),
    dict(etype=EventType.ALERT, limit=100),
    dict(etype=EventType.LOCATION, since_ms=0, until_ms=900, limit=8),
    dict(tenant="t2", limit=300),
    dict(tenant="t2", until_ms=600, limit=300),
    dict(alternate_id="alt-1-4"),
    dict(device_token="d-1", etype=EventType.MEASUREMENT, until_ms=500, limit=3),
]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_archive_matches_jax(tmp_path, name):
    jeng, teng = drive(tmp_path, name)
    assert_tree_equal(jax.device_get(jeng.state), teng.state)
    mj, mt = jeng.metrics(), teng.metrics()
    mj.pop("arena_pool_waits", None)
    mt.pop("arena_pool_waits", None)
    assert mt == mj
    assert mt["archived_rows"] > 2 * SIZES["store_capacity"]
    assert mt["archive_lost_rows"] == 0
    assert_archives_equal(jeng.archive, teng.archive)
    for q in QUERIES:
        ref = jeng.query_events(**q)
        assert teng.query_events(**q) == ref, q
    # some pages reach rows the ring no longer holds
    assert teng.query_events(until_ms=350, limit=15)["total"] > 0
    arenas = teng.state.store.arenas
    head = max(teng.ring_heads().values()) * arenas
    for i in list(range(0, 40)) + list(range(head - 40, head + 3)):
        assert teng.get_event(i) == jeng.get_event(i), i
        assert teng.get_event(i, tenant="t2") == jeng.get_event(i, tenant="t2"), i
    assert any(teng.get_event(i) is not None for i in range(0, 8 * arenas, arenas))
    tled, jled = build_ledger(teng), jax_build_ledger(jeng)
    assert check_conservation(tled) == []
    assert tled["stages"]["archive"] == jled["stages"]["archive"]
    assert tled["watermarks"] == jled["watermarks"] and tled["lag"] == jled["lag"]


def _delivered(events) -> list[dict]:
    return [dataclasses.asdict(e) | {"etype": int(e.etype)} for e in events]


@pytest.mark.parametrize("name", ["plain", "compressed", "arenas"])
def test_feed_replays_the_archive_like_jax(tmp_path, name):
    jeng, teng = drive(tmp_path, name)
    jf, tf = jeng.make_feed_consumer("g", max_batch=64), \
        teng.make_feed_consumer("g", max_batch=64)
    seen = []
    for _ in range(40):
        a, b = _delivered(jf.poll()), _delivered(tf.poll())
        assert b == a
        # at-least-once: a second poll without a commit delivers again
        assert _delivered(tf.poll()) == b
        if not b:
            break
        jf.commit(jf.poll())
        got = tf.poll()
        tf.commit(got)
        seen += [e.event_id for e in got]
    assert tf.offsets == jf.offsets and tf.lag_lost == jf.lag_lost == 0
    # every event once, in id order within each arena
    arenas = teng.state.store.arenas
    assert len(seen) == len(set(seen)) == sum(teng.ring_heads().values())
    for a in range(arenas):
        pos = [i // arenas for i in seen if i % arenas == a]
        assert pos == list(range(len(pos)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_archive(tmp_path, writer):
    jeng, teng = drive(tmp_path, "compressed")
    src = tmp_path / writer
    other = EventArchive if writer == "jax" else JaxArchive
    same = JaxArchive if writer == "jax" else EventArchive
    a = other(src, segment_rows=16, topology="single/1", compress=True)
    b = same(src, segment_rows=16, topology="single/1", compress=True)
    assert [dataclasses.asdict(s) for s in a.segments] == \
        [dataclasses.asdict(s) for s in b.segments]
    assert a.spilled(0) == b.spilled(0) > 0
    for f in (dict(), dict(etype=0), dict(device=3), dict(since_ms=200, until_ms=500),
              dict(tenant=1)):
        ra, rb = a.query(limit=500, **f), b.query(limit=500, **f)
        assert ra[0] == rb[0]
        for x, y in zip(ra[1], rb[1]):
            assert x.keys() == y.keys()
            assert all(np.array_equal(x[k], y[k]) for k in x)
    for pos in range(0, a.spilled(0), 37):
        ra, rb = a.get_row(0, pos), b.get_row(0, pos)
        assert (ra is None) == (rb is None)
        assert ra is None or all(np.array_equal(ra[k], rb[k]) for k in ra)


def test_segments_land_with_the_jax_dtypes(tmp_path):
    """Uncompressed segment files hold the JAX package's member dtypes: a
    staging arena's uint8 vmask never reaches a segment."""
    jeng, teng = drive(tmp_path, "plain")
    for arch in (jeng.archive, teng.archive):
        for seg in arch.segments:
            with np.load(arch.dir / seg.path) as z:
                assert z["vmask"].dtype == np.bool_ and z["valid"].dtype == np.bool_
                assert z["values"].dtype == np.float32
                for col in INT_COLUMNS:
                    assert z[col].dtype == np.int32, col
                assert sorted(z.files) == sorted(
                    np.load(jeng.archive.dir / seg.path).files)


def test_jax_snapshot_with_an_archive_restores_into_the_port(tmp_path):
    jeng, _ = drive(tmp_path, "plain")
    jax_checkpoint.save_engine(jeng, tmp_path / "snap")
    # the restored engine gets a copy of the archive directory: the JAX
    # engine goes on spilling into its own
    shutil.copytree(tmp_path / "jax", tmp_path / "copy")
    host = json.loads((tmp_path / "snap" / "host.json").read_text())
    assert host["config"]["archive_dir"] == str(tmp_path / "jax")
    host["config"]["archive_dir"] = str(tmp_path / "copy")
    (tmp_path / "snap" / "host.json").write_text(json.dumps(host))
    rec = restore_engine(tmp_path / "snap", device="cpu", epoch_cls=PortClock)
    assert rec.archive is not None and rec.archive.dir == tmp_path / "copy"
    assert rec.metrics()["archived_rows"] == jeng.metrics()["archived_rows"]
    for q in QUERIES:
        assert rec.query_events(**q) == jeng.query_events(**q), q
    for i in range(0, 60, 3):
        assert rec.get_event(i) == jeng.get_event(i), i
    # and it keeps spilling where the JAX engine left off
    rng = np.random.default_rng(9)
    for k in range(BATCHES, BATCHES + 4):
        pay = stream(k, rng)
        jeng.ingest_json_batch(pay)
        rec.ingest_json_batch(pay)
    jeng.flush()
    rec.flush()
    assert rec.archive.spilled(0) == jeng.archive.spilled(0)
    assert rec.query_events(limit=1000) == jeng.query_events(limit=1000)


def test_query_round_serves_every_archive_request_in_one_pass(tmp_path):
    """A round of coalesced queries makes one planner call for all of
    their archive requests."""
    _, teng = drive(tmp_path, "plain")
    batcher, arch = teng._query_batcher, teng.archive
    calls0 = arch.planner_calls
    params = (-1, -1, -1, -(2**31), 2**31 - 1, -1, -1, -1, -1, -1)
    entries = [{"params": params, "limit": 16, "event": threading.Event(),
                "result": None, "cursors": None, "q": 0, "error": None,
                "archive": {"limit": 10, "filters": dict(device=d)},
                "archive_result": None} for d in range(4)]
    batcher._execute(entries)
    assert arch.planner_calls == calls0 + 1
    assert all(e["archive_result"] is not None for e in entries)
    assert all(e["cursors"] is not None for e in entries)
