"""The port's write-ahead log and recovery against the JAX package's.

The two ``IngestLog`` classes share one byte format: a log written by
either replays through the other, watermarks included, and a torn tail
stops both replays at the same record. Group commit fsyncs less often than
it appends. Snapshot plus WAL replay (``recover_engine``) gives the JAX
package's state — from the port's own snapshot, from a JAX snapshot, and
the JAX package recovers a port snapshot likewise — and the state of an
engine that never crashed. A strict-channel refusal is never durable.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

import sitewhere_tpu.utils.checkpoint as jax_checkpoint
from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.utils.ingestlog import IngestLog as JaxLog
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import ChannelCapacityError, Engine, EngineConfig
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.loadgen import generate_measurements_message
from sitewhere_tpu_torch.utils.checkpoint import recover_engine, save_engine
from sitewhere_tpu_torch.utils.ingestlog import IngestLog
from tests.test_torch_ingest_wire import (SIZES, assert_engines_equal,
                                          binary_stream, json_stream, pinned)
from tests.torch_parity import assert_tree_equal

NOW = 6_000


class PortClock(EpochBase):
    def now_ms(self):
        return NOW


class JaxClock(JaxEpoch):
    def now_ms(self):
        return NOW


def _write(log_cls, path, group_commit: bool) -> list[bytes]:
    log = log_cls(path, group_commit=group_commit, segment_bytes=900)
    sent = []
    for k in range(6):
        head = (b"\x01" if k % 2 else b"\x02") + f"t{k % 3}".encode() + b"\x00"
        payloads = [f"payload-{k}-{i}".encode() * (1 + i % 3) for i in range(7)]
        log.append_many(payloads, head)
        sent += [head + p for p in payloads]
        if k == 2:
            log.append_watermark(1234)
        log.append(b"single-%d" % k)
        sent.append(b"single-%d" % k)
    log.sync()
    log.close()
    return sent


@pytest.mark.parametrize("group_commit", [True, False])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wal_replays_through_the_other_package(tmp_path, writer, group_commit):
    write_cls, read_cls = (IngestLog, JaxLog) if writer == "port" else (JaxLog, IngestLog)
    sent = _write(write_cls, tmp_path / "wal", group_commit)
    assert len(list((tmp_path / "wal").glob("segment-*.log"))) > 1   # rotated
    for after in (-1, 1233, 1234):
        got = list(read_cls(tmp_path / "wal", readonly=True).replay(after_cursor=after))
        same = list(write_cls(tmp_path / "wal", readonly=True).replay(after_cursor=after))
        assert got == same
    assert list(read_cls(tmp_path / "wal", readonly=True).replay()) == sent
    # records after the watermark only, once the snapshot covers it
    assert len(list(read_cls(tmp_path / "wal", readonly=True).replay(1234))) == 1 + 3 * 8


def test_prune_keeps_the_newest_segments_as_the_jax_log_does(tmp_path):
    import shutil

    _write(IngestLog, tmp_path / "port", group_commit=False)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    segs = sorted(p.name for p in (tmp_path / "port").glob("segment-*.log"))
    assert IngestLog(tmp_path / "port", readonly=True).prune(keep_segments=2) \
        == JaxLog(tmp_path / "jax", readonly=True).prune(keep_segments=2) == len(segs) - 2
    for d in ("port", "jax"):
        assert sorted(p.name for p in (tmp_path / d).glob("segment-*.log")) == segs[-2:]
    assert list(IngestLog(tmp_path / "port", readonly=True).replay()) == \
        list(JaxLog(tmp_path / "jax", readonly=True).replay())


def test_torn_tail_stops_replay_cleanly(tmp_path):
    log = IngestLog(tmp_path / "wal")
    for i in range(10):
        log.append(b"record-%d" % i)
    log.sync()
    log.close()
    seg = sorted((tmp_path / "wal").glob("segment-*.log"))[-1]
    data = seg.read_bytes()
    seg.write_bytes(data[:-3])                      # the last record is torn
    for cls in (IngestLog, JaxLog):
        assert list(cls(tmp_path / "wal", readonly=True).replay()) == [
            b"record-%d" % i for i in range(9)]
    corrupt = bytearray(data)
    corrupt[-1] ^= 0xFF                             # a bad CRC in the tail
    seg.write_bytes(bytes(corrupt))
    for cls in (IngestLog, JaxLog):
        assert len(list(cls(tmp_path / "wal", readonly=True).replay())) == 9
    with pytest.raises(RuntimeError):
        IngestLog(tmp_path / "wal", readonly=True).append(b"x")


def test_group_commit_fewer_fsyncs_than_appends(tmp_path):
    """Several ingest calls land between dispatches, so one fsync covers
    several append groups; every group is durable at the end."""
    eng = Engine(EngineConfig(**dict(SIZES, batch_capacity=256, store_capacity=1024),
                              wal_dir=str(tmp_path / "wal")), device="cpu")
    assert eng.wal.group_commit
    for b in range(16):
        eng.ingest_json_batch([generate_measurements_message(f"gc-{i % 20}", b * 100 + i)
                               for i in range(32)])
    eng.flush()
    assert eng.wal.commit_groups == 16 and eng.wal.durable_seq == 16
    assert eng.wal.fsyncs < 16
    m = eng.metrics()
    assert m["wal_fsyncs"] == eng.wal.fsyncs and m["persisted"] == 512
    eng.wal.close()
    assert len(list(IngestLog(tmp_path / "wal", readonly=True).replay())) == 512


def _drive(eng, k0: int, k1: int, wire: str) -> None:
    rng = np.random.default_rng(5)
    make = json_stream if wire == "json" else binary_stream
    fn = eng.ingest_json_batch if wire == "json" else eng.ingest_binary_batch
    for k in range(k1):
        pay = make(k, rng)
        if k >= k0:
            fn(pay, "t2" if k == 3 else "default")


def _crashed(eng_cls, cfg_cls, clock, tmp_path, name, wire, **kw):
    """An engine that takes a snapshot after 2 batches, ingests 3 more and
    stops without a flush (its WAL closed, as the process would leave
    it)."""
    wal = tmp_path / f"{name}-wal"
    eng = eng_cls(cfg_cls(**SIZES, wal_dir=str(wal)), **kw)
    eng.epoch = clock(1_700_000_000.0)
    eng.register_device("admin-1", device_type="thermostat", area="north")
    _drive(eng, 0, 2, wire)
    save = jax_checkpoint.save_engine if eng_cls is JaxEngine else save_engine
    save(eng, tmp_path / f"{name}-snap")
    _drive(eng, 2, 5, wire)
    eng.register_device("admin-2", tenant="t2")
    eng.wal.close()
    return tmp_path / f"{name}-snap", wal


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_recover_engine_matches_jax_and_the_uncrashed_engine(tmp_path, monkeypatch, wire):
    monkeypatch.setattr(jax_checkpoint, "EpochBase", JaxClock)
    jsnap, jwal = _crashed(JaxEngine, JaxEngineConfig, JaxClock, tmp_path, "jax", wire)
    tsnap, twal = _crashed(Engine, EngineConfig, PortClock, tmp_path, "port", wire,
                           device="cpu")
    jrec = jax_checkpoint.recover_engine(jsnap)
    trec = recover_engine(tsnap, device="cpu", epoch_cls=PortClock)
    assert isinstance(trec.epoch, PortClock) and trec.wal is not None
    assert_engines_equal(jrec, trec)
    # and the engine that never crashed, flushed where the snapshot was
    # taken (the snapshot dispatches the partly filled arena: the in-batch
    # dedup counter depends on where batches end): the same state and
    # mirrors (its host counters and metrics also count the rows before
    # the snapshot, which a recovered engine never staged)
    live = Engine(EngineConfig(**SIZES), device="cpu")
    live.epoch = pinned(EpochBase, NOW)
    live.register_device("admin-1", device_type="thermostat", area="north")
    _drive(live, 0, 2, wire)
    live.flush()
    _drive(live, 2, 5, wire)
    live.register_device("admin-2", tenant="t2")
    live.flush()
    assert_tree_equal(live.state, trec.state)
    assert ({k: dataclasses.asdict(v) for k, v in live.devices.items()}
            == {k: dataclasses.asdict(v) for k, v in trec.devices.items()})
    assert live.token_device == trec.token_device
    for eng in (jrec, trec):
        eng.wal.close()


def test_port_recovers_a_jax_snapshot_and_the_jax_package_a_port_one(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_checkpoint, "EpochBase", JaxClock)
    jsnap, jwal = _crashed(JaxEngine, JaxEngineConfig, JaxClock, tmp_path, "jax", "json")
    jrec = jax_checkpoint.recover_engine(jsnap)
    jrec.wal.close()
    trec = recover_engine(jsnap, device="cpu", epoch_cls=PortClock)
    assert_engines_equal(jrec, trec)
    trec.wal.close()

    tsnap, twal = _crashed(Engine, EngineConfig, PortClock, tmp_path, "port", "json",
                           device="cpu")
    jrec2 = jax_checkpoint.recover_engine(tsnap)
    jrec2.wal.close()
    trec2 = recover_engine(tsnap, device="cpu", epoch_cls=PortClock)
    trec2.wal.close()
    assert_engines_equal(jrec2, trec2)
    assert_engines_equal(jrec, trec2)


PORTED_FEATURES = {"archive_dir": "archive", "tenant_arenas": 2,
                   "auto_register": False, "assignment_triggers": True,
                   "fair_tenancy": True, "qos": True, "autotune": True}


@pytest.mark.parametrize("feature", list(PORTED_FEATURES))
def test_restore_accepts_ported_features(tmp_path, feature):
    """``archive_dir``, ``tenant_arenas``, ``auto_register``,
    ``assignment_triggers``, ``fair_tenancy``, ``qos`` and ``autotune``
    restore with their values."""
    value = PORTED_FEATURES[feature]
    if feature == "archive_dir":
        value = str(tmp_path / value)
    eng = JaxEngine(JaxEngineConfig(**SIZES, **{feature: value}))
    eng.register_device("r-1")
    jax_checkpoint.save_engine(eng, tmp_path / "snap")
    rec = recover_engine(tmp_path / "snap", device="cpu")
    assert getattr(rec.config, feature) == value
    assert_tree_equal(jax.device_get(eng.state), rec.state)
    if feature == "tenant_arenas":
        assert rec.state.store.arenas == 2
    if feature == "archive_dir":
        assert rec.archive is not None and rec.archive.dir == tmp_path / "archive"


def test_unknown_config_keys_are_named_observability_keys_are_not(tmp_path, caplog):
    """A config key the port does not know is named in a warning; the
    observability switches restore with their values, without one."""
    eng = JaxEngine(JaxEngineConfig(**SIZES, flight_recorder=False, span_trace=False))
    jax_checkpoint.save_engine(eng, tmp_path / "snap")
    with caplog.at_level("WARNING", logger="sitewhere_tpu_torch.utils.checkpoint"):
        rec = recover_engine(tmp_path / "snap", device="cpu")
    assert not [r for r in caplog.records if "does not know" in r.getMessage()]
    assert rec.config.flight_recorder is False and rec.config.span_trace is False
    assert not rec.flight.enabled and not rec.tracer.enabled
    host = json.loads((tmp_path / "snap" / "host.json").read_text())
    host["config"]["warp_drive"] = 3
    (tmp_path / "snap" / "host.json").write_text(json.dumps(host))
    with caplog.at_level("WARNING", logger="sitewhere_tpu_torch.utils.checkpoint"):
        recover_engine(tmp_path / "snap", device="cpu")
    assert any("warp_drive" in r.getMessage() for r in caplog.records)


def _with_assets(eng):
    eng.register_device("as-dev", area="north")
    eng.create_assignment("as-dev", token="as-a", asset="pump-7")
    eng.create_assignment("as-dev", token="as-b", asset="valve-2", area="east")
    eng.update_assignment("as-a", asset="pump-8")
    eng.flush()


def test_assets_survive_a_round_trip_jax_port_jax(tmp_path):
    """A JAX snapshot whose assignments carry assets restores into the port
    with the asset names; the port's next snapshot restores into the JAX
    package with the same names, and the asset ids stay resolvable."""
    jeng = JaxEngine(JaxEngineConfig(**SIZES))
    _with_assets(jeng)
    jax_checkpoint.save_engine(jeng, tmp_path / "jax")
    port = recover_engine(tmp_path / "jax", device="cpu")
    names = [jeng.assets.token(i) for i in range(len(jeng.assets))]
    assert names == ["pump-7", "valve-2", "pump-8"]
    assert [port.assets.token(i) for i in range(len(port.assets))] == names
    assert port.get_assignment("as-a").asset == "pump-8"
    # a new asset in the port interns after the restored ones
    port.create_assignment("as-dev", token="as-c", asset="fan-1")
    save_engine(port, tmp_path / "port")
    back = jax_checkpoint.restore_engine(tmp_path / "port")
    assert [back.assets.token(i) for i in range(len(back.assets))] == names + ["fan-1"]
    asset_col = np.asarray(jax.device_get(back.state.registry.assignment_asset))
    for tok in ("as-a", "as-b", "as-c"):
        info = back.get_assignment(tok)
        assert back.assets.token(int(asset_col[info.id])) == info.asset


def test_refused_strict_request_is_never_durable(tmp_path):
    """A strict rejection leaves no WAL record, so recovery replays cleanly
    and sees only the accepted rows (the JAX package's
    ``test_strict_channels_reject_precedes_wal``)."""
    eng = Engine(EngineConfig(
        device_capacity=32, token_capacity=64, assignment_capacity=64,
        store_capacity=512, batch_capacity=8, channels=3,
        strict_channels=True, use_native=False,
        wal_dir=str(tmp_path / "wal")), device="cpu")
    save_engine(eng, tmp_path / "snap")   # empty snapshot; the WAL replays all
    eng.process(DecodedRequest(type=RequestType.DEVICE_MEASUREMENT,
                               device_token="wr-1", measurements={"a": 1.0}))
    with pytest.raises(ChannelCapacityError):
        eng.process(DecodedRequest(
            type=RequestType.DEVICE_MEASUREMENT, device_token="wr-1",
            measurements={"b": 2.0, "c": 3.0, "d": 4.0}))

    def meas(name):
        return generate_measurements_message("wr-1", 0, name=name)

    assert eng.ingest_json_batch([meas("e")])["failed"] == 0   # no lane leaked
    with pytest.raises(ChannelCapacityError):   # 2 used + 3 new > 3
        eng.ingest_json_batch([meas("f"), meas("g"), meas("h")])
    eng.flush()
    assert eng.metrics()["persisted"] == 2
    eng.wal.close()
    records = list(IngestLog(tmp_path / "wal", readonly=True).replay())
    assert len(records) == 2
    rec = recover_engine(tmp_path / "snap", device="cpu")
    rec.flush()
    assert rec.metrics()["persisted"] == 2
    assert [rec.channel_map.names.token(i) for i in range(2)] == ["a", "e"]
    rec.wal.close()


def test_snapshot_keys_are_the_jax_paths(tmp_path):
    jeng = JaxEngine(JaxEngineConfig(**SIZES, analytics_devices=8, analytics_window=4))
    teng = Engine(EngineConfig(**SIZES, analytics_devices=8, analytics_window=4),
                  device="cpu")
    jax_checkpoint.save_engine(jeng, tmp_path / "j")
    save_engine(teng, tmp_path / "t")
    with np.load(tmp_path / "j" / "state.npz") as j, np.load(tmp_path / "t" / "state.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for key in j.files:
            assert j[key].dtype == t[key].dtype and np.array_equal(j[key], t[key]), key
    # a port snapshot's config is a subset of the JAX one's
    host = json.loads((tmp_path / "t" / "host.json").read_text())
    assert set(host["config"]) <= {f.name for f in dataclasses.fields(JaxEngineConfig)}
