"""Durability of the port's mesh engine held to the JAX package's on the CPU:
twins of the cases of ``tests/test_distributed_durability.py`` (snapshot and
restore, WAL crash recovery, the unknown-tenant guard, recovery from a
preserved WAL copy, N -> M resharding through the port's
``parallel/reshard.py``, the ring overflow of a merge), each run on a JAX and
a port ``DistributedEngine`` fed the same payloads with both clocks pinned
(the restored engines too), compared byte for byte; and the snapshot
crossing both ways: a JAX snapshot restored by the port, a port snapshot
restored by the JAX package, with equal pages and state."""

import json
import shutil

import numpy as np
import pytest

import sitewhere_tpu.parallel.distributed as jdist
import sitewhere_tpu_torch.parallel.distributed as tdist
from sitewhere_tpu.core.events import EpochBase as JaxEpochBase
from sitewhere_tpu.parallel.reshard import reshard_snapshot as jax_reshard
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.parallel.reshard import reshard_snapshot
from tests.test_distributed_durability import cfg as jax_cfg
from tests.test_distributed_durability import meas
from tests.torch_spmd import assert_state_equal

NOW_MS = 500_000


class JaxPinned(JaxEpochBase):
    def now_ms(self) -> int:
        return NOW_MS


class Pinned(EpochBase):
    def now_ms(self) -> int:
        return NOW_MS


@pytest.fixture(autouse=True)
def pinned_jax_restore(monkeypatch):
    """The JAX restore builds its clock from the module's ``EpochBase``:
    pin it as the port's restore is pinned (``epoch_cls``)."""
    monkeypatch.setattr(jdist, "EpochBase", JaxPinned)


def engines(port_wal=None, **kw):
    """A JAX and a port engine of one config (the port's WAL in
    ``port_wal``), clocks pinned."""
    c = jax_cfg(**kw).__dict__
    j = jdist.DistributedEngine(jdist.DistributedConfig(**c))
    t = tdist.DistributedEngine(tdist.DistributedConfig(
        **{**c, "wal_dir": port_wal and str(port_wal)}, device="cpu"))
    j.epoch, t.epoch = JaxPinned(0.0), Pinned(0.0)
    return j, t


def both(j, t, fn):
    a, b = fn(j), fn(t)
    if isinstance(a, dict):
        a, b = ({k: v for k, v in x.items() if k != "trace_id"} for x in (a, b))
    assert a == b
    return b


def fill(e, n: int = 24) -> None:
    """``test_distributed_durability.fill_engine``."""
    base_ms = int(e.epoch.base_unix_s * 1000)
    e.ingest_json_batch([meas(f"d-{i}", float(i), ts_ms=base_ms + i * 100)
                         for i in range(n)])
    e.register_device("adm-0", tenant="acme", area="plant")
    e.create_assignment("adm-0", token="adm-0:x", asset="press")
    e.flush()


def event_key_set(e) -> set:
    return {(x["deviceToken"], x["type"], x["eventDateMs"])
            for x in e.query_events(limit=200)["events"]}


def pages(e) -> list:
    return [e.query_events(**kw) for kw in (
        dict(limit=200), dict(limit=7), dict(device_token="d-5"),
        dict(tenant="acme"), dict(since_ms=500, until_ms=1500, limit=50))]


def restore_both(jdir, tdir):
    return (jdist.restore_distributed(jdir),
            tdist.restore_distributed(tdir, device="cpu", epoch_cls=Pinned))


def assert_engines_equal(j, t) -> None:
    assert_state_equal(j, t)
    assert j.metrics() == t.metrics()
    assert pages(j) == pages(t)
    assert ({k: v.__dict__ for k, v in j.devices.items()}
            == {k: v.__dict__ for k, v in t.devices.items()})
    assert ({k: v.__dict__ for k, v in j.assignments.items()}
            == {k: v.__dict__ for k, v in t.assignments.items()})


def test_snapshot_restore_roundtrip(tmp_path):
    j, t = engines()
    for e in (j, t):
        fill(e)
    before_events = event_key_set(t)
    before_state = both(j, t, lambda e: e.get_device_state("d-5"))
    j.save(tmp_path / "j")
    t.save(tmp_path / "t")
    j2, t2 = restore_both(tmp_path / "j", tmp_path / "t")
    assert event_key_set(t2) == before_events
    assert t2.get_device_state("d-5") == before_state
    assert t2.get_device("adm-0").tenant == "acme"
    assert t2.get_assignment("adm-0:x").asset == "press"
    assert t.metrics()["persisted"] == t2.metrics()["persisted"]
    assert_engines_equal(j2, t2)
    out = both(j2, t2, lambda e: (e.ingest_json_batch([meas("d-5", 99.0)]), e.flush())[1])
    assert out["found"] == 1 and out["registered"] == 0
    assert_engines_equal(j2, t2)


def test_wal_crash_recovery(tmp_path):
    j, t = engines(wal_dir=str(tmp_path / "jwal"), port_wal=tmp_path / "twal")
    for e, name in ((j, "j"), (t, "t")):
        fill(e, n=16)
        e.save(tmp_path / f"snap_{name}")
        e.ingest_json_batch([meas(f"late-{i}", 50.0 + i, ts_ms=5000 + i)
                             for i in range(8)])
        e.flush()
    expected = event_key_set(t)
    n_persisted = t.metrics()["persisted"]
    for e in (j, t):
        e.wal.close()   # crash
    j2 = jdist.recover_distributed(tmp_path / "snap_j")
    t2 = tdist.recover_distributed(tmp_path / "snap_t", device="cpu", epoch_cls=Pinned)
    assert t2.metrics()["persisted"] == n_persisted
    assert event_key_set(t2) == expected
    assert t2.get_device_state("late-3")["measurements"]["m"]["value"] == 53.0
    assert_engines_equal(j2, t2)
    for e in (j2, t2):
        e.wal.close()


def test_unknown_tenant_matches_nothing():
    j, t = engines()
    both(j, t, lambda e: e.ingest_json_batch([meas("t-0", 1.0)], tenant="acme"))
    both(j, t, lambda e: e.flush())
    assert both(j, t, lambda e: e.query_events(tenant="acme"))["total"] == 1
    assert both(j, t, lambda e: e.query_events(tenant="no-such-tenant"))["total"] == 0


def test_recovery_from_preserved_wal_copy(tmp_path):
    j, t = engines(wal_dir=str(tmp_path / "j" / "wal"),
                   port_wal=tmp_path / "t" / "wal")
    got = []
    for e, name, mod in ((j, "j", jdist), (t, "t", tdist)):
        root = tmp_path / name
        e.save(root / "snap")
        e.ingest_json_batch([meas(f"w-{i}", float(i), ts_ms=i) for i in range(6)])
        e.flush()
        e.wal.close()
        shutil.copytree(root / "wal", root / "copy")
        listing = sorted(p.name for p in (root / "copy").iterdir())
        hostp = root / "snap" / "host_distributed.json"
        h = json.loads(hostp.read_text())
        h["config"]["wal_dir"] = None
        hostp.write_text(json.dumps(h))
        kw = {} if mod is jdist else dict(device="cpu", epoch_cls=Pinned)
        e2 = mod.recover_distributed(root / "snap", wal_dir=root / "copy", **kw)
        assert e2.metrics()["persisted"] == 6
        assert sorted(p.name for p in (root / "copy").iterdir()) == listing
        assert e2.wal is None
        got.append(e2)
    assert_engines_equal(*got)


@pytest.mark.parametrize("m_new", [2, 8])
def test_reshard_preserves_state(tmp_path, m_new):
    j, t = engines()
    for e, name in ((j, "j"), (t, "t")):
        fill(e)
        e.ingest_json_batch([meas("d-3", 7.5)])
        e.flush()
        e.save(tmp_path / f"snap_{name}")
    before_events = event_key_set(t)
    before_states = {tok: t.get_device_state(tok)
                     for tok in ("d-0", "d-3", "d-11", "adm-0")}
    for s in before_states.values():
        s.pop("shard", None)
    before_metrics = t.metrics()
    jax_reshard(tmp_path / "snap_j", tmp_path / "re_j", m_new)
    reshard_snapshot(tmp_path / "snap_t", tmp_path / "re_t", m_new)
    # the port's reshard of the JAX snapshot writes the JAX reshard's arrays
    reshard_snapshot(tmp_path / "snap_j", tmp_path / "re_jt", m_new)
    a = np.load(tmp_path / "re_j" / "sharded_state.npz")
    b = np.load(tmp_path / "re_jt" / "sharded_state.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    j2, t2 = restore_both(tmp_path / "re_j", tmp_path / "re_t")
    assert t2.n_shards == m_new
    assert event_key_set(t2) == before_events
    for tok, st in before_states.items():
        st2 = t2.get_device_state(tok)
        st2.pop("shard", None)
        assert st2 == st, tok
    m2 = t2.metrics()
    for k in ("processed", "found", "missed", "registered", "persisted"):
        assert m2[k] == before_metrics[k], k
    a = t2.get_assignment("adm-0:x")
    assert a is not None and a.device_token == "adm-0" and a.asset == "press"
    assert_engines_equal(j2, t2)
    out = both(j2, t2, lambda e: (e.ingest_json_batch(
        [meas("d-3", 8.5), meas("fresh-0", 1.0)]), e.flush())[1])
    assert out["found"] == 2 and out["registered"] == 1
    st = t2.get_device_state("d-3")
    assert st["measurements"]["m"]["value"] == 8.5
    assert st["event_counts"]["MEASUREMENT"] == 3
    assert_engines_equal(j2, t2)


def test_reshard_ring_overflow(tmp_path):
    j, t = engines(store_capacity_per_shard=64, batch_capacity_per_shard=16)
    for e, name in ((j, "j"), (t, "t")):
        e.ingest_json_batch([meas(f"ov-{i % 16}", float(i), ts_ms=i * 10)
                             for i in range(128)])
        e.flush()
        e.save(tmp_path / f"snap_{name}")
    jax_reshard(tmp_path / "snap_j", tmp_path / "one_j", 1)
    reshard_snapshot(tmp_path / "snap_t", tmp_path / "one_t", 1)
    j2, t2 = restore_both(tmp_path / "one_j", tmp_path / "one_t")
    res = both(j2, t2, lambda e: e.query_events(limit=64))
    assert res["total"] == 64
    assert max(e["eventDateMs"] for e in res["events"]) == 1270
    assert_engines_equal(j2, t2)


# ------------------------------------------------------- the snapshot crossing

def test_jax_snapshot_restores_in_the_port(tmp_path):
    """A snapshot the JAX package wrote restores in the port (its config
    has no port-only field; the shards land where ``device`` says) with the
    JAX engine's state, pages and device states, and both keep ingesting
    alike."""
    j, _ = engines()
    fill(j)
    j.save(tmp_path / "snap")
    t = tdist.restore_distributed(tmp_path / "snap", device="cpu", epoch_cls=Pinned)
    assert t.config.device == "cpu" and t.config.wal_group_commit is False
    assert_engines_equal(j, t)
    assert (j.get_device_state("d-7") == t.get_device_state("d-7")
            and j.get_device_state("adm-0") == t.get_device_state("adm-0"))
    wire = [meas(f"d-{i}", 100.0 + i, ts_ms=9_000 + i) for i in range(30)]
    both(j, t, lambda e: e.ingest_json_batch(wire))
    both(j, t, lambda e: e.flush())
    assert_engines_equal(j, t)


def test_port_snapshot_restores_in_jax(tmp_path):
    """A snapshot the port wrote restores in the JAX package (the JAX
    config takes its ``config`` as it is) with equal state and pages."""
    _, t = engines()
    fill(t)
    t.save(tmp_path / "snap")
    host = json.loads((tmp_path / "snap" / "host_distributed.json").read_text())
    assert "device" not in host["config"] and host["port_config"] == {
        "wal_group_commit": False}
    j = jdist.restore_distributed(tmp_path / "snap")
    assert_engines_equal(j, t)
    assert j.get_device_state("d-7") == t.get_device_state("d-7")
    wire = [meas(f"n-{i}", float(i), ts_ms=9_000 + i) for i in range(30)]
    both(j, t, lambda e: e.ingest_json_batch(wire))
    both(j, t, lambda e: e.flush())
    assert_engines_equal(j, t)
