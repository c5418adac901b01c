"""The port's stripped-down sharded engine (``parallel/sharded.ShardedEngine``)
and its router, exchange and multi-host helpers, held to the JAX package's
on the CPU: the five cases of ``tests/test_sharded.py`` — host-routed
steps, the exchange path against the routed one, the exchange overflow
count, global query / presence sweep / snapshot, and the multi-host
helpers — each on the same seeded stream through both, compared byte for
byte. The JAX engines run over 8 virtual CPU devices, the port's 8 shards
all on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sitewhere_tpu.core.events import HostEventBuffer as JaxBuffer
from sitewhere_tpu.core.types import EventType
from sitewhere_tpu.parallel.multihost import assemble_stacked_batch as jax_assemble
from sitewhere_tpu.parallel.router import ShardRouter as JaxRouter
from sitewhere_tpu.parallel.sharded import ShardedEngine as JaxShardedEngine
from sitewhere_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from sitewhere_tpu_torch.convert import shard_states_from_numpy
from sitewhere_tpu_torch.core.events import HostEventBuffer
from sitewhere_tpu_torch.parallel.exchange import exchange_events
from sitewhere_tpu_torch.parallel.mesh import make_mesh
from sitewhere_tpu_torch.parallel.multihost import (assemble_stacked_batch,
                                                    initialize, local_shard_ids)
from sitewhere_tpu_torch.parallel.router import ShardRouter, stack_host_batches
from sitewhere_tpu_torch.parallel.sharded import ShardedEngine
from sitewhere_tpu_torch.pipeline import PipelineConfig
from tests.torch_parity import assert_tree_equal

CHANNELS = 4
SIZES = dict(device_capacity_per_shard=32, token_capacity_per_shard=32,
             assignment_capacity_per_shard=32, store_capacity_per_shard=1024,
             channels=CHANNELS)


def _engines(exchange=False, bucket=0):
    j = JaxShardedEngine(n_shards=8, config=JaxPipelineConfig(auto_register=True),
                         exchange=exchange, bucket_capacity=bucket, **SIZES)
    t = ShardedEngine(n_shards=8, config=PipelineConfig(auto_register=True),
                      exchange=exchange, bucket_capacity=bucket, device="cpu", **SIZES)
    return j, t


def _random_stream(rng, n, n_tokens=256):   # tokens span all 8 shards' slices
    return [{"token": int(rng.integers(0, n_tokens)), "ts": int(rng.integers(0, 50)),
             "val": float(np.round(rng.random(), 3))} for _ in range(n)]


def _routed(events, capacity=64):
    jr = JaxRouter(8, 32, capacity, CHANNELS)
    tr = ShardRouter(8, 32, capacity, CHANNELS)
    for ev in events:
        for r in (jr, tr):
            assert r.append(EventType.MEASUREMENT, ev["token"], 0, ev["ts"], ev["ts"],
                            values=[ev["val"]])
    return jr.emit(), tr.emit()


def _unrouted(events, place):
    """Per-shard buffers filled by ``place(i, ev) -> shard`` with global
    token ids, stacked (JAX's and the port's)."""
    jb = [JaxBuffer(32, CHANNELS) for _ in range(8)]
    tb = [HostEventBuffer(32, CHANNELS) for _ in range(8)]
    for i, ev in enumerate(events):
        s = place(i, ev)
        for bufs in (jb, tb):
            bufs[s].append(EventType.MEASUREMENT, ev["token"], 0, ev["ts"], ev["ts"],
                           values=[ev["val"]])
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *[b.emit() for b in jb])
    return stacked, stack_host_batches([b.emit_host() for b in tb])


def _state_equal(j, t):
    assert_tree_equal(jax.device_get(j.state), t.state)


def test_sharded_engine_routed(rng):
    """Host-routed events: every shard's state and the summed counters
    equal the JAX engine's."""
    j, t = _engines()
    events = _random_stream(rng, 200)
    jb, tb = _routed(events)
    for f in dataclasses.fields(tb):
        np.testing.assert_array_equal(getattr(tb, f.name), np.asarray(getattr(jb, f.name)))
    jout, tout = j.step(jb), t.step(tb)
    for name in ("n_found", "n_missed", "n_registered", "n_persisted"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                      np.asarray(getattr(jout, name)))
    m = t.global_metrics()
    assert m == j.global_metrics()
    assert m["processed"] == m["found"] == m["persisted"] == len(events)
    assert m["registered"] == len({ev["token"] for ev in events})
    _state_equal(j, t)


def test_sharded_engine_exchange_matches_routed(rng):
    """Unrouted ingest moved by the exchange equals the JAX exchange byte
    for byte, and per token equals the host-routed run."""
    events = _random_stream(rng, 150)
    for i, ev in enumerate(events):
        ev["ts"] = i
    _, routed = _engines()
    routed.step(_routed(events)[1])
    j, t = _engines(exchange=True, bucket=32)
    jb, tb = _unrouted(events, lambda i, ev: i % 8)
    j.step(jb)
    t.step(tb)
    _state_equal(j, t)
    ma, mb = routed.global_metrics(), t.global_metrics()
    assert mb["processed"] == mb["found"] == ma["found"] == len(events)
    assert (mb["registered"], mb["persisted"]) == (ma["registered"], ma["persisted"])
    for tok in {ev["token"] for ev in events}:
        shard, local = divmod(tok, 32)
        da = int(routed.shards[shard].registry.token_to_device[local])
        db = int(t.shards[shard].registry.token_to_device[local])
        for fld in ("meas_last", "meas_last_ms", "last_interaction_ms", "recent_meas_ms"):
            assert torch.equal(getattr(routed.shards[shard].device_state, fld)[da],
                               getattr(t.shards[shard].device_state, fld)[db]), (tok, fld)


def test_exchange_overflow_counted(rng):
    """A bucket overflow is dead-lettered and counted as missed, the same
    count as JAX's."""
    j, t = _engines(exchange=True, bucket=2)
    events = [{"token": i % 8, "ts": i, "val": 1.0} for i in range(20)]
    jb, tb = _unrouted(events, lambda i, ev: 0)
    j.step(jb)
    t.step(tb)
    m = t.global_metrics()
    assert m == j.global_metrics()
    assert (m["found"], m["missed"]) == (2, 18)
    _state_equal(j, t)
    # the exchange alone: each destination's overflow is its source's
    res = exchange_events([t_b for t_b in _split(tb)], 8, 32, 2)
    assert [int(r.n_overflow) for r in res] == [18] + [0] * 7
    assert int(res[0].batch.valid.sum()) == 2


def _split(stacked):
    from sitewhere_tpu_torch.parallel.sharded import split_batch

    return split_batch(stacked, [torch.device("cpu")] * 8)


def test_sharded_query_presence_and_snapshot(rng, tmp_path):
    j, t = _engines()
    events = _random_stream(rng, 120)
    jb, tb = _routed(events)
    j.step(jb)
    t.step(tb)
    res = t.query_events(limit=50)
    assert res == j.query_events(limit=50)
    assert res["total"] == len(events) and len(res["events"]) == 50
    ts = [e["eventDateMs"] for e in res["events"]]
    assert ts == sorted(ts, reverse=True)
    assert t.query_events(etype=EventType.MEASUREMENT, limit=10) == \
        j.query_events(etype=EventType.MEASUREMENT, limit=10)
    assert t.query_events(etype=EventType.ALERT, limit=10)["total"] == 0
    tok = events[0]["token"]
    shard, local = divmod(tok, 32)
    dev = int(t.shards[shard].registry.token_to_device[local])
    summary = t.device_state_summary(shard, dev)
    assert summary == j.device_state_summary(shard, dev)
    assert summary["presence"] == "PRESENT"
    newly = t.presence_sweep(now_ms=10_000_000, missing_ms=1000)
    assert newly == j.presence_sweep(now_ms=10_000_000, missing_ms=1000)
    assert len(newly) == len({ev["token"] for ev in events})
    assert t.device_state_summary(shard, dev)["presence"] == "MISSING"
    _state_equal(j, t)
    # snapshot round trip, bit for bit; the JAX snapshot loads too
    t.save(tmp_path / "t")
    j.save(tmp_path / "j")
    for src in ("t", "j"):
        back = ShardedEngine(n_shards=8, device="cpu", **SIZES)
        back.restore(tmp_path / src)
        _state_equal(j, back)
        assert back.global_metrics() == t.global_metrics()
        assert back.query_events(limit=5)["total"] == len(events)
    four = ShardedEngine(n_shards=4, device="cpu", **SIZES)
    with pytest.raises(ValueError):
        four.restore(tmp_path / "t")
    # the JAX stacked state comes across whole through convert
    shards = shard_states_from_numpy(jax.device_get(j.state), t.mesh)
    assert all(torch.equal(a.store.ts_ms, b.store.ts_ms) for a, b in zip(shards, t.shards))


def test_multihost_helpers(rng):
    """One process: every shard local, the assembled batch equals the
    host-stacked one (and JAX's), and drives the engine the same way."""
    assert initialize() is False
    _, t = _engines()
    assert local_shard_ids(t.mesh) == list(range(8))
    assert t.mesh == make_mesh(8, ["cpu"] * 8)
    events = _random_stream(rng, 40)
    jb, tb = _routed(events, capacity=16)
    per_shard = {i: type(tb)(**{f.name: getattr(tb, f.name)[i]
                                for f in dataclasses.fields(tb)})
                 for i in range(8)}
    glued = assemble_stacked_batch(t.mesh, per_shard)
    jglued = jax_assemble(_engines()[0].mesh, {
        i: jax.tree_util.tree_map(lambda x: np.asarray(x)[i], jb) for i in range(8)})
    for f in dataclasses.fields(tb):
        got = torch.stack([getattr(g, f.name) for g in glued]).numpy()
        np.testing.assert_array_equal(got, getattr(tb, f.name))
        np.testing.assert_array_equal(got, np.asarray(getattr(jglued, f.name)))
    t.step(glued)
    assert t.global_metrics()["processed"] == len(events)
    with pytest.raises(ValueError):
        assemble_stacked_batch(t.mesh, {0: per_shard[0]})
    with pytest.raises(ValueError):
        initialize("localhost:1")


def test_make_mesh_is_the_one_placement_rule():
    """A list is taken as it is; one device holds every shard; a bare
    "cuda" spreads the shards over the visible GPUs and, with none, raises
    (no CPU default). Both engines place their shards through it."""
    cpu = torch.device("cpu")
    assert make_mesh(3, ["cpu", "cpu", "cpu"]) == [cpu] * 3
    assert make_mesh(None, ["cpu"] * 2) == [cpu] * 2
    assert make_mesh(4, "cpu") == [cpu] * 4
    assert make_mesh(None, "cpu") == [cpu]
    with pytest.raises(ValueError, match="3 shards over 2 devices"):
        make_mesh(3, ["cpu"] * 2)
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert make_mesh(2 * n) == [torch.device("cuda", i % n) for i in range(2 * n)]
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh(2)
    assert ShardedEngine(n_shards=2, device="cpu", **SIZES).mesh == [cpu] * 2
