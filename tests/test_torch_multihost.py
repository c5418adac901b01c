"""The port's two-process sharded job (``parallel/multihost_demo.py``)
held to the JAX package's ``spawn_two_process_demo`` (2 processes x 4
shards, 3 steps of 8 events a shard, the global metrics after every step,
the global store scan and the mesh-wide presence sweep), and the global
shard numbering of ``parallel/multihost.py`` / ``ShardedEngine`` across
processes and without a group.

The port's processes form a gloo group through a ``file://`` store and
keep their shards on the CPU here (on the GPU machine, on ``cuda:0``);
JAX's form one ``jax.distributed`` job over the CPU backend.
"""

import numpy as np
import pytest
import torch

from sitewhere_tpu.parallel.multihost_demo import \
    spawn_two_process_demo as jax_spawn_two_process_demo
from sitewhere_tpu_torch.parallel import multihost
from sitewhere_tpu_torch.parallel.multihost_demo import run_two_process_demo
from sitewhere_tpu_torch.parallel.sharded import ShardedEngine
from tests.torch_parity import multihost_worker, run_on_gloo_ranks


@pytest.fixture(scope="module")
def demo():
    return run_two_process_demo(devices_per_proc=4, device="cpu", timeout_s=240)


def test_two_process_lines_equal_the_jax_demo(demo):
    lines = demo["ok"]
    assert len(lines) == 2
    by_rank = sorted(lines)
    assert "rank=0/2" in by_rank[0] and "rank=1/2" in by_rank[1]
    # both ranks read identical global totals over the 8 shards
    assert by_rank[0].split("persisted=")[1] == by_rank[1].split("persisted=")[1]
    assert "persisted=192" in by_rank[0] and "store_valid=192" in by_rank[0]
    assert "missing=64" in by_rank[0]
    assert "shards=[0, 1, 2, 3]" in by_rank[0]
    assert "shards=[4, 5, 6, 7]" in by_rank[1]
    # line for line what the JAX demo prints: totals and ownership
    assert by_rank == sorted(jax_spawn_two_process_demo(devices_per_proc=4))


def test_two_process_shards_stay_on_their_device(demo):
    assert demo["placed"] == [f"MULTIHOST_PLACED rank={r}/2 device=cpu tensors=216"
                              for r in range(2)]


def test_worker_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="multi-process demo failed"):
        run_two_process_demo(devices_per_proc=1, device="cuda", timeout_s=120)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_on_gloo_ranks(multihost_worker, 2, tmp_path_factory.mktemp("gloo_mh"))


def test_global_numbering_across_processes(ranks):
    for r, out in enumerate(ranks):
        assert out["local"] == [2 * r, 2 * r + 1]
        assert (out["n_shards"], out["n_local"], out["offset"]) == (4, 2, 2 * r)
        # the host sums over the group: shard s took s + 1 events
        assert out["metrics"]["processed"] == 1 + 2 + 3 + 4
        assert out["metrics"]["registered"] == 10
        assert out["sum"] == [3, 20]
        # the sweep names global shards, this process's own
        assert sorted({s for s, _ in out["missing"]}) == out["local"]
        assert out["summary_shard"] == out["local"][-1]
        assert "missing batches for local shards" in out["refused"]["assemble"]


def test_engines_not_given_the_group_keep_their_local_shards(ranks):
    """Inside a 2-rank gloo group, a ``ShardedEngine`` or a
    ``DistributedEngine`` built without ``process_group`` holds only this
    process's shards: numbered from 0, counted and queried alone."""
    for r, out in enumerate(ranks):
        alone = out["alone"]
        assert alone["local"] == [0, 1]
        assert (alone["n_shards"], alone["n_local"], alone["offset"]) == (2, 2, 0)
        # this rank's own events only: shards 2r and 2r + 1 took 2r + 1 and 2r + 2
        assert alone["metrics"]["processed"] == (2 * r + 1) + (2 * r + 2)
        assert alone["events"] == (2 * r + 1) + (2 * r + 2)
        assert alone["distributed_n_shards"] == 2
        assert alone["distributed_sharded"] == [2, 2]
        assert alone["buffer_shards"] == 2


@pytest.mark.parametrize("what", ["query_events", "save", "exchange"])
def test_cross_process_limits_are_refused_with_the_limit_named(ranks, what):
    for out in ranks:
        assert "span 2 processes" in out["refused"][what], out["refused"]


def test_single_process_is_unchanged():
    """No process group: every shard is local and numbered from 0, the
    counts are this process's own, and ``all_sum`` is the identity."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    eng = ShardedEngine(n_shards=3, device_capacity_per_shard=16,
                        token_capacity_per_shard=32, assignment_capacity_per_shard=32,
                        store_capacity_per_shard=64, channels=4, device="cpu")
    assert multihost.local_shard_ids(eng.mesh) == [0, 1, 2]
    assert (eng.n_shards, eng.n_local, eng.shard_offset) == (3, 3, 0)
    assert multihost.group_span() == (0, 1)
    assert multihost.all_sum([4, 5]) == [4, 5]
    assert eng.global_metrics() == {k: 0 for k in eng.global_metrics()}
    assert eng.query_events()["total"] == 0
    with pytest.raises(ValueError, match="not one of this process's"):
        eng.device_state_summary(3, 0)
    np.testing.assert_array_equal(
        [s for s, _ in eng.presence_sweep(10, 0)], [])
