"""Twins of ``tests/test_placement.py``: elastic placement
(``sitewhere_tpu_torch/parallel/placement.py``: the epoch-numbered slot
map, the fenced handoff, join and drain, the balance policy) on CPU
ranks.

Answer twins (``torch_cluster.twin``) hold the port's facade answers
through live moves to the JAX cluster's; the property twins run the port
copy of the JAX test (``torch_cluster.port_tests``). Both packages' slot
maps are held to each other and to the legacy partitioner here too.
"""

from tests.torch_cluster import fresh_dirs, port_tests, twin

PORT = port_tests("test_placement")


def test_initial_map_matches_legacy_partitioner():
    """``test_placement.py:98``, the port copy."""
    PORT.test_initial_map_matches_legacy_partitioner()


def test_map_moves_epoch_roundtrip_and_validation():
    """``test_placement.py:109``, the port copy."""
    PORT.test_map_moves_epoch_roundtrip_and_validation()


def test_manager_epoch_fencing_and_persistence(tmp_path):
    """``test_placement.py:131``, the port copy."""
    PORT.test_manager_epoch_fencing_and_persistence(tmp_path)


def test_fault_partition_and_delay_jitter_are_deterministic():
    """``test_placement.py:163``, the port copy."""
    PORT.test_fault_partition_and_delay_jitter_are_deterministic()


def test_decide_balance_policy():
    """``test_placement.py:198``, the port copy."""
    PORT.test_decide_balance_policy()


def test_conservation_placement_equation_is_falsifiable():
    """``test_placement.py:218``, the port copy."""
    PORT.test_conservation_placement_equation_is_falsifiable()


def test_no_runtime_surface_bypasses_the_placement_map():
    """``test_placement.py:239``, the port copy."""
    PORT.test_no_runtime_surface_bypasses_the_placement_map()


def test_every_surface_resolves_through_the_same_epoch(tmp_path, monkeypatch):
    """``test_placement.py:260``, answer twin."""
    twin(monkeypatch, "test_placement",
         "test_every_surface_resolves_through_the_same_epoch", fresh_dirs(tmp_path))


def test_live_handoff_moves_range_with_zero_acked_loss(tmp_path, monkeypatch):
    """``test_placement.py:333``, answer twin."""
    twin(monkeypatch, "test_placement",
         "test_live_handoff_moves_range_with_zero_acked_loss", fresh_dirs(tmp_path))


def test_chaos_kill_mid_handoff_aborts_to_single_owner(tmp_path, monkeypatch):
    """``test_placement.py:413``, answer twin."""
    twin(monkeypatch, "test_placement",
         "test_chaos_kill_mid_handoff_aborts_to_single_owner", fresh_dirs(tmp_path))


def test_join_and_drain_under_the_same_protocol(tmp_path, monkeypatch):
    """``test_placement.py:466``, answer twin."""
    twin(monkeypatch, "test_placement",
         "test_join_and_drain_under_the_same_protocol", fresh_dirs(tmp_path))


def test_returning_range_never_dual_applies(tmp_path, monkeypatch):
    """``test_placement.py:530``, answer twin."""
    twin(monkeypatch, "test_placement",
         "test_returning_range_never_dual_applies", fresh_dirs(tmp_path))


def test_commit_install_closes_move_and_finish_never_resurrects():
    """``test_placement.py:581``, the port copy."""
    PORT.test_commit_install_closes_move_and_finish_never_resurrects()


def test_fence_expiry_mid_ship_refuses_to_commit():
    """``test_placement.py:621``, the port copy."""
    PORT.test_fence_expiry_mid_ship_refuses_to_commit()


def test_replay_wal_tails_accepts_generator_args(tmp_path):
    """``test_placement.py:646``, the port copy."""
    PORT.test_replay_wal_tails_accepts_generator_args(tmp_path)


def test_slot_maps_match_jax_and_the_legacy_partitioner():
    """One ``owner_rank`` in the port (``placement.owner_rank``, which
    ``cluster.owner_rank`` is), byte-identical to the JAX package's; both
    genesis maps equal, and each equals the legacy partitioner."""
    from sitewhere_tpu.parallel import cluster as jcluster
    from sitewhere_tpu.parallel import placement as jplacement
    from sitewhere_tpu_torch.parallel import cluster as tcluster
    from sitewhere_tpu_torch.parallel import placement as tplacement

    assert tcluster.owner_rank is tplacement.owner_rank
    toks = [f"tok-{i}" for i in range(512)] + ["\U0001F600-dev", ""]
    for n in (1, 2, 3, 8, 24):
        assert [tplacement.owner_rank(t, n) for t in toks] == \
            [jcluster.owner_rank(t, n) for t in toks]
    for n_ranks, spr, active in ((2, 8, None), (3, 8, None), (4, 4, [0, 2])):
        jm = jplacement.PlacementMap.initial(n_ranks, spr, active)
        tm = tplacement.PlacementMap.initial(n_ranks, spr, active)
        assert tm.to_dict() == jm.to_dict()
        if active is None:
            assert [tm.owner(t) for t in toks] == \
                [jcluster.owner_rank(t, n_ranks) for t in toks]
