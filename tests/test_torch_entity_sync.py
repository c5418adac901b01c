"""Twins of ``tests/test_entity_sync.py``: the replicated entity plane
(``sitewhere_tpu_torch/parallel/entity_sync.py``) over two CPU ranks'
instances.

Answer twins (``torch_cluster.twin``) hold the facade answers to the JAX
cluster's; the property twins run the port copy of the JAX test
(``torch_cluster.port_tests``: LWW under shuffled delivery, compaction,
tombstone GC). ``test_entity_state_matches_jax`` holds the replicated
entity state itself to the JAX package's.
"""

from tests.torch_cluster import fresh_dirs, port_tests, twin

PORT = port_tests("test_entity_sync")


def test_entity_plane_replicates_from_any_rank(tmp_path, monkeypatch):
    """``test_entity_sync.py:50``, answer twin."""
    twin(monkeypatch, "test_entity_sync",
         "test_entity_plane_replicates_from_any_rank", fresh_dirs(tmp_path))


def test_closure_updates_groups_and_alarm_enums_replicate(tmp_path, monkeypatch):
    """``test_entity_sync.py:112``, answer twin."""
    twin(monkeypatch, "test_entity_sync",
         "test_closure_updates_groups_and_alarm_enums_replicate", fresh_dirs(tmp_path))


def test_users_and_tenants_replicate(tmp_path):
    """``test_entity_sync.py:156``, the port copy."""
    PORT.test_users_and_tenants_replicate(tmp_path)


def test_recovery_replay_and_anti_entropy(tmp_path):
    """``test_entity_sync.py:190``, the port copy."""
    PORT.test_recovery_replay_and_anti_entropy(tmp_path)


def test_lww_converges_under_any_delivery_order(tmp_path):
    """``test_entity_sync.py:234``, the port copy."""
    PORT.test_lww_converges_under_any_delivery_order(tmp_path)


def test_codec_roundtrips_nested_and_enum_fields():
    """``test_entity_sync.py:268``, the port copy."""
    PORT.test_codec_roundtrips_nested_and_enum_fields()


def test_concurrent_creates_never_collide_on_ids(tmp_path):
    """``test_entity_sync.py:289``, the port copy."""
    PORT.test_concurrent_creates_never_collide_on_ids(tmp_path)


def test_compaction_bounds_index_and_late_joiner_state_transfer(tmp_path):
    """``test_entity_sync.py:314``, the port copy."""
    PORT.test_compaction_bounds_index_and_late_joiner_state_transfer(tmp_path)


def test_state_transfer_pages_over_shrunken_frame_cap(tmp_path, monkeypatch):
    """``test_entity_sync.py:379``, the port copy."""
    PORT.test_state_transfer_pages_over_shrunken_frame_cap(tmp_path, monkeypatch)


def test_compacted_journal_restart_replays_dump_plus_tail(tmp_path):
    """``test_entity_sync.py:440``, the port copy."""
    PORT.test_compacted_journal_restart_replays_dump_plus_tail(tmp_path)


def test_concurrent_mutations_with_compaction_storm_converge(tmp_path):
    """``test_entity_sync.py:481``, the port copy."""
    PORT.test_concurrent_mutations_with_compaction_storm_converge(tmp_path)


def test_tombstone_gc_safe_horizon_never_resurrects(tmp_path):
    """``test_entity_sync.py:536``, the port copy."""
    PORT.test_tombstone_gc_safe_horizon_never_resurrects(tmp_path)


def test_tombstone_gc_waits_for_lagging_peer(tmp_path):
    """``test_entity_sync.py:587``, the port copy."""
    PORT.test_tombstone_gc_waits_for_lagging_peer(tmp_path)


def _entity_state(P, module, tmp_path):
    """Rank 0 of a two-rank replicated instance pair (``module``'s
    ``_mk_replicated``) creates a device type, a command and a user, and
    rank 1 logs the user in; returns both ranks' state dumps after the
    pushes drain, each entry less its LWW stamp (the wall clock)."""
    cmd = P.mod("commands.model")
    clusters, insts, reps, host = module._mk_replicated(tmp_path)
    try:
        insts[0].device_management.create_device_type("sensor-x", "Sensor X")
        insts[0].command_registry.create(cmd.DeviceCommand(
            token="calibrate", device_type="sensor-x", name="calibrate"))
        insts[0].users.create_user("operator", "s3cret", roles=["user"])
        reps[0].drain_pushes()
        assert insts[1].users.authenticate("operator", "s3cret").username == "operator"
        dumps = []
        for rep in reps:
            d = rep.state_dump()
            d["entries"] = [{k: v for k, v in e.items() if k != "ts"}
                            for e in d["entries"]]
            dumps.append(d)
        return dumps
    finally:
        module._close_all(clusters, reps, host)


def test_entity_state_matches_jax(tmp_path, monkeypatch):
    """Device types, commands and users created at rank 0 read back at
    rank 1 identically, and both ranks' entity state equals the JAX
    cluster's (entity, auth and salt clocks pinned)."""
    import tests.test_entity_sync as jax_tests
    from tests.torch_parity import plain
    from tests.torch_services import J, T
    from tests.torch_servers import pin_servers

    pin_servers(monkeypatch)
    dirs = fresh_dirs(tmp_path)
    jdumps = _entity_state(J, jax_tests, dirs())
    tdumps = _entity_state(T, PORT, dirs())
    assert plain(tdumps) == plain(jdumps)
    r0, r1 = ({(e["kind"], e["token"]): e["state"] for e in d["entries"]}
              for d in plain(tdumps))
    assert set(r1) == set(r0) == {("device-type", "sensor-x"),
                                  ("device-command", "calibrate"),
                                  ("user", "operator")}
    for key in (("device-type", "sensor-x"), ("device-command", "calibrate")):
        assert r1[key] == r0[key]
    # the login at rank 1 stamps its own copy only
    assert {k: v for k, v in r1["user", "operator"].items() if k != "last_login_ms"} \
        == {k: v for k, v in r0["user", "operator"].items() if k != "last_login_ms"}
