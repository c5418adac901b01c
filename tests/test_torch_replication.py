"""Twins of ``tests/test_replication.py``: event-plane replication
(``sitewhere_tpu_torch/parallel/replication.py``: the replica feed, the
follower's standby stores, failover reads, schedule fire-over) on CPU
ranks.

Answer twins (``torch_cluster.twin``) hold the facade answers and the
owner and standby stores read back to the JAX cluster's, byte for byte
with pinned staging clocks; the property twins run the port copy of the
JAX test (``torch_cluster.port_tests``): LWW, chaos and kill-and-recover
assert properties there too.
"""

import pytest

from tests.torch_cluster import fresh_dirs, port_tests, twin

PORT = port_tests("test_replication")


def test_replica_ring_is_deterministic_and_disjoint():
    """``test_replication.py:81``, the port copy."""
    PORT.test_replica_ring_is_deterministic_and_disjoint()


def test_follower_store_byte_equal_after_replicated_stream(tmp_path, monkeypatch):
    """``test_replication.py:92``, answer twin."""
    twin(monkeypatch, "test_replication",
         "test_follower_store_byte_equal_after_replicated_stream", fresh_dirs(tmp_path))


def test_wal_resync_rebuilds_standby_from_full_history(tmp_path):
    """``test_replication.py:140``, the port copy."""
    PORT.test_wal_resync_rebuilds_standby_from_full_history(tmp_path)


def test_failover_reads_served_by_follower_with_stale_ms(tmp_path, monkeypatch):
    """``test_replication.py:169``, answer twin."""
    twin(monkeypatch, "test_replication",
         "test_failover_reads_served_by_follower_with_stale_ms", fresh_dirs(tmp_path))


def test_no_acked_event_lost_on_owner_kill_and_recovery(tmp_path, monkeypatch):
    """``test_replication.py:208``, answer twin."""
    twin(monkeypatch, "test_replication",
         "test_no_acked_event_lost_on_owner_kill_and_recovery", fresh_dirs(tmp_path))


def test_scheduler_fireover_fencing_and_no_double_fire(tmp_path):
    """``test_replication.py:282``, the port copy."""
    PORT.test_scheduler_fireover_fencing_and_no_double_fire(tmp_path)


def test_cron_catchup_fires_missed_window_once():
    """``test_replication.py:366``, the port copy."""
    PORT.test_cron_catchup_fires_missed_window_once()


def test_fault_injector_is_deterministic_and_kills(tmp_path):
    """``test_replication.py:392``, the port copy."""
    PORT.test_fault_injector_is_deterministic_and_kills(tmp_path)


def test_peer_health_state_machine():
    """``test_replication.py:429``, the port copy."""
    PORT.test_peer_health_state_machine()


@pytest.mark.slow
def test_chaos_kill_recover_loop(tmp_path):
    """``test_replication.py:446``, the port copy."""
    PORT.test_chaos_kill_recover_loop(tmp_path)
