"""Twins of ``tests/test_cluster_reshard.py``: the offline rank-count
change (``sitewhere_tpu_torch/parallel/cluster_reshard.py``: snapshot
and archive migration, then the WAL tails replayed through the live
cluster), on CPU ranks.
"""

from tests.torch_cluster import fresh_dirs, port_tests, twin

PORT = port_tests("test_cluster_reshard")


def test_pruned_wal_snapshot_archive_migration_identical_queries(tmp_path, monkeypatch):
    """``test_cluster_reshard.py:100``, answer twin."""
    twin(monkeypatch, "test_cluster_reshard",
         "test_pruned_wal_snapshot_archive_migration_identical_queries",
         fresh_dirs(tmp_path))


def test_replay_wal_tails_validates_everything_before_replaying(tmp_path):
    """``test_cluster_reshard.py:246``, the port copy."""
    PORT.test_replay_wal_tails_validates_everything_before_replaying(tmp_path)
