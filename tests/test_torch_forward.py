"""Twins of ``tests/test_forward.py``: durable cross-rank forwarding
(``sitewhere_tpu_torch/parallel/forward.py``: the spill queue, its
retry pump, the owner-side forward registry) on two CPU ranks.

Answer twins (``torch_cluster.twin``) hold the port's facade answers to
the JAX cluster's through the same spill/redeliver cycle; the property
twins run the port copy of the JAX test (``torch_cluster.port_tests``).
"""

from tests.torch_cluster import fresh_dirs, port_tests, twin

PORT = port_tests("test_forward")


def test_down_owner_spills_instead_of_raising_and_redelivers(tmp_path, monkeypatch):
    """``test_forward.py:56``, answer twin."""
    twin(monkeypatch, "test_forward",
         "test_down_owner_spills_instead_of_raising_and_redelivers",
         fresh_dirs(tmp_path))


def test_redelivery_is_suppressed_by_forward_registry(tmp_path, monkeypatch):
    """``test_forward.py:111``, answer twin."""
    twin(monkeypatch, "test_forward",
         "test_redelivery_is_suppressed_by_forward_registry", fresh_dirs(tmp_path))


def test_retry_budget_moves_to_deadletter_not_drops(tmp_path):
    """``test_forward.py:149``, the port copy."""
    PORT.test_retry_budget_moves_to_deadletter_not_drops(tmp_path)


def test_envelope_forwarding_spills_and_redelivers(tmp_path, monkeypatch):
    """``test_forward.py:174``, answer twin."""
    twin(monkeypatch, "test_forward",
         "test_envelope_forwarding_spills_and_redelivers", fresh_dirs(tmp_path))


def test_circuit_breaker_spills_fast_after_first_failure(tmp_path, monkeypatch):
    """``test_forward.py:201``, answer twin."""
    twin(monkeypatch, "test_forward",
         "test_circuit_breaker_spills_fast_after_first_failure", fresh_dirs(tmp_path))


def test_cluster_status_reports_down_peer_via_circuit(tmp_path):
    """``test_forward.py:234``, the port copy."""
    PORT.test_cluster_status_reports_down_peer_via_circuit(tmp_path)


def test_poison_batch_does_not_block_the_queue(tmp_path, monkeypatch):
    """``test_forward.py:268``, answer twin."""
    twin(monkeypatch, "test_forward",
         "test_poison_batch_does_not_block_the_queue", fresh_dirs(tmp_path))


def test_transport_failures_still_preserve_order(tmp_path):
    """``test_forward.py:306``, the port copy."""
    PORT.test_transport_failures_still_preserve_order(tmp_path)


def test_post_horizon_redelivery_rejected_not_reapplied(tmp_path, monkeypatch):
    """``test_forward.py:329``, answer twin."""
    twin(monkeypatch, "test_forward",
         "test_post_horizon_redelivery_rejected_not_reapplied", fresh_dirs(tmp_path))
