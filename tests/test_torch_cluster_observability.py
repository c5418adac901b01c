"""Twins of ``tests/test_cluster_observability.py``: the federated scrape,
exemplars, the forward-hop histogram, per-peer staleness and the REST
metrics route of a port cluster on CPU ranks.

Answer twins (``torch_cluster.twin``) hold each scrape's family names
to the JAX cluster's (less the JAX package's XLA compile plane); the
property twins run the port copy of the JAX test. The lint-clean case is
written out: the port exports no XLA compile counters, and holds the
rest of that case.
"""

import re

import pytest

from tests.torch_cluster import fresh_dirs, port_tests, twin

PORT = port_tests("test_cluster_observability")


def test_cluster_metrics_is_one_lint_clean_rank_labeled_exposition(tmp_path):
    """``test_cluster_observability.py:39``: the JAX case on the port,
    less its XLA compile counters (the port exports the memory half of
    the device plane only; the answer twins below hold the other family
    names to the JAX scrape's)."""
    from tests.test_metrics_exposition import lint_prometheus

    clusters, host, _ = PORT._mk_cluster(tmp_path / "lint")
    c0, _c1 = clusters
    try:
        PORT._ingest_both_ranks(c0)
        text = c0.cluster_metrics()
        lint_prometheus(text)
        assert 'rank="0"' in text and 'rank="1"' in text
        assert 'swtpu_cluster_rank_up{rank="0"} 1' in text
        assert 'swtpu_cluster_rank_up{rank="1"} 1' in text
        assert text.count("# HELP swtpu_engine_persisted") == 1
        assert text.count("# TYPE swtpu_ingest_e2e_seconds histogram") == 1
        assert 'swtpu_ingest_e2e_seconds_bucket{' in text
        for rank in ("0", "1"):
            assert re.search(
                rf'swtpu_device_mem_bytes\{{rank="{rank}",'
                r'component="ring_store",engine="e\d+"\}', text), (
                f"rank {rank} exports no memory ledger")
    finally:
        PORT._close(clusters, host)


def test_cluster_metrics_exemplar_links_to_a_resolvable_trace(tmp_path):
    """``test_cluster_observability.py:76``, the port copy (not an answer
    twin: the JAX side would read its process-global registry, where the
    JAX file's own run of this case leaves an unresolvable exemplar of
    the same tenant)."""
    PORT.test_cluster_metrics_exemplar_links_to_a_resolvable_trace(tmp_path)


def test_slo_harvest_consumes_each_record_once(tmp_path, monkeypatch):
    """``test_cluster_observability.py:100``, answer twin."""
    twin(monkeypatch, "test_cluster_observability",
         "test_slo_harvest_consumes_each_record_once", fresh_dirs(tmp_path))


def test_cluster_metrics_down_rank_degrades_not_fails(tmp_path, monkeypatch):
    """``test_cluster_observability.py:122``, answer twin."""
    twin(monkeypatch, "test_cluster_observability",
         "test_cluster_metrics_down_rank_degrades_not_fails", fresh_dirs(tmp_path))


def test_rest_cluster_metrics_endpoint(tmp_path):
    """``test_cluster_observability.py:139``, the port copy."""
    PORT.test_rest_cluster_metrics_endpoint(tmp_path)


def test_per_peer_stale_in_health_block_and_exposition(tmp_path):
    """``test_cluster_observability.py:235``, the port copy."""
    PORT.test_per_peer_stale_in_health_block_and_exposition(tmp_path)


def test_forward_hop_histogram_observes_forwards(tmp_path):
    """``test_cluster_observability.py:274``, the port copy."""
    PORT.test_forward_hop_histogram_observes_forwards(tmp_path)


@pytest.mark.slow
def test_open_loop_cluster_load_stress(tmp_path):
    """``test_cluster_observability.py:295``, the port copy."""
    PORT.test_open_loop_cluster_load_stress(tmp_path)
