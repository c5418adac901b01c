"""Parity of the port's sort/segment primitives with ``sitewhere_tpu.ops.segment``
on random keys with many ties: the results must be identical (the
lexicographic sort is stable on both sides, so even tie order agrees)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ops import segment as jseg
from sitewhere_tpu_torch.ops import segment as tseg
from tests.torch_parity import assert_leaf_equal

INT32_MIN = np.iinfo(np.int32).min
INT32_MAX = np.iinfo(np.int32).max


def _keys(rng, n, n_keys, spread):
    keys = [rng.integers(-spread, spread, n).astype(np.int32)
            for _ in range(n_keys)]
    # the sentinels the pipeline sorts with
    keys[0][rng.random(n) < 0.1] = INT32_MAX
    keys[-1][rng.random(n) < 0.1] = INT32_MIN
    return keys


@pytest.mark.parametrize("n,n_keys,spread", [
    (1, 1, 3), (7, 1, 2), (257, 1, 4), (300, 2, 3), (513, 3, 2), (64, 3, 1000)])
def test_lex_argsort_matches_jax(n, n_keys, spread):
    rng = np.random.default_rng(n * 10 + n_keys)
    keys = _keys(rng, n, n_keys, spread)
    jsorted, jperm = jseg.lex_argsort([jnp.asarray(k) for k in keys])
    tsorted, tperm = tseg.lex_argsort([torch.from_numpy(k) for k in keys])
    assert_leaf_equal(jperm, tperm, "perm")
    for i, (a, b) in enumerate(zip(jsorted, tsorted)):
        assert_leaf_equal(a, b, f"sorted key {i}")


@pytest.mark.parametrize("n,spread", [(1, 1), (2, 1), (50, 3), (400, 20), (129, 1)])
def test_segment_ranks_matches_jax(n, spread):
    rng = np.random.default_rng(n + spread)
    ids = np.sort(rng.integers(0, spread, n)).astype(np.int32)
    jstart, jend = jseg.segment_ranks(jnp.asarray(ids))
    tstart, tend = tseg.segment_ranks(torch.from_numpy(ids))
    assert_leaf_equal(jstart, tstart, "rank_from_start")
    assert_leaf_equal(jend, tend, "rank_from_end")


@pytest.mark.parametrize("n,p_valid", [(1, 0.5), (33, 0.0), (33, 1.0), (500, 0.3)])
def test_compact_valid_front_matches_jax(n, p_valid):
    rng = np.random.default_rng(n)
    valid = rng.random(n) < p_valid
    jn, jperm = jseg.compact_valid_front(jnp.asarray(valid))
    tn, tperm = tseg.compact_valid_front(torch.from_numpy(valid))
    assert_leaf_equal(jn, tn, "n_valid")
    assert_leaf_equal(jperm, tperm, "perm")
