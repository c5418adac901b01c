"""Parity of the port's read path with the JAX package: ``query_store``,
``query_store_batch`` (every field of every page, the non-matching padding
rows past ``n`` included), ``read_range`` across the ring wrap, the
``scatter_argmax_mask`` / ``stable_partition_topk`` primitives,
``host_filter_mask`` and ``merge_shard_pages``.

The stores are seeded numpy columns handed to both sides: event-time ties,
``INT32_MIN`` / ``INT32_MIN + 1`` / ``INT32_MAX`` timestamps, invalid rows,
NULL_ID ids, 1 and 4 arenas. Every leaf must be byte-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.core.store import EventStore as JaxStore
from sitewhere_tpu.ops import query as jq
from sitewhere_tpu.ops import readback as jrb
from sitewhere_tpu.ops import segment as jseg
from sitewhere_tpu_torch.core.store import EventStore
from sitewhere_tpu_torch.ops import query as tq
from sitewhere_tpu_torch.ops import readback as trb
from sitewhere_tpu_torch.ops import segment as tseg
from tests.torch_parity import assert_leaf_equal

INT32_MIN = np.iinfo(np.int32).min
INT32_MAX = np.iinfo(np.int32).max
S, C = 256, 3


def store_columns(seed: int, capacity: int = S, channels: int = C,
                  arenas: int = 1) -> dict[str, np.ndarray]:
    """A ring's columns from a seed: ids with NULL_ID, heavy event-time
    ties, the int32 extremes, ~15 % invalid rows, cursors mid-ring with
    epochs > 0 (the ring has wrapped)."""
    rng = np.random.default_rng(seed)
    s = capacity
    ts = rng.integers(-5, 40, s)
    ts[rng.random(s) < 0.05] = INT32_MIN
    ts[rng.random(s) < 0.05] = INT32_MIN + 1
    ts[rng.random(s) < 0.03] = INT32_MAX
    cols = dict(
        cursor=rng.integers(0, s // arenas, arenas),
        epoch=rng.integers(1, 4, arenas),
        etype=rng.integers(0, 6, s), device=rng.integers(-1, 8, s),
        assignment=rng.integers(-1, 10, s), tenant=rng.integers(-1, 3, s),
        area=rng.integers(-1, 3, s), customer=rng.integers(-1, 3, s),
        asset=rng.integers(-1, 3, s), ts_ms=ts,
        received_ms=rng.integers(0, 100, s),
        aux=rng.integers(-1, 4, (s, 2)))
    cols = {k: v.astype(np.int32) for k, v in cols.items()}
    cols["values"] = rng.standard_normal((s, channels)).astype(np.float32)
    cols["vmask"] = rng.random((s, channels)) < 0.7
    cols["valid"] = rng.random(s) < 0.85
    return cols


def both_stores(cols):
    return (JaxStore(**{k: jnp.asarray(v) for k, v in cols.items()}),
            EventStore(**{k: torch.from_numpy(v.copy()) for k, v in cols.items()}))


def assert_page_equal(ref, got, name):
    for f in ref._fields:
        assert_leaf_equal(getattr(ref, f), getattr(got, f), f"{name}.{f}")


# one predicate set per case, in QueryParams field terms
FILTERS = {
    "full_scan": {},
    "device": dict(device=3),
    "etype": dict(etype=0),
    "tenant": dict(tenant=1),
    "window": dict(t0=3, t1=20),
    "since_min": dict(t0=INT32_MIN),
    "until_min": dict(t1=INT32_MIN + 1),
    "assignment": dict(assignment=4),
    "aux0": dict(aux0=2),
    "aux1": dict(aux1=0),
    "area": dict(area=2),
    "customer": dict(customer=0),
    "combo": dict(device=2, etype=1, t0=0, t1=30, area=1),
    "nothing": dict(device=99),
}
FIELDS = jq.QueryParams._fields


def params_of(f: dict) -> tuple:
    base = dict(device=-1, etype=-1, tenant=-1, t0=INT32_MIN, t1=INT32_MAX,
                assignment=-1, aux0=-1, aux1=-1, area=-1, customer=-1)
    base.update(f)
    return tuple(base[k] for k in FIELDS)


@pytest.mark.parametrize("arenas", [1, 4])
@pytest.mark.parametrize("case", list(FILTERS))
def test_query_store_matches_jax(case, arenas):
    js, ts = both_stores(store_columns(7 + arenas, arenas=arenas))
    p = dict(zip(FIELDS, params_of(FILTERS[case])))
    ref = jq.query_store(js, *(jnp.int32(p[k]) for k in FIELDS[:5]), limit=32,
                         **{k: jnp.int32(p[k]) for k in FIELDS[5:]})
    got = tq.query_store(ts, *(p[k] for k in FIELDS[:5]), limit=32,
                         **{k: p[k] for k in FIELDS[5:]})
    assert_page_equal(ref, got, case)


@pytest.mark.parametrize("limit", [1, 16, 64, 300])    # 300 > capacity
@pytest.mark.parametrize("arenas", [1, 4])
def test_query_store_batch_matches_jax_and_sequential(arenas, limit):
    js, ts = both_stores(store_columns(3 * limit + arenas, arenas=arenas))
    lanes = [params_of(f) for f in FILTERS.values()]
    cols = np.asarray(lanes, np.int32).T
    ref = jq.query_store_batch(js, jq.QueryParams(*map(jnp.asarray, cols)),
                               limit=limit)
    got = tq.query_store_batch(ts, tq.QueryParams(*map(torch.from_numpy, cols)),
                               limit=limit)
    assert_page_equal(ref, got, f"batch limit={limit}")
    for q, case in enumerate(FILTERS):
        p = dict(zip(FIELDS, lanes[q]))
        seq = tq.query_store(ts, *(p[k] for k in FIELDS[:5]), limit=limit,
                             **{k: p[k] for k in FIELDS[5:]})
        if limit > S:   # query_store's perm[:limit] stops at the capacity
            assert seq.etype.shape[0] == S
        for f in seq._fields:
            assert_leaf_equal(getattr(seq, f), getattr(got, f)[q],
                              f"sequential {case}.{f}")


def test_query_store_without_optional_filters_matches_jax():
    js, ts = both_stores(store_columns(5))
    ref = jq.query_store(js, jnp.int32(-1), jnp.int32(0), jnp.int32(-1),
                         jnp.int32(INT32_MIN), jnp.int32(INT32_MAX), limit=8)
    got = tq.query_store(ts, -1, 0, -1, INT32_MIN, INT32_MAX, limit=8)
    assert_page_equal(ref, got, "no optional filters")


@pytest.mark.parametrize("arenas,arena,start,count", [
    (1, 0, 250, 12),       # wraps past the end of the ring
    (1, 0, 3 * S + 5, 4),  # start beyond one lap
    (4, 2, 60, 9),         # wraps inside arena 2
    (4, 3, 0, 64),         # one whole arena
])
def test_read_range_matches_jax(arenas, arena, start, count):
    cols = store_columns(arena + count, arenas=arenas)
    js, ts = both_stores(cols)
    ref = jrb.read_range(js, jnp.int32(start), count, arena=arena)
    got = trb.read_range(ts, start, count, arena=arena)
    for f in ref._fields:
        assert_leaf_equal(getattr(ref, f), getattr(got, f), f"slice.{f}")
    assert trb.absolute_cursor(ts) == jrb.absolute_cursor(js)
    for a in range(arenas):
        assert trb.arena_cursor(ts, a) == jrb.arena_cursor(js, a)


@pytest.mark.parametrize("n,n_seg,p_valid", [(1, 1, 1.0), (50, 4, 0.7),
                                             (400, 37, 0.5), (64, 80, 0.9)])
def test_scatter_argmax_mask_matches_jax(n, n_seg, p_valid):
    rng = np.random.default_rng(n + n_seg)
    seg = rng.integers(0, n_seg + 3, n).astype(np.int32)    # some past n_seg
    key1 = rng.integers(-3, 3, n).astype(np.int32)          # many ties
    key1[rng.random(n) < 0.1] = INT32_MIN
    key2 = rng.permutation(n).astype(np.int32)              # unique
    valid = rng.random(n) < p_valid
    ref = jseg.scatter_argmax_mask(*map(jnp.asarray, (seg, key1, key2, valid)),
                                   n_seg)
    got = tseg.scatter_argmax_mask(*map(torch.from_numpy, (seg, key1, key2, valid)),
                                   n_seg)
    assert_leaf_equal(ref, got, "winner")


@pytest.mark.parametrize("n,limit,p_match", [(1, 1, 1.0), (40, 8, 0.3),
                                             (40, 40, 0.0), (300, 64, 0.6),
                                             (300, 17, 1.0)])
def test_stable_partition_topk_matches_jax_and_lex_argsort(n, limit, p_match):
    rng = np.random.default_rng(n * limit)
    key = rng.integers(-4, 4, n).astype(np.int32)
    match = rng.random(n) < p_match
    _, jperm = jseg.lex_argsort([jnp.asarray(key)])
    perm = np.array(jperm)
    total = np.int32(match.sum())
    ref = jseg.stable_partition_topk(jperm, jnp.asarray(match[perm]),
                                     jnp.int32(total), limit)
    tperm = torch.from_numpy(perm)
    got = tseg.stable_partition_topk(tperm, torch.from_numpy(match[perm]),
                                     torch.tensor(total), limit)
    assert_leaf_equal(ref, got, "topk")
    _, full = tseg.lex_argsort([torch.from_numpy((~match).astype(np.int32)),
                                torch.from_numpy(key)])
    assert torch.equal(got, full[:limit])
    # batched: Q match masks over one shared perm
    masks = np.stack([match, ~match, np.zeros(n, bool)])
    got_q = tseg.stable_partition_topk(
        tperm, torch.from_numpy(masks[:, perm]),
        torch.from_numpy(masks.sum(1).astype(np.int32)), limit)
    for q in range(3):
        one = tseg.stable_partition_topk(
            tperm, torch.from_numpy(masks[q][perm]),
            torch.tensor(np.int32(masks[q].sum())), limit)
        assert torch.equal(got_q[q], one)


@pytest.mark.parametrize("case", ["device", "tenant", "window", "combo",
                                  "aux1", "nothing"])
def test_host_filter_mask_matches_both_query_masks(case):
    cols = store_columns(11)
    f = FILTERS[case]
    since, until = f.get("t0"), f.get("t1")
    kw = {k: v for k, v in f.items() if k not in ("t0", "t1")}
    ref = jq.host_filter_mask(cols, since_ms=since, until_ms=until, **kw)
    got = tq.host_filter_mask(cols, since_ms=since, until_ms=until, **kw)
    np.testing.assert_array_equal(got, ref)
    # the device query counts exactly these rows among the valid ones
    _, ts = both_stores(cols)
    p = dict(zip(FIELDS, params_of(f)))
    page = tq.query_store(ts, *(p[k] for k in FIELDS[:5]), limit=4,
                          **{k: p[k] for k in FIELDS[5:]})
    assert int(page.total) == int((got & cols["valid"]).sum())


@pytest.mark.parametrize("shards,limit", [(1, 8), (3, 8), (4, 32)])
def test_merge_shard_pages_matches_jax(shards, limit):
    pages = []
    for s in range(shards):
        _, ts = both_stores(store_columns(100 + s))
        pages.append(tq.query_store(ts, -1, -1, -1, INT32_MIN, INT32_MAX,
                                    limit=limit))
    stacked = tq.QueryResult(*(np.stack([getattr(p, f).numpy() for p in pages])
                               for f in tq.QueryResult._fields))
    ref = jq.merge_shard_pages(jq.QueryResult(*stacked), limit)
    got = tq.merge_shard_pages(stacked, limit)
    for f in ref._fields:
        assert_leaf_equal(np.asarray(getattr(ref, f)), getattr(got, f), f)


def test_bucket_limit_and_page_clamp_match_jax():
    for v in (None, 0, 1, 2, 3, 64, 65, 999, 1000, 5000):
        assert tq.clamp_page_size(v) == jq.clamp_page_size(v)
        if v:
            assert tq.bucket_limit(v) == jq.bucket_limit(v)
    assert tq.N_QUERY_PARAMS == jq.N_QUERY_PARAMS
    assert tq.QueryParams._fields == jq.QueryParams._fields
    assert tq.QueryResult._fields == jq.QueryResult._fields
