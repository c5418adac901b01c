"""The port's multi-shard engine (``parallel/sharded.SpmdEngine``) held to the
JAX package's on the CPU, every shard on the CPU, the stream and clock of
``tests/test_spmd.py``:

* state byte-identity with the JAX engine (store, registry, device state,
  counters) for 1, 2 and 4 shards, and each shard's store byte-identical
  to a single-card engine fed that shard's substream;
* query pages equal to the JAX engine's and to a single-card engine's,
  including the documented cross-shard tie order;
* device state, tenant metrics, the counter grid, ``metrics()``, the shard
  flow document and the conservation ledger equal to the JAX engine's.

Each JAX engine is built once per module (its first steps compile)."""

import numpy as np
import pytest

from sitewhere_tpu.utils.conservation import build_ledger as jax_build_ledger
from sitewhere_tpu_torch.parallel.placement import shard_for_token
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation
from tests.torch_spmd import (assert_state_equal, jax_single, jax_spmd, page, run,
                              settle, torch_single, torch_spmd, _stream)

QUERIES = (
    dict(limit=200),                                        # the full page
    dict(limit=7),                                          # a truncated page
    dict(device_token="sp-3", limit=20),                    # a device filter
    dict(device_token="sp-3", since_ms=1_200, until_ms=1_800, limit=20),
    dict(limit=20, since_ms=1_300),
)


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}shards")
def pair(request):
    n = request.param
    events = _stream()
    jeng, teng = jax_spmd(n), torch_spmd(n)
    ref = torch_single()
    run([jeng, teng, ref], events)
    settle(jeng, teng, ref)
    return n, jeng, teng, ref, events


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}shards")
def tie_pair(request):
    n = request.param
    events = _stream(ties=True)
    jeng, teng, ref = jax_spmd(n), torch_spmd(n), torch_single()
    run([jeng, teng, ref], events)
    return n, jeng, teng, ref, events


def test_state_byte_identical_to_jax(pair):
    _, jeng, teng, _, events = pair
    assert_state_equal(jeng, teng)
    assert teng.host_counters == {"arena_rows": len(events)}
    assert teng.host_counters == jeng.host_counters


def test_store_byte_identical_to_per_shard_substreams(pair):
    n, _, teng, _, events = pair
    for s in range(n):
        sub = [ev for ev in events if shard_for_token(ev[0], n) == s]
        ref = torch_single()
        run([ref], sub)
        settle(ref)
        for f in ("valid", "etype", "device", "assignment", "tenant", "ts_ms",
                  "received_ms", "values", "vmask", "aux", "cursor", "epoch"):
            np.testing.assert_array_equal(getattr(ref.state.store, f).numpy(),
                                          getattr(teng.shards[s].store, f).numpy(),
                                          err_msg=f"shard {s} store.{f}")


def test_single_shard_is_the_identity():
    teng, ref = torch_spmd(1), torch_single()
    run([teng, ref], _stream(64))
    settle(teng, ref)
    for f in ("valid", "etype", "device", "assignment", "tenant", "ts_ms",
              "received_ms", "values", "vmask", "aux", "cursor", "epoch"):
        assert np.array_equal(getattr(ref.state.store, f).numpy(),
                              getattr(teng.shards[0].store, f).numpy()), f


@pytest.mark.parametrize("kw", QUERIES, ids=[str(i) for i in range(len(QUERIES))])
def test_query_pages_match_jax_and_single_card(pair, kw):
    _, jeng, teng, ref, _ = pair
    # shard-qualified assignment ids too: the same id space as JAX's
    assert page(jeng, canonical=False, **kw) == page(teng, canonical=False, **kw)
    assert page(ref, **kw) == page(teng, **kw)


def test_query_tie_order_is_the_documented_merge_contract(tie_pair):
    """Timestamp ties across shards come out shard-major, each shard's rows
    in arrival order (``tests/test_spmd.py``'s contract), as JAX's do; the
    rows of each timestamp are the single card's."""
    n, jeng, teng, ref, events = tie_pair
    assert page(jeng, canonical=False, limit=200) == page(teng, canonical=False, limit=200)
    t_ref, page_ref = page(ref, limit=200)
    t_got, page_got = page(teng, limit=200)
    assert t_ref == t_got == len(events)

    def by_ts(rows):
        out = {}
        for ev in rows:
            out.setdefault(ev["eventDateMs"], []).append(
                tuple(sorted((k, str(v)) for k, v in ev.items())))
        return {ts: sorted(r) for ts, r in out.items()}

    assert by_ts(page_ref) == by_ts(page_got)
    expected = []
    for ts in sorted({ts for _, _, ts in events}, reverse=True):
        for s in range(n):
            expected.extend(tok for tok, _, ts2 in events
                            if ts2 == ts and shard_for_token(tok, n) == s)
    assert [ev["deviceToken"] for ev in page_got] == expected


def test_device_state_and_tenant_metrics_match(pair):
    _, jeng, teng, ref, _ = pair
    for d in range(8):
        got = teng.get_device_state(f"sp-{d}")
        assert got == jeng.get_device_state(f"sp-{d}")
        assert got == ref.get_device_state(f"sp-{d}")
    assert teng.tenant_metrics() == jeng.tenant_metrics() == ref.tenant_metrics()
    assert (teng.tenant_pipeline_counters() == jeng.tenant_pipeline_counters()
            == ref.tenant_pipeline_counters())


def test_metrics_match_jax(pair):
    _, jeng, teng, _, _ = pair
    a, b = jeng.metrics(), teng.metrics()
    for k in ("processed", "found", "missed", "registered", "persisted",
              "reg_overflow", "channel_collisions", "staged", "arena_rows",
              "arena_pool_size"):
        assert a[k] == b[k], (k, a[k], b[k])


def test_shard_flow_and_conservation_match_jax(pair):
    _, jeng, teng, _, _ = pair
    assert teng.shard_flow() == jeng.shard_flow()
    led = build_ledger(teng)
    assert check_conservation(led) == []
    jled = jax_build_ledger(jeng)
    assert led["stages"]["spmd"] == jled["stages"]["spmd"]
    assert led["stages"]["ingest"] == jled["stages"]["ingest"]


def test_take_shard_staged_hwm_matches_jax(pair):
    _, jeng, teng, _, _ = pair
    assert (teng.take_shard_staged_hwm(reset=False)
            == jeng.take_shard_staged_hwm(reset=False))


def test_single_card_engine_state_equals_the_jax_single_card():
    """The reference the substream checks lean on: the port's single-card
    engine on the same stream is byte-identical to the JAX one."""
    j, t = jax_single(), torch_single()
    run([j, t], _stream(64))
    settle(j, t)
    assert_state_equal(j, t)
