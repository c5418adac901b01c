"""The port's multi-shard engine held to the JAX package's with every host
plane on: QoS, tracing and rules (``metrics()`` equal), rule fires equal to
JAX's and to the sequential host oracle, rollups folded across shards,
rule counters; the admin paths with shard-qualified ids; the presence
sweep; and the configurations both refuse. The engines of a module are
built once."""

import pytest

from sitewhere_tpu.rules import RulesManager as JaxRulesManager
from sitewhere_tpu_torch.rules import oracle as rules_oracle
from sitewhere_tpu_torch.engine import EngineConfig
from sitewhere_tpu_torch.parallel.placement import shard_for_token
from sitewhere_tpu_torch.parallel.sharded import SpmdEngine
from sitewhere_tpu_torch.rules import RulesManager
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation
from tests.torch_spmd import (CFG, RULESET, assert_state_equal, jax_single, jax_spmd,
                              run, settle, torch_single, torch_spmd, _stream)


def _rollup_rows(doc):
    return sorted(map(tuple, (sorted(b.items()) for b in doc["buckets"])))


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}shards")
def ruled(request):
    """JAX and port engines with QoS, span tracing and the rule set on,
    and a single-card port engine with the same rules."""
    n = request.param
    kw = dict(qos=True, devicewatch=True, span_sample=1.0)
    jeng, teng, ref = jax_spmd(n, **kw), torch_spmd(n, **kw), torch_single(**kw)
    jmgr, tmgr, rmgr = JaxRulesManager(jeng), RulesManager(teng), RulesManager(ref)
    jmgr.load(RULESET, precompile=False)
    tmgr.load(RULESET)
    rmgr.load(RULESET)
    events = _stream()
    run([jeng, teng, ref], events)
    # the counters before the harvest: a poll stages its alert rows
    metrics = [e.metrics() for e in (jeng, teng, ref)]
    polls = [{a["alternateId"] for a in m.poll()} for m in (jmgr, tmgr, rmgr)]
    return n, (jeng, teng, ref), (jmgr, tmgr, rmgr), polls, events, metrics


def test_metrics_dict_equal_with_qos_tracing_rules_on(ruled):
    a, b, c = ruled[5]
    for k in ("processed", "found", "missed", "registered", "persisted",
              "reg_overflow", "channel_collisions", "staged", "rule_fires",
              "rules_active"):
        assert a[k] == b[k] == c[k], (k, a[k], b[k], c[k])


def test_rule_fires_match_jax_single_card_and_oracle(ruled):
    _, _, _, (keys_jax, keys_port, keys_single), events, _ = ruled
    assert keys_port == keys_jax == keys_single
    ev = [{"ts": ts, "group": t, "value": v, "value_b": v} for t, v, ts in events]
    expected = {f"swr:hot:{g}:{w}" for g, w in rules_oracle.threshold_fire_keys(
        ev, op=0, value=90.0, cooldown_ms=1000)}
    expected |= {f"swr:burst:{g}:{w}" for g, w in rules_oracle.window_fire_keys(
        ev, agg="count", op=1, value=3, window_ms=2000, where=(0, 50.0))}
    assert keys_port == expected


def test_rollups_fold_across_shards_as_in_jax(ruled):
    _, _, (jmgr, tmgr, rmgr), _, _, _ = ruled
    got = tmgr.read_rollup("temp-1s", limit=100)
    assert _rollup_rows(got) == _rollup_rows(jmgr.read_rollup("temp-1s", limit=100))
    assert _rollup_rows(got) == _rollup_rows(rmgr.read_rollup("temp-1s", limit=100))
    for d in ("sp-1", "sp-6"):
        assert (_rollup_rows(tmgr.read_rollup("temp-1s", group=d))
                == _rollup_rows(jmgr.read_rollup("temp-1s", group=d)))


def test_rule_counters_and_state_match_jax(ruled):
    """Equal to JAX's but for ``rollupsActive``: the JAX engine reads it
    off the stacked rollup table's leading axis, so it reports the shard
    count; the port reports the rollups, as the single card does (a pinned
    divergence)."""
    n, (jeng, teng, ref), _, _, _, _ = ruled
    got, jax_counters = teng.rule_counters(), jeng.rule_counters()
    assert jax_counters.pop("rollupsActive") == n
    assert got.pop("rollupsActive") == ref.rule_counters()["rollupsActive"] == 1
    assert {k: got[k] for k in jax_counters} == jax_counters
    assert_state_equal(jeng, teng, parts=("store", "registry", "metrics"))


def test_conservation_balances_with_the_rules_stage(ruled):
    _, (_, teng, ref), (_, tmgr, rmgr), _, _, _ = ruled
    led = build_ledger(teng, tmgr)
    assert check_conservation(led) == []
    single = build_ledger(ref, rmgr)["stages"]["rules"]
    assert {k: led["stages"]["rules"][k] for k in ("fires", "missed", "harvested",
                                                  "emitted")} == \
        {k: single[k] for k in ("fires", "missed", "harvested", "emitted")}


# --------------------------------------------------------------- admin


@pytest.fixture(scope="module")
def admin_pair():
    jeng, teng = jax_spmd(4), torch_spmd(4)
    out = []
    for eng in (jeng, teng):
        dids = [eng.register_device(f"adm-{i}", tenant="acme") for i in range(12)]
        info = eng.create_assignment("adm-0", token="asn-1", asset="truck")
        eng.update_assignment("asn-1", area="north")
        area = eng.get_assignment("asn-1").area
        eng.release_assignment("asn-1")
        status = eng.get_assignment("asn-1").status
        eng.update_device("adm-0", device_type="gateway")
        dtype = eng.get_device("adm-0").device_type
        out.append((dids, info.device_token, area, status, dtype))
    return jeng, teng, out


def test_admin_ids_are_shard_qualified_as_in_jax(admin_pair):
    _, _, (jax_out, port_out) = admin_pair
    assert port_out == jax_out
    dids = port_out[0]
    assert len(set(dids)) == 12
    assert all(d // CFG["device_capacity"] == shard_for_token(f"adm-{i}", 4)
               for i, d in enumerate(dids))


def test_admin_state_matches_jax(admin_pair):
    jeng, teng, _ = admin_pair
    assert_state_equal(jeng, teng, parts=("registry", "next_device", "next_assignment"))


def test_parents_share_a_shard_or_are_refused(admin_pair):
    jeng, teng, _ = admin_pair
    by_shard: dict[int, list[str]] = {}
    for i in range(12):
        by_shard.setdefault(shard_for_token(f"adm-{i}", 4), []).append(f"adm-{i}")
    group = next(g for g in by_shard.values() if len(g) >= 2)
    a, b = group[0], group[1]
    assert teng.map_device(a, b).metadata["parentToken"] == b
    jeng.map_device(a, b)
    heads = [g[0] for g in by_shard.values()]
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="share a shard"):
            eng.map_device(heads[0], heads[1])
    assert_state_equal(jeng, teng, parts=("registry",))


def test_presence_sweep_parity():
    jeng, teng, ref = jax_spmd(2), torch_spmd(2), torch_single()
    run([jeng, teng, ref], _stream(32))
    missing_at = 500_000 + int(EngineConfig(**CFG).presence_missing_s * 1000) + 10_000
    for e in (jeng, teng, ref):
        e.epoch._now = missing_at
    swept = sorted(teng.presence_sweep())
    assert swept == sorted(jeng.presence_sweep()) == sorted(ref.presence_sweep())
    assert swept and teng.presence_sweep() == jeng.presence_sweep() == []
    assert_state_equal(jeng, teng, parts=("device_state",))


@pytest.mark.parametrize("bad, match", [
    (dict(archive_dir="/nonexistent/x"), "archive"),
    (dict(fair_tenancy=True), "fair_tenancy"),
    (dict(analytics_devices=8), "analytics window"),
    (dict(tenant_arenas=2, store_capacity=4096), "tenant_arenas"),
    (dict(autotune=True), "autotune"),
])
def test_unsupported_configs_are_refused(bad, match):
    with pytest.raises(ValueError, match=match):
        SpmdEngine(EngineConfig(**{**CFG, **bad}), n_shards=2, device="cpu")


def test_shard_unaware_surfaces_are_refused_and_scan_chunk_is_not():
    assert torch_spmd(2, scan_chunk=2).config.scan_chunk == 2
    eng = torch_spmd(2)
    for call in (eng.search_device_states, lambda: eng.get_event("x"),
                 lambda: eng.make_feed_consumer("g"),
                 lambda: eng.ingest_event_batch(None)):
        with pytest.raises(NotImplementedError):
            call()


def test_a_cuda_engine_without_a_gpu_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):
        SpmdEngine(EngineConfig(**CFG), n_shards=2)
    with pytest.raises(RuntimeError):
        SpmdEngine(EngineConfig(**CFG), n_shards=2, device="cuda:0")


def test_jax_single_card_rules_agree_with_the_port_single_card():
    j, t = jax_single(), torch_single()
    jm, tm = JaxRulesManager(j), RulesManager(t)
    jm.load(RULESET, precompile=False)
    tm.load(RULESET)
    run([j, t], _stream(60))
    assert {a["alternateId"] for a in jm.poll()} == {a["alternateId"] for a in tm.poll()}
    settle(j, t)
