"""Parity of the port's streaming-rules tier (``ops/rules.py``,
``rules/model.py``, ``rules/manager.py``) with the JAX package.

One seeded multi-batch stream (20 devices in 3 tenants, 16 of them in 4
areas, a device that goes quiet halfway, a second channel for the sequence
predicate, values in binary halves so every float sum is exact in any
order) goes through a JAX ``Engine(use_native=False)`` and the port's
``Engine(device="cpu")`` with the clock pinned, each with the same rule
set (every rule kind in every scope, rollups in every scope) loaded by
its own ``RulesManager``. After every flush the whole pipeline state —
rule tables, carried accumulators, pending-fire rings, rollup rings — is
byte-identical; ``poll()`` emits equal alerts, whose device-scope keys are
the sequential oracle's; the fire set, carried state and rollups are
batch-partition invariant; ``RuleSet.parse`` rejects the same documents.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.ingest.requests import DecodedRequest as JaxRequest
from sitewhere_tpu.ingest.requests import RequestType as JaxRequestType
from sitewhere_tpu.ops import rules as jrules
from sitewhere_tpu.rules import RuleSet as JaxRuleSet
from sitewhere_tpu.rules import RuleSetError as JaxRuleSetError
from sitewhere_tpu.rules import RulesManager as JaxRulesManager
from sitewhere_tpu.rules import oracle
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.ops import rules as trules
from sitewhere_tpu_torch.rules import RuleSet, RuleSetError, RulesManager
from tests.torch_parity import assert_leaf_equal, assert_tree_equal

BASE_S = 1_700_000_000.0
BASE_MS = int(BASE_S * 1000)
CFG = dict(device_capacity=64, token_capacity=128, assignment_capacity=128,
           store_capacity=1024, batch_capacity=32, channels=4,
           rule_groups=16, rollup_buckets=4, rule_pending=3)
DEVS, AREA_DEVS = 20, 16

_T = dict(channel="temp")
RULESET = {
    "name": "parity",
    "rules": [
        {"name": "hot-dev", "kind": "threshold", **_T, "op": ">",
         "value": 90.0, "cooldownMs": 1000},
        {"name": "hot-area", "kind": "threshold", **_T, "op": ">=",
         "value": 90.0, "cooldownMs": 1500, "scope": "area"},
        {"name": "cold-tenant", "kind": "threshold", **_T, "op": "<",
         "value": 5.0, "cooldownMs": 2000, "scope": "tenant"},
        {"name": "burst-dev", "kind": "window", "agg": "count", **_T,
         "op": ">=", "value": 3, "windowMs": 4000,
         "where": {"channel": "temp", "op": ">", "value": 30.0}},
        {"name": "sum-area", "kind": "window", "agg": "sum", **_T,
         "op": ">", "value": 300.0, "windowMs": 3000, "scope": "area"},
        {"name": "max-tenant", "kind": "window", "agg": "max", **_T,
         "op": ">=", "value": 95.0, "windowMs": 1500, "scope": "tenant"},
        {"name": "min-dev", "kind": "window", "agg": "min", **_T,
         "op": "<=", "value": 3.0, "windowMs": 2500},
        {"name": "updown-dev", "kind": "sequence",
         "first": {"channel": "temp", "op": ">", "value": 90.0},
         "then": {"channel": "rpm", "op": "<", "value": 100.0},
         "withinMs": 4000},
        {"name": "updown-tenant", "kind": "sequence", "scope": "tenant",
         "first": {"channel": "temp", "op": ">", "value": 90.0},
         "then": {"channel": "temp", "op": "<", "value": 5.0},
         "withinMs": 3000, "tenant": "t1"},
        {"name": "silent-dev", "kind": "absence", **_T, "deadlineMs": 3000},
        {"name": "silent-area", "kind": "absence", **_T, "op": ">",
         "value": 96.0, "deadlineMs": 1500, "scope": "area",
         "level": "error"},
    ],
    "rollups": [
        {"name": "temp-1s", "channel": "temp", "windowMs": 1000},
        {"name": "temp-area", "channel": "temp", "windowMs": 2000,
         "scope": "area"},
        {"name": "rpm-tenant", "channel": "rpm", "windowMs": 3000,
         "scope": "tenant", "etype": "any"},
    ],
}


def stream(n: int = 240, quiet_after: int | None = 120):
    """(device, temp, rpm or None, ts_rel) rows: ~9 % of temps above 90,
    2.5 every 23rd, rpm below 100 every 17th and absent every 5th; device
    0 goes quiet after ``quiet_after`` (its rows move to device 1)."""
    rows = []
    for i in range(n):
        d = i % DEVS
        if quiet_after is not None and d == 0 and i >= quiet_after:
            d = 1
        v = 96.5 if i % 11 == 0 else 20.0 + (i % 40) * 0.5
        if i % 23 == 0:
            v = 2.5
        rpm = None if i % 5 == 0 else (50.0 if i % 17 == 0
                                       else 1000.0 + (i % 8) * 0.5)
        rows.append((d, v, rpm, i * 37))
    return rows


def _pin(cls):
    class Pinned(cls):
        def now_ms(self):
            return 9_000

    return Pinned(BASE_S)


def _requests(req_cls, type_cls, rows):
    out = []
    for d, v, rpm, ts in rows:
        meas = {"temp": v} if rpm is None else {"temp": v, "rpm": rpm}
        out.append(req_cls(type=type_cls.DEVICE_MEASUREMENT,
                           device_token=f"r-{d}", tenant=f"t{d % 3}",
                           measurements=meas, event_ts_ms=BASE_MS + ts))
        if ts % 7 == 0:             # a location row: no rule or rollup sees it
            out.append(req_cls(type=type_cls.DEVICE_LOCATION,
                               device_token=f"r-{d}", tenant=f"t{d % 3}",
                               latitude=1.0, longitude=2.0,
                               event_ts_ms=BASE_MS + ts))
    return out


def make_port(**cfg):
    eng = Engine(EngineConfig(**{**CFG, **cfg}, use_native=False), device="cpu")
    eng.epoch = _pin(EpochBase)
    for d in range(AREA_DEVS):
        eng.register_device(f"r-{d}", tenant=f"t{d % 3}", area=f"a{d % 4}")
    return eng


def drive(eng, req_cls, type_cls, rows, chunk):
    reqs = _requests(req_cls, type_cls, rows)
    for lo in range(0, len(reqs), chunk):
        for r in reqs[lo:lo + chunk]:
            eng.process(r)
        eng.flush()
        yield lo


@pytest.fixture(scope="module")
def driven():
    """Both engines through the stream, state compared after every flush;
    then one poll each and the alerts flushed through both pipelines."""
    jeng = JaxEngine(JaxEngineConfig(**CFG, use_native=False))
    jeng.epoch = _pin(JaxEpoch)
    for d in range(AREA_DEVS):
        jeng.register_device(f"r-{d}", tenant=f"t{d % 3}", area=f"a{d % 4}")
    teng = make_port()
    jmgr, tmgr = JaxRulesManager(jeng), RulesManager(teng)
    loaded = (jmgr.load(RULESET, precompile=False), tmgr.load(RULESET))
    assert_tree_equal(jax.device_get(jeng.state), teng.state, "installed")
    rows = stream()
    jd = drive(jeng, JaxRequest, JaxRequestType, rows, chunk=45)
    for lo in drive(teng, DecodedRequest, RequestType, rows, chunk=45):
        next(jd)
        assert_tree_equal(jax.device_get(jeng.state), teng.state,
                          f"after request {lo}")
    alerts = (jmgr.poll(), tmgr.poll())
    jeng.flush()
    teng.flush()
    return jeng, teng, jmgr, tmgr, loaded, alerts, rows


def test_load_summaries_match(driven):
    _, _, _, _, (jsum, tsum), _, _ = driven
    assert tsum == jsum


def test_stream_state_matches_jax_after_alerts(driven):
    jeng, teng, *_ = driven
    assert_tree_equal(jax.device_get(jeng.state), teng.state, "after poll")
    assert teng.metrics() == jeng.metrics()
    assert teng.rule_counters() == jeng.rule_counters()
    c = teng.rule_counters()
    # the stream exercised what it is meant to
    assert c["ruleFires"] > 0 and c["ruleOobGroups"] > 0
    assert c["ruleMissedFires"] > 0          # pending ring of 3 overflowed


def test_alerts_match_jax_and_every_rule_fired(driven):
    _, _, _, _, _, (jalerts, talerts), _ = driven
    assert talerts == jalerts
    fired = {a["rule"] for a in talerts}
    assert fired == {r["name"] for r in RULESET["rules"]}


def test_device_scope_keys_match_the_sequential_oracle():
    """With pending rings deep enough to hold every fire, the device-scope
    alert keys are exactly the oracle's (one event at a time)."""
    teng = make_port(rule_pending=64)
    mgr = RulesManager(teng)
    mgr.load(RULESET)
    rows = stream()
    for _ in drive(teng, DecodedRequest, RequestType, rows, chunk=45):
        pass
    got = {a["alternateId"] for a in mgr.poll() if a["scope"] == "device"}
    live = [r for r in rows if r[0] < AREA_DEVS]     # device ids < groups
    ev = [{"ts": ts, "group": f"r-{d}", "value": v, "value_b": rpm}
          for d, v, rpm, ts in live]
    temp_only = [dict(e, value_b=e["value"]) for e in ev]
    wm = rows[-1][3]
    want = set()
    for g, w in oracle.threshold_fire_keys(ev, op=0, value=90.0,
                                           cooldown_ms=1000):
        want.add(f"swr:hot-dev:{g}:{w}")
    for g, w in oracle.window_fire_keys(ev, agg="count", op=1, value=3,
                                        window_ms=4000, where=(0, 30.0)):
        want.add(f"swr:burst-dev:{g}:{w}")
    for g, w in oracle.window_fire_keys(ev, agg="min", op=3, value=3.0,
                                        window_ms=2500):
        want.add(f"swr:min-dev:{g}:{w}")
    for g, w in oracle.sequence_fire_keys(ev, op_a=0, val_a=90.0, op_b=2,
                                          val_b=100.0, within_ms=4000):
        want.add(f"swr:updown-dev:{g}:{w}")
    for g, w in oracle.absence_fire_keys(temp_only, op=1, value=float("-inf"),
                                         deadline_ms=3000, final_watermark=wm):
        want.add(f"swr:silent-dev:{g}:{w}")
    assert got == want
    assert any(k.startswith("swr:silent-dev:r-0:") for k in got)


def _carried(eng) -> dict:
    rb, ro = eng.state.rules.rules, eng.state.rules.rollups
    return {f: getattr(rb, f).clone() for f in
            ("wm", "acc_wid", "acc_cnt", "acc_sum", "mark_ts", "fired_key",
             "fires")} | {f"rollup.{f}": getattr(ro, f).clone()
                          for f in ("wid", "adds", "exts")}


def test_batch_partition_invariance():
    """The same stream cut at very different batch boundaries gives the
    same carried state, the same fire keys and the same rollups."""
    results = []
    for chunk in (240, 31, 7, 1):
        teng = make_port(rule_pending=64)
        mgr = RulesManager(teng)
        mgr.load(RULESET)
        for _ in drive(teng, DecodedRequest, RequestType, stream(), chunk):
            pass
        carried = _carried(teng)
        keys = {a["alternateId"] for a in mgr.poll()}
        results.append((chunk, carried, keys,
                        mgr.read_rollup("temp-area", group="a1")))
    _, ref_state, ref_keys, ref_rollup = results[0]
    assert ref_keys
    for chunk, carried, keys, rollup in results[1:]:
        assert keys == ref_keys, chunk
        assert rollup == ref_rollup, chunk
        for name, x in carried.items():
            assert_leaf_equal(ref_state[name], x, f"chunk {chunk}: {name}")


def test_rule_param_tweak_preserves_state_and_window_change_resets():
    teng = make_port()
    mgr = RulesManager(teng)
    mgr.load(RULESET)
    for _ in drive(teng, DecodedRequest, RequestType, stream(60), 30):
        pass
    before = teng.state.rules.rules
    tweaked = {**RULESET, "rules": [dict(RULESET["rules"][0], value=91.0)]
               + RULESET["rules"][1:]}
    assert mgr.load(tweaked)["preservedState"]
    after = teng.state.rules.rules
    assert torch.equal(after.fired_key, before.fired_key)
    assert float(after.val_a[0]) == 91.0
    moved = {**RULESET, "rules": [dict(RULESET["rules"][0], cooldownMs=500)]
             + RULESET["rules"][1:]}
    assert not mgr.load(moved)["preservedState"]
    assert int(teng.state.rules.rules.fired_key.max()) == -(2**31)
    mgr.clear()
    assert teng.state.rules is None and mgr.poll() == []


def test_state_dtypes_never_widen_with_rules_and_zones():
    teng = make_port()
    RulesManager(teng).load(RULESET)
    teng.set_geofence_zones([[(0.0, 0.0), (0.0, 3.0), (3.0, 3.0)]])
    for _ in drive(teng, DecodedRequest, RequestType, stream(60), 20):
        pass
    teng.poll_rule_fires()
    allowed = {torch.int32, torch.float32, torch.bool}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            assert x.dtype in allowed, f"{path}: {x.dtype}"
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}")
    walk(teng.state, "state")


def test_harvest_fires_matches_jax(driven):
    jeng, teng, *_ = driven
    jrs = jax.device_get(jeng.state.rules)
    trs = convert.pipeline_state_from_numpy(jax.device_get(jeng.state),
                                            "cpu").rules
    jout = jrules.harvest_fires(jrs)
    tout = trules.harvest_fires(trs)
    assert_tree_equal(jout[0], tout[0], "harvested state")
    for i, name in enumerate(("pend_key", "pend_val", "pend_w", "pend_h"), 1):
        assert_leaf_equal(jout[i], tout[i], name)
    empty = trules.harvest_fires(trules.RulesState())
    assert empty[1].shape == (0, 0)


@pytest.mark.parametrize("shards,device_cap", [(1, 8), (3, 4)])
def test_merge_shard_harvests_matches_jax(shards, device_cap):
    rng = np.random.default_rng(shards)
    r, g, k = 4, 6, 3
    pk = rng.integers(0, 50, (shards, r, g, k)).astype(np.int32)
    pv = (rng.integers(0, 40, (shards, r, g, k)) * 0.5).astype(np.float32)
    pw = rng.integers(0, 7, (shards, r, g)).astype(np.int32)
    ph = np.minimum(pw, rng.integers(0, 4, (shards, r, g))).astype(np.int32)
    layout = ((0, 0, 3, 0, -1), (0, 1, 3, 0, -1), (1, 2, 3, 0, 2),
              (2, 0, 3, 1, -1))
    ref = jrules.merge_shard_harvests(pk, pv, pw, ph, layout, device_cap)
    got = trules.merge_shard_harvests(pk, pv, pw, ph, layout, device_cap)
    for a, b, name in zip(ref, got, ("key", "val", "w", "h")):
        assert_leaf_equal(a, b, name)


BAD_DOCS = {
    "not an object": [1, 2],
    "empty": {"rules": []},
    "colon in name": {"rules": [{"name": "a:b", "kind": "threshold",
                                 "channel": "t", "op": ">", "value": 1}]},
    "unknown kind": {"rules": [{"name": "a", "kind": "nope"}]},
    "sequence without window": {"rules": [
        {"name": "a", "kind": "sequence",
         "first": {"channel": "t", "op": ">", "value": 1},
         "then": {"channel": "t", "op": "<", "value": 0}}]},
    "duplicate names": {"rules": [
        {"name": "a", "kind": "threshold", "channel": "t", "op": ">", "value": 1},
        {"name": "a", "kind": "threshold", "channel": "t", "op": ">", "value": 2}]},
    "non-monotone window": {"rules": [
        {"name": "a", "kind": "window", "agg": "sum", "channel": "t",
         "op": "<", "value": 3, "windowMs": 10}]},
    "unknown scope": {"rules": [{"name": "a", "kind": "absence",
                                 "channel": "t", "deadlineMs": 5,
                                 "scope": "planet"}]},
    "bad level": {"rules": [{"name": "a", "kind": "absence", "channel": "t",
                             "deadlineMs": 5, "level": "loud"}]},
    "bad etype": {"rules": [{"name": "a", "kind": "absence", "channel": "t",
                             "deadlineMs": 5, "etype": "SMOKE"}]},
    "zero window": {"rules": [{"name": "a", "kind": "absence", "channel": "t",
                               "deadlineMs": 0}]},
    "bad groups knob": {"groups": 0, "rollups": [{"name": "r",
                                                  "channel": "t",
                                                  "windowMs": 5}]},
    "rollup without channel": {"rollups": [{"name": "r", "windowMs": 5}]},
}


@pytest.mark.parametrize("case", list(BAD_DOCS))
def test_ruleset_parse_errors_match_jax(case):
    with pytest.raises(JaxRuleSetError) as jerr:
        JaxRuleSet.parse(BAD_DOCS[case])
    with pytest.raises(RuleSetError) as terr:
        RuleSet.parse(BAD_DOCS[case])
    assert str(terr.value) == str(jerr.value)


def test_lower_matches_jax_tables():
    jeng = JaxEngine(JaxEngineConfig(**CFG, use_native=False))
    teng = Engine(EngineConfig(**CFG, use_native=False), device="cpu")
    jstate, jmeta, jro = JaxRuleSet.parse(RULESET).lower(jeng)
    tstate, tmeta, tro = RuleSet.parse(RULESET).lower(teng)
    assert_tree_equal(jax.device_get(jstate), tstate, "lowered")
    assert [dataclasses.asdict(m) for m in tmeta] == \
        [dataclasses.asdict(m) for m in jmeta]
    assert [dataclasses.asdict(m) for m in tro] == \
        [dataclasses.asdict(m) for m in jro]
    assert RuleSet.parse(RULESET).signature() == \
        JaxRuleSet.parse(RULESET).signature()


@pytest.mark.parametrize("knob", ["rule_groups", "rollup_buckets"])
def test_lower_rejects_empty_tables_like_jax(knob):
    """An engine configured with no group slots or no rollup buckets makes
    ``lower`` raise (parse cannot see engine settings)."""
    cfg = {**CFG, knob: 0}
    with pytest.raises(JaxRuleSetError) as jerr:
        JaxRuleSet.parse(RULESET).lower(
            JaxEngine(JaxEngineConfig(**cfg, use_native=False)))
    with pytest.raises(RuleSetError) as terr:
        RuleSet.parse(RULESET).lower(Engine(EngineConfig(**cfg, use_native=False), device="cpu"))
    assert str(terr.value) == str(jerr.value)
