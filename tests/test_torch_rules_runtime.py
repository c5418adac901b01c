"""The rules tier's host runtime in the port (``rules/manager.py``): hot
reload (``watch_file``, ``check_reload``, ``RuleSetWatcher``), standby
emission and promotion, the rollup archive (``spill_rollups``,
``read_rollup_history``) and the four ``swtpu_rules_*`` counters — each
held to the JAX manager's outcome on the same input.

Both sides run ``Engine(use_native=False)`` with the same pinned epoch
base, so alert dicts (event times derive from the epoch base and the
fire key) compare whole. Values are binary halves, so every float sum is
exact in any order: rollup pages compare for equality.
"""

import json
import os
import threading
import time

import pytest

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.rules import RuleSetError as JaxRuleSetError
from sitewhere_tpu.rules import RulesManager as JaxRulesManager
from sitewhere_tpu.utils.metrics import REGISTRY as JAX_REGISTRY
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.rules import RuleSetError, RuleSetWatcher, RulesManager
from sitewhere_tpu_torch.utils.metrics import REGISTRY

BASE_S = 1_700_000_000.0
CFG = dict(device_capacity=256, token_capacity=512, assignment_capacity=512,
           store_capacity=4096, batch_capacity=32, channels=4, rule_groups=64,
           rollup_buckets=8, use_native=False)

RULESET = {
    "name": "t",
    "rules": [
        {"name": "hot", "kind": "threshold", "channel": "temp",
         "op": ">", "value": 90.0, "cooldownMs": 1000},
        {"name": "burst", "kind": "window", "agg": "count",
         "channel": "temp", "op": ">=", "value": 3, "windowMs": 2000,
         "where": {"channel": "temp", "op": ">", "value": 50.0}},
        {"name": "updown", "kind": "sequence",
         "first": {"channel": "temp", "op": ">", "value": 90.0},
         "then": {"channel": "temp", "op": "<", "value": 5.0},
         "withinMs": 4000},
        {"name": "silent", "kind": "absence", "channel": "temp",
         "deadlineMs": 3000},
    ],
    "rollups": [{"name": "temp-1s", "channel": "temp",
                 "windowMs": 1000, "scope": "device"}],
}
BAD_DOCS = ("{not json", json.dumps({"rules": [
    {"name": "x", "kind": "window", "agg": "count", "channel": "temp",
     "op": "<", "value": 1, "windowMs": 1000}]}))   # non-monotone (agg, op)
ROLLUP_DOC = {"name": "t", "rules": [],
              "rollups": [{"name": "temp-1s", "channel": "temp",
                           "windowMs": 1000, "scope": "device"}]}


def _pin(cls):
    class Pinned(cls):
        def now_ms(self):
            return 9_000

    return Pinned(BASE_S)


def _engines(archive=None, **kw):
    """A JAX engine and a port engine with the same pinned epoch (and each
    its own archive directory under ``archive``)."""
    dirs = ({"archive_dir": str(archive / side)} if archive else {}
            for side in ("jax", "port"))
    jeng = JaxEngine(JaxEngineConfig(**CFG, **kw, **next(dirs)))
    teng = Engine(EngineConfig(**CFG, **kw, **next(dirs)), device="cpu")
    jeng.epoch, teng.epoch = _pin(JaxEpoch), _pin(EpochBase)
    return jeng, teng


def _meas(eng, tok, v, ts_rel):
    return json.dumps({
        "deviceToken": tok, "type": "DeviceMeasurement",
        "request": {"name": "temp", "value": v,
                    "eventDate": int(eng.epoch.base_unix_s * 1000) + ts_rel}}).encode()


def _run(eng, events, chunk=32, prefix="r"):
    for lo in range(0, len(events), chunk):
        eng.ingest_json_batch([_meas(eng, f"{prefix}-{d}", v, ts)
                               for d, v, ts in events[lo:lo + chunk]])
        eng.flush()


def _touch(path, doc):
    path.write_text(doc if isinstance(doc, str) else json.dumps(doc))
    os.utime(path, (path.stat().st_mtime + 2,) * 2)


def _tweaked():
    doc = json.loads(json.dumps(RULESET))
    doc["rules"][0]["value"] = 80.0
    return doc


def _grown():
    doc = json.loads(json.dumps(RULESET))
    doc["rules"].append({"name": "cold", "kind": "threshold", "channel": "temp",
                         "op": "<", "value": -50.0, "cooldownMs": 1000})
    return doc


def _managers(tmp_path, **kw):
    jeng, teng = _engines(**kw)
    out = {}
    for side, eng, cls in (("jax", jeng, JaxRulesManager), ("port", teng, RulesManager)):
        path = tmp_path / f"{side}.json"
        path.write_text(json.dumps(RULESET))
        mgr = cls(eng)
        out[side] = (eng, mgr, path)
    return out


def test_hot_reload_param_tweak_keeps_carried_state(tmp_path):
    sides = _managers(tmp_path)
    got = {}
    for side, (eng, mgr, path) in sides.items():
        assert mgr.watch_file(path)["preservedState"] is False
        _run(eng, [(0, 60.0, 100), (0, 61.0, 200)], chunk=2)   # 2 of 3 window events
        _touch(path, _tweaked())
        assert mgr.check_reload() is True
        assert mgr.check_reload() is False                     # mtime advanced
        _run(eng, [(0, 62.0, 300)], chunk=1)                   # completes the window
        got[side] = (mgr.status()["swaps"], mgr.poll())
    assert got["port"] == got["jax"]
    swaps, alerts = got["port"]
    assert swaps == 2 and any(a["rule"] == "burst" for a in alerts)


def test_hot_reload_shape_change_resets_and_serves_the_new_rule(tmp_path):
    sides = _managers(tmp_path)
    got = {}
    for side, (eng, mgr, path) in sides.items():
        mgr.watch_file(path)
        _run(eng, [(0, 95.0, 100)], chunk=1)
        _touch(path, _grown())
        assert mgr.check_reload() is True
        _run(eng, [(0, 95.0, 1100), (0, -60.0, 1200)], chunk=2)
        got[side] = mgr.poll()
    assert got["port"] == got["jax"]
    assert {a["rule"] for a in got["port"]} >= {"hot", "cold"}


def test_rejected_document_keeps_the_active_set_serving(tmp_path):
    sides = _managers(tmp_path)
    got = {}
    for side, (eng, mgr, path) in sides.items():
        mgr.watch_file(path)
        for bad in BAD_DOCS:
            _touch(path, bad)
            with pytest.raises((RuleSetError, JaxRuleSetError, ValueError)):
                mgr.check_reload()
            assert mgr.ruleset is not None and mgr.ruleset.name == "t"
        _run(eng, [(0, 95.0, 100)], chunk=1)
        st = mgr.status()
        got[side] = (mgr.reload_errors, st["reloadErrors"], st["watchedFile"] == str(path),
                     st["active"], mgr.poll())
    assert got["port"] == got["jax"]
    assert got["port"][:4] == (2, 2, True, True)
    assert any(a["rule"] == "hot" for a in got["port"][4])


def _watch(eng, mgr, path, watcher_cls):
    """A watcher over ``path``: a parameter tweak reloads, a torn document
    is counted while the set keeps serving, ``stop()`` joins the thread."""
    w = watcher_cls(mgr, path, interval_s=0.02)
    w.start()
    try:
        thread = w._thread
        name, alive = thread.name, thread.is_alive()
        watched = mgr.status()["watchedFile"] == str(path)
        _touch(path, _tweaked())
        deadline = time.monotonic() + 10
        while mgr.swaps < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        _touch(path, BAD_DOCS[0])
        while mgr.reload_errors < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        served = mgr.ruleset.doc["rules"][0]["value"]
    finally:
        w.stop()
    # the torn document retries (and counts) every tick until it changes
    return dict(name=name, alive=alive, watched=watched, swaps=mgr.swaps,
                errors=mgr.reload_errors >= 1, served=served,
                joined=w._thread is None and not thread.is_alive())


def test_rule_set_watcher_reloads_and_stops_like_jax(tmp_path):
    from sitewhere_tpu.rules import RuleSetWatcher as JaxRuleSetWatcher

    sides = _managers(tmp_path)
    ref = _watch(*sides["jax"], JaxRuleSetWatcher)
    got = _watch(*sides["port"], RuleSetWatcher)
    assert got == ref
    assert got == dict(name="swtpu-rules-watch", alive=True, watched=True, swaps=2,
                       errors=True, served=80.0, joined=True)
    assert "swtpu-rules-watch" not in {t.name for t in threading.enumerate()}


# -------------------------------------------------- standby and promotion
REPLAY_RULES = {
    "name": "rp",
    "rules": [
        {"name": "hot", "kind": "threshold", "channel": "temp",
         "op": ">", "value": 90.0, "cooldownMs": 1000},
        {"name": "burst", "kind": "window", "agg": "sum", "channel": "temp",
         "op": ">=", "value": 200.0, "windowMs": 2000},
        {"name": "silent", "kind": "absence", "channel": "temp",
         "deadlineMs": 3000},
    ],
    "rollups": [{"name": "temp-1s", "channel": "temp", "windowMs": 1000,
                 "scope": "device"}],
}


def _replay_stream(n=72, devs=4, quiet_after=36):
    out = []
    for i in range(n):
        d = i % devs
        if d == 0 and i >= quiet_after:
            d = 1
        out.append((d, 96.5 if i % 9 == 0 else 30.0 + (i % 20) * 0.5, i * 100))
    return out


def _feed(eng, events, lo, hi, chunk=24):
    for b in range(lo, hi, chunk):
        eng.ingest_json_batch([_meas(eng, f"q-{d}", v, ts)
                               for d, v, ts in events[b:min(b + chunk, hi)]])
    eng.flush()


def _standby_run(owner, standby, mgr_cls):
    """The owner's ingest (its alerts included) applied on a standby that
    runs the same rules with emission off; the owner dies after its first
    poll, the standby promotes and polls."""
    events = _replay_stream()
    omgr, smgr = mgr_cls(owner), mgr_cls(standby, active=False)
    for m in (omgr, smgr):
        m.load(REPLAY_RULES)
    orig = owner.ingest_json_batch

    def forwarding(payloads, tenant="default", **kw):
        res = orig(payloads, tenant, **kw)
        standby.ingest_json_batch(list(payloads), tenant)
        return res

    owner.ingest_json_batch = forwarding
    _feed(owner, events, 0, 36)
    pre = omgr.poll()
    _feed(owner, events, 36, len(events))
    standby.flush()
    passive = smgr.poll()
    status_passive = smgr.status()["active"]
    suppressed0 = smgr.alerts_suppressed
    resynced = smgr.promote()
    post = smgr.poll()
    return dict(pre=pre, post=post, passive=passive, resynced=resynced,
                status_passive=status_passive, active=smgr.status()["active"],
                suppressed=smgr.alerts_suppressed - suppressed0)


def test_standby_promotion_emits_only_the_tail_like_jax():
    jo, to = _engines()
    js, ts = _engines()
    ref = _standby_run(jo, js, JaxRulesManager)
    got = _standby_run(to, ts, RulesManager)
    assert got == ref
    pre = {a["alternateId"] for a in got["pre"]}
    post = {a["alternateId"] for a in got["post"]}
    assert pre and post and not (pre & post)
    assert got["passive"] == [] and got["status_passive"] is False
    assert got["active"] is True and got["suppressed"] > 0


# ------------------------------------------------------- rollup archive
def _rollup_side(eng, mgr_cls):
    mgr = mgr_cls(eng)
    mgr.load(ROLLUP_DOC)
    base = int(eng.epoch.base_unix_s * 1000)
    payloads = [json.dumps({
        "deviceToken": f"r-{i % 4}", "type": "DeviceMeasurement",
        "request": {"name": "temp", "value": 10.0 + (i % 7) * 0.5,
                    "eventDate": base + i * 250}}).encode() for i in range(96)]
    for lo in range(0, 96, 32):
        eng.ingest_json_batch(payloads[lo:lo + 32])
        eng.flush()
    live = mgr.read_rollup("temp-1s", limit=1000)
    first = mgr.spill_rollups(lag=1)
    again = mgr.spill_rollups(lag=1)
    hist = mgr.read_rollup_history("temp-1s", limit=1000)
    one = mgr.read_rollup_history("temp-1s", group="r-1", limit=1000)
    ranged = mgr.read_rollup_history("temp-1s", since_ms=2000, until_ms=9000, limit=5)
    ra = mgr.rollup_archive()
    fresh = mgr_cls(eng)                       # a restart over the same archive
    fresh.load(ROLLUP_DOC)
    return dict(live=live, first=first, again=again, hist=hist, one=one,
                ranged=ranged, restart=fresh.spill_rollups(lag=1),
                rows=ra.total_rows(), dirname=ra.dir.name,
                compressed=[s.stats["enc_bytes"] < s.stats["bytes"] for s in ra.segments],
                main_has_rollups=any("rollups" in s.path for s in eng.archive.segments),
                counter=eng.host_counters.get("rollup_windows_spilled"))


@pytest.mark.parametrize("compress", [True, False], ids=["compressed", "plain"])
def test_rollup_spill_and_history_match_jax(tmp_path, compress):
    jeng, teng = _engines(tmp_path, archive_segment_rows=16, archive_compress=compress)
    ref = _rollup_side(jeng, JaxRulesManager)
    got = _rollup_side(teng, RulesManager)
    assert got == ref
    # the spilled history is exactly the closed live windows
    live = {(b["group"], b["windowStartMs"]): (b["count"], b["sum"], b["min"], b["max"])
            for b in got["live"]["buckets"]}
    newest = max(ws for _, ws in live)
    closed = {k: v for k, v in live.items() if k[1] <= newest - 1000}
    hist = {(b["group"], b["windowStartMs"]): (b["count"], b["sum"], b["min"], b["max"])
            for b in got["hist"]["buckets"]}
    assert hist == closed and closed
    assert got["first"] == {"spilled": len(closed), "rollups": 1}
    assert got["again"]["spilled"] == 0 and got["restart"]["spilled"] == 0
    assert got["one"]["buckets"] and all(b["group"] == "r-1" for b in got["one"]["buckets"])
    assert got["rows"] == got["counter"] == len(closed)
    assert got["dirname"] == "rollups" and not got["main_has_rollups"]
    assert all(got["compressed"]) == compress


def test_rollup_spill_without_an_archive_is_a_no_op():
    _, teng = _engines()
    mgr = RulesManager(teng)
    mgr.load(ROLLUP_DOC)
    assert mgr.rollup_archive() is None
    assert mgr.spill_rollups() == {"spilled": 0, "rollups": 0}
    assert mgr.read_rollup_history("temp-1s")["buckets"] == []
    with pytest.raises(KeyError):
        mgr.read_rollup_history("nope")


# ------------------------------------------------------------- metrics
COUNTERS = ("swtpu_rules_swaps_total", "swtpu_rules_reload_errors_total",
            "swtpu_rules_alerts_total", "swtpu_rules_suppressed_total")


def _counter_values(registry):
    return {name: registry.counter(name, "").value() for name in COUNTERS}


def _metrics_sequence(eng, mgr, path, registry):
    """load -> feed -> poll -> a rejected reload -> a shape-changing reload
    (state reset) -> the same window fires again -> poll (suppressed)."""
    before = _counter_values(registry)
    mgr.watch_file(path)
    _run(eng, [(0, 95.0, 100), (1, 96.0, 150)], chunk=2)
    mgr.poll()
    _touch(path, BAD_DOCS[1])
    with pytest.raises(ValueError):
        mgr.check_reload()
    _touch(path, _grown())
    mgr.check_reload()
    _run(eng, [(0, 97.0, 300), (1, 98.0, 350), (2, 95.0, 400)], chunk=3)
    mgr.poll()
    after = _counter_values(registry)
    return {k: after[k] - before[k] for k in COUNTERS}


def test_rules_counters_move_as_the_jax_managers_do(tmp_path):
    sides = _managers(tmp_path)
    ref = _metrics_sequence(*sides["jax"], JAX_REGISTRY)
    got = _metrics_sequence(*sides["port"], REGISTRY)
    assert got == ref
    assert got == {"swtpu_rules_swaps_total": 2, "swtpu_rules_reload_errors_total": 1,
                   "swtpu_rules_alerts_total": got["swtpu_rules_alerts_total"],
                   "swtpu_rules_suppressed_total": 2}
    assert got["swtpu_rules_alerts_total"] >= 3
