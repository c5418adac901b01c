"""The shard heat and skew plane of the port (``utils/shardobs.py``, the
multi-shard engine's flow document and its ``swtpu_shard_*`` series)
held to the JAX package's: the tracker on identical inputs, the
spmd-shard-flow equation (balanced, falsifiable, with the mid-flight
backlog as its only slack), the hot tenant and slot found, the staged
high-watermark, ``metrics()`` unchanged by the plane, the scrape series.
The cases of ``tests/test_shardobs.py`` that need the cluster plane
(placement's ``decide_balance``, the debug bundle, the Perfetto
converter) wait for it."""

import json

import numpy as np
import pytest

from sitewhere_tpu.utils.shardobs import ShardHeatTracker as JaxTracker
from sitewhere_tpu.utils.shardobs import heat_map_doc as jax_heat_map_doc
from sitewhere_tpu_torch.parallel.placement import slot_for_token
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation
from sitewhere_tpu_torch.utils.metrics import MetricsRegistry, export_engine_metrics
from sitewhere_tpu_torch.utils.shardobs import (ShardHeatTracker, heat_map_doc,
                                                spmd_heat_payload)
from tests.test_metrics_exposition import lint_prometheus
from tests.torch_spmd import _meas, _stream, jax_spmd, run, settle, torch_single, torch_spmd


def _grid(n_shards, n_buckets, accepted, invalid=None):
    g = np.zeros((n_shards, n_buckets, 4), np.int64)
    g[..., 0] = accepted
    if invalid is not None:
        g[..., 3] = invalid
    return g


def _heat_script(tr):
    """The unit sequences of the JAX tests on one tracker: harvests with a
    hot cell and a hot slot, a quiet interval, a regression, dispatch
    skews and the audits; returns everything it exposes."""
    slots = np.zeros(tr.n_slots, np.int64)
    tr.harvest(_grid(tr.n_shards, 4, 0), slots, now_s=0.0)
    g = _grid(tr.n_shards, 4, 0, invalid=0)
    g[0, 1, 0], g[0, 1, 3] = 50, 5
    s2 = slots.copy()
    s2[3] = 50
    tr.harvest(g, s2, now_s=1.0)
    tr.harvest(g, s2, now_s=3.5)
    tr.harvest(_grid(tr.n_shards, 4, 7), s2, now_s=4.0)      # went backwards
    skews = [tr.note_dispatch(r) for r in ([8] + [0] * (tr.n_shards - 1),
                                           [2] * tr.n_shards, [0] * tr.n_shards)]
    audits = [tr.audit_skew() for _ in range(4)]
    return (tr.heat_grid.tolist(), tr.slot_heat.tolist(), skews, audits,
            tr.take_skew_hwm(), tr.take_skew_hwm(), tr.top_slots(), tr.sustained_total,
            tr.skew_posture())


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_tracker_matches_jax_on_the_same_inputs(n_shards):
    kw = dict(halflife_s=10.0, skew_threshold=2.0)
    assert (_heat_script(ShardHeatTracker(n_shards, 8 * n_shards, **kw))
            == _heat_script(JaxTracker(n_shards, 8 * n_shards, **kw)))


def test_tracker_halflife_is_exact_and_first_harvest_primes_at_zero():
    tr = ShardHeatTracker(1, 4, halflife_s=10.0)
    tr.harvest(_grid(1, 2, 0), np.zeros(4, np.int64), now_s=0.0)
    assert tr.harvests == 1 and not tr.heat_grid.any() and tr.top_slots() == []
    g = _grid(1, 2, 0)
    g[0, 0, 0] = 40
    tr.harvest(g, np.zeros(4, np.int64), now_s=10.0)
    warm = float(tr.heat_grid[0, 0])
    tr.harvest(g, np.zeros(4, np.int64), now_s=20.0)
    assert float(tr.heat_grid[0, 0]) == warm * 0.5


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_flow_conservation_balances_and_is_falsifiable(n_shards):
    eng = torch_spmd(n_shards)
    run([eng], _stream(n=96))
    settle(eng)
    led = build_ledger(eng)
    assert not check_conservation(led)
    sp, dev = led["stages"]["spmd"], led["stages"]["device"]
    assert sp["shards"] == n_shards and sp["counting"]
    for lane in ("processed", "accepted", "invalid"):
        assert sum(r[lane] for r in sp["perShard"]) == dev[lane]
    for row in sp["perShard"]:
        assert row["backlog_rows"] == 0
        assert row["routed_rows"] == row["dispatched_rows"] > 0
    bad = json.loads(json.dumps(led))
    bad["stages"]["spmd"]["perShard"][0]["accepted"] += 1
    vs = check_conservation(bad)
    assert len(vs) == 2 and {v.equation for v in vs} == {"spmd-shard-flow"}
    bad2 = json.loads(json.dumps(led))
    bad2["stages"]["spmd"]["perShard"][-1]["dispatched_rows"] -= 1
    assert any(v.equation == "spmd-shard-flow" for v in check_conservation(bad2))


def test_shard_flow_mid_flight_backlog_is_the_legal_slack():
    eng, jeng = torch_spmd(2), jax_spmd(2)
    wire = [_meas(f"sp-{i % 8}", 30.0, 1_000 + i * 10) for i in range(16)]
    for e in (eng, jeng):
        e.ingest_json_batch(wire)                     # staged, not flushed
    assert eng.shard_flow() == jeng.shard_flow()
    led = build_ledger(eng)
    assert not check_conservation(led)
    sp = led["stages"]["spmd"]
    assert sum(r["backlog_rows"] for r in sp["perShard"]) == 16
    assert all(r["dispatched_rows"] == 0 for r in sp["perShard"])
    eng.flush()
    eng.drain()
    assert not check_conservation(build_ledger(eng))


def test_single_card_ledger_has_no_spmd_stage():
    eng = torch_single()
    run([eng], _stream(n=32))
    led = build_ledger(eng)
    assert "spmd" not in led["stages"] and not check_conservation(led)


def test_heat_fingers_hot_tenant_and_hot_slot_as_in_jax():
    docs = []
    for eng in (torch_spmd(2), jax_spmd(2)):
        eng.harvest_shard_heat(now_s=0.0)
        hot = [_meas("blaze-7", 21.0, 1_000 + i) for i in range(64)]
        for lo in range(0, 64, 16):
            eng.ingest_json_batch(hot[lo:lo + 16], tenant="blaze")
            eng.flush()
        eng.ingest_json_batch([_meas(f"cold-{i}", 21.0, 1_000 + i) for i in range(8)],
                              tenant="quiet")
        eng.flush()
        eng.drain()
        tracker = eng.harvest_shard_heat(now_s=1.0)
        doc = (heat_map_doc if isinstance(tracker, ShardHeatTracker)
               else jax_heat_map_doc)(tracker, eng.tenants)
        docs.append((doc, tracker.top_slots(), tracker.dispatches))
    (doc, top, dispatches), jax_doc = docs[0], docs[1]
    assert (doc, top, dispatches) == jax_doc
    cells = [(eps, ten) for c in doc.values() for ten, eps in c.items()]
    assert max(cells)[1] == "blaze"
    assert top[0][0] == slot_for_token("blaze-7", 2)


def test_spmd_heat_payload_and_duck_typing():
    eng = torch_spmd(2)
    run([eng], _stream(n=32))
    eng.harvest_shard_heat(now_s=0.0)
    payload = spmd_heat_payload(eng, now_s=1.0)
    assert payload["spmd"] is True and payload["flow"]["perShard"]
    assert payload["skew"]["dispatches"] > 0
    assert eng.spmd_heat()["spmd"] is True
    assert spmd_heat_payload(torch_single()) == {"spmd": False}
    assert spmd_heat_payload(object()) == {"spmd": False}


def test_staged_hwm_reset_on_scrape_sees_drained_pileup():
    eng = torch_spmd(2)
    wire = [_meas(f"sp-{i % 8}", 30.0, 1_000 + i * 10) for i in range(24)]
    eng.ingest_json_batch(wire)
    eng.flush()
    eng.drain()
    hwm = eng.take_shard_staged_hwm()
    assert sum(hwm) == 24 and all(h > 0 for h in hwm)
    assert eng.take_shard_staged_hwm() == [0, 0]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_metrics_dict_unchanged_with_heat_plane_exercised(n_shards):
    a, b = torch_spmd(n_shards, scan_chunk=1), torch_spmd(n_shards, scan_chunk=2)
    events = _stream(n=64)
    clock = iter(range(100))
    for lo in range(0, len(events), 16):
        wire = [_meas(t, v, ts) for t, v, ts in events[lo:lo + 16]]
        for e in (a, b):
            e.ingest_json_batch(wire)
            e.flush()
            e.harvest_shard_heat(now_s=float(next(clock)))
            e.shard_flow()
            e.take_shard_staged_hwm()
            e.spmd_heat()
    settle(a, b)
    ma, mb = a.metrics(), b.metrics()
    assert ma == mb
    assert not any("heat" in k or "skew" in k or "slot" in k for k in ma)


def test_heat_series_export_at_scrape():
    eng = torch_spmd(2)
    wire = [_meas(f"sx-{i % 8}", float(i), 1_000 + i) for i in range(24)]
    reg = MetricsRegistry()
    for _ in range(2):
        eng.ingest_json_batch(wire)
        eng.flush()
        eng.drain()
        reg = MetricsRegistry()
        export_engine_metrics(eng, reg)
    text = reg.expose_text()
    lint_prometheus(text)
    lbl = eng.metrics_label
    for s in ("0", "1"):
        assert f'swtpu_shard_staged_rows_hwm{{engine="{lbl}",shard="{s}"}}' in text
        for lane in ("processed", "accepted", "routed_rows", "dispatched_rows",
                     "backlog_rows"):
            assert f'swtpu_shard_flow_rows{{engine="{lbl}",lane="{lane}",shard="{s}"}}' in text
    for name in ("swtpu_shard_heat", "swtpu_slot_heat_topk"):
        assert f'{name}{{engine="{lbl}"' in text
    assert f'swtpu_spmd_skew{{engine="{lbl}"}}' in text
    assert f'swtpu_spmd_skew_hwm{{engine="{lbl}"}}' in text
    reg1 = MetricsRegistry()
    export_engine_metrics(torch_single(), reg1)
    t1 = reg1.expose_text()
    assert not any(n in t1 for n in ("swtpu_shard_flow_rows", "swtpu_shard_heat",
                                     "swtpu_spmd_skew"))


def test_spmd_flight_spans_match_jax():
    """The multi-shard ingest's flight records carry the route / scatter
    lifecycle as spmd.* spans and the skew breadcrumbs on the root event,
    with JAX's names; a single-card record derives no spmd.* span."""
    from sitewhere_tpu.utils.tracing import timeline_events as jax_timeline
    from sitewhere_tpu_torch.utils.tracing import timeline_events

    wire = [_meas(f"fl-{i % 8}", 25.0, 1_000 + i) for i in range(16)]
    names = []
    for eng, timeline in ((torch_spmd(2), timeline_events), (jax_spmd(2), jax_timeline)):
        eng.ingest_json_batch(wire)
        eng.flush()
        eng.drain()
        rec = next(r for r in eng.flight.recent(kind="ingest")
                   if "route" in (r.get("stagesUs") or {}))
        events = timeline(eng, rec["traceId"])
        root = next(e for e in events if e["name"] == "ingest")
        assert root["args"]["shard_rows"].count("/") == 1 and "skew" in root["args"]
        names.append({e["name"] for e in events if e["name"].startswith("ingest.")})
    assert names[0] == names[1]
    assert {"ingest.spmd.route", "ingest.spmd.scatter", "ingest.spmd.commit"} <= names[0]
    single = torch_single()
    single.ingest_json_batch(wire)
    single.flush()
    rec = single.flight.recent(kind="ingest")[-1]
    assert not any("spmd" in e["name"] for e in timeline_events(single, rec["traceId"]))
