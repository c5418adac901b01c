"""The port's conservation ledger against the JAX package's.

The same seeded wire streams go through both engines (native path, both
clocks pinned) on the arena path, the copy path, a scan chunk, a write-ahead
log and the streaming-rules tier. After each, the port's ledger balances
(``check_conservation`` finds nothing) and gives the JAX ledger's stage
counts. A counter broken on purpose gives the expected violation — the
archive-spill, analytics-windows and edge-admission equations included —
and a recovered engine balances over the rows it replayed. The auditor
thread starts, audits (escalating only a violation seen twice in a row,
counting its device reads) and stops; the payload and the scrape export
carry its verdict.
"""

import threading

import numpy as np
import pytest

from sitewhere_tpu.rules import RulesManager as JaxRulesManager
from sitewhere_tpu.utils.conservation import build_ledger as jax_build_ledger
from sitewhere_tpu.utils.conservation import check_conservation as jax_check
from sitewhere_tpu.utils.ingestlog import IngestLog as JaxLog
from sitewhere_tpu_torch.rules import RulesManager
from sitewhere_tpu_torch.utils.checkpoint import recover_engine, save_engine
from sitewhere_tpu_torch.utils.conservation import (EQUATIONS,
                                                    ConservationAuditor,
                                                    build_ledger,
                                                    check_conservation,
                                                    conservation_payload,
                                                    export_conservation_metrics)
from sitewhere_tpu_torch.utils.metrics import MetricsRegistry
from sitewhere_tpu_torch.utils.ingestlog import IngestLog
from tests.test_torch_ingest_wire import binary_stream, engines, json_stream
from tests.test_torch_wal import PortClock
from tests.torch_parity import strip_trace

RULES = {"name": "c", "rules": [
    {"name": "hot", "kind": "threshold", "channel": "m0", "op": ">",
     "value": 1.0, "cooldownMs": 10}],
    "rollups": [{"name": "m0-1s", "channel": "m0", "windowMs": 1000}]}

STREAMS = {
    "arena": {},
    "copy": dict(ingest_arenas=-1),
    "scan3": dict(scan_chunk=3, dispatch_depth=2),
    "python": dict(use_native=False),
    "wal": "wal",
    "rules": "rules",
}


def _drive(jeng, teng, wire: str, batches: int = 4, flush_each: bool = False,
           managers=None):
    rng = np.random.default_rng(3)
    make = json_stream if wire == "json" else binary_stream
    fn = "ingest_json_batch" if wire == "json" else "ingest_binary_batch"
    for k in range(batches):
        pay = make(k, rng)
        ref = strip_trace(getattr(jeng, fn)(pay))
        assert strip_trace(getattr(teng, fn)(pay)) == ref
        if flush_each:
            jeng.flush()
            teng.flush()
        if managers:
            managers[0].poll(flush=True)
            managers[1].poll(flush=True)


def _stages(ledger) -> dict:
    """The stages both packages report, without the timestamp."""
    st = dict(ledger["stages"])
    return {k: st[k] for k in ("ingest", "device", "wal", "rules") if k in st}


@pytest.mark.parametrize("wire", ["json", "binary"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_ledger_balances_with_the_jax_stage_counts(tmp_path, name, wire):
    kw = STREAMS[name]
    managers = None
    if kw == "wal":
        jeng, teng = engines()
        # each engine its own log directory
        jeng.wal = JaxLog(tmp_path / "jax", group_commit=True)
        teng.wal = IngestLog(tmp_path / "port", group_commit=True)
    else:
        jeng, teng = engines(**({} if kw == "rules" else kw))
    if kw == "rules":
        managers = (JaxRulesManager(jeng), RulesManager(teng))
        managers[0].load(RULES)
        managers[1].load(RULES)
    _drive(jeng, teng, wire, managers=managers)
    # mid-stream, with rows still staged: the backlog term balances them
    jled, tled = jax_build_ledger(jeng, managers and managers[0]), build_ledger(
        teng, managers and managers[1])
    assert check_conservation(tled) == [] and jax_check(jled) == []
    assert _stages(tled)["ingest"] == _stages(jled)["ingest"]
    jeng.flush()
    teng.flush()
    jled, tled = jax_build_ledger(jeng, managers and managers[0]), build_ledger(
        teng, managers and managers[1])
    assert check_conservation(tled) == []
    assert _stages(tled) == _stages(jled)
    ing = tled["stages"]["ingest"]
    assert ing["backlog_rows"] == 0 and ing["staged_rows"] == ing["dispatched_rows"] > 0
    assert tled["watermarks"] == jled["watermarks"] and tled["lag"] == jled["lag"]
    if kw == "wal":
        assert tled["stages"]["wal"]["durable_seq"] == tled["stages"]["wal"]["appended_seq"]
        jeng.wal.close()
        teng.wal.close()
    if kw == "rules":
        assert tled["stages"]["rules"]["harvested"] > 0


def _balanced_ledger():
    jeng, teng = engines()
    _drive(jeng, teng, "json", batches=2, flush_each=True)
    mgr = RulesManager(teng)
    mgr.load(RULES)
    _drive(jeng, teng, "json", batches=1)
    mgr.poll(flush=True)
    teng.flush()
    return teng, build_ledger(teng, mgr)


BREAKS = {
    # (what is broken, equations that must report it)
    "dispatched+1": ({"ingest": {"dispatched_rows": 1}},
                     {"staging-balance", "device-processed"}),
    "staged+1": ({"ingest": {"staged_rows": 1}}, {"staging-balance"}),
    "processed+1": ({"device": {"processed": 1}},
                    {"device-processed", "device-disposition"}),
    "accepted+1": ({"device": {"accepted": 1}}, {"device-disposition"}),
    "harvested+1": ({"rules": {"harvested": 1}}, {"rules-harvest"}),
    "missed>fires": ({"rules": {"missed": 10**6}}, {"rules-harvest"}),
}


@pytest.mark.parametrize("case", list(BREAKS))
def test_a_broken_counter_gives_its_violation(case):
    _, ledger = _balanced_ledger()
    assert check_conservation(ledger) == []
    delta, expected = BREAKS[case]
    for stage, fields in delta.items():
        for key, d in fields.items():
            ledger["stages"][stage][key] += d
    got = {v.equation for v in check_conservation(ledger)}
    assert got == expected and got <= set(EQUATIONS)
    assert {v.equation for v in jax_check(ledger)} == got


def test_a_broken_engine_counter_and_the_wal_equation():
    teng, _ = _balanced_ledger()
    teng.ledger.add("staged_rows", 3)      # rows counted that never staged
    (v,) = check_conservation(build_ledger(teng))
    assert v.equation == "staging-balance" and v.lhs == v.rhs + 3
    ledger = {"stages": {"wal": {"appended_seq": 4, "durable_seq": 5}}}
    (v,) = check_conservation(ledger)
    assert v.equation == "wal-durability" and jax_check(ledger)[0].equation == v.equation


def test_a_recovered_engine_balances_over_its_replay(tmp_path):
    jeng, teng = engines()
    teng.wal = IngestLog(tmp_path / "wal", group_commit=True)
    _drive(jeng, teng, "json", batches=2)
    save_engine(teng, tmp_path / "snap")
    _drive(jeng, teng, "json", batches=2)
    teng.wal.close()
    rec = recover_engine(tmp_path / "snap", tmp_path / "wal", device="cpu",
                         epoch_cls=PortClock)
    ledger = build_ledger(rec)
    assert check_conservation(ledger) == []
    ing = ledger["stages"]["ingest"]
    assert ing["staged_rows"] == ing["dispatched_rows"] == \
        ledger["stages"]["device"]["processed"] > 0


def _archive_ledger(tmp_path):
    """A balanced ledger of a port engine with an archive (its ring wrapped
    several times) and an analytics job that scored part of it."""
    from sitewhere_tpu_torch.engine import Engine, EngineConfig
    from sitewhere_tpu_torch.models.analytics import AnalyticsJobSpec, AnalyticsManager
    from tests.test_torch_analytics_jobs import CFG, MIN_FILL, W, _feed, _stream

    teng = Engine(EngineConfig(**CFG, archive_dir=str(tmp_path / "a")), device="cpu")
    teng.epoch = PortClock(1_700_000_000.0)
    _feed(teng, _stream())
    AnalyticsManager(teng).run_job(AnalyticsJobSpec(
        window=W, batch_devices=5, min_fill=MIN_FILL, emit=False, name="c"))
    ledger = build_ledger(teng)
    assert check_conservation(ledger) == []
    assert ledger["stages"]["archive"]["rows"] > 0
    assert ledger["stages"]["analytics"]["planned"] == 12
    return ledger


ARCHIVE_BREAKS = {
    # (stage, part or None, key, delta)
    "spilled_past_head": ("archive", "0", "spilled", 10**6),
    "backlog_past_capacity": ("archive", "0", "head", 10**6),
    "planned+1": ("analytics", None, "planned", 1),
    "scored+1": ("analytics", None, "scored", 1),
    "skipped+1": ("analytics", None, "skipped_underfilled", 1),
    "cancelled+1": ("analytics", None, "cancelled", 1),
}


@pytest.mark.parametrize("case", list(ARCHIVE_BREAKS))
def test_archive_and_analytics_equations_are_falsifiable(tmp_path, case):
    """The archive-spill and analytics-windows equations audit clean on a
    live engine and trip on a change of any one term, as the JAX checker
    does on the same ledger; a loss the archive counted is legal slack."""
    ledger = _archive_ledger(tmp_path)
    stage, part, key, delta = ARCHIVE_BREAKS[case]
    target = ledger["stages"][stage]
    if part is not None:
        target = target["parts"][part]
    target[key] += delta
    expected = {"archive-spill"} if stage == "archive" else {"analytics-windows"}
    got = {v.equation for v in check_conservation(ledger)}
    assert got == expected and got <= set(EQUATIONS)
    assert {v.equation for v in jax_check(ledger)} == got
    if case == "backlog_past_capacity":
        ledger["stages"]["archive"]["lost_rows"] += 10**6
        assert check_conservation(ledger) == []


EDGE_BREAKS = {
    "offered+1": ("offered", 1),
    "shed+1": ("shed", 1),
}


@pytest.mark.parametrize("case", list(EDGE_BREAKS))
def test_edge_admission_equation_matches_jax_and_is_falsifiable(case):
    """A QoS engine's edge stage (offered, admitted, shed, sheds noted after
    admission) equals the JAX engine's for the same admissions, balances,
    and a broken counter reports ``edge-admission`` in both checkers."""
    jeng, teng = engines(qos=True, tenant_rates={"t2": 30.0})
    from sitewhere_tpu.utils import qos as jqos
    from sitewhere_tpu_torch.utils import qos as tqos

    for eng, mod in ((jeng, jqos), (teng, tqos)):
        eng.qos = mod.AdmissionController(tenant_rates={"t2": 30.0}, burst_s=1.0,
                                          clock=mod.ManualClock())
        for n in (10, 25, 5, 40, 1):
            eng.qos.admit("t2", n)
            eng.qos.admit("default", n)
        eng.qos.note_shed("t2", 4, "stall")
    _drive(jeng, teng, "json", batches=2, flush_each=True)
    tled, jled = build_ledger(teng), jax_build_ledger(jeng)
    assert tled["stages"]["edge"] == jled["stages"]["edge"]
    assert check_conservation(tled) == []
    key, d = EDGE_BREAKS[case]
    tled["stages"]["edge"][key] += d
    assert {v.equation for v in check_conservation(tled)} == {"edge-admission"}
    assert {v.equation for v in jax_check(tled)} == {"edge-admission"}


def test_auditor_confirms_on_the_second_read_and_counts_its_syncs():
    reg = MetricsRegistry()
    jeng, eng = engines()
    _drive(jeng, eng, "json", batches=2, flush_each=True)
    aud = ConservationAuditor(eng, interval_s=60.0, registry=reg)
    assert eng.conservation_auditor is aud
    _, v = aud.audit()
    assert not v and aud.audits == 1
    # device reads of one audit: the metrics counters and the tenant grid
    assert aud.stats["audits"] == 1 and aud.stats["syncs"] == 2
    eng.ledger.counters["staged_rows"] += 3
    _, v1 = aud.audit()
    assert v1 and aud.confirmed_total == 0     # first read: a suspect
    _, v2 = aud.audit()
    assert v2 and aud.confirmed_total == 1     # second read: escalated
    c = reg.counter("swtpu_conservation_violation_total")
    assert c.value(equation="staging-balance") == 1.0
    eng.ledger.counters["staged_rows"] -= 3
    _, v3 = aud.audit()
    assert not v3 and aud.confirmed_total == 1


def test_auditor_thread_starts_audits_and_stops():
    jeng, eng = engines()
    _drive(jeng, eng, "json", batches=2)
    aud = ConservationAuditor(eng, interval_s=0.01)
    three = threading.Event()
    audit = aud.audit

    def counted():
        out = audit()
        if aud.audits >= 3:
            three.set()
        return out

    aud.audit = counted
    aud.start()
    assert aud.running
    aud.start()                                   # idempotent
    assert three.wait(timeout=60)
    aud.stop()
    assert not aud.running and aud.confirmed_total == 0
    assert aud.last_ledger is not None and not aud.last_violations


def test_conservation_payload_and_flow_export():
    jeng, eng = engines()
    _drive(jeng, eng, "json", batches=2, flush_each=True)
    doc = conservation_payload(eng)
    assert doc["balanced"] and doc["violations"] == [] and "auditor" not in doc
    staged = doc["ledger"]["stages"]["ingest"]["staged_rows"]
    aud = ConservationAuditor(eng, interval_s=60.0)
    aud.audit()
    doc = conservation_payload(eng)
    assert doc["auditor"] == {"audits": 1, "confirmedViolations": 0,
                              "intervalS": 60.0, "running": False}
    reg = MetricsRegistry()
    export_conservation_metrics(eng, reg)
    lbl = eng.metrics_label
    g = reg.gauge("swtpu_flow_rows")
    assert g.value(stage="staged", engine=lbl) == staged > 0
    assert g.value(stage="dispatched", engine=lbl) == staged
    assert reg.gauge("swtpu_conservation_audits_total").value(engine=lbl) == 1
    assert reg.gauge("swtpu_conservation_violations").value(engine=lbl) == 0
