"""The port's metrics plane (``utils/metrics.py``) held to the JAX package
on the CPU.

Byte for byte: the registry core — counters, gauges (with ``retain``),
histograms (``observe_n``, exemplars, ``quantile``, ``count_where``,
``quantile_where``) and their text exposition, exemplars included — and
``strip_exemplars``. Equal after the ``engine="e<n>"`` label is
normalised (labels count per process): the series names and label keys
an engine exports on the same multi-tenant stream, with the counts and
integer gauges exact and the timing histograms' sample counts exact. The
one pinned divergence: the JAX package's compile-watchdog series
(``swtpu_xla_*``) have no port counterpart. The exposition parses, and
the single-rank federated exposition carries ``rank="0"`` and
``swtpu_cluster_rank_up``.
"""

import re

import numpy as np

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.utils import metrics as jm
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.utils import metrics as tm
from tests.test_torch_ingest_wire import SIZES, json_stream, pinned

# series the host plane exports on a QoS engine with a recorder, a tracer,
# the conservation ledger and an arena pool: chip_smoke.py's hostplane
# phase holds the card's scrape to the same list
PINNED_SERIES = (
    "swtpu_engine_processed", "swtpu_engine_persisted", "swtpu_engine_arena_rows",
    "swtpu_tenant_events", "swtpu_pipeline_accepted", "swtpu_pipeline_invalid",
    "swtpu_arena_pool_arenas", "swtpu_arena_pool_free", "swtpu_arena_pool_inflight",
    "swtpu_arena_pool_waits", "swtpu_arena_pool_occupancy_hwm",
    "swtpu_staged_backlog_hwm_rows", "swtpu_dispatch_inflight", "swtpu_flight_records",
    "swtpu_span_records", "swtpu_spans_recorded_total", "swtpu_spans_sampled_out_total",
    "swtpu_ingest_e2e_seconds", "swtpu_device_exec_seconds", "swtpu_flow_rows",
    "swtpu_conservation_audits_total", "swtpu_conservation_violations",
    "swtpu_device_mem_bytes", "swtpu_device_mem_hwm", "swtpu_qos_admitted_total",
    "swtpu_qos_shed_total", "swtpu_qos_bucket_fill", "swtpu_qos_shed_threshold",
    "swtpu_qos_wfq_vtime", "swtpu_query_latency_seconds", "swtpu_queries_total",
)

_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)( # .*)?$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse(text: str) -> dict:
    """Prometheus text -> {(name, frozenset(labels)): value}; raises on a
    line that is neither a comment nor a sample. ``engine`` labels are
    normalised (their numbers count per process)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        assert m, f"unparsable exposition line: {line!r}"
        labels = dict(_LABEL.findall(m.group(3) or ""))
        if "engine" in labels:
            labels["engine"] = "E"
        out[(m.group(1), frozenset(labels.items()))] = float(m.group(4))
    return out


def _family(name: str) -> str:
    return re.sub(r"_(bucket|sum|count)$", "", name)


def test_registry_core_matches_jax():
    regs = [jm.MetricsRegistry(), tm.MetricsRegistry()]
    rng = np.random.default_rng(0)
    ops = [(int(rng.integers(0, 5)), float(rng.lognormal(-4, 2)),
            ["a", "b", 'q"x\\y\nz'][int(rng.integers(0, 3))]) for _ in range(400)]
    for reg in regs:
        c = reg.counter("swtpu_t_total", "a counter")
        g = reg.gauge("swtpu_t_gauge", "a gauge")
        h = reg.histogram("swtpu_t_seconds", "a histogram",
                          buckets=jm.E2E_LATENCY_BUCKETS)
        for op, v, t in ops:
            if op == 0:
                c.inc(v, tenant=t)
            elif op == 1:
                g.set(v, tenant=t, engine="e1")
            elif op == 2:
                h.observe(v, tenant=t)
            elif op == 3:
                h.observe_n(v, int(v * 100) % 7 + 1, exemplar=f"{int(v * 1e6):032x}",
                            tenant=t)
            else:
                g.dec(v, tenant=t, engine="e2")
        g.retain({tuple(sorted({"tenant": "a", "engine": "e1"}.items()))}, engine="e1")
    j, t = regs
    for ex in (False, True):
        assert t.expose_text(exemplars=ex) == j.expose_text(exemplars=ex)
    hj, ht = j.histogram("swtpu_t_seconds"), t.histogram("swtpu_t_seconds")
    for q in (0.5, 0.9, 0.99):
        assert ht.quantile(q, tenant="a") == hj.quantile(q, tenant="a")
        assert ht.quantile_where(q) == hj.quantile_where(q)
    assert ht.count_where(tenant="b") == hj.count_where(tenant="b")
    text = t.expose_text(exemplars=True)
    assert tm.strip_exemplars(text) == jm.strip_exemplars(text)
    assert " # {" not in tm.strip_exemplars(text) and " # {" in text
    assert tm.next_engine_label().startswith("e")


def test_quantile_since_reads_only_the_window():
    """``quantile_since`` over a ``snapshot`` baseline equals the quantile
    of a histogram (the port's and JAX's) that saw only the window."""
    rng = np.random.default_rng(3)
    before, window = (rng.lognormal(-3, 2, n) for n in (300, 200))
    h = tm.MetricsRegistry().histogram("swtpu_w_seconds", "w", buckets=jm.E2E_LATENCY_BUCKETS)
    assert h.quantile_since(0.99, h.snapshot(dst="1"), dst="1") is None
    for v in before:
        h.observe(float(v), dst="1")
        h.observe(float(v) / 10, dst="0")
    base = h.snapshot(dst="1")
    assert h.quantile_since(0.99, base, dst="1") is None
    alone = [tm.MetricsRegistry().histogram("swtpu_w_seconds", "w",
                                            buckets=jm.E2E_LATENCY_BUCKETS),
             jm.MetricsRegistry().histogram("swtpu_w_seconds", "w",
                                            buckets=jm.E2E_LATENCY_BUCKETS)]
    for v in window:
        for x in (h, *alone):
            x.observe(float(v), dst="1")
    assert h.snapshot(dst="1")[1] - base[1] == len(window)
    for q in (0.5, 0.9, 0.99):
        got = h.quantile_since(q, base, dst="1")
        assert got == alone[0].quantile(q, dst="1") == alone[1].quantile(q, dst="1")


def _engines(tmp_path):
    cfg = dict(SIZES, qos=True, tenant_weights={"t2": 2.0}, tenant_rates={"t2": 5.0})
    jeng = JaxEngine(JaxEngineConfig(**cfg))
    teng = Engine(EngineConfig(**cfg), device="cpu")
    jeng.epoch, teng.epoch = pinned(JaxEpoch), pinned(EpochBase)
    for eng in (jeng, teng):
        rng = np.random.default_rng(1)
        for k in range(5):
            tenant = "t2" if k % 2 else "default"
            eng.qos.admit(tenant, 10)
            eng.ingest_json_batch(json_stream(k, rng), tenant)
        eng.flush()
        eng.query_events(limit=4)
    return jeng, teng


def test_engine_exposition_matches_jax(tmp_path):
    """The same stream exports the same series and label keys, with equal
    counts; timing histograms agree in their sample counts."""
    jeng, teng = _engines(tmp_path)
    from sitewhere_tpu.utils.conservation import ConservationAuditor as JaxAuditor
    from sitewhere_tpu_torch.utils.conservation import ConservationAuditor

    JaxAuditor(jeng).audit()
    ConservationAuditor(teng).audit()
    rj, rt = jm.MetricsRegistry(), tm.MetricsRegistry()
    jm.export_engine_metrics(jeng, rj)
    tm.export_engine_metrics(teng, rt)
    sj, st = parse(rj.expose_text()), parse(rt.expose_text())
    sj = {k: v for k, v in sj.items() if not k[0].startswith("swtpu_xla_")}
    # live-array bytes: JAX counts its live buffers, the port the card's
    # caching allocator (none on the CPU)
    sj = {k: v for k, v in sj.items()
          if ("component", "live_arrays") not in k[1]}
    assert set(st) == set(sj)
    timing = ("_seconds_bucket", "_seconds_sum")
    for key, v in sj.items():
        name = key[0]
        if name.endswith(timing):
            continue
        if name.startswith(("swtpu_qos_bucket_fill", "swtpu_qos_wfq_vtime")):
            continue            # token balances read the wall clock
        assert st[key] == v, key
    e2e = {k: v for k, v in st.items() if k[0] == "swtpu_ingest_e2e_seconds_count"}
    assert sum(e2e.values()) == sum(r["payloads"] for r in teng.recent_traces(64))


def test_scrape_parses_and_holds_the_pinned_series(tmp_path):
    _, teng = _engines(tmp_path)
    from sitewhere_tpu_torch.utils.conservation import ConservationAuditor

    ConservationAuditor(teng).audit()
    reg = tm.MetricsRegistry()
    tm.export_engine_metrics(teng, reg)
    # the process-global instruments (query, QoS) live on REGISTRY
    families = {_family(n) for n, _ in parse(reg.expose_text())} | \
        {_family(n) for n, _ in parse(tm.REGISTRY.expose_text())}
    assert set(PINNED_SERIES) <= families, set(PINNED_SERIES) - families
    import chip_smoke

    assert tuple(chip_smoke.HOSTPLANE_SERIES) == PINNED_SERIES


def test_exemplars_link_the_slowest_records_to_their_traces():
    eng = Engine(EngineConfig(**SIZES), device="cpu")
    rng = np.random.default_rng(2)
    ids = []
    for k in range(4):
        ids.append(eng.ingest_json_batch(json_stream(k, rng), "ex-t")["trace_id"])
    eng.flush()
    reg = tm.MetricsRegistry()
    tm.harvest_slo(eng, reg)
    text = reg.expose_text(exemplars=True)
    found = set(re.findall(r'# \{trace_id="([0-9a-f]{32})"\}', text))
    assert found and found <= set(ids)
    assert " # {" not in reg.expose_text()
    tm.harvest_slo(eng, reg)                    # each record once
    assert (reg.histogram("swtpu_ingest_e2e_seconds").count_where(tenant="ex-t")
            == sum(r["payloads"] for r in eng.recent_traces(8)))


def test_federated_exposition_of_one_engine():
    eng = Engine(EngineConfig(**SIZES), device="cpu")
    eng.ingest_json_batch(json_stream(0, np.random.default_rng(3)))
    eng.flush()
    text = tm.federated_exposition(eng)
    samples = parse(tm.strip_exemplars(text))
    assert samples[("swtpu_cluster_rank_up", frozenset({("rank", "0")}))] == 1.0
    assert all(("rank", "0") in labels for _, labels in samples)
    assert text.count("# TYPE swtpu_engine_processed ") == 1
