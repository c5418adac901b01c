"""The port's archive -> device analytics jobs against the JAX package's.

``fill_windows`` must equal the JAX op byte for byte on seeded rows
(over-full and under-filled devices, dropped and out-of-range slots, tied
timestamps). ``AnalyticsManager.run_job`` runs on a JAX and a port engine
fed the same stream (native decode, both clocks pinned, archive on), each
scoring with the same weights: the JAX side a flax ``AnomalyModel``
initialized from ``jax.random.key(0)``, the port the same parameters
through ``convert.anomaly_params_from_flax``. Devices, window ends,
validity, dedup keys, emitted alerts, job counters and the conservation
counters must be identical; scores agree within the tolerances of
``tests/test_torch_anomaly.py``:

* float32: ``rtol=1e-5, atol=1e-6`` — the same products summed in another
  order;
* bfloat16: ``rtol=1e-2, atol=1e-3`` — both sides round every product and
  activation to bf16, at places that differ.

Cancel, a re-run that suppresses, ``max_batches`` followed by a recovery
that emits exactly the unshipped tail, and standby promotion are covered
as the JAX package's tests cover them.
"""

import json
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.models.analytics import AnalyticsJobSpec as JaxSpec
from sitewhere_tpu.models.analytics import AnalyticsManager as JaxManager
from sitewhere_tpu.models.anomaly import AnomalyConfig as JaxConfig
from sitewhere_tpu.models.anomaly import AnomalyModel as JaxModel
from sitewhere_tpu.ops.window_fill import fill_windows as jax_fill_windows
from sitewhere_tpu_torch.convert import anomaly_params_from_flax
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.core.types import EventType
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.models.analytics import (SCORE_KEY_PREFIX,
                                                  AnalyticsJobSpec,
                                                  AnalyticsManager)
from sitewhere_tpu_torch.models.anomaly import AnomalyConfig, AnomalyModel
from sitewhere_tpu_torch.ops import window_features as wf
from sitewhere_tpu_torch.ops.window_fill import fill_windows
from sitewhere_tpu_torch.utils.checkpoint import replay_wal_into, restore_engine, save_engine
from sitewhere_tpu_torch.utils.conservation import build_ledger, check_conservation
from tests.test_torch_ingest_wire import BASE_MS, pinned
from tests.test_torch_wal import PortClock

W, C, M = 8, 4, 8
MIN_FILL = 4
F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=1e-3)
CFG = dict(device_capacity=64, token_capacity=256, assignment_capacity=128,
           store_capacity=64, batch_capacity=16, channels=C,
           archive_segment_rows=16)
JOB_KEYS = ("state", "devices", "planned", "scored", "skipped_underfilled",
            "cancelled", "emitted", "suppressed", "rounds", "segments",
            "bytes", "rows")


# ------------------------------------------------------------ fill_windows
FILL_CASES = {
    # n rows, m slots, w, channels, slot range, ts range
    "overfull": (400, 8, 6, 5, (-2, 10), (0, 30)),
    "underfilled": (40, 16, 8, 3, (0, 16), (0, 1000)),
    "ties_dropped": (256, 4, 16, 4, (-3, 7), (0, 4)),
}


@pytest.mark.parametrize("case", list(FILL_CASES))
def test_fill_windows_matches_jax(case):
    n, m, w, c, slots, tss = FILL_CASES[case]
    rng = np.random.default_rng(len(case))
    cols = (rng.integers(*slots, n).astype(np.int32),
            rng.integers(*tss, n).astype(np.int32),
            rng.permutation(n).astype(np.int32),
            rng.standard_normal((n, c)).astype(np.float32),
            rng.random((n, c)) < 0.7)
    ref_data, ref_counts = jax_fill_windows(*(jnp.asarray(x) for x in cols), m=m, w=w)
    data, counts = fill_windows(*(torch.from_numpy(x) for x in cols), m=m, w=w)
    assert data.dtype == torch.float32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(data.numpy(), np.asarray(ref_data))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    if case == "overfull":
        assert counts.numpy().max() > w        # older rows spilled off
    if case == "underfilled":
        assert counts.numpy().min() < w


# ------------------------------------------------------------------ engines
def _meas(tok: str, ts_rel: int, vals: dict) -> bytes:
    return json.dumps({"deviceToken": tok, "type": "DeviceMeasurements",
                       "request": {"measurements": vals,
                                   "eventDate": BASE_MS + ts_rel}}).encode()


def _stream(n_devices: int = 12, n_each: int = 10) -> list[bytes]:
    """Interleaved measurements of ``n_devices`` devices; device k%12 == 11
    sends only 3 (under MIN_FILL)."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(n_devices * n_each):
        d = i % n_devices
        if d == n_devices - 1 and i >= 3 * n_devices:
            continue
        out.append(_meas(f"kr-{d}", 1000 + i, {
            "c0": float(rng.standard_normal()), "c1": float(rng.standard_normal())}))
    return out


def _feed(eng, payloads, per_call: int = 4) -> None:
    for lo in range(0, len(payloads), per_call):
        eng.ingest_json_batch(payloads[lo:lo + per_call])
    eng.flush()


def _engines(tmp_path, **kw):
    jeng = JaxEngine(JaxEngineConfig(**CFG, archive_dir=str(tmp_path / "jax"), **kw))
    teng = Engine(EngineConfig(**CFG, archive_dir=str(tmp_path / "port"), **kw),
                  device="cpu")
    jeng.epoch, teng.epoch = pinned(JaxEpoch), pinned(EpochBase)
    return jeng, teng


def _services(dtype: str):
    """Service stand-ins carrying one set of weights: flax parameters from
    ``jax.random.key(0)`` and their conversion."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                    torch.bfloat16)
    kw = dict(sensors=C, window=W, hidden=256, lstm_hidden=256, latent=32)
    jcfg = JaxConfig(**kw, dtype=jdt)
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((2, W, C), jnp.float32))
    tmodel = AnomalyModel(AnomalyConfig(**kw, dtype=tdt), device="cpu")
    tmodel.load_state_dict(anomaly_params_from_flax(jax.device_get(params)))
    tmodel.eval()
    return (SimpleNamespace(cfg=jcfg, model=jmodel, params=params, _lock=threading.Lock()),
            SimpleNamespace(cfg=tmodel.cfg, model=tmodel, _lock=threading.Lock()))


def _capture(mgr) -> dict:
    """device id -> (window end, score, valid) of every harvested batch."""
    seen: dict = {}
    orig = mgr._emit_batch

    def spy(job, batch_devs, ends, scores, valid, *a, **kw):
        for d, e, s, v in zip(batch_devs, ends, scores, valid):
            seen[int(d)] = (int(e), float(s), bool(v))
        return orig(job, batch_devs, ends, scores, valid, *a, **kw)

    mgr._emit_batch = spy
    return seen


def _spy_ingest(eng) -> list:
    sent = []
    orig = eng.ingest_json_batch

    def spy(payloads, tenant="default", **kw):
        sent.extend(json.loads(p) for p in payloads)
        return orig(payloads, tenant, **kw)

    eng.ingest_json_batch = spy
    return sent


def _alerts(sent) -> dict:
    return {e["request"]["alternateId"]: e for e in sent if e["type"] == "DeviceAlert"}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_run_job_matches_jax(tmp_path, dtype):
    jeng, teng = _engines(tmp_path)
    pay = _stream()
    _feed(jeng, pay)
    _feed(teng, pay)
    jsvc, tsvc = _services(dtype)
    jm, tm = JaxManager(jeng, service=jsvc), AnalyticsManager(teng, service=tsvc)
    jscores, tscores = _capture(jm), _capture(tm)
    jsent, tsent = _spy_ingest(jeng), _spy_ingest(teng)
    spec = dict(window=W, batch_devices=5, min_fill=MIN_FILL, threshold=-1e9,
                name="par")
    launches0 = wf.window_features.launches
    ref = jm.run_job(JaxSpec(**spec))
    got = tm.run_job(AnalyticsJobSpec(**spec))
    assert wf.window_features.launches == launches0      # CPU: the plain version
    assert {k: got[k] for k in JOB_KEYS} == {k: ref[k] for k in JOB_KEYS}
    assert got["state"] == "done" and got["devices"] == 12
    assert got["skipped_underfilled"] == 1 and got["batches"] == 3
    assert tscores.keys() == jscores.keys()
    for d in jscores:
        assert tscores[d][0] == jscores[d][0] and tscores[d][2] == jscores[d][2], d
    tol = F32 if dtype == "f32" else BF16
    np.testing.assert_allclose([tscores[d][1] for d in sorted(tscores)],
                               [jscores[d][1] for d in sorted(jscores)], **tol)
    # the same dedup keys and envelopes (the message carries the score to
    # three decimals: within the tolerance, not byte for byte, in bf16)
    ja, ta = _alerts(jsent), _alerts(tsent)
    assert ta.keys() == ja.keys() and len(ta) == got["emitted"] == 11
    assert all(k.startswith(f"{SCORE_KEY_PREFIX}par:") for k in ta)
    for k in ta:
        strip = [dict(x, request={f: v for f, v in x["request"].items() if f != "message"})
                 for x in (ta[k], ja[k])]
        assert strip[0] == strip[1]
        if dtype == "f32":
            assert ta[k]["request"]["message"] == ja[k]["request"]["message"]
    assert tm.ledger_stage() == jm.ledger_stage()
    jeng.flush()
    teng.flush()
    assert teng.query_events(etype=EventType.ALERT, limit=100) == \
        jeng.query_events(etype=EventType.ALERT, limit=100)
    led = build_ledger(teng)
    assert check_conservation(led) == []
    assert led["stages"]["analytics"]["planned"] == 12


def test_job_spans_match_jax(tmp_path):
    """A job leaves the JAX job's spans in the engine's tracer: a load span
    a round (and a plan span a planner call), a transfer and a score span
    a scoring batch, an emit span a batch with hits, with the same tags."""
    jeng, teng = _engines(tmp_path)
    pay = _stream()
    _feed(jeng, pay)
    _feed(teng, pay)
    jsvc, tsvc = _services("f32")
    spec = dict(window=W, batch_devices=5, min_fill=MIN_FILL, threshold=-1e9,
                name="sp")
    ref = JaxManager(jeng, service=jsvc).run_job(JaxSpec(**spec))
    got = AnalyticsManager(teng, service=tsvc).run_job(AnalyticsJobSpec(**spec))

    def spans(eng):
        return sorted((s["name"], sorted(s["tags"].items()))
                      for s in eng.tracer.recent(4096)
                      if s["name"].startswith("analytics."))

    assert spans(teng) == spans(jeng)
    names = [n for n, _ in spans(teng)]
    # the last plan finds nothing fresh and ends the stream
    assert names.count("analytics.plan") - 1 == names.count("analytics.load") \
        == got["rounds"] == ref["rounds"]
    assert names.count("analytics.transfer") == names.count("analytics.score") \
        == got["batches"] == 3


def test_cancel_rerun_and_max_batches_match_jax(tmp_path):
    jeng, teng = _engines(tmp_path)
    pay = _stream()
    _feed(jeng, pay)
    _feed(teng, pay)
    jsvc, tsvc = _services("f32")
    managers = (JaxManager(jeng, service=jsvc), AnalyticsManager(teng, service=tsvc))
    for mgr in managers:
        orig = mgr._emit_batch

        def emit_then_cancel(job, *a, _orig=orig, **kw):
            out = _orig(job, *a, **kw)
            job["cancel"].set()            # the first harvest pulls the plug
            return out

        mgr._emit_batch = emit_then_cancel
    spec = dict(window=W, batch_devices=4, min_fill=MIN_FILL, threshold=-1e9, name="cx")
    ref = managers[0].run_job(JaxSpec(**spec))
    got = managers[1].run_job(AnalyticsJobSpec(**spec))
    assert {k: got[k] for k in JOB_KEYS} == {k: ref[k] for k in JOB_KEYS}
    assert got["state"] == "cancelled" and got["cancelled"] == 4
    # a fresh manager re-runs the same job name: the shipped keys resync
    # from the interner and suppress
    jeng.flush()
    teng.flush()
    again = (JaxManager(jeng, service=jsvc), AnalyticsManager(teng, service=tsvc))
    ref = again[0].run_job(JaxSpec(**spec))
    got = again[1].run_job(AnalyticsJobSpec(**spec))
    assert {k: got[k] for k in JOB_KEYS} == {k: ref[k] for k in JOB_KEYS}
    assert got["suppressed"] == 8 and got["emitted"] == 3   # one underfilled
    # a scope-limited run: only the in-scope batch is planned
    spec = dict(spec, name="cx-b", max_batches=1, emit=False)
    ref = again[0].run_job(JaxSpec(**spec))
    got = again[1].run_job(AnalyticsJobSpec(**spec))
    assert {k: got[k] for k in JOB_KEYS} == {k: ref[k] for k in JOB_KEYS}
    assert got["planned"] == 4 and got["cancelled"] == 0
    assert again[1].ledger_stage() == again[0].ledger_stage()
    assert check_conservation(build_ledger(teng)) == []


def test_max_batches_then_recover_emits_exactly_the_unshipped(tmp_path):
    """The owner scores one batch (8 of 12 devices), ships those alerts and
    dies; snapshot + WAL replay rebuild the engine over the same archive,
    and a fresh manager running the same job emits exactly the 4 windows
    the owner never shipped."""
    teng = Engine(EngineConfig(**CFG, archive_dir=str(tmp_path / "arch"),
                               wal_dir=str(tmp_path / "wal")), device="cpu")
    teng.epoch = pinned(EpochBase)
    save_engine(teng, tmp_path / "snap")
    _feed(teng, _stream())
    mgr = AnalyticsManager(teng)
    # a bounded range pins each window: the job's own alerts spool too
    spec = dict(window=W, batch_devices=M, min_fill=MIN_FILL, threshold=-1e9,
                until_ms=1103, name="kr")
    pre_sent = _spy_ingest(teng)
    job = mgr.run_job(AnalyticsJobSpec(**spec, max_batches=1))
    pre = set(_alerts(pre_sent))
    assert job["devices"] == 12 and job["planned"] == 8
    assert len(pre) == job["emitted"] > 0
    teng.flush()
    teng.wal.sync()
    teng.wal.close()
    del teng

    rec = restore_engine(tmp_path / "snap", device="cpu", epoch_cls=PortClock)
    replay_wal_into(rec, 0, tmp_path / "wal")
    mgr2 = AnalyticsManager(rec)
    post_sent = _spy_ingest(rec)
    job2 = mgr2.run_job(AnalyticsJobSpec(**spec))
    post = set(_alerts(post_sent))
    assert job2["state"] == "done" and job2["planned"] == 12
    assert post and not (pre & post), "duplicate score alert"
    assert job2["suppressed"] == len(pre)
    assert len(pre | post) == job2["scored"]
    rec.flush()
    assert rec.query_events(etype=EventType.ALERT, limit=200)["total"] == len(pre | post)
    assert check_conservation(build_ledger(rec)) == []


def test_standby_promotion_emits_only_the_tail(tmp_path):
    """A standby receives the owner's stream (its score alerts included)
    with emission off; promotion resyncs the shipped keys and the next run
    emits exactly the unshipped complement."""
    owner = Engine(EngineConfig(**CFG, archive_dir=str(tmp_path / "own")), device="cpu")
    standby = Engine(EngineConfig(**CFG, archive_dir=str(tmp_path / "sby")),
                     device="cpu")
    owner.epoch = standby.epoch = pinned(EpochBase)
    omgr = AnalyticsManager(owner)
    smgr = AnalyticsManager(standby, active=False)
    orig = owner.ingest_json_batch

    def forwarding(payloads, tenant="default", **kw):
        res = orig(payloads, tenant, **kw)
        standby.ingest_json_batch(list(payloads), tenant)
        return res

    owner.ingest_json_batch = forwarding
    _feed(owner, _stream(), per_call=1)
    standby.flush()
    spec = dict(window=W, batch_devices=M, min_fill=MIN_FILL, threshold=-1e9,
                until_ms=1103, name="sp")
    pre_sent = _spy_ingest(owner)
    job = omgr.run_job(AnalyticsJobSpec(**spec, max_batches=1))
    pre = set(_alerts(pre_sent))
    assert len(pre) == job["emitted"] > 0
    standby.flush()
    passive = smgr.run_job(AnalyticsJobSpec(
        window=W, batch_devices=M, min_fill=MIN_FILL, threshold=-1e9,
        name="sp-passive"))
    assert passive["scored"] > 0 and passive["emitted"] == 0
    assert smgr.promote() == 0 and smgr.active
    post_sent = _spy_ingest(standby)
    job2 = smgr.run_job(AnalyticsJobSpec(**spec))
    post = set(_alerts(post_sent))
    assert post and not (pre & post)
    assert job2["suppressed"] == len(pre)
    assert len(pre | post) == job2["scored"] == 11


def test_default_model_is_seeded_and_shaped_like_the_service_default(tmp_path):
    """Without a service of the job's shape the manager builds the default
    width from a generator seeded 0: two managers score identically."""
    _, teng = _engines(tmp_path)
    _feed(teng, _stream())
    a, b = AnalyticsManager(teng), AnalyticsManager(teng)
    ma, _ = a._model_bundle(W, C)
    mb, _ = b._model_bundle(W, C)
    assert ma.cfg == AnomalyConfig(sensors=C, window=W, hidden=256, lstm_hidden=256,
                                   latent=32)
    sa, sb = ma.state_dict(), mb.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    sa_scores, sb_scores = _capture(a), _capture(b)
    spec = dict(window=W, batch_devices=M, min_fill=MIN_FILL, emit=False)
    a.run_job(AnalyticsJobSpec(**spec, name="d1"))
    b.run_job(AnalyticsJobSpec(**spec, name="d2"))
    assert sa_scores == sb_scores and len(sa_scores) == 12
