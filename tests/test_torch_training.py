"""Training in the port (``models/anomaly.py``: ``loss_fn``, ``adamw``,
``make_train_step``; ``convert.adamw_state_from_optax``;
``models/service.py``: ``train_on_live``, ``save_model`` /
``restore_model``, ``run``) against the JAX package on the same seeded
numpy inputs, with the same weights (``convert.anomaly_params_from_flax``).

Tolerances:
* gradients of ``loss_fn``, per tensor: max abs error <= 1e-5 x that
  tensor's max magnitude in float32 (7.1e-7 measured), 5e-2 in bfloat16
  (2.0e-2 measured: both sides round products and activations to bf16 at
  places that differ);
* AdamW against ``optax.adamw(1e-3)`` over 20 equal float32 gradients:
  max abs parameter error <= 1e-5 (3.6e-6 measured); torch's default
  ``weight_decay`` (0.01) misses by more than 1e-4;
* parameters after training steps (``make_train_step``,
  ``train_on_live``, a carried-across optimizer): ``rtol=1e-4,
  atol=1e-6``; losses ``rtol=1e-5``; picked batches ``rtol=1e-5,
  atol=1e-6`` (the same rows, whose features both sides compute in
  float32).
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.ingest.requests import DecodedRequest as JaxRequest
from sitewhere_tpu.ingest.requests import RequestType as JaxRequestType
from sitewhere_tpu.models import anomaly as janomaly
from sitewhere_tpu.models.service import AnalyticsService as JaxService
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.models.anomaly import (AnomalyConfig, AnomalyModel, adamw,
                                                loss_fn, make_train_step)
from sitewhere_tpu_torch.models.service import AnalyticsService
from tests.torch_parity import StopAfter, analytics_stream, spy_batches

MODEL = dict(sensors=10, window=12, hidden=64, lstm_hidden=32, latent=16)
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
PARAMS = dict(rtol=1e-4, atol=1e-6)
W, C = 12, 6
ENGINE = dict(device_capacity=64, token_capacity=128, assignment_capacity=128,
              store_capacity=4096, batch_capacity=64, channels=C,
              analytics_devices=32, analytics_window=W)
SVC_MODEL = dict(sensors=C, window=W, hidden=64, lstm_hidden=32, latent=16)
N_FULL, N_SHORT, OUTLIER = 20, 6, 7
THRESHOLD = 0.4


def _windows(seed, b=6, kw=MODEL):
    return np.random.default_rng(seed).standard_normal(
        (b, kw["window"], kw["sensors"])).astype(np.float32)


def _pair(jdt, tdt, seed=0):
    x = _windows(seed)
    jmodel = janomaly.AnomalyModel(janomaly.AnomalyConfig(**MODEL, dtype=jdt))
    params = jax.device_get(jmodel.init(jax.random.key(seed), jnp.asarray(x)))
    tmodel = AnomalyModel(AnomalyConfig(**MODEL, dtype=tdt), device="cpu")
    tmodel.load_state_dict(convert.anomaly_params_from_flax(params))
    return x, jmodel, params, tmodel


def _assert_params_close(tmodel, jparams, **tol):
    want = convert.anomaly_params_from_flax(jax.device_get(jparams))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_gradients_match_jax(dtype):
    x, jmodel, params, tmodel = _pair(getattr(jnp, dtype), getattr(torch, dtype))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: janomaly.loss_fn(jmodel, p, jnp.asarray(x))))(params)
    loss = loss_fn(tmodel, torch.from_numpy(x))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=GRAD_TOL[dtype])
    want = convert.anomaly_params_from_flax(jax.device_get(jgrads))
    for name, p in tmodel.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= GRAD_TOL[dtype] * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("weight_decay,within", [(None, True), (0.01, False)],
                         ids=["optax_default", "torch_default"])
def test_adamw_against_optax(weight_decay, within):
    """20 equal float32 gradients through ``optax.adamw(1e-3)`` and the
    port's ``adamw``; with torch's default decay instead of optax's 1e-4
    the parameters leave optax's path."""
    rng = np.random.default_rng(5)
    p0 = {"w": rng.standard_normal((32, 16)).astype(np.float32),
          "b": rng.standard_normal(16).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
              for k, v in p0.items()} for _ in range(20)]
    tx = optax.adamw(1e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = adamw(tp.values(), 1e-3)
    if weight_decay is not None:
        opt.param_groups[0]["weight_decay"] = weight_decay
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    err = max(np.abs(tp[k].detach().numpy() - np.asarray(jp[k])).max() for k in p0)
    if within:
        assert err <= 1e-5, err
    else:
        assert err > 1e-4, err


def test_make_train_step_matches_jax():
    x, jmodel, params, tmodel = _pair(jnp.float32, torch.float32, seed=2)
    tx = optax.adamw(1e-3)
    jstep = jax.jit(janomaly.make_train_step(jmodel, tx))
    jst = tx.init(params)
    step = make_train_step(tmodel, adamw(tmodel.parameters(), 1e-3))
    xt = torch.from_numpy(x)
    for i in range(5):
        params, jst, jloss = jstep(params, jst, jnp.asarray(x))
        loss = step(xt)
        assert loss.dim() == 0 and loss.grad_fn is None
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                                   err_msg=f"step {i}")
    assert all(p.grad is None for p in tmodel.parameters())
    _assert_params_close(tmodel, params, **PARAMS)


# ------------------------------------------------------------- the service
def _carry(jsvc, tsvc):
    """The JAX service's weights, optimizer state and statistics into the
    port's service."""
    tsvc.model.load_state_dict(
        convert.anomaly_params_from_flax(jax.device_get(jsvc.params)))
    convert.adamw_state_from_optax(jax.device_get(jsvc.opt_state),
                                   tsvc.model, tsvc.opt)
    for k in ("_score_mean", "_score_m2", "_score_n", "threshold"):
        setattr(tsvc, k, getattr(jsvc, k))


@pytest.fixture(scope="module")
def trained():
    """Two engines fed one stream; a JAX service and a port service from
    the same weights train 2 calls of 2 steps; then a fresh port service
    takes over the JAX service's state (count 4) and both train 2 more."""
    jeng = JaxEngine(JaxEngineConfig(**ENGINE, use_native=False))
    teng = Engine(EngineConfig(**ENGINE, use_native=False), device="cpu")
    for kw in analytics_stream(0, N_FULL, N_SHORT, W, C, outlier=OUTLIER):
        jeng.process(JaxRequest(type=JaxRequestType.DEVICE_MEASUREMENT, **kw))
        teng.process(DecodedRequest(type=RequestType.DEVICE_MEASUREMENT, **kw))
    jeng.flush()
    teng.flush()
    jcfg = janomaly.AnomalyConfig(**SVC_MODEL, dtype=jnp.float32)
    tcfg = AnomalyConfig(**SVC_MODEL, dtype=torch.float32)
    jsvc = JaxService(jeng, jcfg, threshold=THRESHOLD, min_fill=W)
    tsvc = AnalyticsService(teng, tcfg, threshold=THRESHOLD, min_fill=W)
    _carry(jsvc, tsvc)
    jseen, tseen = spy_batches(jsvc), spy_batches(tsvc)
    losses = [(jsvc.train_on_live(batch_size=16, steps=2),
               tsvc.train_on_live(batch_size=16, steps=2)) for _ in range(2)]
    first = dict(jsvc=jsvc, tsvc=tsvc, losses=losses, jseen=list(jseen),
                 tseen=list(tseen),
                 tparams={k: v.clone() for k, v in tsvc.model.state_dict().items()},
                 jparams=jax.device_get(jsvc.params))
    carried = AnalyticsService(teng, tcfg, threshold=THRESHOLD, min_fill=W, seed=9)
    _carry(jsvc, carried)
    more = (jsvc.train_on_live(batch_size=16, steps=2),
            carried.train_on_live(batch_size=16, steps=2))
    return dict(first, jeng=jeng, teng=teng, carried=carried, more=more,
                jcfg=jcfg, tcfg=tcfg)


def test_train_on_live_matches_jax(trained):
    t = trained
    assert len(t["jseen"]) == len(t["tseen"]) == 4
    for jx, tx in zip(t["jseen"], t["tseen"]):
        assert jx.shape == tx.shape == (16, W, C)
        np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-6)
    for jl, tl in t["losses"]:
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    tsvc = t["tsvc"]
    tsvc.model.load_state_dict(t["tparams"])
    _assert_params_close(tsvc.model, t["jparams"], **PARAMS)
    assert not tsvc.model.training      # scoring stays in eval mode


def test_train_on_live_without_an_eligible_window_is_nan(trained):
    t = trained
    jsvc = JaxService(t["jeng"], t["jcfg"], min_fill=10**6)
    tsvc = AnalyticsService(t["teng"], t["tcfg"], min_fill=10**6)
    assert np.isnan(jsvc.train_on_live()) and np.isnan(tsvc.train_on_live())


def test_carried_optimizer_state_continues_jax_training(trained):
    t = trained
    jl, tl = t["more"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert int(t["carried"].opt.state_dict()["state"][0]["step"]) == 6
    _assert_params_close(t["carried"].model, t["jsvc"].params, **PARAMS)


def test_save_restore_round_trip_and_jax_meta(trained, tmp_path):
    t = trained
    svc = t["carried"]
    meta = svc.save_model(tmp_path / "port")
    back = AnalyticsService(t["teng"], t["tcfg"], min_fill=W, seed=3)
    back.restore_model(tmp_path / "port")
    for k, v in svc.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    a, b = svc.opt.state_dict(), back.opt.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, st in a["state"].items():
        for k, v in st.items():
            assert torch.equal(b["state"][i][k], v), (i, k)
    assert (back._score_mean, back._score_m2, back._score_n, back.threshold) == \
        (svc._score_mean, svc._score_m2, svc._score_n, svc.threshold)
    assert json.loads((tmp_path / "port" / "analytics.json").read_text()) == meta
    # the JAX service's analytics.json for the same statistics, text for text
    t["jsvc"].save_model(tmp_path / "jax")
    assert (tmp_path / "port" / "analytics.json").read_text() == \
        (tmp_path / "jax" / "analytics.json").read_text()
    # an orbax model directory is refused by name
    with pytest.raises(ValueError, match="orbax"):
        back.restore_model(tmp_path / "jax")
    # the restored service's next step is the original's, bit for bit
    s1 = svc.train_on_live(batch_size=8, steps=1)
    s2 = back.train_on_live(batch_size=8, steps=1)
    assert s1 == s2
    for k, v in svc.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    _carry(t["jsvc"], svc)          # undo the extra step for the loop test


def _alert_tokens(eng) -> list:
    sent, inner = [], eng.process

    def spy(req):
        if req.type.name == "DEVICE_ALERT":
            sent.append((req.device_token, req.alert_type))
        return inner(req)

    eng.process = spy
    return sent


def test_one_loop_iteration_injects_the_jax_alerts(trained):
    t = trained
    jsvc, svc = t["jsvc"], t["carried"]
    jsent, tsent = _alert_tokens(t["jeng"]), _alert_tokens(t["teng"])
    scored, inner = [], svc.score_all
    svc.score_all = lambda **kw: scored.append(inner(**kw)) or scored[-1]
    try:
        asyncio.run(jsvc.run(interval_s=0.0, stop_event=StopAfter()))
        asyncio.run(svc.run(interval_s=0.0, stop_event=StopAfter()))
    finally:
        del svc.score_all
    assert tsent == jsent and (f"an-{OUTLIER}", "analytics.anomaly") in tsent
    z = scored[0]["zscores"][scored[0]["valid"]]
    assert np.min(np.abs(z - THRESHOLD)) > 1e-3     # no crossing at the edge
    st = t["teng"].get_device_state(f"an-{OUTLIER}")
    assert st["recent_alerts"][0]["type"] == "analytics.anomaly"


def test_loop_survives_a_failing_iteration(trained, caplog):
    svc = trained["carried"]

    def boom(**kw):
        raise RuntimeError("boom")

    svc.train_on_live = boom
    try:
        asyncio.run(svc.run(interval_s=0.0, stop_event=StopAfter()))
    finally:
        del svc.train_on_live
    assert "analytics loop error" in caplog.text
