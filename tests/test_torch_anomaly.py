"""The port's anomaly model against the flax ``AnomalyModel`` with the same
weights (``convert.anomaly_params_from_flax``) on the same seeded windows.

Tolerances:
* float32 (``dtype=jnp.float32`` / ``torch.float32``): ``rtol=1e-5,
  atol=1e-6`` — the same products summed in another order;
* bfloat16 (the default dtype): ``rtol=1e-2, atol=1e-3`` — both sides
  round every product and activation to bf16, at places that differ
  (e.g. where a bias is added), so scores drift by a few bf16 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.models.anomaly import AnomalyConfig as JaxConfig
from sitewhere_tpu.models.anomaly import AnomalyModel as JaxModel
from sitewhere_tpu.models.anomaly import LSTMForecaster as JaxLSTM
from sitewhere_tpu.models.anomaly import WindowAutoencoder as JaxAE
from sitewhere_tpu_torch.convert import anomaly_params_from_flax
from sitewhere_tpu_torch.models.anomaly import AnomalyConfig, AnomalyModel

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=1e-3)
SIZES = [dict(sensors=4, window=8, hidden=32, lstm_hidden=16, latent=8),
         dict(sensors=10, window=12, hidden=64, lstm_hidden=32, latent=16)]


def _pair(kw, jdt, tdt, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (6, kw["window"], kw["sensors"])).astype(np.float32)
    jmodel = JaxModel(JaxConfig(**kw, dtype=jdt))
    params = jax.device_get(jmodel.init(jax.random.key(seed), jnp.asarray(x)))
    tmodel = AnomalyModel(AnomalyConfig(**kw, dtype=tdt), device="cpu")
    tmodel.load_state_dict(anomaly_params_from_flax(params))
    return x, jmodel, params, tmodel


@pytest.mark.parametrize("kw", SIZES)
def test_scores_match_flax_float32(kw):
    x, jmodel, params, tmodel = _pair(kw, jnp.float32, torch.float32)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize("kw", SIZES)
def test_submodules_match_flax_float32(kw):
    """Autoencoder reconstruction and LSTM forecast separately, so a
    mismatch names its half."""
    x, _, params, tmodel = _pair(kw, jnp.float32, torch.float32)
    jcfg = JaxConfig(**kw, dtype=jnp.float32)
    p = params["params"]
    recon = JaxAE(jcfg).apply({"params": p["ae"]}, jnp.asarray(x))
    preds = JaxLSTM(jcfg).apply({"params": p["lstm"]}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(tmodel.ae(torch.from_numpy(x)).numpy(),
                                   np.asarray(recon), **F32)
        np.testing.assert_allclose(tmodel.lstm(torch.from_numpy(x)).numpy(),
                                   np.asarray(preds), **F32)


@pytest.mark.parametrize("kw", SIZES)
def test_scores_match_flax_bfloat16(kw):
    x, jmodel, params, tmodel = _pair(kw, jnp.bfloat16, torch.bfloat16, seed=1)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **BF16)


def test_state_dict_names_cover_every_flax_leaf():
    kw = SIZES[0]
    _, _, params, tmodel = _pair(kw, jnp.float32, torch.float32)
    converted = anomaly_params_from_flax(params)
    assert set(converted) == set(tmodel.state_dict())
    n_flax = sum(np.size(v) for v in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(v.numel() for v in converted.values())


def test_init_is_seeded_by_generator():
    cfg = AnomalyConfig(**SIZES[0], dtype=torch.float32)
    a = AnomalyModel(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = AnomalyModel(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c = AnomalyModel(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["ae.enc1.weight"], sc["ae.enc1.weight"])
    assert all(v.dtype == torch.float32 for v in sa.values())
