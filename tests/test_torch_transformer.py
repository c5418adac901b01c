"""The port's long-window transformer against the JAX package's, with the
same weights (``convert.transformer_params_from_jax``) on the same seeded
windows, at a small size (sensors=8, d_model=64, heads=4, layers=2,
mlp=128; B=2, S=96).

The JAX side runs with its default attention (the jnp oracle off the TPU)
and with the Pallas kernel in interpret mode
(``flash_attention(..., force_pallas=True)``); the port runs on the CPU,
where ``flash_attention`` takes its plain version.

Tolerances:
* float32: ``rtol = atol = 1e-5`` — the same float32 math, sums in another
  order (the two JAX attention routes differ by ~2e-7 here);
* bfloat16 (the default dtype): ``rtol = 1e-2, atol = 1e-3`` on scores, as
  in ``tests/test_torch_anomaly.py`` — both sides round every product and
  activation to bf16, at places that differ (where a bias is added).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.models import transformer as jtf
from sitewhere_tpu.ops.attention import flash_attention as jflash
from sitewhere_tpu_torch.convert import transformer_params_from_jax
from sitewhere_tpu_torch.models import transformer as ttf
from sitewhere_tpu_torch.ops import attention as tatt

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-3)
SIZE = dict(sensors=8, d_model=64, heads=4, layers=2, mlp=128)
ROUTES = {
    "jnp_oracle": None,
    "pallas_interpret": functools.partial(jflash, causal=True, force_pallas=True,
                                          block_q=32, block_k=32),
}


def _pair(jdt, tdt, seed=0, b=2, s=96, size=SIZE):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, size["sensors"])).astype(np.float32)
    jcfg = jtf.TransformerConfig(**size, dtype=jdt)
    params = jax.device_get(jtf.init_params(jax.random.key(seed), jcfg))
    tmodel = ttf.TelemetryTransformer(ttf.TransformerConfig(**size, dtype=tdt),
                                      device="cpu")
    tmodel.load_state_dict(transformer_params_from_jax(params))
    return x, jcfg, params, tmodel


@pytest.mark.parametrize("route", list(ROUTES))
def test_forward_matches_jax_float32(route):
    x, jcfg, params, tmodel = _pair(jnp.float32, torch.float32)
    ref = jtf.forward(params, jnp.asarray(x), jcfg, attention_fn=ROUTES[route])
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("route", list(ROUTES))
def test_scores_match_jax_float32(route):
    x, jcfg, params, tmodel = _pair(jnp.float32, torch.float32, seed=1)
    ref = jtf.forecast_scores(params, jnp.asarray(x), jcfg,
                              attention_fn=ROUTES[route])
    got = ttf.forecast_scores(tmodel, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("route", list(ROUTES))
def test_scores_match_jax_bfloat16(route):
    x, jcfg, params, tmodel = _pair(jnp.bfloat16, torch.bfloat16, seed=2)
    ref = jtf.forecast_scores(params, jnp.asarray(x), jcfg,
                              attention_fn=ROUTES[route])
    got = ttf.forecast_scores(tmodel, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **BF16)


# head dims past 128, which the card runs at D = 256: the d_model=256,
# heads=1 model (D = 256) and d_model=384, heads=2 (D = 192, padded there)
WIDE_HEADS = {"d256": dict(d_model=256, heads=1), "d192": dict(d_model=384, heads=2)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("width", list(WIDE_HEADS))
def test_scores_past_head_dim_128_match_jax_float32(width, route):
    size = dict(SIZE, **WIDE_HEADS[width])
    x, jcfg, params, tmodel = _pair(jnp.float32, torch.float32, seed=5, s=64, size=size)
    ref = jtf.forecast_scores(params, jnp.asarray(x), jcfg, attention_fn=ROUTES[route])
    got = ttf.forecast_scores(tmodel, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("width", list(WIDE_HEADS))
def test_scores_past_head_dim_128_match_jax_bfloat16(width):
    size = dict(SIZE, **WIDE_HEADS[width])
    x, jcfg, params, tmodel = _pair(jnp.bfloat16, torch.bfloat16, seed=6, s=64, size=size)
    ref = jtf.forecast_scores(params, jnp.asarray(x), jcfg)
    got = ttf.forecast_scores(tmodel, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **BF16)


def test_offset_positions_match_jax():
    """A sequence shard's global positions (here 1000..1095) reach the
    position encoding as on the JAX side."""
    x, jcfg, params, tmodel = _pair(jnp.float32, torch.float32, seed=3)
    pos = np.arange(1000, 1096, dtype=np.int32)
    ref = jtf.forecast_scores(params, jnp.asarray(x), jcfg, positions=jnp.asarray(pos))
    got = ttf.forecast_scores(tmodel, torch.from_numpy(x),
                              positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    base = ttf.forecast_scores(tmodel, torch.from_numpy(x))
    assert not torch.equal(got, base)


def test_pos_encoding_matches_jax():
    """Sin then cos of position x float32 frequencies. The two sides' exp
    put some frequencies one float32 ulp (<= 6e-8) apart, and the angle
    multiplies that by the position: the bound grows with it (at position
    16383 the encodings differ by ~4e-4)."""
    pos = np.array([0, 1, 7, 95, 1000, 16383], np.int32)
    ref = np.asarray(jtf._pos_encoding(jnp.asarray(pos), 256))
    got = ttf._pos_encoding(torch.from_numpy(pos), 256)
    assert got.dtype == torch.float32 and got.shape == (6, 256)
    bound = 1e-5 + 6e-8 * pos.astype(np.float64)[:, None]
    assert np.all(np.abs(got.numpy() - ref) <= bound)


def test_layer_norm_eps_matches_jax():
    """eps 1e-6 inside the rsqrt, as the JAX package: on rows whose variance
    is ~1e-6, ``nn.LayerNorm``'s default 1e-5 would be off by ~3x."""
    x = (1e-3 * np.random.default_rng(4).standard_normal((3, 64))).astype(np.float32)
    g = np.linspace(0.5, 1.5, 64).astype(np.float32)
    b = np.linspace(-0.1, 0.1, 64).astype(np.float32)
    ref = np.asarray(jtf._layer_norm(jnp.asarray(x), {"g": jnp.asarray(g),
                                                      "b": jnp.asarray(b)}))
    ln = torch.nn.LayerNorm(64)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(g))
        ln.bias.copy_(torch.from_numpy(b))
        got = ttf._layer_norm(torch.from_numpy(x), ln).numpy()
        default = ln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert np.max(np.abs(default - ref)) > 0.1


def test_attention_gets_strided_views_of_the_fused_qkv_product():
    """The forward hands the attention the three views of one [B, S, 3, H,
    Dh] product, as the JAX forward slices it; the CUDA kernel reads them
    in place, with no copies."""
    _, _, _, tmodel = _pair(jnp.float32, torch.float32)
    seen = []

    def spy(q, k, v):
        seen.append((q, k, v))
        return tatt.mha_reference(q, k, v, causal=True)

    with torch.no_grad():
        tmodel(torch.zeros((2, 10, SIZE["sensors"])), attention_fn=spy)
    assert len(seen) == SIZE["layers"]
    dh = SIZE["d_model"] // SIZE["heads"]
    for q, k, v in seen:
        assert q.shape == (2, 10, SIZE["heads"], dh) and not q.is_contiguous()
        assert k.data_ptr() - q.data_ptr() == v.data_ptr() - k.data_ptr() == 64 * 4
        assert q.stride() == (10 * 3 * 64, 3 * 64, dh, 1)


def test_converted_params_cover_every_jax_leaf():
    _, _, params, tmodel = _pair(jnp.float32, torch.float32)
    converted = transformer_params_from_jax(params)
    assert set(converted) == set(tmodel.state_dict())
    n_jax = sum(np.size(v) for v in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(v.numel() for v in converted.values())
    sd = tmodel.state_dict()
    assert all(sd[k].shape == v.shape for k, v in converted.items())


def test_init_is_seeded_by_generator():
    cfg = ttf.TransformerConfig(**SIZE, dtype=torch.float32)
    a = ttf.TelemetryTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = ttf.TelemetryTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c = ttf.TelemetryTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.0.qkv.weight"], sc["blocks.0.qkv.weight"])
    assert all(v.dtype == torch.float32 for v in sa.values())


def test_init_follows_the_jax_distribution():
    """Normal weights with std sqrt(2 / (fan_in + fan_out)), zero biases,
    LayerNorm g = 1 and b = 0, as ``init_params``."""
    cfg = dataclasses.replace(ttf.TransformerConfig(), layers=1)
    model = ttf.TelemetryTransformer(cfg, device="cpu")
    sd = model.state_dict()
    for name in ("blocks.0.qkv", "blocks.0.mlp_in", "blocks.0.mlp_out", "embed"):
        w = sd[f"{name}.weight"]
        fan_out, fan_in = w.shape
        assert abs(w.std().item() / (2.0 / (fan_in + fan_out)) ** 0.5 - 1) < 0.02
        assert abs(w.mean().item()) < 0.01
        assert not sd[f"{name}.bias"].any()
    assert torch.equal(sd["blocks.0.ln1.weight"], torch.ones(256))
    assert not sd["ln_f.bias"].any()
