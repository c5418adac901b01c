"""Training the port's long-window transformer (``models/transformer.py``:
``loss_fn``, ``make_train_step``, ``adam``; ``convert.adamw_state_from_optax``
with ``params_from=transformer_params_from_jax``) against the JAX package's
(``sitewhere_tpu/models/transformer.py:147-158``), with the same weights
(``convert.transformer_params_from_jax``) on the same seeded windows, at a
small size (sensors=8, d_model=32, heads=2, layers=2, mlp=64; B=2, S=48).
The port runs on the CPU, where the attention is the plain
``mha_reference`` and autograd differentiates it; the JAX side
differentiates its oracle, as it does off the TPU.

Tolerances:
* float32 loss ``rtol = atol = 1e-5`` (the same float32 math in another
  order); float32 gradients within 1e-5 of each tensor's largest element;
* bfloat16 loss ``rtol = 1e-2`` as the scores in
  ``tests/test_torch_transformer.py``; bf16 gradients within 5e-2 of each
  tensor's largest (every product and activation rounds to bf16, at
  places that differ);
* k optimizer steps in float32: parameters ``rtol = 1e-4, atol = 1e-6``
  (Adam divides by sqrt(v): a gradient difference of 1e-7 relative moves
  an update by as much, over 5 steps), the key bias aside: its exact
  gradient is 0, so each side's update is its own rounding noise over
  itself, and it is held to Adam's bound of lr a step instead;
* the bf16 kernels' arithmetic (emulated on the CPU, forward and backward)
  in a bf16 model against the plain attention's autograd: every parameter
  gradient within TRAIN_GRAD_TOL_BF16 of its largest element, the limit
  ``chip_smoke.py``'s train leg (b) holds the card to.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sitewhere_tpu.models import transformer as jtf
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.models import transformer as ttf
from sitewhere_tpu_torch.models.anomaly import adamw
from sitewhere_tpu_torch.ops import attention as tatt
from tests.test_torch_attention import emulate_bf16_backward, emulate_bf16_kernel

SIZE = dict(sensors=8, d_model=32, heads=2, layers=2, mlp=64)
F32 = dict(rtol=1e-5, atol=1e-5)
GRAD_F32_OF_MAX = 1e-5
GRAD_BF16_OF_MAX = 5e-2
STEPS_TOL = dict(rtol=1e-4, atol=1e-6)
TRAIN_GRAD_TOL_BF16 = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(dtype="float32", seed=0, b=2, s=48, size=SIZE):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal((b, s, size["sensors"])).astype(np.float32)
    jcfg = jtf.TransformerConfig(**size, dtype=jdt)
    params = jax.device_get(jtf.init_params(jax.random.key(seed), jcfg))
    tmodel = ttf.TelemetryTransformer(ttf.TransformerConfig(**size, dtype=tdt), device="cpu")
    tmodel.load_state_dict(convert.transformer_params_from_jax(params))
    return x, jcfg, params, tmodel


def _of_max(got, ref, tol, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} of {scale}"


def _params_close(tmodel, jparams, tol, what, steps, lr=1e-3, d=SIZE["d_model"]):
    """Every parameter within ``tol`` of JAX's, except the key bias (the
    middle third of each ``qkv.bias``): softmax is invariant to a shift of
    every score of a row, so its exact gradient is 0 and each side's Adam
    step is its own rounding noise over itself, +-lr. It is held to that
    bound on both sides instead (zero init; weight decay ~1e-7)."""
    ref = convert.transformer_params_from_jax(jax.device_get(jparams))
    for name, p in tmodel.named_parameters():
        got, want = p.detach().numpy(), ref[name].numpy()
        if name.endswith("qkv.bias"):
            bound = steps * lr * 1.01
            assert np.abs(got[d:2 * d]).max() <= bound and np.abs(want[d:2 * d]).max() <= bound
            got = np.concatenate([got[:d], got[2 * d:]])
            want = np.concatenate([want[:d], want[2 * d:]])
        np.testing.assert_allclose(got, want, **tol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_loss_and_every_gradient_match_jax(dtype):
    x, jcfg, params, tmodel = _pair(dtype, seed=1)
    jloss, jgrads = jax.value_and_grad(lambda p: jtf.loss_fn(p, jnp.asarray(x), jcfg))(params)
    loss = ttf.loss_fn(tmodel, torch.from_numpy(x))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    loss_tol = F32 if dtype == "float32" else dict(rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(loss.item(), float(jloss), **loss_tol)
    ref = convert.transformer_params_from_jax(jax.device_get(jgrads))
    tol = GRAD_F32_OF_MAX if dtype == "float32" else GRAD_BF16_OF_MAX
    assert set(ref) == {n for n, _ in tmodel.named_parameters()}
    for name, p in tmodel.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        _of_max(p.grad.numpy(), ref[name].numpy(), tol, name)


OPTIMIZERS = {  # JAX transformation, the port's optimizer
    "adam": (optax.adam, ttf.adam),
    "adamw": (optax.adamw, adamw),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_k_steps_match_jax(name):
    """5 ``make_train_step`` steps on the same batch with ``optax.adam`` /
    ``optax.adamw`` against the port's ``adam`` / ``models.anomaly.adamw``:
    the losses and the parameters follow JAX's path."""
    jtx, topt = OPTIMIZERS[name]
    x, jcfg, params, tmodel = _pair(seed=2)
    tx = jtx(1e-3)
    jstep = jax.jit(jtf.make_train_step(jcfg, tx))
    jstate = tx.init(params)
    step = ttf.make_train_step(tmodel, topt(tmodel.parameters(), 1e-3))
    for i in range(5):
        params, jstate, jloss = jstep(params, jstate, jnp.asarray(x))
        loss = step(torch.from_numpy(x))
        np.testing.assert_allclose(loss.item(), float(jloss), **F32, err_msg=f"step {i}")
    _params_close(tmodel, params, STEPS_TOL, name, steps=5)


# head dims past 128 (the card runs them at D = 256): d_model=256, heads=1
# (D = 256) and d_model=384, heads=2 (D = 192)
WIDE_HEADS = {"d256": dict(d_model=256, heads=1), "d192": dict(d_model=384, heads=2)}
WIDE_SGD_LR = 0.1


@pytest.mark.parametrize("width", list(WIDE_HEADS))
def test_k_steps_past_head_dim_128_match_jax(width):
    """3 ``make_train_step`` steps at a head dim past 128 with plain SGD
    (``optax.sgd`` and ``torch.optim.SGD``, lr 0.1): losses at F32 and
    parameters within STEPS_TOL of JAX's. SGD carries the gradients'
    agreement into the parameters as it is; Adam (``test_k_steps_match_jax``
    at SIZE) normalizes each element's update, and at these widths it turns
    the float32 rounding of a few near-zero gradient elements of
    ``qkv.weight`` into whole updates on either side (measured: 6 of
    442,368 elements past STEPS_TOL after 3 AdamW steps at d192)."""
    size = dict(SIZE, **WIDE_HEADS[width])
    x, jcfg, params, tmodel = _pair(seed=7, size=size)
    tx = optax.sgd(WIDE_SGD_LR)
    jstep = jax.jit(jtf.make_train_step(jcfg, tx))
    jstate = tx.init(params)
    step = ttf.make_train_step(tmodel, torch.optim.SGD(tmodel.parameters(), lr=WIDE_SGD_LR))
    for i in range(3):
        params, jstate, jloss = jstep(params, jstate, jnp.asarray(x))
        loss = step(torch.from_numpy(x))
        np.testing.assert_allclose(loss.item(), float(jloss), **F32, err_msg=f"step {i}")
    _params_close(tmodel, params, STEPS_TOL, width, steps=3, lr=WIDE_SGD_LR,
                  d=size["d_model"])


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_carried_optimizer_state_continues_jax_training(name):
    """A JAX trainer stops after 3 steps; its parameters and optax state come
    across (``adamw_state_from_optax(..., params_from=
    transformer_params_from_jax)``) and 3 more steps on each side stay on
    one path."""
    jtx, topt = OPTIMIZERS[name]
    x, jcfg, params, tmodel = _pair(seed=3)
    tx = jtx(1e-3)
    jstep = jax.jit(jtf.make_train_step(jcfg, tx))
    jstate = tx.init(params)
    for _ in range(3):
        params, jstate, _ = jstep(params, jstate, jnp.asarray(x))
    tmodel.load_state_dict(convert.transformer_params_from_jax(jax.device_get(params)))
    opt = topt(tmodel.parameters(), 1e-3)
    convert.adamw_state_from_optax(jax.device_get(jstate), tmodel, opt,
                                   params_from=convert.transformer_params_from_jax)
    first = next(iter(opt.state.values()))
    assert float(first["step"]) == 3.0
    step = ttf.make_train_step(tmodel, opt)
    for i in range(3):
        params, jstate, jloss = jstep(params, jstate, jnp.asarray(x))
        loss = step(torch.from_numpy(x))
        np.testing.assert_allclose(loss.item(), float(jloss), **F32, err_msg=f"step {i}")
    _params_close(tmodel, params, STEPS_TOL, name, steps=6)


def test_carried_state_without_params_from_is_the_anomaly_mapping():
    """Existing callers pass no ``params_from``: the flax anomaly mapping,
    which a transformer state does not fit."""
    x, jcfg, params, tmodel = _pair(seed=4)
    tx = optax.adam(1e-3)
    state = jax.device_get(tx.init(params))
    with pytest.raises(KeyError):
        convert.adamw_state_from_optax(state, tmodel, ttf.adam(tmodel.parameters(), 1e-3))


def test_transformer_train_step_reduces_loss():
    """The port's counterpart of ``tests/test_attention.py::
    test_transformer_train_step_reduces_loss``: JAX's float32 test config
    (d_model 64, 4 heads, 2 layers) on a lagged sine, 30 Adam steps at
    3e-3 halve the loss."""
    cfg = ttf.TransformerConfig(sensors=8, d_model=64, heads=4, layers=2, mlp=128,
                                dtype=torch.float32)
    model = ttf.TelemetryTransformer(cfg, device="cpu")
    t = np.arange(64)
    x = np.stack([np.sin(0.3 * t + p) for p in np.linspace(0, 1, 8)], axis=-1)
    x = torch.from_numpy(np.stack([x, x * 0.5]).astype(np.float32))
    step = ttf.make_train_step(model, ttf.adam(model.parameters(), 3e-3))
    first = ttf.loss_fn(model, x).item()
    for _ in range(30):
        loss = step(x)
    assert loss.item() < first * 0.5, (first, loss.item())


def test_train_step_has_profiler_ranges_and_clears_grads():
    x, _, _, tmodel = _pair(seed=5)
    step = ttf.make_train_step(tmodel, ttf.adam(tmodel.parameters(), 1e-3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loss = step(torch.from_numpy(x))
    names = {e.name for e in prof.events()}
    assert {"transformer.forward", "transformer.backward",
            "transformer.optimizer"} <= names
    assert not loss.requires_grad
    assert all(p.grad is None for p in tmodel.parameters())


def test_forecast_scores_stays_gradient_free():
    x, _, _, tmodel = _pair(seed=6)
    scores = ttf.forecast_scores(tmodel, torch.from_numpy(x))
    assert not scores.requires_grad and scores.is_inference()
    torch.testing.assert_close(scores.mean(), ttf.loss_fn(tmodel, torch.from_numpy(x)).detach(),
                               rtol=0, atol=0)


class _EmulatedKernels(torch.autograd.Function):
    """The bf16 kernels' arithmetic behind autograd, on the CPU: the forward
    as ``emulate_bf16_kernel`` (plus the plain lse), the backward as
    ``emulate_bf16_backward``."""

    @staticmethod
    def forward(ctx, q, k, v):
        out = emulate_bf16_kernel(q, k, v, causal=True)
        lse = tatt.lse_reference(q, k, causal=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return emulate_bf16_backward(q, k, v, out, do.to(q.dtype), lse, causal=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_emulated_kernel_gradients_fit_the_train_tolerance(seed):
    """The bf16 model at full head width (D = 32) on windows longer than a
    tile: every parameter's gradient through the emulated kernels stays
    within TRAIN_GRAD_TOL_BF16 of its largest element of the gradient
    through the plain attention; the card's train leg (b) holds the
    kernels to that."""
    cfg = ttf.TransformerConfig(sensors=8, d_model=64, heads=2, layers=2, mlp=128)
    model = ttf.TelemetryTransformer(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(seed))
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 200, 8)).astype(np.float32))
    ttf.loss_fn(model, x, attention_fn=_EmulatedKernels.apply).backward()
    kernel = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    ttf.loss_fn(model, x, attention_fn=functools.partial(tatt.mha_reference,
                                                         causal=True)).backward()
    for n, p in model.named_parameters():
        assert bool(torch.isfinite(kernel[n]).all()) and bool(kernel[n].any()), n
        _of_max(kernel[n].numpy(), p.grad.numpy(), TRAIN_GRAD_TOL_BF16, n)


def test_jax_config_fields_match_the_port():
    """The two configs share field names and defaults (bar the dtype's
    type), so ``TransformerConfig(**kw)`` builds the same model on both
    sides."""
    j = {f.name: f.default for f in dataclasses.fields(jtf.TransformerConfig)}
    t = {f.name: f.default for f in dataclasses.fields(ttf.TransformerConfig)}
    assert set(j) == set(t)
    assert all(j[k] == t[k] for k in j if k != "dtype")
