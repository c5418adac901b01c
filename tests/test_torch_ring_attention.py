"""The port's sequence parallelism (``sitewhere_tpu_torch/parallel/
ring_attention.py``, ``models/transformer.forecast_scores_sp``) on 4 gloo
ranks against the JAX package's on a 4-device sub-mesh of the CPU mesh.

The 4 ranks are spawned once for the module (``torch_parity.run_on_gloo_ranks``:
a ``file://`` store, so no port is bound; one thread a rank), each given the
same seeded numpy inputs; each returns its results, and every rank's are
held to the JAX package's:
* ring and Ulysses attention (causal and not): the outputs against JAX's
  ``ring_attention_sharded`` / ``ulysses_attention_sharded``; the
  gradients of q, k and v for a seeded output gradient, elementwise on
  every rank, against ``jax.vjp`` of the oracle ``mha_reference``;
* ``forecast_scores_sp`` of a small float32 transformer (weights carried
  by ``convert``) against JAX's ``forecast_scores_sp``; the gradient of
  every parameter of the mean score, elementwise on every rank, against
  ``jax.grad`` of the single-device oracle path (JAX's own SP gradient
  equals that one, and compiles for ~50 s here);
* the trap the port avoids: ``torch.distributed.nn.functional.all_reduce``
  hands each rank n times the gradient, the port's ``all_sum`` once.

Tolerances (float32): ``rtol = atol = 1e-5`` on outputs and scores (the
same float32 math, blockwise softmax and sums in another order);
gradients within 1e-5 of each tensor's largest element.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from sitewhere_tpu.models import transformer as jtf
from sitewhere_tpu.ops.attention import mha_reference as jmha
from sitewhere_tpu.parallel.ring_attention import (ring_attention_sharded,
                                                   ulysses_attention_sharded)
from sitewhere_tpu_torch.convert import transformer_params_from_jax
from tests.torch_parity import run_on_gloo_ranks, sp_worker

WORLD = 4
F32 = dict(rtol=1e-5, atol=1e-5)
GRAD_OF_MAX = 1e-5
CFG = dict(sensors=8, d_model=64, heads=4, layers=2, mlp=128)
QKV_SHAPE = (2, 64, 4, 16)          # H == WORLD for Ulysses
X_SHAPE = (2, 64, CFG["sensors"])


def _of_max(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= GRAD_OF_MAX * scale, f"{what}: max abs err {err} > {GRAD_OF_MAX} of {scale}"


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    qkv = [rng.standard_normal(QKV_SHAPE).astype(np.float32) for _ in range(4)]
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    jcfg = jtf.TransformerConfig(**CFG, dtype=jnp.float32)
    params = jax.device_get(jtf.init_params(jax.random.key(3), jcfg))
    state = {n: t.numpy() for n, t in transformer_params_from_jax(params).items()}
    return dict(qkv=qkv, x=x, cfg=CFG, state=state, jcfg=jcfg, params=params)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    payload = {k: case[k] for k in ("qkv", "x", "cfg", "state")}
    return run_on_gloo_ranks(sp_worker, WORLD, tmp_path_factory.mktemp("gloo"), payload)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("sp",))


SHARDED = {"ring": ring_attention_sharded, "ulysses": ulysses_attention_sharded}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_attention_matches_jax(name, causal, case, ranks, mesh):
    q, k, v, _ = (jnp.asarray(a) for a in case["qkv"])
    ref = np.asarray(SHARDED[name](q, k, v, mesh, causal=causal))
    key = f"{name}_{'causal' if causal else 'full'}"
    for r, res in enumerate(ranks):
        assert res["world"] == WORLD
        np.testing.assert_allclose(res[key], ref, **F32, err_msg=f"rank {r}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_attention_gradients_match_jax_vjp(name, causal, case, ranks):
    """The hops carry the gradient home and the replicated inputs sum it:
    every rank holds the whole dq, dk, dv of the oracle."""
    q, k, v, do = (jnp.asarray(a) for a in case["qkv"])
    _, vjp = jax.vjp(functools.partial(jmha, causal=causal), q, k, v)
    ref = vjp(do)
    key = f"{name}_{'causal' if causal else 'full'}_grads"
    for r, res in enumerate(ranks):
        for t, got, want in zip("qkv", res[key], ref):
            _of_max(got, want, f"rank {r} d{t}")


def test_forecast_scores_sp_matches_jax(case, ranks, mesh):
    x = jnp.asarray(case["x"])
    ref_sp = np.asarray(jtf.forecast_scores_sp(case["params"], x, case["jcfg"], mesh))
    ref_one = np.asarray(jtf.forecast_scores(
        case["params"], x, case["jcfg"], attention_fn=functools.partial(jmha, causal=True)))
    for r, res in enumerate(ranks):
        assert res["scores"].shape == (X_SHAPE[0],)
        np.testing.assert_allclose(res["scores"], ref_sp, **F32, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["scores"], ref_one, **F32, err_msg=f"rank {r}")


def test_forecast_scores_sp_gradients_equal_single_device_gradient(case, ranks):
    x = jnp.asarray(case["x"])

    def loss(p):
        return jnp.mean(jtf.forecast_scores(
            p, x, case["jcfg"], attention_fn=functools.partial(jmha, causal=True)))

    ref = transformer_params_from_jax(jax.device_get(jax.grad(loss)(case["params"])))
    for r, res in enumerate(ranks):
        assert set(res["grads"]) == set(ref)
        for name, want in ref.items():
            _of_max(res["grads"][name], want.numpy(), f"rank {r} {name}")


def test_every_rank_holds_the_same_result(ranks):
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["scores"], ranks[0]["scores"])
        for name in ("ring_causal", "ulysses_full"):
            np.testing.assert_array_equal(res[name], ranks[0][name])


def test_group_sum_backward_reaches_each_local_term_once(ranks):
    """``torch.distributed.nn.functional.all_reduce``'s backward is itself a
    summed all-reduce: a loss every rank backpropagates reaches each local
    term n times. The port's ``all_sum`` (``lax.psum``'s transpose) once."""
    for res in ranks:
        np.testing.assert_array_equal(res["all_reduce_grad"], np.full(3, WORLD, np.float32))
        np.testing.assert_array_equal(res["all_sum_grad"], np.ones(3, np.float32))
