"""The anomaly model's DP×TP training step (``param_shardings``,
``distribute_model``, ``make_train_step_dp_tp``) held to the JAX package's
``param_shardings`` and its sharded ``jit(make_train_step)`` on a (4, 2)
``("dp", "tp")`` mesh.

The port runs on 8 gloo ranks on the CPU (``torch_parity.run_on_gloo_ranks``,
spawned once for the module: both configurations ride one spawn), JAX on
the 8 virtual CPU devices of ``conftest.py``. Two configurations:

* ``TP_CFG`` (hidden 512, LSTM 256): JAX's predicate shards 8 of the 26
  flax leaves (the four large AE kernels and the four hidden-gate kernels
  ``h{i,f,g,o}``); the rest, every bias and the input-gate kernels
  included, are replicated.
* ``JAX_TEST_CFG``, the config of ``tests/test_models.py``'s dp/tp test:
  every kernel is under 2^16 elements, so JAX shards no leaf there.

Tolerances, float32, against the port's single-device step on the same
batch: the loss ``rtol=1e-5``; each gradient within 1e-5 of its largest
element (the dp sum adds four partial sums where the single device adds
one batch); each parameter within ``rtol=1e-5, atol=1e-8`` plus what its
gradient difference moves AdamW's first update, ``2 * lr * dg / (|g| +
eps)``, capped at one update (lr): a gradient near Adam's eps turns a
rounding difference into a visible step, as ``chip_smoke.py``'s train
phase holds the card to the CPU. Against JAX's sharded step: the loss
``rtol=1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sitewhere_tpu.models.anomaly import AnomalyConfig as JaxAnomalyConfig
from sitewhere_tpu.models.anomaly import AnomalyModel as JaxAnomalyModel
from sitewhere_tpu.models.anomaly import make_train_step as jax_make_train_step
from sitewhere_tpu.models.anomaly import param_shardings as jax_param_shardings
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.models import anomaly as tan
from tests.torch_parity import anomaly_tp_worker, run_on_gloo_ranks

TP_CFG = dict(sensors=8, window=16, hidden=512, lstm_hidden=256, latent=16)
JAX_TEST_CFG = dict(sensors=8, window=16, hidden=128, lstm_hidden=128, latent=16)
CONFIGS = {"tp_cfg": TP_CFG, "jax_test_cfg": JAX_TEST_CFG}
SHARDED_LEAVES = {"tp_cfg": 8, "jax_test_cfg": 0}
MESH = (4, 2)
BATCH = 8
LR = 1e-3
RTOL, ATOL = 1e-5, 1e-8
GRAD_SHARE = 1e-5
ADAM_EPS = 1e-8


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_side(cfg: dict, x: np.ndarray) -> dict:
    """JAX's placements of every flax leaf and, for a config that trains,
    its sharded step's loss (as ``tests/test_models.py`` runs it)."""
    devs = np.asarray(jax.devices()[:8]).reshape(MESH)
    mesh = Mesh(devs, ("dp", "tp"))
    model = JaxAnomalyModel(JaxAnomalyConfig(**cfg, dtype=jnp.float32))
    xj = jnp.asarray(x)
    params = model.init(jax.random.key(0), xj)
    host = jax.device_get(params)
    shardings = jax_param_shardings(params, mesh, "tp")
    sharded = jax.device_put(params, shardings)
    tx = optax.adamw(LR)
    step = jax.jit(jax_make_train_step(model, tx))
    _, _, loss = step(sharded, tx.init(sharded), jax.device_put(xj, NamedSharding(mesh, P("dp"))))
    shards = {}
    for leaf in tan.anomaly_flax_leaves(tan.AnomalyConfig(**cfg)):
        arr = _leaf(sharded["params"], leaf.path)
        shards[leaf.path] = {list(devs.flat).index(s.device): np.asarray(s.data)
                             for s in arr.addressable_shards}
    return {"host": host, "loss": float(loss), "shards": shards,
            "specs": {leaf.path: _leaf(shardings["params"], leaf.path).spec
                      for leaf in tan.anomaly_flax_leaves(tan.AnomalyConfig(**cfg))}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    x = np.random.default_rng(0).random((BATCH, 16, 8)).astype(np.float32)
    out = {}
    cases = []
    for name, cfg in CONFIGS.items():
        jx = _jax_side(cfg, x)
        state = {n: t.numpy() for n, t in convert.anomaly_params_from_flax(jx["host"]).items()}
        out[name] = {"jax": jx, "state": state}
        cases.append(dict(cfg=cfg, mesh=MESH, state=state, x=x,
                          steps=1 if name == "tp_cfg" else 0))
    ranks = run_on_gloo_ranks(anomaly_tp_worker, MESH[0] * MESH[1],
                              tmp_path_factory.mktemp("gloo_tp"), cases)
    for i, name in enumerate(CONFIGS):
        out[name]["ranks"] = [r[i] for r in ranks]
    # the port's single-device step from the same converted weights
    model = tan.AnomalyModel(tan.AnomalyConfig(**TP_CFG, dtype=torch.float32), device="cpu")
    model.load_state_dict({n: torch.from_numpy(a.copy())
                           for n, a in out["tp_cfg"]["state"].items()})
    opt = tan.adamw(model.parameters(), LR)
    loss = tan.loss_fn(model, torch.from_numpy(x))
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    opt.step()
    out["single"] = {"loss": loss.item(), "grads": grads,
                     "params": {n: t.detach().numpy() for n, t in model.state_dict().items()}}
    return out


def _expected(spec) -> list[str]:
    """The port's placements ("dp", "tp") of a parameter whose flax leaf
    JAX places by ``spec``: tp on the leaf's last axis is the port's dim
    0 (``weight`` is [out, in], gates fused by rows)."""
    return ["R", "S(0)"] if "tp" in tuple(spec) else ["R", "R"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_placements_follow_jax_predicate_leaf_by_leaf(runs, name):
    jx, ranks = runs[name]["jax"], runs[name]["ranks"]
    leaves = tan.anomaly_flax_leaves(tan.AnomalyConfig(**CONFIGS[name]))
    assert len(leaves) == 26 == len(jx["specs"])
    n_sharded = 0
    for leaf in leaves:
        want = _expected(jx["specs"][leaf.path])
        n_sharded += want[1] != "R"
        for r in ranks:
            assert r["shardings"][leaf.param] == want, (leaf.path, leaf.param)
            assert r["before"][leaf.param] == want, (leaf.path, leaf.param)
    assert n_sharded == SHARDED_LEAVES[name]
    if name == "tp_cfg":
        sharded = {leaf.path[-2] for leaf in leaves
                   if _expected(jx["specs"][leaf.path])[1] != "R"}
        assert sharded == {"enc1", "enc2", "dec2", "out", "hi", "hf", "hg", "ho"}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_rank_holds_jax_shard_of_every_leaf(runs, name):
    """Rank (dp, tp) holds exactly the rows of each parameter that JAX's
    device (dp, tp) holds of the flax leaf: for a hidden-gate kernel, its
    slice of every gate (the gate-interleaved layout of ``w_hh``)."""
    jx, ranks = runs[name]["jax"], runs[name]["ranks"]
    cfg = tan.AnomalyConfig(**CONFIGS[name])
    for rank, r in enumerate(ranks):
        assert r["coords"] == [rank // MESH[1], rank % MESH[1]]
        for leaf in tan.anomaly_flax_leaves(cfg):
            mine = jx["shards"][leaf.path][rank]
            local = r["local"][leaf.param]
            if leaf.rows is not None:
                # the local rows are gate-major: gate k's block is the k-th
                # quarter of this rank's rows
                k = leaf.rows.start // cfg.lstm_hidden
                local = np.split(local, 4)[k]
            got = local.T if len(leaf.shape) == 2 else local
            np.testing.assert_array_equal(got, mine, err_msg=str(leaf.path))


def test_dp_tp_step_equals_single_device_step(runs):
    ranks, single = runs["tp_cfg"]["ranks"], runs["single"]
    slack_elements = 0
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], single["loss"], rtol=RTOL)
        for n, ref in single["params"].items():
            g_ref, g = single["grads"][n], r["grads"][0][n]
            dg = np.abs(g - g_ref)
            assert dg.max() <= GRAD_SHARE * np.abs(g_ref).max(), (n, dg.max())
            slack = np.minimum(2 * LR * dg / (np.abs(g_ref) + ADAM_EPS), LR)
            diff = np.abs(r["params"][n] - ref)
            base = ATOL + RTOL * np.abs(ref)
            assert np.all(diff <= base + slack), (n, float((diff - base - slack).max()))
            slack_elements += int((diff > base).sum())
    # the slack is for a few elements whose gradient sits near eps
    assert slack_elements <= 1e-3 * sum(a.size for a in single["params"].values()) * len(ranks)


def test_dp_tp_loss_equals_jax_sharded_step(runs):
    jx = runs["tp_cfg"]["jax"]
    for r in runs["tp_cfg"]["ranks"]:
        np.testing.assert_allclose(r["losses"][0], jx["loss"], rtol=RTOL)


def test_placements_survive_the_step(runs):
    for r in runs["tp_cfg"]["ranks"]:
        assert r["after"] == r["before"]


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_gate_interleave_round_trip(tp):
    """Row block r of the interleaved ``[4H, in]`` matrix is rank r's slice
    of every gate, and the inverse gives the fused layout back."""
    h, n_in = 8, 3
    w = torch.arange(4 * h * n_in, dtype=torch.float32).reshape(4 * h, n_in)
    inter = tan._interleave_gates(w, tp)
    for r, block in enumerate(inter.chunk(tp)):
        want = torch.cat([w[k * h + r * h // tp:k * h + (r + 1) * h // tp] for k in range(4)])
        assert torch.equal(block, want)
    assert torch.equal(tan._deinterleave_gates(inter, tp), w)


def test_flax_leaf_map_matches_convert():
    """``anomaly_flax_leaves`` names the rows ``anomaly_params_from_flax``
    fills: each leaf (transposed where it is a kernel) lands where the map
    says."""
    cfg = JaxAnomalyConfig(**TP_CFG, dtype=jnp.float32)
    x = jnp.zeros((2, 16, 8), jnp.float32)
    host = jax.device_get(JaxAnomalyModel(cfg).init(jax.random.key(1), x))
    state = convert.anomaly_params_from_flax(host)
    leaves = tan.anomaly_flax_leaves(tan.AnomalyConfig(**TP_CFG))
    assert {leaf.param for leaf in leaves} == set(state)
    for leaf in leaves:
        arr = np.asarray(_leaf(host["params"], leaf.path))
        assert arr.shape == leaf.shape
        got = state[leaf.param].numpy()
        got = got if leaf.rows is None else got[leaf.rows]
        np.testing.assert_array_equal(got, arr.T if arr.ndim == 2 else arr)
