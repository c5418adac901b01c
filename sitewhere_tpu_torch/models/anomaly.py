"""Anomaly / forecast models over telemetry windows as ``torch.nn``
modules, and their training step (port of
``sitewhere_tpu/models/anomaly.py``).

The numerics follow the flax modules of the JAX package:
  * parameters are float32 and every product runs in ``cfg.dtype``
    (bfloat16 by default): inputs, kernel and bias are cast to it, as
    flax's ``Dense(dtype=...)`` does;
  * ``gelu`` is the tanh approximation (flax's ``nn.gelu`` default);
  * the LSTM is ``flax.linen.OptimizedLSTMCell``: gates i, f, g, o; the
    input is projected without bias and the hidden state with bias;
    ``c' = f*c + i*g``, ``h' = o*tanh(c')``; a zero float32 carry, which
    stays float32 across steps (bf16 gates promote against it), and the
    readout on ``hs[:, :-1]``.
The products stay ``torch.matmul`` / ``F.linear``, as the JAX package
leaves them to XLA, and training is autograd plus ``torch.optim.AdamW``
held to ``optax.adamw`` (:func:`adamw`). Parameter names follow PyTorch's
habit (``weight`` [out, in]); ``convert.anomaly_params_from_flax`` maps a
flax tree onto them, and :func:`anomaly_flax_leaves` names the flax leaf
(and gate rows) behind each parameter.

Data and tensor parallelism over a 2-d ``("dp", "tp")`` device mesh:
  * :func:`param_shardings` is JAX's placement rule, applied to the flax
    leaf each parameter came from: a leaf with ``ndim >= 2``, a last axis
    divisible by tp and at least 2^16 elements is sharded over tp on its
    last (output) axis, which is the port's dim 0 (``weight`` is
    [out, in]); every other leaf, every bias included, is replicated.
  * :func:`distribute_model` copies a model onto the mesh as DTensor
    parameters with those placements. A sharded fused gate matrix
    (``w_hh``, and ``w_ih`` where it is large enough) is laid out gate
    interleaved, ``[tp, 4, H/tp, in]``, so that ``Shard(0)`` hands each tp
    rank its slice of every gate, as JAX's four per-gate leaves do;
    :func:`full_state_dict` gathers and undoes it.
  * :func:`make_train_step_dp_tp` is ``jit(make_train_step)`` over such
    parameters and a batch split over dp: :func:`make_train_step` with a
    :class:`TensorParallel` context. The modules have one forward, which
    takes its products, its row selection and its gather of ``h`` from a
    context: :data:`PLAIN` (whole tensors, no collective) by default;
    :class:`TensorParallel` runs it on the local shards with explicit
    collectives over tp (a sharded product is column-parallel, its output
    all-gathered; the LSTM gathers ``h`` once a time step), then averages
    the gradients of the global mean loss over dp before AdamW steps the
    DTensor parameters in place.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class AnomalyConfig:
    sensors: int = 100        # C — sensor channels per device window
    window: int = 128         # W — timesteps per window
    latent: int = 64
    hidden: int = 512
    lstm_hidden: int = 512
    dtype: torch.dtype = torch.bfloat16


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    # flax's default kernel init: truncated normal (+-2 sd), variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class _Plain:
    """The forward's parallel context on one device: whole parameters,
    plain products, no collective (see :class:`TensorParallel`)."""
    size = 1

    @staticmethod
    def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _dense(layer, x, dtype)

    @staticmethod
    def rows(p: torch.Tensor, groups: int) -> torch.Tensor:
        return p

    @staticmethod
    def copy(x: torch.Tensor) -> torch.Tensor:
        return x

    @staticmethod
    def gather(x: torch.Tensor) -> torch.Tensor:
        return x


PLAIN = _Plain()


def _linear(n_in: int, n_out: int, gen: torch.Generator) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        _lecun_normal_(layer.weight, n_in, gen)
        layer.bias.zero_()
    return layer


class WindowAutoencoder(nn.Module):
    """Dense autoencoder over a flattened telemetry window; the anomaly score
    is per-window reconstruction error. [B, W, C] -> [B, W, C]."""

    def __init__(self, cfg: AnomalyConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        wc = cfg.window * cfg.sensors
        self.enc1 = _linear(wc, cfg.hidden, gen)
        self.enc2 = _linear(cfg.hidden, cfg.hidden // 2, gen)
        self.latent = _linear(cfg.hidden // 2, cfg.latent, gen)
        self.dec1 = _linear(cfg.latent, cfg.hidden // 2, gen)
        self.dec2 = _linear(cfg.hidden // 2, cfg.hidden, gen)
        self.out = _linear(cfg.hidden, wc, gen)

    def forward(self, x: torch.Tensor, par=PLAIN) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        b = x.shape[0]
        h = x.reshape(b, -1).to(dt)
        h = F.gelu(par.dense(self.enc1, h, dt), approximate="tanh")
        h = F.gelu(par.dense(self.enc2, h, dt), approximate="tanh")
        z = par.dense(self.latent, h, dt)
        h = F.gelu(par.dense(self.dec1, z, dt), approximate="tanh")
        h = F.gelu(par.dense(self.dec2, h, dt), approximate="tanh")
        out = par.dense(self.out, h, dt)
        return out.reshape(b, cfg.window, cfg.sensors)


class LSTMForecaster(nn.Module):
    """Single-layer LSTM forecaster: predicts x[t+1] from x[<=t]; the anomaly
    score is next-step prediction error. [B, W, C] -> [B, W-1, C].

    ``w_ih`` [4H, C] and ``w_hh`` [4H, H] stack the gates i, f, g, o;
    ``b_hh`` [4H] is the hidden projection's bias."""

    def __init__(self, cfg: AnomalyConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        c, h = cfg.sensors, cfg.lstm_hidden
        self.w_ih = nn.Parameter(torch.empty(4 * h, c))
        self.w_hh = nn.Parameter(torch.empty(4 * h, h))
        self.b_hh = nn.Parameter(torch.zeros(4 * h))
        with torch.no_grad():
            for k in range(4):
                _lecun_normal_(self.w_ih[k * h:(k + 1) * h], c, gen)
                nn.init.orthogonal_(self.w_hh[k * h:(k + 1) * h], generator=gen)
        self.readout = _linear(h, c, gen)

    def forward(self, x: torch.Tensor, par=PLAIN) -> torch.Tensor:
        dt = self.cfg.dtype
        b, w, _ = x.shape
        hid = self.cfg.lstm_hidden
        # the input projection of every step at once: [B, W, 4H] in dt
        # (with tp, 4H / tp columns: this rank's rows of every gate)
        gi = torch.matmul(x.to(dt), par.rows(self.w_ih, 4).to(dt).t())
        w_hh = par.rows(self.w_hh, 4).to(dt).t()
        b_hh = par.rows(self.b_hh, 4).to(dt)
        h = torch.zeros(b, hid, dtype=torch.float32, device=x.device)
        c = torch.zeros(b, hid // par.size, dtype=torch.float32, device=x.device)
        hs = []
        for t in range(w):
            z = (torch.matmul(par.copy(h).to(dt), w_hh) + b_hh) + gi[:, t]
            i, f, g, o = z.chunk(4, -1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c = f * c + i * g           # f32 carry: bf16 gates promote
            h = par.gather(o * torch.tanh(c))   # with tp, one all-gather a step
            hs.append(h)
        hs = torch.stack(hs[:-1], 1)    # [B, W-1, H]
        return par.dense(self.readout, hs, dt)


class AnomalyModel(nn.Module):
    """Combined scorer: 0.5 * AE reconstruction error + 0.5 * LSTM forecast
    error. Returns per-window scores [B] (float32)."""

    def __init__(self, cfg: AnomalyConfig,
                 device: str | torch.device = DEFAULT_DEVICE,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        # parameters are drawn on the CPU (the generator's device), then moved
        self.ae = WindowAutoencoder(cfg, gen)
        self.lstm = LSTMForecaster(cfg, gen)
        self.to(dev)

    def forward(self, x: torch.Tensor, par=PLAIN) -> torch.Tensor:
        recon = self.ae(x, par)
        preds = self.lstm(x, par)
        ae_err = torch.square(recon.float() - x).mean((1, 2))
        fc_err = torch.square(preds.float() - x[:, 1:]).mean((1, 2))
        return 0.5 * ae_err + 0.5 * fc_err


def loss_fn(model: AnomalyModel, x: torch.Tensor, par=PLAIN) -> torch.Tensor:
    """Self-supervised training objective = mean anomaly score on normal
    traffic (reconstruction + forecast)."""
    return model(x, par).mean()


def adamw(params, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)`` as a torch optimizer. The betas and
    eps are both libraries' defaults, but the weight decay is optax's
    1e-4, not torch's 0.01: with torch's default the parameters leave
    optax's path by ~1e-3 within 20 steps. Both decay every parameter,
    biases included, and apply the decay as ``p -= lr * wd * p``."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def make_train_step(model: AnomalyModel, opt: torch.optim.Optimizer, par=None):
    """``train_step(x) -> loss``: forward, backward, one optimizer step.
    The loss comes back as a 0-d tensor on the model's device; nothing
    waits for the device. Each part runs under a ``record_function``
    range, so a profile attributes the device time it launches. With a
    :class:`TensorParallel` ``par`` (a :func:`distribute_model` copy's),
    the step takes this rank's dp block of ``x``, runs the forward on the
    local shards, and averages the gradients and the loss over dp before
    the optimizer step."""

    def train_step(x: torch.Tensor) -> torch.Tensor:
        if par is not None:
            x = par.local_batch(x)
        with record_function("anomaly.forward"):
            loss = loss_fn(model, x, par or PLAIN)
        with record_function("anomaly.backward"):
            loss.backward()
        loss = loss.detach()
        if par is not None:
            with record_function("anomaly.grad_allreduce"):
                loss = par.average_over_dp(model.parameters(), loss)
        with record_function("anomaly.optimizer"):
            opt.step()
            opt.zero_grad(set_to_none=True)
        return loss

    return train_step


# ---------------------------------------------------------- flax leaves

FLAX_LSTM_CELL = "ScanOptimizedLSTMCell_0"   # flax's name of the scanned cell
_AE_LAYERS = ("enc1", "enc2", "latent", "dec1", "dec2", "out")
_GATES = ("i", "f", "g", "o")
_GATE_PARAMS = ("lstm.w_ih", "lstm.w_hh")


@dataclasses.dataclass(frozen=True)
class FlaxLeaf:
    """One leaf of the flax ``AnomalyModel`` tree: its path under
    ``params``, the port parameter it becomes, the rows of that parameter
    it fills (a gate's block of the fused LSTM matrices; None for all of
    it) and the leaf's own shape (a ``Dense.kernel`` is [in, out], the
    transpose of the port's ``weight``)."""
    path: tuple[str, ...]
    param: str
    rows: slice | None
    shape: tuple[int, ...]


def anomaly_flax_leaves(cfg: AnomalyConfig) -> list[FlaxLeaf]:
    """Every flax leaf of an ``AnomalyModel`` of ``cfg`` and where it lives
    in the port's model (``convert.anomaly_params_from_flax`` fills the
    parameters by this map)."""
    c, w, hid, lh = cfg.sensors, cfg.window, cfg.hidden, cfg.lstm_hidden
    dims = {"enc1": (w * c, hid), "enc2": (hid, hid // 2),
            "latent": (hid // 2, cfg.latent), "dec1": (cfg.latent, hid // 2),
            "dec2": (hid // 2, hid), "out": (hid, w * c)}
    out = []
    for name in _AE_LAYERS:
        n_in, n_out = dims[name]
        out.append(FlaxLeaf(("ae", name, "kernel"), f"ae.{name}.weight", None, (n_in, n_out)))
        out.append(FlaxLeaf(("ae", name, "bias"), f"ae.{name}.bias", None, (n_out,)))
    for k, g in enumerate(_GATES):
        rows = slice(k * lh, (k + 1) * lh)
        cell = ("lstm", FLAX_LSTM_CELL)
        out.append(FlaxLeaf(cell + (f"i{g}", "kernel"), "lstm.w_ih", rows, (c, lh)))
        out.append(FlaxLeaf(cell + (f"h{g}", "kernel"), "lstm.w_hh", rows, (lh, lh)))
        out.append(FlaxLeaf(cell + (f"h{g}", "bias"), "lstm.b_hh", rows, (lh,)))
    out.append(FlaxLeaf(("lstm", "readout", "kernel"), "lstm.readout.weight", None, (lh, c)))
    out.append(FlaxLeaf(("lstm", "readout", "bias"), "lstm.readout.bias", None, (c,)))
    return out


# ------------------------------------------------------ tensor parallelism

def _dtensor():
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    return DTensor, Replicate, Shard, distribute_tensor


def jax_shards_leaf(shape: tuple[int, ...], tp: int) -> bool:
    """JAX's predicate (``sitewhere_tpu/models/anomaly.py:param_shardings``):
    shard the last axis of a leaf with ``ndim >= 2``, a last axis divisible
    by ``tp`` and at least 2^16 elements."""
    return len(shape) >= 2 and shape[-1] % tp == 0 and math.prod(shape) >= 1 << 16


def param_shardings(model: AnomalyModel, mesh, tp_axis: str = "tp") -> dict:
    """``{parameter name: DTensor placements}`` over ``mesh`` (a
    ``DeviceMesh`` whose dims include ``tp_axis``): ``Shard(0)`` over
    ``tp_axis`` for a parameter whose flax leaves JAX's predicate shards,
    ``Replicate()`` over every other dim and for every other parameter.
    The predicate reads the flax leaf's shape, not the port's tensor's
    (transposed, and four gates fused)."""
    _, Replicate, Shard, _ = _dtensor()
    names = mesh.mesh_dim_names
    tp = mesh.size(names.index(tp_axis))
    decided: dict[str, bool] = {}
    for leaf in anomaly_flax_leaves(model.cfg):
        shard = jax_shards_leaf(leaf.shape, tp)
        if decided.setdefault(leaf.param, shard) != shard:
            raise ValueError(f"the flax leaves of {leaf.param} disagree on their placement")
    have = {n for n, _ in model.named_parameters()}
    if have != set(decided):
        raise ValueError(f"parameters without a flax leaf: {sorted(have ^ set(decided))}")
    return {name: tuple(Shard(0) if shard and dim == tp_axis else Replicate()
                        for dim in names)
            for name, shard in decided.items()}


def _interleave_gates(w: torch.Tensor, tp: int) -> torch.Tensor:
    """[4H, in] in gate order -> [tp, 4, H/tp, in] flattened: row block r
    holds rank r's slice of every gate."""
    h = w.shape[0] // 4
    return w.reshape(4, tp, h // tp, -1).transpose(0, 1).reshape(w.shape)


def _deinterleave_gates(w: torch.Tensor, tp: int) -> torch.Tensor:
    h = w.shape[0] // 4
    return w.reshape(tp, 4, h // tp, -1).transpose(0, 1).reshape(w.shape)


def _is_sharded(p) -> bool:
    _, _, Shard, _ = _dtensor()
    return any(isinstance(pl, Shard) for pl in p.placements)


def distribute_model(model: AnomalyModel, mesh, tp_axis: str = "tp") -> AnomalyModel:
    """A copy of ``model`` whose parameters are DTensors on ``mesh``, placed
    by :func:`param_shardings`; a sharded fused gate matrix is laid out
    gate interleaved first. Every rank must pass the same weights."""
    _, _, _, distribute_tensor = _dtensor()
    placements = param_shardings(model, mesh, tp_axis)
    tp = mesh.size(mesh.mesh_dim_names.index(tp_axis))
    out = copy.deepcopy(model)
    for name, p in list(out.named_parameters()):
        full = p.detach()
        shard = any(pl.is_shard() for pl in placements[name])
        if shard and name in _GATE_PARAMS:
            full = _interleave_gates(full, tp)
        owner, attr = out.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
        setattr(owner, attr, nn.Parameter(distribute_tensor(full, mesh, placements[name])))
    out.tp_mesh, out.tp_axis = mesh, tp_axis
    return out


def full_state_dict(model: AnomalyModel, grads: bool = False) -> dict[str, torch.Tensor]:
    """The whole parameters (or, with ``grads``, their gradients) of a
    :func:`distribute_model` copy, gathered, in the single-device layout
    (gate rows back in gate order). Every rank must call it."""
    mesh, tp_axis = model.tp_mesh, model.tp_axis
    tp = mesh.size(mesh.mesh_dim_names.index(tp_axis))
    out = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            full = (p.grad if grads else p).full_tensor()
            if _is_sharded(p) and name in _GATE_PARAMS:
                full = _deinterleave_gates(full, tp)
            out[name] = full.detach()
    return out


class _CopyToTP(torch.autograd.Function):
    """Forward the identity; backward the gradient summed over the tp
    group (a replicated input of a column-parallel product: each rank's
    slice of the output gives part of its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """Forward: the tp ranks' pieces concatenated along the last dim, in
    rank order. Backward: this rank's slice of the (replicated)
    gradient."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        import torch.distributed as dist

        ctx.rank, ctx.n = rank, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None


class _SplitToTP(torch.autograd.Function):
    """Forward: this tp rank's rows of a replicated ``[groups * n, ...]``
    tensor, the slice ``rank`` of each of its ``groups`` row blocks (the
    four gates, or one block). Backward: every rank's slices gathered back
    into the whole gradient, identical on every rank."""

    @staticmethod
    def forward(ctx, x, groups, group, rank, size):
        ctx.groups, ctx.group, ctx.size, ctx.shape = groups, group, size, x.shape
        blocks = x.reshape(groups, size, -1, *x.shape[1:])
        return blocks[:, rank].reshape(-1, *x.shape[1:]).contiguous()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(ctx.size)]
        dist.all_gather(parts, g, group=ctx.group)
        blocks = [p.reshape(ctx.groups, -1, *g.shape[1:]) for p in parts]
        return torch.stack(blocks, 1).reshape(ctx.shape), None, None, None, None


class TensorParallel:
    """The forward's parallel context over a :func:`distribute_model`
    copy on one rank of ``mesh``: each product reads the local shard of its
    DTensor parameter; a sharded product computes this rank's output
    columns and all-gathers them over tp, and the LSTM takes this rank's
    rows of every gate and gathers ``h`` once a time step. The operations
    run in the single-device forward's order (:data:`PLAIN` is the same
    context with every collective an identity)."""

    def __init__(self, mesh, dp_axis: str = "dp", tp_axis: str = "tp"):
        names = mesh.mesh_dim_names
        self.group = mesh.get_group(tp_axis)
        self.rank = mesh.get_local_rank(tp_axis)
        self.size = mesh.size(names.index(tp_axis))
        self.dp_group = mesh.get_group(dp_axis)
        self.dp = mesh.size(names.index(dp_axis))
        self.dp_rank = mesh.get_local_rank(dp_axis)

    def copy(self, x):
        return _CopyToTP.apply(x, self.group) if x.requires_grad else x

    def gather(self, x):
        return _GatherFromTP.apply(x, self.group, self.rank, self.size)

    def _split(self, x, groups: int):
        return _SplitToTP.apply(x, groups, self.group, self.rank, self.size)

    def rows(self, p, groups: int):
        """This rank's rows of a row-parallel input of the LSTM (a fused
        gate matrix, or its bias): the local shard when sharded, else the
        rows split out of the replicated whole."""
        t = p.to_local()
        return t if _is_sharded(p) else self._split(t, groups)

    def dense(self, layer: nn.Linear, x, dt):
        w, b = layer.weight.to_local(), layer.bias.to_local()
        if not _is_sharded(layer.weight):
            return F.linear(x.to(dt), w.to(dt), b.to(dt))
        y = F.linear(self.copy(x).to(dt), w.to(dt), self._split(b, 1).to(dt))
        return self.gather(y)

    def local_batch(self, x):
        """This rank's dp block of the whole batch ``x`` (the batch
        divisible by dp), or the local part of a DTensor sharded on dp."""
        if isinstance(x, _dtensor()[0]):
            return x.to_local()
        if x.shape[0] % self.dp:
            raise ValueError(f"batch {x.shape[0]} is not divisible by dp {self.dp}")
        return x.chunk(self.dp)[self.dp_rank]

    def average_over_dp(self, params, loss):
        """Each gradient summed over dp and divided by dp (the gradient of
        the global mean loss, equal local batches); returns the global mean
        loss."""
        import torch.distributed as dist

        with torch.no_grad():
            for p in params:
                g = p.grad.to_local()
                dist.all_reduce(g, group=self.dp_group)
                g.div_(self.dp)
            loss = loss.clone()
            dist.all_reduce(loss, group=self.dp_group)
            return loss.div_(self.dp)


def make_train_step_dp_tp(model: AnomalyModel, opt: torch.optim.Optimizer, mesh,
                          dp_axis: str = "dp", tp_axis: str = "tp"):
    """``train_step(x) -> loss`` over a :func:`distribute_model` copy whose
    DTensor parameters ``opt`` steps (the port's :func:`adamw`): JAX's
    ``jit(make_train_step)`` with ``param_shardings`` and the batch on
    ``P("dp")``, as :func:`make_train_step` with a :class:`TensorParallel`
    context. ``x`` is the whole batch on every rank (this rank takes its
    dp block, the batch divisible by dp) or a DTensor sharded on dp. The
    returned loss is the global mean. Placements are kept."""
    return make_train_step(model, opt, TensorParallel(mesh, dp_axis, tp_axis))
