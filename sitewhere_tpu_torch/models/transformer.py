"""Long-window telemetry transformer — causal forecaster for anomaly scoring,
as a ``torch.nn`` module, with its training step and its
sequence-parallel scoring (port of ``sitewhere_tpu/models/transformer.py``).

The numerics follow the JAX package's forward:
  * parameters are float32 and every product runs in ``cfg.dtype``
    (bfloat16 by default): input, weight and bias are cast to it;
  * the residual stream stays in ``cfg.dtype``, and the sinusoidal
    position encoding (sin then cos, float32 frequencies) is cast to it;
  * LayerNorm runs in float32 with eps 1e-6 inside the rsqrt (not
    ``nn.LayerNorm``'s default 1e-5) and returns ``cfg.dtype``;
  * ``gelu`` is the tanh approximation;
  * attention is causal; by default ``ops.attention.flash_attention``,
    which on the card is the CUDA kernel reading the strided q, k, v
    views of the fused qkv product in place, and under autograd the
    kernel pair behind ``FlashAttentionFunction`` (forward with the
    log-sum-exp, the hand-written backward);
  * the score is the float32 mean squared next-step error.
The large products stay ``F.linear``, as the JAX package leaves them to
XLA. ``convert.transformer_params_from_jax`` maps a JAX parameter tree
onto the ``state_dict``, ``convert.adamw_state_from_optax(...,
params_from=convert.transformer_params_from_jax)`` an optax Adam or AdamW
state onto the optimizer.

Training (JAX :147-158): :func:`loss_fn`, :func:`make_train_step` and
:func:`adam`, held to ``optax.adam`` (``models.anomaly.adamw`` is held to
``optax.adamw``).

Sequence parallelism (JAX :163-217): :func:`forecast_scores_sp` scores
[B, S, C] windows whose S is split over the ranks of a
``torch.distributed`` group, every layer's attention a ring over the
group (``parallel/ring_attention.py``); every other op acts on the local
shard as it is.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, resolve_device
from sitewhere_tpu_torch.ops.attention import flash_attention
from sitewhere_tpu_torch.parallel.ring_attention import (all_sum, replicated,
                                                         ring_attention, ring_shift)

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    sensors: int = 100          # input channels C
    d_model: int = 256
    heads: int = 8
    layers: int = 4
    mlp: int = 1024
    dtype: torch.dtype = torch.bfloat16


def _pos_encoding(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal positions -> [..., d_model] float32. Taking positions as an
    argument (not an arange) lets a sequence shard encode its global
    offset."""
    half = d_model // 2
    neg_log = -torch.log(torch.tensor(10000.0, dtype=torch.float32))
    freqs = torch.exp(neg_log * torch.arange(half, dtype=torch.float32) / half)
    ang = positions[..., None].float() * freqs.to(positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _linear(n_in: int, n_out: int, gen: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with the JAX package's init: normal weights scaled by
    sqrt(2 / (fan_in + fan_out)), zero bias."""
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        layer.weight.copy_(torch.randn((n_out, n_in), generator=gen)
                           * math.sqrt(2.0 / (n_in + n_out)))
        layer.bias.zero_()
    return layer


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        LN_EPS).to(x.dtype)


class _Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS)
        self.qkv = _linear(d, 3 * d, gen)
        self.proj = _linear(d, d, gen)
        self.mlp_in = _linear(d, cfg.mlp, gen)
        self.mlp_out = _linear(cfg.mlp, d, gen)


class TelemetryTransformer(nn.Module):
    """Causal transformer forecast: [B, S, C] -> next-step prediction
    [B, S, C] (the prediction at t targets x[t+1])."""

    def __init__(self, cfg: TransformerConfig,
                 device: str | torch.device = DEFAULT_DEVICE,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        d = cfg.d_model
        # parameters are drawn on the CPU (the generator's device), then moved
        self.embed = _linear(cfg.sensors, d, gen)
        self.readout = _linear(d, cfg.sensors, gen)
        self.ln_f = nn.LayerNorm(d, eps=LN_EPS)
        self.blocks = nn.ModuleList(_Block(cfg, gen) for _ in range(cfg.layers))
        self.to(dev)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor | None = None,
                attention_fn=None) -> torch.Tensor:
        """``positions``: global timestep of each row ([S]), default arange
        (a sequence shard passes its offset positions). ``attention_fn(q,
        k, v)``: the attention, default causal ``flash_attention``."""
        cfg, dt = self.cfg, self.cfg.dtype
        b, s, _ = x.shape
        d, h = cfg.d_model, cfg.heads
        if positions is None:
            positions = torch.arange(s, device=x.device)
        if attention_fn is None:
            attention_fn = functools.partial(flash_attention, causal=True)

        hh = _dense(self.embed, x, dt)
        hh = hh + _pos_encoding(positions, d)[None].to(dt)
        for blk in self.blocks:
            y = _layer_norm(hh, blk.ln1)
            qkv = _dense(blk.qkv, y, dt).reshape(b, s, 3, h, d // h)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            att = attention_fn(q, k, v).reshape(b, s, d)
            hh = hh + _dense(blk.proj, att, dt)
            y = _layer_norm(hh, blk.ln2)
            y = F.gelu(_dense(blk.mlp_in, y, dt), approximate="tanh")
            hh = hh + _dense(blk.mlp_out, y, dt)
        return _dense(self.readout, _layer_norm(hh, self.ln_f), dt)


def _scores(model: TelemetryTransformer, x: torch.Tensor, **kw) -> torch.Tensor:
    preds = model(x, **kw)
    err = torch.square(preds[:, :-1].float() - x[:, 1:])
    return err.mean((1, 2))


@torch.inference_mode()
def forecast_scores(model: TelemetryTransformer, x: torch.Tensor,
                    **kw) -> torch.Tensor:
    """Per-window anomaly score [B] float32: mean squared next-step forecast
    error. ``kw`` goes to the forward (``positions``, ``attention_fn``)."""
    return _scores(model, x, **kw)


def loss_fn(model: TelemetryTransformer, x: torch.Tensor, **kw) -> torch.Tensor:
    """Training objective: the mean forecast score over the batch, with a
    gradient (JAX ``loss_fn``). ``kw`` goes to the forward."""
    return _scores(model, x, **kw).mean()


def adam(params, learning_rate: float) -> torch.optim.Adam:
    """``optax.adam(learning_rate)`` as a torch optimizer: the same betas
    (0.9, 0.999) and eps 1e-8 outside the square root (optax's
    ``eps_root`` is 0), no weight decay, bias-corrected moments. For
    ``optax.adamw`` use ``models.anomaly.adamw`` (optax's decay 1e-4)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(model: TelemetryTransformer, opt: torch.optim.Optimizer):
    """``train_step(x) -> loss``: forward, backward, one optimizer step (JAX
    ``make_train_step``). The loss comes back as a 0-d tensor on the model's device; nothing
    waits for the device. Each part runs under a ``record_function`` range,
    so a profile attributes the device time it launches."""

    def train_step(x: torch.Tensor) -> torch.Tensor:
        with record_function("transformer.forward"):
            loss = loss_fn(model, x)
        with record_function("transformer.backward"):
            loss.backward()
        with record_function("transformer.optimizer"):
            opt.step()
            opt.zero_grad(set_to_none=True)
        return loss.detach()

    return train_step


# --- sequence-parallel scoring (ring attention over a process group) -------

def _sp_forward_local(model: TelemetryTransformer, params: dict,
                      x_local: torch.Tensor, group) -> torch.Tensor:
    """The forward on this rank's sequence shard: global positions from the
    shard's offset, every layer's attention a ring over the group."""
    s_local = x_local.shape[1]
    offset = dist.get_rank(group) * s_local
    positions = offset + torch.arange(s_local, device=x_local.device)

    def attention_fn(q, k, v):
        return ring_attention(q, k, v, group, causal=True)

    return torch.func.functional_call(model, params, (x_local,),
                                      dict(positions=positions,
                                           attention_fn=attention_fn))


def _sp_scores_local(model: TelemetryTransformer, x_local: torch.Tensor,
                     total_len: int, group) -> torch.Tensor:
    """Forecast scores from this rank's shard: the target of its last
    prediction is the next shard's first timestep (a reverse ring hop); the
    last global position has no target and is masked out; the squared
    errors are summed over the group."""
    # the parameters are replicated: each rank's gradient is summed over
    # the group in the backward, so every rank ends with the whole gradient
    params = {n: replicated(p, group) for n, p in model.named_parameters()}
    preds = _sp_forward_local(model, params, x_local, group)     # [B, Sl, C]
    s_local = x_local.shape[1]
    nxt = ring_shift(x_local[:, :1], -1, group)                  # rank r+1's first
    targets = torch.cat([x_local[:, 1:], nxt], dim=1)
    err = torch.square(preds.float() - targets)
    gpos = dist.get_rank(group) * s_local + torch.arange(s_local, device=x_local.device)
    valid = (gpos < total_len - 1).float()[None, :, None]
    local = (err * valid).sum((1, 2))
    return all_sum(local, group) / float((total_len - 1) * x_local.shape[2])


def forecast_scores_sp(model: TelemetryTransformer, x: torch.Tensor,
                       group=None) -> torch.Tensor:
    """Sequence-parallel anomaly scoring (JAX ``forecast_scores_sp``): ``x``
    is the whole [B, S, C] on every rank of ``group`` (the default group
    when None), S divisible by its size; each rank runs its S/n shard and
    every rank returns the same [B] scores, numerically
    :func:`forecast_scores` on one device. Differentiable: a loss of the
    scores backpropagated on every rank gives every rank the single-device
    gradient of the parameters, as JAX's ``shard_map`` transposes do (the
    group sum's backward is the identity, the replicated parameters'
    backward a summed all-reduce). Not under ``inference_mode``: wrap it in
    ``torch.no_grad()`` to score."""
    n = dist.get_world_size(group)
    s = x.shape[1]
    if s % n:
        raise ValueError(f"sequence length {s} does not divide by the group size {n}")
    sl = s // n
    lo = dist.get_rank(group) * sl
    return _sp_scores_local(model, x[:, lo:lo + sl], s, group)
