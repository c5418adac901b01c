"""Long-window telemetry transformer — causal forecaster for anomaly scoring,
forward only, as a ``torch.nn`` module (port of
``sitewhere_tpu/models/transformer.py``; its training step and
sequence-parallel path are not ported yet).

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
    views of the fused qkv product in place;
  * the score is the float32 mean squared next-step error.
The large products stay ``F.linear``, as the JAX package leaves them to
XLA. ``convert.transformer_params_from_jax`` maps a JAX parameter tree
onto the ``state_dict``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, resolve_device
from sitewhere_tpu_torch.ops.attention import flash_attention

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


@torch.inference_mode()
def forecast_scores(model: TelemetryTransformer, x: torch.Tensor,
                    **kw) -> torch.Tensor:
    """Per-window anomaly score [B] float32: mean squared next-step forecast
    error. ``kw`` goes to the forward (``positions``, ``attention_fn``)."""
    preds = model(x, **kw)
    err = torch.square(preds[:, :-1].float() - x[:, 1:])
    return err.mean((1, 2))
