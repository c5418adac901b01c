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
flax tree onto them. The JAX package's ``param_shardings`` (a mesh helper)
waits for the multi-GPU engines.
"""

from __future__ import annotations

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        b = x.shape[0]
        h = x.reshape(b, -1).to(dt)
        h = F.gelu(_dense(self.enc1, h, dt), approximate="tanh")
        h = F.gelu(_dense(self.enc2, h, dt), approximate="tanh")
        z = _dense(self.latent, h, dt)
        h = F.gelu(_dense(self.dec1, z, dt), approximate="tanh")
        h = F.gelu(_dense(self.dec2, h, dt), approximate="tanh")
        out = _dense(self.out, h, dt)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        b, w, _ = x.shape
        hid = self.cfg.lstm_hidden
        # the input projection of every step at once: [B, W, 4H] in dt
        gi = torch.matmul(x.to(dt), self.w_ih.to(dt).t())
        w_hh = self.w_hh.to(dt).t()
        b_hh = self.b_hh.to(dt)
        h = torch.zeros(b, hid, dtype=torch.float32, device=x.device)
        c = torch.zeros(b, hid, dtype=torch.float32, device=x.device)
        hs = []
        for t in range(w):
            z = (torch.matmul(h.to(dt), w_hh) + b_hh) + gi[:, t]
            i, f, g, o = z.chunk(4, -1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c = f * c + i * g           # f32 carry: bf16 gates promote
            h = o * torch.tanh(c)
            hs.append(h)
        hs = torch.stack(hs[:-1], 1)    # [B, W-1, H]
        return _dense(self.readout, hs, dt)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        recon = self.ae(x)
        preds = self.lstm(x)
        ae_err = torch.square(recon.float() - x).mean((1, 2))
        fc_err = torch.square(preds.float() - x[:, 1:]).mean((1, 2))
        return 0.5 * ae_err + 0.5 * fc_err


def loss_fn(model: AnomalyModel, x: torch.Tensor) -> torch.Tensor:
    """Self-supervised training objective = mean anomaly score on normal
    traffic (reconstruction + forecast)."""
    return model(x).mean()


def adamw(params, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)`` as a torch optimizer. The betas and
    eps are both libraries' defaults, but the weight decay is optax's
    1e-4, not torch's 0.01: with torch's default the parameters leave
    optax's path by ~1e-3 within 20 steps. Both decay every parameter,
    biases included, and apply the decay as ``p -= lr * wd * p``."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def make_train_step(model: AnomalyModel, opt: torch.optim.Optimizer):
    """``train_step(x) -> loss``: forward, backward, one optimizer step.
    The loss comes back as a 0-d tensor on the model's device; nothing
    waits for the device. Each part runs under a ``record_function``
    range, so a profile attributes the device time it launches."""

    def train_step(x: torch.Tensor) -> torch.Tensor:
        with record_function("anomaly.forward"):
            loss = loss_fn(model, x)
        with record_function("anomaly.backward"):
            loss.backward()
        with record_function("anomaly.optimizer"):
            opt.step()
            opt.zero_grad(set_to_none=True)
        return loss.detach()

    return train_step
