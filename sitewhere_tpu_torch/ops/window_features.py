"""Fused per-device window feature extraction (port of
``sitewhere_tpu/ops/window_features.py``).

Computes analytics features over the device-resident telemetry windows
(models/windows.py, [M, W, C] float32): per (device, channel) mean,
population std, min, max, last value and first-to-last delta — the
normalization front end of models/anomaly.py.

Feature layout (axis -1): [mean, std, min, max, last, delta].

Kernel: ``csrc/window_features.cu``, a hand-written CUDA kernel for
``sm_90a`` that replaces the TPU kernel
``sitewhere_tpu/ops/window_features.py:_features_kernel``.
  * Bound: bytes. It reads M*W*C*4 bytes once and writes M*C*24 (at
    M=8192, W=128, C=100: 419 MB read, ~0.125 ms at 3.35 TB/s).
  * Design: it reads the [M, W, C] layout as it lies (no transpose: the
    TPU kernel's [M, C, W] layout is a lane-width artifact and would cost
    one more full copy here) and keeps many bytes in flight. A thread owns
    4 neighbouring channels, read as one 16-byte ``float4`` (C % 4 == 0,
    as C = 100 on the scoring path; any other C takes a scalar path, one
    channel a thread), and 8 threads split each window's W timesteps into
    segments, each with 8 loads in flight. The std is Welford's
    single-pass recurrence in registers (a multiply by a reciprocal, no
    division in the chain), the segments merged with Chan's parallel
    formula through warp shuffles — stable on windows with a large offset
    and small spread, where the TPU kernel's E[x^2] - mean^2 cancels.
The wrapper runs the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

NUM_FEATURES = 6
KERNEL = "window_features"


def window_features_reference(windows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [M, W, C] -> [M, C, NUM_FEATURES]. The std is
    the population std (``unbiased=False``; ``torch.std`` defaults to the
    unbiased estimator, ``jnp.std`` does not)."""
    mean = windows.mean(1)
    std = windows.std(1, unbiased=False)
    mn = windows.amin(1)
    mx = windows.amax(1)
    last = windows[:, -1, :]
    delta = windows[:, -1, :] - windows[:, 0, :]
    return torch.stack([mean, std, mn, mx, last, delta], -1)


def _as_float32(windows: torch.Tensor) -> torch.Tensor:
    """``windows`` cast to float32, as the reference casts its input
    (``astype(jnp.float32)``): floating point, integer and bool windows
    alike; a complex dtype, which has no float32 value, is refused."""
    if windows.dtype.is_complex:
        raise TypeError(f"window_features takes real windows, got {windows.dtype}")
    return windows.float()


def _launch(windows: torch.Tensor) -> torch.Tensor:
    from sitewhere_tpu_torch import cuda_build

    windows = _as_float32(windows)
    if windows.dim() != 3 or windows.shape[1] == 0:
        raise ValueError(f"window_features takes [M, W>0, C], got {tuple(windows.shape)}")
    if not windows.is_contiguous():
        raise ValueError("window_features kernel takes a contiguous [M, W, C] tensor")
    m, w, c = windows.shape
    lib = cuda_build.load(KERNEL)
    fn = lib.swtpu_window_features
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((m, c, NUM_FEATURES), dtype=torch.float32,
                      device=windows.device)
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream(windows.device).cuda_stream
        err = fn(windows.data_ptr(), out.data_ptr(), m, w, c, stream)
    if err != 0:
        raise RuntimeError(f"window_features kernel launch failed: CUDA error {err}")
    window_features.launches += 1
    return out


def window_features(windows: torch.Tensor) -> torch.Tensor:
    """[M, W, C] -> [M, C, NUM_FEATURES] float32; windows of another
    real type are cast to float32 first, as the reference casts them.
    CUDA tensors go through the hand-written kernel (counted in
    ``window_features.launches``); CPU tensors through
    :func:`window_features_reference`."""
    if windows.device.type == "cuda":
        return _launch(windows)
    if windows.device.type == "cpu":
        return window_features_reference(_as_float32(windows))
    raise ValueError(f"window_features: unsupported device {windows.device}")


# launches of the CUDA kernel since the count was last reset to 0
window_features.launches = 0


def normalize_windows(windows: torch.Tensor, features: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Standardize windows with the extracted per-channel mean/std — the
    input conditioning for the anomaly models."""
    mean = features[:, :, 0][:, None, :]
    std = features[:, :, 1][:, None, :]
    return (windows - mean) / (std + eps)
