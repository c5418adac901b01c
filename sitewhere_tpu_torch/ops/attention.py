"""Blockwise (flash) attention for long telemetry windows (port of
``sitewhere_tpu/ops/attention.py``, forward only).

The compute core of the long-window transformer (models/transformer.py):
windows of tens of thousands of timesteps, so the [S, S] score matrix is
never materialised on the kernel path.

Layout: q, k, v and the output are [B, S, H, D], the JAX package's layout.

Kernel: ``csrc/flash_attention.cu``, hand-written CUDA for ``sm_90a`` that
replaces the TPU kernel ``sitewhere_tpu/ops/attention.py:_flash_kernel``.
  * Bound: operations, the exponentials. At the transformer's shape
    ([8, 16384, 8, 32] bf16, causal) it moves 268 MB (0.08 ms) but does
    8.6e9 exponentials (2.05 ms at 16 per SM per clock) and 1.1e12
    product operations (1.1 ms on the bf16 tensor cores).
  * bfloat16 design (the transformer's path): FA2 on the tensor cores. A
    block of 4 warps owns (batch, head, 128 query rows), 32 a warp as two
    m16 tiles that share each K/V fragment, Q held in registers as
    ``mma.sync`` m16n8k16 A fragments; K/V tiles of 64 keys
    come through a ``cp.async`` ring in padded shared memory and reach the
    tensor cores through ``ldmatrix``. The float32 scores are scaled inside
    the ``exp2`` argument, the running max and sum live in registers, and
    P, rounded to bf16, is the A operand of the P·V product without a
    trip through shared memory. The products leave the CUDA cores; what
    is left there is the softmax around one exponential per pair.
  * float32 design: one thread per query row with float32 products on the
    CUDA cores (tensor cores would mean TF32, too coarse for the float32
    tolerance); not on the transformer's path.
  * Both read q, k and v in place through their (batch, row, head)
    strides, so the strided views of one fused qkv product need no copies,
    and write a contiguous [B, S, H, D] output. Any S; head dims 16, 32,
    64. bf16 needs 16-byte aligned base pointers and strides that are a
    multiple of 8 elements (the ``cp.async`` copies are 16 bytes).
The wrapper runs the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

KERNEL = "flash_attention"
HEAD_DIMS = (16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)

# masked scores, as in the JAX package: -1e30, not -inf, so a softmax
# state that has seen only masked entries never computes -inf - -inf
_NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, sm_scale: float | None = None
                  ) -> torch.Tensor:
    """Plain multi-head attention: [B, S, H, D] -> [B, S, H, D] in
    ``q.dtype``; scores, softmax and both products in float32 (the
    [B, H, S, S] scores are materialised)."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / float(d) ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s.mul_(scale)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        row = torch.arange(sq, device=s.device)[:, None]
        col = torch.arange(sk, device=s.device)[None, :]
        s.masked_fill_(col > row, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The kernel's shape, type code and strides for q, k, v; raises
    (``TypeError`` / ``ValueError``) on what the kernel does not take:
    another dtype than float32 / bfloat16, mixed dtypes or devices, a rank
    other than 4, unequal shapes, a non-unit stride on D, a head dim
    outside ``HEAD_DIMS``; for bfloat16 also a base pointer that is not
    16-byte aligned or a (batch, row, head) stride that is not a multiple
    of 8 elements."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention takes q, k, v of one shape [B, S, H, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes unit stride on D")
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    if q.dtype == torch.bfloat16 and (any(t.data_ptr() % 16 for t in (q, k, v))
                                      or any(st % 8 for st in strides)):
        raise ValueError("flash_attention bf16 kernel takes 16-byte aligned q, k, v "
                         "with strides that are multiples of 8 elements")
    return (b, s, h, d, int(q.dtype == torch.bfloat16), *strides)


def _launch(q, k, v, causal: bool, sm_scale: float | None) -> torch.Tensor:
    from sitewhere_tpu_torch import cuda_build

    args = kernel_args(q, k, v)
    b, s, h, d = args[:4]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / float(d) ** 0.5
    lib = cuda_build.load(KERNEL)
    fn = lib.swtpu_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_int64] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args,
                 scale * math.log2(math.e), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale: float | None = None
                    ) -> torch.Tensor:
    """Attention, [B, S, H, D] -> [B, S, H, D] (``sm_scale`` defaults to
    1/sqrt(D)). CUDA tensors go through the hand-written kernel (counted in
    ``flash_attention.launches``); CPU tensors through
    :func:`mha_reference`."""
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


# launches of the CUDA kernel since the count was last reset to 0
flash_attention.launches = 0
