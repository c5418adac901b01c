"""Blockwise (flash) attention for long telemetry windows (port of
``sitewhere_tpu/ops/attention.py``), forward and backward.

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
  * bfloat16 at D = 16 and 32 (the default transformer's path): FA2 on
    the tensor cores. A
    block of 4 warps owns (batch, head, 128 query rows), 32 a warp as two
    m16 tiles that share each K/V fragment, Q held in registers as
    ``mma.sync`` m16n8k16 A fragments; K/V tiles of 64 keys
    come through a ``cp.async`` ring in padded shared memory and reach the
    tensor cores through ``ldmatrix``. The float32 scores are scaled inside
    the ``exp2`` argument, the running max and sum live in registers, and
    P, rounded to bf16, is the A operand of the P·V product without a
    trip through shared memory. The products leave the CUDA cores; what
    is left there is the softmax around one exponential per pair.
  * bfloat16 and float16 at D = 64, 128 and 256 (any D from 33 up,
    padded): FA3's forward on Hopper's ``wgmma`` and TMA,
    warp-specialised. A block owns 128 query rows (two compute warpgroups
    of 64; three at D = 64); one thread brings Q once and K and V tiles of
    128 keys (64 at D = 256, where Q alone takes 64 KB of shared memory)
    through TMA into mbarrier rings of their own; S = Q K^T and O += P V
    are ``wgmma`` products, P (in the input type) the register A operand
    of the second. Each warpgroup issues the P V product of one tile right
    behind the S of the next and takes that S's softmax while the product
    runs, and the two warpgroups issue their products in turns, so the
    exponentials run under the tensor cores' work: at D = 64 the two cost
    about the same (1.11 and 1.03 ms at [8, 16384, 4, 64] causal), at
    D = 128 and 256 the products bind.
  * float16 at D = 16 and 32: the ``mma.sync`` kernel with float16
    fragments and the float16 ``mma.sync``.
  * float32 design: one thread per query row (four at D = 256, each with
    64 of its columns) with float32 products on the CUDA cores (tensor
    cores would mean TF32, too coarse for the float32 tolerance); not on
    the transformer's path.
  * Both read q, k and v in place through their (batch, row, head)
    strides, so the strided views of one fused qkv product need no copies,
    and write a contiguous [B, S, H, D] output. Any S; head dims 16, 32,
    64, 128 and 256 (``HEAD_DIMS``). Any other D up to 256 runs
    zero-padded to the next of them (:func:`padded_head_dim`; a copy of q,
    k and v, the output sliced back; D = 129 to 255 at 256), as the TPU
    kernel pads D to a multiple of 128: the zero lanes add nothing to q.k,
    and the scale stays the true D's. A D past 256 (the TPU kernel takes
    any D) and a type outside ``DTYPES`` (float64) are refused. The
    16-bit types need 16-byte aligned base pointers and strides that are a
    multiple of 8 elements (the ``cp.async`` copies are 16 bytes).
  * The forward can also write each row's log-sum-exp (``lse`` [B, H, S]
    float32, natural log), which the backward recomputes P from.

Backward kernel: ``csrc/flash_attention_bwd.cu``. For bfloat16 and
float16 at every head dim, FA3's backward for Hopper: one pass over the
(query, key) pairs (five ``wgmma`` products and one exponential a pair; Q
and dO tiles through TMA into an mbarrier ring, warp-specialised), dQ
summed in float32 across key blocks in a fixed order (a turn counter per
query tile), so a gradient is bitwise the same from run to run. At D = 128
each tile is two 64-column boxes of 128-byte swizzle, and each compute
warpgroup takes 64 of dQ's columns over the block's 128 keys. At D = 256
(four boxes) a block owns 64 keys and each warpgroup 128 of the columns of
dK, dV and dQ, computing the scores and dP of the block whole for itself;
a tile's dQ leaves through its own Q and dO tiles. float16's 5
exponent bits would lose a long row's small entries of P and dS, so the
float16 kernel scales them by powers of two: a key's rows of P^T and dS^T
(the dV and dK operands) by a running per-row scale, and a query's row of
dS (the dQ operand) by a power of two fixed before the kernel runs from a
bound on |dS| (:func:`f16_dq_scale_exponents` is its plain version), so
that the sum over key blocks stays in one unit. float32 keeps two
CUDA-core kernels, each element summed by one thread. It replaces no
Pallas kernel: the JAX trainer
(``sitewhere_tpu/models/transformer.py:153``) differentiates the oracle
``mha_reference``, and this is that gradient.
:class:`FlashAttentionFunction` puts the two kernels behind autograd, and
:func:`flash_attention` takes that route for a CUDA input that requires
grad while grad is enabled.

The wrappers run the plain versions only for a tensor on the CPU; for a
CUDA tensor they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

KERNEL = "flash_attention"
BWD_KERNEL = "flash_attention_bwd"
# the head dims the kernels are instantiated at; any other D up to the last
# is padded with zero lanes to the next one (as the TPU kernel pads D to a
# multiple of 128), a larger D is refused
HEAD_DIMS = (16, 32, 64, 128, 256)
# the kernels' types, in the order of the type code they are handed
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# masked scores, as in the JAX package: -1e30, not -inf, so a softmax
# state that has seen only masked entries never computes -inf - -inf
_NEG_INF = -1e30


def _scale(d: int, sm_scale: float | None) -> float:
    return sm_scale if sm_scale is not None else 1.0 / float(d) ** 0.5


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, sm_scale: float | None,
            q_off: int = 0, k_off: int = 0) -> torch.Tensor:
    """The scaled float32 scores [B, H, Sq, Sk], masked entries -1e30; the
    offsets are the global positions of q's and k's first rows (a ring
    step's shards)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s.mul_(_scale(q.shape[-1], sm_scale))
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        row = q_off + torch.arange(sq, device=s.device)[:, None]
        col = k_off + torch.arange(sk, device=s.device)[None, :]
        s.masked_fill_(col > row, _NEG_INF)
    return s


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, sm_scale: float | None = None
                  ) -> torch.Tensor:
    """Plain multi-head attention: [B, S, H, D] -> [B, S, H, D] in
    ``q.dtype``; scores, softmax and both products in float32 (the
    [B, H, S, S] scores are materialised)."""
    s = _scores(q, k, causal, sm_scale)
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def lse_reference(q: torch.Tensor, k: torch.Tensor, *, causal: bool = False,
                  sm_scale: float | None = None) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled (and masked) scores, [B, H, S]
    float32 in the natural log: what the forward kernel writes as ``lse``."""
    return torch.logsumexp(_scores(q, k, causal, sm_scale), dim=-1)


def mha_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                           *, causal: bool = False, sm_scale: float | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`mha_reference` for an output
    gradient ``do``, the way the backward kernel computes them, in float32
    torch ops, returned in ``q.dtype``: P = exp(scale q.k - lse) from the
    forward's ``lse`` ([B, H, S]), delta = rowsum(dO o) from its output
    ``o``, dS = P (dO v - delta), dq = scale dS k, dk = scale dS^T q,
    dv = P^T dO, contiguous [B, S, H, D]. The [B, H, S, S] P and dS are
    materialised (in place, two at a time)."""
    scale = _scale(q.shape[-1], sm_scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = _scores(q, k, causal, sm_scale)
    p.sub_(lse.float()[..., None]).exp_()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)          # [B, H, S]
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds.sub_(delta[..., None]).mul_(p)
    del p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf).mul_(scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).mul_(scale)
    return tuple(g.to(q.dtype).contiguous() for g in (dq, dk, dv))


# the float16 backward scales each query's row of dS by 2^e_i before the
# dQ product: the row's bound times 2^e_i lies below 2^F16_DQ_TOP, one
# power of two below the 2^15 that float16 (largest 65504) must not reach
F16_DQ_TOP = 14


def f16_dq_scale_exponents(o: torch.Tensor, do: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """The power of two e_i ([B, H, S] int32) by which the float16 backward
    kernel scales query i's row of dS before rounding it to float16 for
    dQ = dS K, fixed before the kernel runs so that the same 2^e_i holds
    for every key block and the float32 dQ sum stays in one unit (taken
    off at the end). From the bound |dS_ij| = P_ij |dO_i . (v_j - o_i)|
    <= ||dO_i|| (max_j ||v_j|| + ||o_i||) (P <= 1, Cauchy-Schwarz), the
    max over the (batch, head)'s keys: e_i = F16_DQ_TOP - x with bound <
    2^x, at most 126; 0 where the bound is 0 (the row of dS is 0 then) or
    not finite. The plain version of the kernel's prep pass (float32 norms;
    the kernel sums them in its own order), used by the tests, never on
    the card's path."""
    dn = do.float().norm(dim=-1)                              # [B, S, H]
    on = o.float().norm(dim=-1)
    vmax = v.float().norm(dim=-1).amax(dim=1, keepdim=True)   # [B, 1, H]
    bound = dn * (vmax + on)
    _, x = torch.frexp(bound)                                 # bound < 2^x
    e = (F16_DQ_TOP - x).clamp(max=126)
    e = torch.where((bound > 0) & torch.isfinite(bound), e, 0)
    return e.to(torch.int32).transpose(1, 2).contiguous()


def gradient_row_errors(got: torch.Tensor, ref: torch.Tensor, which: str, *,
                        causal: bool, step: float = 0.0) -> tuple:
    """Each row (one position of one head) of a gradient ``got`` against
    ``ref``: its largest absolute error over the head dim less ``step``
    (at least 0), its largest |ref| element, and whether its exact
    gradient is 0 (every dq and dk row at S = 1, and dq's row 0 under a
    causal mask: one key, so P = 1 and o = v), each [B, S, H]. ``which``
    is "dq", "dk" or "dv"."""
    err = ((got.float() - ref.float()).abs().amax(-1) - step).clamp_min(0.0)
    zero = torch.zeros_like(err, dtype=torch.bool)
    if which in ("dq", "dk") and got.shape[1] == 1:
        zero[:] = True
    elif which == "dq" and causal:
        zero[:, 0] = True
    return err, ref.float().abs().amax(-1), zero


def gradient_row_shares(got: torch.Tensor, ref: torch.Tensor, which: str, *,
                        causal: bool, atol: float, step: float = 0.0) -> torch.Tensor:
    """How far each row (one position of one head) of a gradient ``got``
    lies from ``ref``: its largest absolute error over the head dim, as a
    share of that row's largest |ref| element, [B, S, H] float32 (0 where
    both are 0, inf where only ``ref`` is). ``which`` is "dq", "dk" or
    "dv". ``atol`` comes off the error only on the rows whose exact
    gradient is 0, where float32 rounding of dP - delta is all that is
    left (``gradient_row_errors``). ``step`` comes off every row's error:
    the gradient type's smallest step (float16's subnormal 2^-24), by
    which two roundings of nearly the same value can differ in a row that
    lies below the type's normal range. A share of the whole tensor's
    largest element would not do: a causal gradient falls off along S,
    and a wrong tail of small rows would pass it."""
    err, top, zero = gradient_row_errors(got, ref, which, causal=causal, step=step)
    err = torch.where(zero, (err - atol).clamp_min(0.0), err)
    return torch.where(top > 0, err / top, torch.where(err > 0, math.inf, 0.0))


def padded_head_dim(d: int) -> int:
    """The instantiated head dim a head dim of ``d`` runs at: the smallest
    of ``HEAD_DIMS`` that is at least ``d``. Raises ``ValueError`` past the
    largest, naming the limit."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"flash_attention kernel takes head dims up to {HEAD_DIMS[-1]}, "
                     f"got {d}")


def pad_head_dim(x: torch.Tensor, dp: int) -> torch.Tensor:
    """``x`` [..., D] with zero lanes appended to ``dp`` (a copy; ``x``
    itself when D == dp). Zero lanes add nothing to a score q.k, and give
    zero output and gradient lanes, which are sliced off; the softmax scale
    must still come from the true D."""
    d = x.shape[-1]
    return x if d == dp else torch.nn.functional.pad(x, (0, dp - d))


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The kernel's shape, type code (an index of ``DTYPES``) and strides
    for q, k, v; raises (``TypeError`` / ``ValueError``) on what the kernel
    does not take: a dtype outside ``DTYPES`` (float64 among them), mixed
    dtypes or devices, a rank other than 4, unequal shapes, a non-unit
    stride on D, a head dim outside ``HEAD_DIMS`` (the callers pad to one
    first); for the 16-bit types also a base pointer that is not 16-byte
    aligned or a (batch, row, head) stride that is not a multiple of 8
    elements."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes float32, bfloat16 or float16 "
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
    if q.dtype != torch.float32 and (any(t.data_ptr() % 16 for t in (q, k, v))
                                     or any(st % 8 for st in strides)):
        raise ValueError("flash_attention 16-bit kernels take 16-byte aligned q, k, v "
                         "with strides that are multiples of 8 elements")
    return (b, s, h, d, DTYPES.index(q.dtype), *strides)


def _launch(q, k, v, causal: bool, sm_scale: float | None, with_lse: bool = False):
    """The forward kernel: ``out``, or ``(out, lse)`` with ``with_lse``. A
    head dim between the instantiated ones runs padded with zero lanes (a
    copy of q, k and v) at the true D's scale, and the output is sliced
    back (a contiguous copy)."""
    from sitewhere_tpu_torch import cuda_build

    d = q.shape[-1]
    scale = _scale(d, sm_scale)
    dp = padded_head_dim(d)
    q, k, v = (pad_head_dim(t, dp) for t in (q, k, v))
    args = kernel_args(q, k, v)
    b, s, h = args[:3]
    out = torch.empty((b, s, h, dp), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        out = out[..., :d].contiguous()
        return (out, lse) if with_lse else out
    lib = cuda_build.load(KERNEL)
    fn = lib.swtpu_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_int64] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None, *args,
                 scale * math.log2(math.e), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    if dp != d:
        out = out[..., :d].contiguous()
    return (out, lse) if with_lse else out


def backward_args(q, k, v, o, do, lse) -> tuple:
    """:func:`kernel_args` for q, k, v, and ``do`` as the backward kernel
    reads it; raises (``TypeError`` / ``ValueError``) where ``o`` is not a
    contiguous [B, S, H, D] of q's type on q's device, ``do`` not of that
    shape and type, or ``lse`` not a contiguous [B, H, S] float32. ``do``
    comes back contiguous and 16-byte aligned (a copy where it was not)."""
    args = kernel_args(q, k, v)
    b, s, h, d = args[:4]
    for name, t in (("o", o), ("do", do)):
        if t.dtype != q.dtype or tuple(t.shape) != (b, s, h, d) or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} must be [B, S, H, D] "
                             f"{q.dtype} on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if not o.is_contiguous() or o.data_ptr() % 16:
        raise ValueError("flash_attention backward: o must be contiguous and 16-byte aligned")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention backward: lse must be a contiguous [B, H, S] "
                         f"float32 on {q.device}, got {tuple(lse.shape)} {lse.dtype}")
    do = do.contiguous()
    if do.data_ptr() % 16:
        do = do.clone()
    return args, do


def _launch_bwd(q, k, v, o, do, lse, causal: bool, sm_scale: float | None):
    """The backward kernels: ``(dq, dk, dv)``; a head dim between the
    instantiated ones runs padded as in :func:`_launch`."""
    from sitewhere_tpu_torch import cuda_build

    d = q.shape[-1]
    scale = _scale(d, sm_scale)
    dp = padded_head_dim(d)
    q, k, v, o, do = (pad_head_dim(t, dp) for t in (q, k, v, o, do))
    args, do = backward_args(q, k, v, o, do, lse)
    b, s, h = args[:3]
    dq, dk, dv = (torch.empty((b, s, h, dp), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if dq.numel() == 0:
        return tuple(g[..., :d].contiguous() for g in (dq, dk, dv))
    lib = cuda_build.load(BWD_KERNEL)
    size = lib.swtpu_flash_attention_bwd_scratch_bytes
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_int64
    # delta, lse2 and (the 16-bit wgmma kernel) the float32 dQ accumulator
    # and turn counters; float16 also the dQ scales and v's row norms; the
    # kernels initialise what they read
    scratch = torch.empty(size(b, s, h, dp, args[4]), dtype=torch.uint8, device=q.device)
    fn = lib.swtpu_flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_int64] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 scratch.data_ptr(), *args, scale, int(causal), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention backward kernel launch failed: CUDA error {err}")
    flash_attention_backward.launches += 1
    if dp != d:
        return tuple(g[..., :d].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Attention on the card with a gradient: the forward kernel, which
    also writes ``lse``; the backward kernel from q, k, v, the output and
    ``lse``. ``apply(q, k, v, causal, sm_scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float | None):
        out, lse = _launch(q, k, v, causal, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, out, do, lse, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale: float | None = None
                    ) -> torch.Tensor:
    """Attention, [B, S, H, D] -> [B, S, H, D] (``sm_scale`` defaults to
    1/sqrt(D)). CUDA tensors go through the hand-written kernel (counted in
    ``flash_attention.launches``), through :class:`FlashAttentionFunction`
    when grad is enabled and an input requires it (its backward counted in
    ``flash_attention_backward.launches``); CPU tensors through
    :func:`mha_reference`, which autograd differentiates."""
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFunction.apply(q, k, v, causal, sm_scale)
        return _launch(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = False, sm_scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the attention and each row's log-sum-exp ([B, H, S]
    float32): the forward kernel on a CUDA tensor (one launch, counted in
    ``flash_attention.launches``), :func:`mha_reference` and
    :func:`lse_reference` on a CPU tensor. No gradient."""
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, sm_scale, with_lse=True)
    if q.device.type == "cpu":
        return (mha_reference(q, k, v, causal=causal, sm_scale=sm_scale),
                lse_reference(q, k, causal=causal, sm_scale=sm_scale))
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = False, sm_scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` for the output gradient ``do``, from the forward's
    output ``o`` and ``lse``: the backward kernel on a CUDA tensor (counted
    in ``flash_attention_backward.launches``), :func:`mha_backward_reference`
    on a CPU tensor."""
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, o, do, lse, causal, sm_scale)
    if q.device.type == "cpu":
        return mha_backward_reference(q, k, v, o, do, lse, causal=causal,
                                      sm_scale=sm_scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


# launches of the CUDA kernels since each count was last reset to 0: the
# forward (whatever wrapper launched it) and the backward (one a call of
# the backward's launches: prep pass, main kernel, then dQ to the 16-bit
# type (float16 with v's row norms first), or dQ for float32)
flash_attention.launches = 0
flash_attention_backward.launches = 0
