"""The port's attention against the JAX package's.

* The plain PyTorch version (``mha_reference``) against the JAX oracle
  ``mha_reference`` and against the JAX ``flash_attention(...,
  force_pallas=True)``, which runs the Pallas kernel in interpret mode (as
  ``tests/test_attention.py`` runs it), on the same seeded numpy inputs.
  Tolerances: float32 ``rtol = atol = 1e-5`` (the same float32 math with
  sums in another order; the Pallas route also streams its softmax);
  bfloat16 one bf16 ulp (``rtol = 2**-7``): both sides compute in float32
  and round once to bf16, so a result can land one ulp apart where the
  float32 values straddle a rounding boundary.
* The bf16 kernel's arithmetic, emulated here on the CPU (64-key tiles,
  128 for the wgmma kernel at D = 128; float32 scores scaled inside
  ``exp2``, P rounded to bf16 per tile before the P·V product, float32
  accumulation), against both ``mha_reference``s
  within the card's bf16 tolerance (``rtol = atol = 8e-3``, the limit the
  card's check holds the kernel to): the rounding of P fits that budget;
  and its handling of a zero or negative ``sm_scale`` (the scale inside
  ``exp2`` must be positive). The same arithmetic in float16 sizes the
  float16 limits, and with P (and dS) rounded to bf16 under float16
  inputs it is the control those limits must fail.
* The wrapper's argument checks, which need no card.
* The backward: the port's plain backward (``mha_backward_reference``)
  and autograd of its ``mha_reference`` against ``jax.vjp`` of JAX's
  oracle, the plain log-sum-exp against ``jax.nn.logsumexp``, and the bf16
  backward kernel's arithmetic emulated on the CPU (P and dS rounded to
  bf16 before their products, dQ summed over key blocks in their order)
  against the float32 gradient, which sizes the card's gradient
  tolerance; tolerances with their reasons below.
* The CUDA kernels themselves run only on the card (``gpu`` marker):
  against the plain versions on strided views, ragged S and S=1, the
  gradient through the transformer reaching ``blocks.*.qkv``, and the
  wrappers raising on what the kernels do not take.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sitewhere_tpu.ops import attention as jatt
from sitewhere_tpu_torch.ops import attention as tatt

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2**-7, atol=1e-6)
FLASH_TOL_BF16 = dict(rtol=8e-3, atol=8e-3)   # the kernel against its plain version
# float16 rounds 8x finer than bf16: one float16 ulp at 1.0 (2**-10), where
# the float16 kernel's arithmetic (emulated below) reads <= 5.7e-4 and the
# same arithmetic with P rounded to bf16 fails on every causal case
FLASH_TOL_F16 = dict(rtol=1e-3, atol=1e-3)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_jax_oracle(causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((2, 256, 4, 32)), dtype)
    ref = jatt.mha_reference(jq, jk, jv, causal=causal)
    got = tatt.mha_reference(tq, tk, tv, causal=causal)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, 256, 4, 32)
    np.testing.assert_allclose(_np(got), _np(ref), **DTYPES[dtype][2])


# (shape, block_q, block_k): the JAX package's own kernel cases — two
# blocks of queries and four of keys; D=32 lane padding to 128; S=96,
# which no preferred block divides
PALLAS_CASES = {
    "blocks_128x64": ((2, 256, 4, 32), 128, 64),
    "lane_padding_d32": ((2, 64, 2, 32), 32, 32),
    "odd_block_s96": ((2, 96, 2, 64), 512, 512),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_version_matches_pallas_interpret(case, causal, dtype):
    shape, bq, bk = PALLAS_CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape, seed=1), dtype)
    pal = jatt.flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                               force_pallas=True)
    got = tatt.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(pal), **DTYPES[dtype][2])


def test_sm_scale_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((1, 40, 2, 16), seed=2), "float32")
    ref = jatt.mha_reference(jq, jk, jv, causal=True, sm_scale=0.37)
    got = tatt.mha_reference(tq, tk, tv, causal=True, sm_scale=0.37)
    np.testing.assert_allclose(_np(got), _np(ref), **F32)


def test_masked_scores_are_minus_1e30_as_in_jax():
    """Masked entries hold -1e30, not -inf: where every real score lies
    below -1e30, a causal row's masked entries win the softmax, on both
    sides alike."""
    q = np.full((1, 4, 1, 4), 1e16, np.float32)
    k = np.full((1, 4, 1, 4), -1e16, np.float32)
    v = np.random.default_rng(3).standard_normal((1, 4, 1, 4)).astype(np.float32)
    ref = np.asarray(jatt.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True))
    got = tatt.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True).numpy()
    np.testing.assert_allclose(got, ref, **F32)
    # row 2's one masked key (3) takes the whole weight
    np.testing.assert_allclose(got[0, 2, 0], v[0, 3, 0], **F32)


def emulate_bf16_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, sm_scale: float | None = None,
                        block_k: int = 64, low: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """The arithmetic of the bf16 tensor-core kernel, on the CPU: key tiles
    of ``block_k`` (64 for the mma.sync kernel up to D = 64, 128 for the
    wgmma kernel at D = 128); float32 scores (exact products of bf16 values summed in
    float32) scaled inside the exp2 argument, p = exp2(s·c − m·c) with c =
    sm_scale·log2(e) made positive (a negative c as |c| on -q, a zero c as
    the smallest normal float); the running max starting at -1e30; masked
    entries p = 0; P rounded to bf16 before the P·V product, accumulated in
    float32; the normaliser summed from the float32 p; l == 0 writes 0.
    ``low`` is the type P is rounded to (float16 for the float16 kernel,
    or bf16 under float16 inputs as a control); the output has q's type."""
    b, s, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    c = scale * math.log2(math.e)
    if c < 0:
        q, c = -q, -c
    c = c or float(torch.finfo(torch.float32).tiny)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        sc = qf @ kt.transpose(-1, -2)
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            sc = sc.masked_fill(cols > rows, -math.inf)
        mx = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2((m - mx) * c)
        p = torch.exp2(sc * c - (mx * c)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(low).float() @ vt
        m = mx
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 63, 65, 200])
def test_bf16_kernel_arithmetic_fits_the_tolerance(s, d, causal):
    """The kernel's bf16 P (relative error up to 2**-9 a weight) stays
    within the card's bf16 limit of both plain versions."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((2, s, 2, d), seed=5 + s + d), "bfloat16")
    got = emulate_bf16_kernel(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (2, s, 2, d)
    np.testing.assert_allclose(
        _np(got), _np(tatt.mha_reference(tq, tk, tv, causal=causal)), **FLASH_TOL_BF16)
    np.testing.assert_allclose(
        _np(got), _np(jatt.mha_reference(jq, jk, jv, causal=causal)), **FLASH_TOL_BF16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sm_scale", [0.0, -0.3])
def test_bf16_kernel_arithmetic_takes_any_sign_of_scale(sm_scale, causal):
    """A zero scale weighs every live key alike, a negative one favours
    the smallest scores: the kernel's positive-scale rewrite of both stays
    within the card's bf16 limit of both plain versions, and finite."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((2, 130, 2, 32), seed=9), "bfloat16")
    got = emulate_bf16_kernel(tq, tk, tv, causal=causal, sm_scale=sm_scale)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(
        _np(got), _np(tatt.mha_reference(tq, tk, tv, causal=causal, sm_scale=sm_scale)),
        **FLASH_TOL_BF16)
    np.testing.assert_allclose(
        _np(got), _np(jatt.mha_reference(jq, jk, jv, causal=causal, sm_scale=sm_scale)),
        **FLASH_TOL_BF16)


@pytest.mark.parametrize("sm_scale", [None, 0.0, -0.3])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 65, 300])
def test_bf16_wgmma_forward_arithmetic_at_d128_holds_to_jax(s, causal, sm_scale):
    """The D = 128 forward on wgmma (``flash_attention_wgmma_kernel``):
    128-key tiles, a negative scale taken as its magnitude on -q (the
    kernel negates its Q tile in shared memory once, which is exact in
    bf16), a zero one as the smallest normal float, P rounded to bf16
    before P·V. It stays within the card's bf16 limit of JAX's oracle and
    of the Pallas kernel in interpret mode (measured <= 5.2e-3)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((2, s, 2, 128), seed=80 + s), "bfloat16")
    got = emulate_bf16_kernel(tq, tk, tv, causal=causal, sm_scale=sm_scale, block_k=128)
    assert got.dtype == torch.bfloat16 and got.shape == (2, s, 2, 128)
    assert bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(
        _np(got), _np(jatt.mha_reference(jq, jk, jv, causal=causal, sm_scale=sm_scale)),
        **FLASH_TOL_BF16)
    np.testing.assert_allclose(
        _np(got), _np(jatt.flash_attention(jq, jk, jv, causal=causal, sm_scale=sm_scale,
                                           force_pallas=True)), **FLASH_TOL_BF16)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    before = tatt.flash_attention.launches
    _, (tq, tk, tv) = _both(_qkv((2, 33, 2, 16), seed=4), "float32")
    for causal in (False, True):
        torch.testing.assert_close(
            tatt.flash_attention(tq, tk, tv, causal=causal),
            tatt.mha_reference(tq, tk, tv, causal=causal), rtol=0, atol=0)
    assert tatt.flash_attention.launches == before


def test_kernel_args_read_strided_views_in_place():
    """The three views of one fused [B, S, 3, H, D] product pass as they
    lie: their strides go to the kernel, no copy is made."""
    qkv = torch.zeros((2, 10, 3, 4, 32), dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    args = tatt.kernel_args(q, k, v)
    assert args[:5] == (2, 10, 4, 32, 1)
    assert args[5:] == (3840, 384, 32) * 3
    assert q.data_ptr() + 128 * 2 == k.data_ptr()


@pytest.mark.parametrize("bad, err", [
    (lambda q: (q.double(), q.double(), q.double()), TypeError),
    (lambda q: (q.int(), q.int(), q.int()), TypeError),
    (lambda q: (q, q, q.bfloat16()), TypeError),
    (lambda q: (q[0], q[0], q[0]), ValueError),
    (lambda q: (q, q, q[:, :5]), ValueError),
    (lambda q: (q[..., :8], q[..., :8], q[..., :8]), ValueError),
    (lambda q: (q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3)), ValueError),
])
def test_kernel_args_refuse_what_the_kernel_does_not_take(bad, err):
    q = torch.zeros((2, 6, 32, 32))
    with pytest.raises(err):
        tatt.kernel_args(*bad(q))


def _misaligned_base(dtype):
    """[2, 6, 4, 32] one element past a 16-byte boundary."""
    flat = torch.zeros(2 * 6 * 4 * 32 + 1, dtype=dtype)
    return flat[1:].view(2, 6, 4, 32)


def _stride(row: int, head: int):
    base = torch.zeros(2 * 6 * row, dtype=torch.bfloat16)
    return torch.as_strided(base, (2, 6, 4, 32), (6 * row, row, head, 1))


@pytest.mark.parametrize("make", [
    lambda: _misaligned_base(torch.bfloat16),   # base pointer 2 bytes off
    lambda: torch.zeros((2, 6, 4, 36), dtype=torch.bfloat16)[..., :32],  # head stride 36
    lambda: _stride(row=132, head=32),          # row stride 132
], ids=["base_not_16_byte_aligned", "head_stride_36", "row_stride_132"])
def test_kernel_args_refuse_what_the_bf16_copies_cannot_read(make):
    """The bf16 kernel copies 16-byte chunks: every base pointer 16-byte
    aligned, every (batch, row, head) stride a multiple of 8 elements."""
    q = make()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tatt.kernel_args(q, q, q)


def test_kernel_args_float32_takes_any_alignment():
    """The float32 kernel reads element by element: no alignment check."""
    q = _misaligned_base(torch.float32)
    assert q.data_ptr() % 16 != 0
    assert tatt.kernel_args(q, q, q)[:5] == (2, 6, 4, 32, 0)


def test_kernel_source_is_plain_c_for_sm90a():
    from sitewhere_tpu_torch import cuda_build

    src = (cuda_build.CSRC / "flash_attention.cu").read_text()
    assert 'extern "C" int swtpu_flash_attention(' in src
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert "torch/extension.h" not in src


@pytest.mark.parametrize("d, dp", [(1, 16), (8, 16), (16, 16), (17, 32), (48, 64),
                                   (64, 64), (100, 128), (128, 128)])
def test_padded_head_dim_is_the_next_instantiated_one(d, dp):
    assert tatt.padded_head_dim(d) == dp


def test_head_dims_past_the_largest_are_refused_with_the_limit():
    with pytest.raises(ValueError, match="up to 128"):
        tatt.padded_head_dim(129)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 48, 100])
def test_zero_padded_head_dim_at_the_true_scale_is_the_unpadded_attention(d, causal):
    """What the kernel wrappers do for a head dim between the instantiated
    ones, on the plain version: zero lanes up to ``padded_head_dim(d)``, the
    scale of the true D, the output and the gradients sliced back. Both
    equal the unpadded attention's (float32, the same products plus zeros)."""
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 70, 3, d)).astype(np.float32))
                   for _ in range(4))
    dp = tatt.padded_head_dim(d)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = tatt.mha_reference(*leaves, causal=causal)
    ref.backward(do)
    padded = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = tatt.mha_reference(*(tatt.pad_head_dim(t, dp) for t in padded), causal=causal,
                             sm_scale=1.0 / math.sqrt(d))
    assert got.shape[-1] == dp and not got[..., d:].any()
    got = got[..., :d]
    got.backward(do)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    for a, b in zip(padded, leaves):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)
    # the kernel pair's plain versions through the same pad give the same
    o, lse = (tatt.mha_reference(*(tatt.pad_head_dim(t, dp) for t in (q, k, v)),
                                 causal=causal, sm_scale=1.0 / math.sqrt(d)),
              tatt.lse_reference(q, k, causal=causal))
    grads = tatt.mha_backward_reference(
        *(tatt.pad_head_dim(t, dp) for t in (q, k, v)), o, tatt.pad_head_dim(do, dp), lse,
        causal=causal, sm_scale=1.0 / math.sqrt(d))
    for g, b in zip(grads, leaves):
        assert not g[..., d:].any()
        torch.testing.assert_close(g[..., :d], b.grad, rtol=1e-4, atol=1e-5)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a GPU")


GPU_CASES = [  # (B, S, H, D, dtype)
    (2, 1000, 8, 32, torch.bfloat16),    # ragged: S % 64 != 0
    (3, 1, 8, 32, torch.bfloat16),
    (2, 63, 4, 32, torch.bfloat16),      # one key tile, one row short
    (2, 65, 4, 32, torch.bfloat16),      # one key past a tile
    (2, 300, 2, 16, torch.bfloat16),
    (2, 777, 4, 64, torch.bfloat16),
    (2, 777, 4, 64, torch.float32),
    (2, 300, 2, 16, torch.float32),
    # head dims between the instantiated ones (padded) and D = 128
    (2, 300, 4, 8, torch.bfloat16),
    (2, 333, 4, 48, torch.bfloat16),
    (2, 777, 2, 128, torch.bfloat16),
    (2, 65, 2, 100, torch.bfloat16),
    (2, 300, 2, 128, torch.float32),
    (2, 129, 2, 48, torch.float32),
    # float16
    (2, 1000, 8, 32, torch.float16),
    (2, 300, 4, 8, torch.float16),
    (2, 333, 4, 48, torch.float16),
    (2, 777, 2, 128, torch.float16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", GPU_CASES)
def test_cuda_kernel_matches_plain_version(case, causal):
    _cuda_or_skip()
    b, s, h, d, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((b, s, 3, h, d), device="cuda", generator=gen).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]     # strided views
    before = tatt.flash_attention.launches
    got = tatt.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tatt.flash_attention.launches == before + 1
    assert got.is_contiguous() and got.dtype == dtype
    tol = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: FLASH_TOL_BF16,
           torch.float16: FLASH_TOL_F16}[dtype]
    torch.testing.assert_close(got, tatt.mha_reference(q, k, v, causal=causal), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("sm_scale", [0.0, -0.3])
def test_cuda_kernel_takes_any_sign_of_scale(sm_scale, dtype, causal):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn((2, 333, 3, 4, 32), device="cuda", generator=gen).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = tatt.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    tol = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: FLASH_TOL_BF16,
           torch.float16: FLASH_TOL_F16}[dtype]
    torch.testing.assert_close(
        got, tatt.mha_reference(q, k, v, causal=causal, sm_scale=sm_scale), **tol)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    _cuda_or_skip()
    q = torch.zeros((2, 8, 4, 32), device="cuda")
    with pytest.raises(TypeError):
        tatt.flash_attention(q.double(), q.double(), q.double())
    big = torch.zeros((2, 8, 4, 256), device="cuda")
    with pytest.raises(ValueError, match="up to 128"):
        tatt.flash_attention(big, big, big)


# ---------------------------------------------------------------- backward
#
# Gradient tolerances are relative to each gradient tensor's largest
# element ("of max"), since a gradient's small elements carry the absolute
# error of its large ones:
# * float32 plain backward / autograd against jax.vjp: 1e-5 of max (the
#   same float32 math in another order; measured <= 7e-7);
# * bfloat16 against jax.vjp: 1e-2 of max (both round the gradients to
#   bf16 once; the plain backward takes delta from the bf16-rounded output,
#   as the kernel does, where JAX's softmax transpose uses the float32
#   one: measured <= 6.4e-3);
# * the bf16 kernel's arithmetic (emulated below) against the plain
#   backward: GRAD_TOL_BF16 = 2e-2 of each row's largest element (one
#   position of one head; tatt.gradient_row_shares), the limit the card's
#   check holds the kernel to (measured <= 9.7e-3 a row for S up to 2048
#   and D = 16, 32, 64: one bf16 ulp of the row's largest element, up to
#   2**-7, and a little more from P and dS rounded to bf16 before their
#   products). A share of
#   the tensor's largest element would let a wrong causal tail pass: the
#   rows fall off along S. Against the float32 gradient (float32 output
#   o, where the kernel takes delta from the bf16 one) the same 2e-2 holds
#   of the tensor's largest element (measured <= 7.4e-3), not row by row:
#   the bf16 rounding of o moves delta, and rows where dP - delta cancels
#   move by up to 18 % of their own size;
# * the float32 kernel: GRAD_TOL_F32 = 1e-4 of each row's largest element
#   (float32 sums in another order, exp2f for exp);
# * on the card also GRAD_ATOL = 1e-5, only on the rows whose exact
#   gradient is 0 (every dq and dk row at S = 1, dq's row 0 under a causal
#   mask: o = v there), where both sides hold only float32 rounding of
#   dP - delta, which no share of a maximum bounds.
GRAD_F32 = 1e-5
GRAD_BF16_VS_JAX = 1e-2
GRAD_TOL_BF16 = 2e-2
GRAD_TOL_F32 = 1e-4
GRAD_ATOL = 1e-5
# * float16: GRAD_TOL_F16 = 2.5e-3 of each row's largest element, after
#   F16_STEP (float16's subnormal step, 2**-24) off each row's error: the
#   float16 kernels' arithmetic (emulated below: P^T and dS^T a row scaled
#   by a power of two, then rounded to float16) reads <= 1.05e-3 up to S =
#   4096, one float16 ulp of the row's largest element and a little more;
#   with P and dS rounded to bf16 instead it reads >= 3.3e-3 on every
#   gradient. A row whose gradient lies below float16's normal range
#   (2**-14; late keys at long S) holds its values to 2**-24 absolute, so
#   two roundings of one value can differ there by a step that no share
#   of the row bounds: the step comes off, and nothing else.
GRAD_TOL_F16 = 2.5e-3
F16_STEP = 2.0 ** -24
LSE_TOL = dict(rtol=1e-6, atol=1e-6)


def assert_close_of_max(got, ref, tol: float, what: str = "", atol: float = 0.0) -> None:
    """|got - ref| <= tol * max|ref| + atol elementwise (float32 comparison)."""
    got = got.float() if isinstance(got, torch.Tensor) else torch.from_numpy(np.array(got, np.float32))
    ref = ref.float() if isinstance(ref, torch.Tensor) else torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    assert err <= tol * scale + atol, f"{what}: max abs err {err} > {tol} of max {scale} + {atol}"


def assert_rows_close_of_max(got, ref, tol: float, which: str, *, causal: bool,
                             atol: float = 0.0, step: float = 0.0) -> None:
    """Each row of a [B, S, H, D] gradient within ``tol`` of that row's
    largest |ref| element (``atol`` off on its exact-zero rows, ``step``
    off every row)."""
    assert got.shape == ref.shape, (which, got.shape, ref.shape)
    shares = tatt.gradient_row_shares(got, ref, which, causal=causal, atol=atol,
                                      step=step)
    worst = float(shares.max()) if shares.numel() else 0.0
    assert worst <= tol, f"{which}: worst row err {worst} of its row's max > {tol}"


def _jax_grads(arrays, dtype, causal, sm_scale):
    jdt = DTYPES[dtype][0]
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jatt.mha_reference(q, k, v, causal=causal,
                                                        sm_scale=sm_scale), jq, jk, jv)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]


@pytest.mark.parametrize("sm_scale", [None, 0.37])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_jax_vjp(causal, dtype, sm_scale):
    arrays = _qkv((2, 96, 3, 32), seed=11) + _qkv((2, 96, 3, 32), seed=12)[:1]
    ref = _jax_grads(arrays, dtype, causal, sm_scale)
    tdt = DTYPES[dtype][1]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in arrays)
    o = tatt.mha_reference(tq, tk, tv, causal=causal, sm_scale=sm_scale)
    lse = tatt.lse_reference(tq, tk, causal=causal, sm_scale=sm_scale)
    plain = tatt.mha_backward_reference(tq, tk, tv, o, tdo, lse, causal=causal,
                                        sm_scale=sm_scale)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(tatt.flash_attention(*leaves, causal=causal,
                                                    sm_scale=sm_scale), leaves, tdo)
    tol = GRAD_F32 if dtype == "float32" else GRAD_BF16_VS_JAX
    for name, p, a, r in zip("qkv", plain, auto, ref):
        assert p.dtype == tdt and a.dtype == tdt
        assert_close_of_max(p, r, tol, f"plain d{name}")
        assert_close_of_max(a, r, tol, f"autograd d{name}")


@pytest.mark.parametrize("sm_scale", [None, 0.37, -0.3])
@pytest.mark.parametrize("causal", [False, True])
def test_lse_reference_matches_jax_logsumexp(causal, sm_scale):
    q, k, _ = _qkv((2, 80, 3, 16), seed=13)
    scale = sm_scale if sm_scale is not None else 16 ** -0.5
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), jnp.asarray(k)) * scale
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((80, 80), bool)), s, jatt._NEG_INF)
    ref = np.asarray(jax.nn.logsumexp(s, axis=-1))
    got = tatt.lse_reference(torch.from_numpy(q), torch.from_numpy(k), causal=causal,
                             sm_scale=sm_scale)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 80)
    np.testing.assert_allclose(got.numpy(), ref, **LSE_TOL)


def round_rows(x: torch.Tensor, low: torch.dtype, dim: int) -> torch.Tensor:
    """``x`` (float32) rounded to ``low`` and back. For float16 each row
    (``dim`` is the axis reduced over) is first scaled by the power of two
    that puts its largest |entry| in [2^14, 2^15), as the float16 kernels'
    ``RowScale`` does (exact in float32): float16's 5 exponent bits would
    lose a long row's small entries otherwise. bfloat16 keeps float32's
    range and takes no scale."""
    if low != torch.float16:
        return x.to(low).float()
    top = x.abs().amax(dim, keepdim=True)
    e = (14 - torch.floor(torch.log2(top.clamp_min(2.0 ** -126)))).clamp(max=126)
    f = torch.where(top > 0, torch.exp2(e), 1.0)
    return (x * f).to(low).float() / f


def emulate_bf16_backward(q, k, v, o, do, lse, *, causal: bool,
                          sm_scale: float | None = None, q_tile: int = 64,
                          key_block: int = 128, key_part: int = 64,
                          low: torch.dtype = torch.bfloat16):
    """The arithmetic of the bf16 backward kernel, on the CPU: delta =
    rowsum(dO o) in float32 from the bf16 output; float32 scores of the
    bf16 inputs (exact products summed in float32); P = exp2(s·c − lse·log2
    e) with c = sm_scale·log2(e), masked entries 0; dS = P (dP − delta) in
    float32; P rounded to bf16 before the dV product and dS rounded to bf16
    before the dK and dQ products. dV and dK accumulate in float32 over
    64-row query tiles. dQ: each key block of 128 keys sums its two
    64-key parts (one a compute warpgroup) in float32 (at D = 128 one part
    of 128 keys, ``key_part=128``: a warpgroup's columns of dQ over the
    whole block in one product), and the blocks' sums
    are added in float32 in key-block order; dq, dk and dv are rounded to
    q's type once. ``low`` is the type P and dS are rounded to: float16
    for the float16 kernel (``round_rows``: each key's row of P^T and dS^T
    scaled first, as ``RowScale`` does; for dQ each query's row of dS
    scaled by the fixed 2^e_i of ``tatt.f16_dq_scale_exponents``, which
    the float32 sum keeps and the end takes off), or bf16 under float16
    inputs as a control."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    c = scale * math.log2(math.e)
    qf, kf, vf, of, dof = (t.float().transpose(1, 2) for t in (q, k, v, o, do))
    s = q.shape[1]
    delta = (dof * of).sum(-1)
    p = torch.exp2((qf @ kf.transpose(-1, -2)) * c
                   - (lse.float() * math.log2(math.e))[..., None])
    if causal:
        p = p.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    pb, dsb = round_rows(p, low, -2), round_rows(ds, low, -2)
    if low == torch.float16:
        f = torch.exp2(tatt.f16_dq_scale_exponents(o, do, v).float())[..., None]
        dsq = (ds * f).to(low).float() / f
    else:
        dsq = ds.to(low).float()
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    for t0 in range(0, s, q_tile):
        sl = slice(t0, t0 + q_tile)
        dk += dsb[:, :, sl].transpose(-1, -2) @ qf[:, :, sl]
        dv += pb[:, :, sl].transpose(-1, -2) @ dof[:, :, sl]
    for k0 in range(0, s, key_block):
        block = torch.zeros_like(qf)
        for p0 in range(k0, min(k0 + key_block, s), key_part):
            sl = slice(p0, p0 + key_part)
            block += dsq[..., sl] @ kf[:, :, sl]
        dq += block
    return tuple((g * m).transpose(1, 2).to(q.dtype)
                 for g, m in ((dq, scale), (dk, scale), (dv, 1.0)))


def _bf16_case(s, d, seed, causal, sm_scale=None):
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _qkv((2, s, 2, d), seed=seed) + _qkv((2, s, 2, d), seed=seed + 1)[:1])
    o = tatt.mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    lse = tatt.lse_reference(q, k, causal=causal, sm_scale=sm_scale)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 63, 65, 200])
def test_bf16_backward_arithmetic_fits_the_tolerance(s, d, causal):
    """The backward kernel's bf16 P and dS stay within GRAD_TOL_BF16 of the
    float32 gradient (of the same bf16 inputs, exact output) and, row by
    row, of the plain backward of the bf16 tensors."""
    q, k, v, o, do, lse = _bf16_case(s, d, 20 + s + d, causal)
    got = emulate_bf16_backward(q, k, v, o, do, lse, causal=causal)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    exact = tatt.mha_backward_reference(
        qf, kf, vf, tatt.mha_reference(qf, kf, vf, causal=causal), dof, lse, causal=causal)
    plain = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=causal)
    for name, g, e, p in zip("qkv", got, exact, plain):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        assert_close_of_max(g, e, GRAD_TOL_BF16, f"d{name} vs float32")
        assert_rows_close_of_max(g, p, GRAD_TOL_BF16, f"d{name}", causal=causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sm_scale", [0.0, -0.3])
def test_bf16_backward_arithmetic_takes_any_sign_of_scale(sm_scale, causal):
    """The backward needs no running max, so the scale enters exp2 as it
    is: zero gives P = 1/l (and dq = dk = 0), a negative one the gradient
    of the smallest scores' weights."""
    q, k, v, o, do, lse = _bf16_case(130, 32, 40, causal, sm_scale)
    got = emulate_bf16_backward(q, k, v, o, do, lse, causal=causal, sm_scale=sm_scale)
    plain = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=causal,
                                        sm_scale=sm_scale)
    for name, g, p in zip("qkv", got, plain):
        assert bool(torch.isfinite(g.float()).all())
        if sm_scale == 0.0 and name != "v":
            assert not g.float().any() and not p.float().any()
        else:
            assert_rows_close_of_max(g, p, GRAD_TOL_BF16, f"d{name}", causal=causal)


@pytest.mark.parametrize("sm_scale", [None, 0.0, -0.3])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 65, 300])
def test_bf16_wgmma_backward_arithmetic_at_d128_holds_to_jax_grad(s, causal, sm_scale):
    """The D = 128 backward on wgmma (``flash_bwd_wgmma_kernel<bf16, 128>``):
    64-row query tiles, 128-key blocks whose dQ sums all 128 keys in one
    product (each compute warpgroup takes 64 of dQ's columns over the whole
    block: ``key_part`` 128), P and dS rounded to bf16. Every row of dq, dk
    and dv stays within GRAD_TOL_BF16 of ``jax.vjp`` of JAX's oracle on the
    same bf16 values (measured <= 6.9e-3). The output gradient's delta is
    taken from the float32 output on both sides, so what is measured is the
    kernel's own rounding."""
    arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
              for a in _qkv((2, s, 2, 128), seed=90 + s) + _qkv((2, s, 2, 128), seed=91 + s)[:1]]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    out, vjp = jax.vjp(lambda q, k, v: jatt.mha_reference(q, k, v, causal=causal,
                                                        sm_scale=sm_scale), jq, jk, jv)
    ref = [torch.from_numpy(np.array(g)) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in arrays)
    o = torch.from_numpy(np.array(out))
    lse = tatt.lse_reference(tq.float(), tk.float(), causal=causal, sm_scale=sm_scale)
    got = emulate_bf16_backward(tq, tk, tv, o, tdo, lse, causal=causal, sm_scale=sm_scale,
                                q_tile=64, key_block=128, key_part=128)
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == (2, s, 2, 128)
        assert bool(torch.isfinite(g.float()).all())
        if sm_scale == 0.0 and name != "v":
            assert not g.float().any() and not r.any()
        else:
            assert_rows_close_of_max(g, r, GRAD_TOL_BF16, f"d{name}", causal=causal,
                                     atol=GRAD_ATOL)


F16_CASES = [  # (S, D, causal, sm_scale)
    (63, 16, True, None), (65, 32, False, None), (200, 8, True, None),
    (333, 48, True, None), (333, 48, False, None), (300, 128, True, None),
    (333, 32, True, -0.3), (1000, 32, True, None), (2048, 32, True, None)]


def _f16_case(s, d, causal, sm_scale):
    q, k, v, do = (torch.from_numpy(a).half()
                   for a in _qkv((2, s, 2, d), seed=70 + s + d) + _qkv((2, s, 2, d),
                                                                     seed=71 + s + d)[:1])
    o = tatt.mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    lse = tatt.lse_reference(q, k, causal=causal, sm_scale=sm_scale)
    return q, k, v, o, do, lse


def _allclose_share(got, ref) -> float:
    """The least x for which allclose(got, ref, rtol=x, atol=x) holds."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() / (1 + r.abs())).max())


@pytest.mark.parametrize("case", F16_CASES)
def test_f16_kernel_arithmetic_fits_the_tolerance(case):
    """The float16 forward's arithmetic (P rounded to float16) stays within
    FLASH_TOL_F16 of the plain version; rounded to bf16 instead it fails
    that limit under a causal mask, where a row's first keys carry their
    whole weight (at full attention over hundreds of keys the rounding of
    P averages out below the output's own float16 ulp)."""
    s, d, causal, sm_scale = case
    q, k, v, o, _, _ = _f16_case(s, d, causal, sm_scale)
    # 128-key tiles on the wgmma kernel at D = 128, 64 on mma.sync below
    block_k = 128 if d > 64 else 64
    got = emulate_bf16_kernel(q, k, v, causal=causal, sm_scale=sm_scale, low=torch.float16,
                              block_k=block_k)
    assert got.dtype == torch.float16
    torch.testing.assert_close(got, o, **FLASH_TOL_F16)
    control = emulate_bf16_kernel(q, k, v, causal=causal, sm_scale=sm_scale, block_k=block_k)
    assert control.dtype == torch.float16
    if causal:
        assert _allclose_share(control, o) > FLASH_TOL_F16["rtol"]


@pytest.mark.parametrize("case", F16_CASES)
def test_f16_backward_arithmetic_fits_the_tolerance(case):
    """The float16 backward's arithmetic (a key's row of P^T and dS^T
    scaled by its RowScale, a query's row of dS by its fixed 2^e_i, then
    rounded to float16) holds every row within GRAD_TOL_F16 of the plain
    backward, the float16 step off; rounded to bf16 instead, every
    gradient fails it."""
    s, d, causal, sm_scale = case
    q, k, v, o, do, lse = _f16_case(s, d, causal, sm_scale)
    plain = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=causal, sm_scale=sm_scale)
    key_part = 128 if d > 64 else 64
    got = emulate_bf16_backward(q, k, v, o, do, lse, causal=causal, sm_scale=sm_scale,
                                low=torch.float16, key_part=key_part)
    control = emulate_bf16_backward(q, k, v, o, do, lse, causal=causal, sm_scale=sm_scale,
                                    key_part=key_part)
    for name, g, c, p in zip("qkv", got, control, plain):
        assert g.dtype == c.dtype == torch.float16
        assert_rows_close_of_max(g, p, GRAD_TOL_F16, f"d{name}", causal=causal,
                                 atol=GRAD_ATOL, step=F16_STEP)
        with pytest.raises(AssertionError, match="worst row err"):
            assert_rows_close_of_max(c, p, GRAD_TOL_F16, f"d{name}", causal=causal,
                                     atol=GRAD_ATOL, step=F16_STEP)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 200])
def test_f16_one_pass_backward_arithmetic_fits_the_tolerance(s, d, causal):
    """The float16 arithmetic of the one-pass kernel
    (``flash_bwd_wgmma_kernel<__half, D>``): 64-row query tiles, 128-key
    blocks whose dQ sums two 64-key parts (one part of 128 at D = 128), a
    key's rows of P^T and dS^T scaled by its RowScale for dV and dK, a
    query's row of dS by the fixed 2^e_i of ``f16_dq_scale_exponents`` for
    dQ. Every row stays within GRAD_TOL_F16 of the plain backward after
    the float16 step (measured <= 1.05e-3 up to S = 4096); the same
    arithmetic rounded to bf16 fails the limit wherever anything is
    rounded (at S = 1 P is 1 and dq = dk = 0: the control has nothing to
    round there)."""
    q, k, v, o, do, lse = _f16_case(s, d, causal, None)
    plain = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=causal)
    key_part = 128 if d > 64 else 64
    got = emulate_bf16_backward(q, k, v, o, do, lse, causal=causal, low=torch.float16,
                                key_part=key_part)
    control = emulate_bf16_backward(q, k, v, o, do, lse, causal=causal, key_part=key_part)
    for name, g, c, p in zip("qkv", got, control, plain):
        assert g.dtype == torch.float16 and g.shape == q.shape
        assert bool(torch.isfinite(g.float()).all())
        assert_rows_close_of_max(g, p, GRAD_TOL_F16, f"d{name}", causal=causal,
                                 atol=GRAD_ATOL, step=F16_STEP)
        if s > 1:
            with pytest.raises(AssertionError, match="worst row err"):
                assert_rows_close_of_max(c, p, GRAD_TOL_F16, f"d{name}", causal=causal,
                                         atol=GRAD_ATOL, step=F16_STEP)


def _max_ds(q, k, v, o, do, lse, causal, sm_scale=None) -> torch.Tensor:
    """max_j |dS_ij| [B, H, S] in float32: dS = P (dO v^T - delta), P from
    the scores and ``lse``, delta = rowsum(dO o)."""
    p = tatt._scores(q, k, causal, sm_scale).sub_(lse.float()[..., None]).exp_()
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, v.float()).sub_(delta[..., None]).mul_(p)
    return ds.abs().amax(-1)


def _check_dq_scale(q, k, v, o, do, lse, causal) -> None:
    """The kernel's guarantee and its tightness: max_j |dS_ij| 2^e_i below
    2^F16_DQ_TOP (the bound is never below the largest entry; then below
    2^15, where float16 still has room) and e_i the largest exponent the
    bound allows (the bound times 2^(e_i + 1) reaches 2^F16_DQ_TOP, unless
    e_i is at its cap of 126 or the bound is 0)."""
    e = tatt.f16_dq_scale_exponents(o, do, v)
    assert e.dtype == torch.int32 and e.shape == lse.shape
    f = torch.exp2(e.double())
    top = _max_ds(q, k, v, o, do, lse, causal).double()
    assert bool((top * f < 2.0 ** tatt.F16_DQ_TOP).all())
    assert bool((top * f < 2.0 ** 15).all())
    bound = (do.double().norm(dim=-1) * (v.double().norm(dim=-1).amax(1, keepdim=True)
                                         + o.double().norm(dim=-1))).transpose(1, 2)
    loose = (bound * f * 2 < 2.0 ** tatt.F16_DQ_TOP * (1 - 1e-6)) & (e < 126) & (bound > 0)
    assert not bool(loose.any())
    assert bool((e[bound == 0] == 0).all())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s, d", [(1, 32), (63, 16), (200, 64), (300, 128)])
def test_f16_dq_scale_exponents_bound_ds(s, d, causal):
    """``f16_dq_scale_exponents`` (the prep pass's rule) against a float32
    computation of max_j |dS_ij| on the float16 cases' inputs."""
    _check_dq_scale(*_f16_case(s, d, causal, None), causal)


@settings(max_examples=40, deadline=None)
@given(s=st.sampled_from([1, 2, 17, 64]), d=st.sampled_from([16, 32]), causal=st.booleans(),
       mag_do=st.integers(-20, 10), mag_v=st.integers(-20, 10), mag_qk=st.integers(-4, 2),
       seed=st.integers(0, 2**16))
def test_f16_dq_scale_exponents_hold_at_any_magnitude(s, d, causal, mag_do, mag_v, mag_qk, seed):
    """The same guarantee over output gradients and values of magnitude
    2^-20 (float16's subnormals, many entries lost) to 2^10, scores sharp
    or flat, S = 1 and causal rows among them."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, s, 2, d)).astype(np.float32)
                                    * 2.0 ** m).half()
                   for m in (mag_qk, mag_qk, mag_v, mag_do))
    o = tatt.mha_reference(q, k, v, causal=causal)
    lse = tatt.lse_reference(q, k, causal=causal)
    _check_dq_scale(q, k, v, o, do, lse, causal)


def test_f16_rows_below_the_normal_range_need_the_step():
    """With a small output gradient (an unscaled loss's: dO at 2**-12) the
    gradients lie below float16's normal range, where the float16
    arithmetic misses the row limit without the step, and by no more than
    one subnormal step on any row: the step is what float16 cannot hold,
    not slack."""
    q, k, v, o, do, lse = _f16_case(333, 32, True, None)
    do = (do.float() * 2.0 ** -12).half()
    plain = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=True)
    got = emulate_bf16_backward(q, k, v, o, do, lse, causal=True, low=torch.float16)
    for w, g, p in zip(("dq", "dk", "dv"), got, plain):
        shares = tatt.gradient_row_shares(g, p, w, causal=True, atol=GRAD_ATOL)
        bad = shares > GRAD_TOL_F16
        assert bool(bad.any()), w
        top = p.float().abs().amax(-1)
        assert bool((top[bad] < 2.0 ** -14).all()), w
        err = (g.float() - p.float()).abs().amax(-1)
        assert bool((err <= GRAD_TOL_F16 * top + F16_STEP).all()), w
        assert_rows_close_of_max(g, p, GRAD_TOL_F16, w, causal=True, atol=GRAD_ATOL,
                                 step=F16_STEP)


def test_row_shares_take_the_step_off_every_row():
    """``step`` comes off each row's error, on every row alike."""
    ref = torch.full((1, 3, 1, 4), 1e-6)
    got = ref + torch.tensor([0.5, 1.0, 2.0]).view(1, 3, 1, 1) * F16_STEP
    shares = tatt.gradient_row_shares(got, ref, "dv", causal=True, atol=GRAD_ATOL,
                                      step=F16_STEP)
    assert shares[0, :2, 0].tolist() == [0.0, 0.0]
    assert float(shares[0, 2, 0]) == pytest.approx(F16_STEP / 1e-6, rel=1e-3)


def _causal_grads(s: int = 1024) -> dict:
    q, k, v, o, do, lse = _bf16_case(s, 32, 60, True)
    return dict(zip(("dq", "dk", "dv"),
                    tatt.mha_backward_reference(q, k, v, o, do, lse, causal=True)))


@pytest.mark.parametrize("which", ["dq", "dk", "dv"])
def test_row_shares_fail_a_zeroed_causal_tail(which):
    """A gradient whose second half along S is zeroed fails the row measure
    the card holds the kernel to, on every zeroed row and no other."""
    ref = _causal_grads()[which]
    bad = ref.clone()
    bad[:, 512:] = 0
    shares = tatt.gradient_row_shares(bad, ref, which, causal=True, atol=GRAD_ATOL)
    assert float(shares[:, :512].max()) == 0.0
    assert bool((shares[:, 512:] == 1.0).all())
    with pytest.raises(AssertionError, match="worst row err"):
        assert_rows_close_of_max(bad, ref, GRAD_TOL_BF16, which, causal=True, atol=GRAD_ATOL)


@pytest.mark.parametrize("which", ["dk", "dv"])
def test_row_shares_see_rows_the_tensor_max_cannot(which):
    """Under a causal mask dk and dv fall off along S: at S = 1024 most rows
    of the second half lie below GRAD_TOL_BF16 of the tensor's largest
    element, so zeroing them passes a share of that element and fails the
    row measure."""
    ref = _causal_grads()[which]
    top = ref.float().abs().amax(-1)
    small = top < GRAD_TOL_BF16 * float(top.max())
    assert float(small[:, 512:].float().mean()) > 0.4
    bad = ref.masked_fill(small[..., None], 0)
    assert_close_of_max(bad, ref, GRAD_TOL_BF16, which)
    with pytest.raises(AssertionError, match="worst row err"):
        assert_rows_close_of_max(bad, ref, GRAD_TOL_BF16, which, causal=True, atol=GRAD_ATOL)


def test_row_shares_take_atol_only_on_exact_zero_rows():
    """GRAD_ATOL comes off every dq and dk row at S = 1 and dq's row 0
    under a causal mask, and nowhere else."""
    ref = torch.ones((1, 3, 1, 4))
    got = ref + 0.5 * GRAD_ATOL
    for which, causal, zero_rows in (("dq", True, [0]), ("dq", False, []),
                                     ("dk", True, []), ("dv", True, [])):
        shares = tatt.gradient_row_shares(got, ref, which, causal=causal, atol=GRAD_ATOL)
        assert [i for i in range(3) if shares[0, i, 0] == 0.0] == zero_rows, (which, causal)
    for which, zero in (("dq", True), ("dk", True), ("dv", False)):
        shares = tatt.gradient_row_shares(got[:, :1], ref[:, :1], which, causal=False,
                                          atol=GRAD_ATOL)
        assert (float(shares.max()) == 0.0) == zero, which
    assert float(tatt.gradient_row_shares(torch.full((1, 2, 1, 4), 1e-3), torch.zeros(
        (1, 2, 1, 4)), "dv", causal=True, atol=GRAD_ATOL).min()) == math.inf


def test_cpu_backward_takes_plain_version_and_counts_no_launch():
    before = (tatt.flash_attention.launches, tatt.flash_attention_backward.launches)
    q, k, v, o, do, lse = _bf16_case(33, 16, 50, True)
    out, lse2 = tatt.flash_attention_forward(q, k, v, causal=True)
    torch.testing.assert_close(out, o, rtol=0, atol=0)
    torch.testing.assert_close(lse2, lse, rtol=0, atol=0)
    got = tatt.flash_attention_backward(q, k, v, o, do, lse, causal=True)
    ref = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=True)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert (tatt.flash_attention.launches,
            tatt.flash_attention_backward.launches) == before


def test_cpu_grad_goes_through_autograd_of_the_plain_version():
    """On the CPU a ``requires_grad`` input takes ``mha_reference`` (its
    autograd graph, no Function); on a CUDA one the Function."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv((1, 9, 2, 16), seed=14))
    out = tatt.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    assert "FlashAttentionFunction" not in type(out.grad_fn).__name__


@pytest.mark.parametrize("bad, match", [
    (lambda q, o, lse: dict(o=o[:, :5]), "o must be"),
    (lambda q, o, lse: dict(o=o.float()), "o must be"),
    (lambda q, o, lse: dict(o=o.transpose(1, 2).contiguous().transpose(1, 2)), "contiguous"),
    (lambda q, o, lse: dict(do=o[..., :16]), "do must be"),
    (lambda q, o, lse: dict(lse=lse.double()), "lse must be"),
    (lambda q, o, lse: dict(lse=lse[:, :, :5]), "lse must be"),
    (lambda q, o, lse: dict(lse=lse.transpose(1, 2).contiguous().transpose(1, 2)), "lse must be"),
])
def test_backward_args_refuse_what_the_kernel_does_not_take(bad, match):
    q = torch.zeros((2, 6, 4, 32), dtype=torch.bfloat16)
    o = torch.zeros_like(q)
    lse = torch.zeros((2, 4, 6))
    kw = dict(o=o, do=o, lse=lse) | bad(q, o, lse)
    with pytest.raises(ValueError, match=match):
        tatt.backward_args(q, q, q, kw["o"], kw["do"], kw["lse"])


def test_backward_args_copy_a_strided_or_misaligned_do():
    q = torch.zeros((2, 6, 4, 32), dtype=torch.bfloat16)
    lse = torch.zeros((2, 4, 6))
    do = torch.zeros((2, 6, 4, 64), dtype=torch.bfloat16)[..., :32]
    _, got = tatt.backward_args(q, q, q, q.clone(), do, lse)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    flat = torch.zeros(2 * 6 * 4 * 32 + 1, dtype=torch.bfloat16)
    _, got = tatt.backward_args(q, q, q, q.clone(), flat[1:].view(2, 6, 4, 32), lse)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0


def _translation_unit(name: str) -> str:
    """``csrc/<name>.cu`` and every ``csrc/*.cuh`` it includes, directly or
    through another header: what nvcc compiles for it."""
    import re

    from sitewhere_tpu_torch import cuda_build

    seen, text, todo = set(), [], [f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        body = (cuda_build.CSRC / f).read_text()
        text.append(body)
        todo += re.findall(r'#include "([^"]+\.cuh)"', body)
    return "\n".join(text)


def test_backward_kernel_source_is_plain_c_for_sm90a():
    from sitewhere_tpu_torch import cuda_build

    src = _translation_unit("flash_attention_bwd")
    assert 'extern "C" int swtpu_flash_attention_bwd(' in src
    assert '#include "flash_common.cuh"' in src
    assert "torch/extension.h" not in src
    # both 16-bit types at every instantiated head dim take one pass on
    # Hopper's wgmma and TMA (takes_wgmma decides; no mma.sync backward is
    # left), and no atomic add decides an order (the bitwise check is on
    # the card: test_cuda_backward_kernel_is_bitwise_deterministic)
    assert "wgmma.mma_async" in src and "cp.async.bulk.tensor" in src
    assert ("bool takes_wgmma(int dtype, int d) { return (dtype == 1 || dtype == 2) && d <= 128; }"
            in src)
    assert "mma_bf16(" not in src and "CU_TENSOR_MAP_DATA_TYPE_FLOAT16" in src
    assert "mma_16816" not in (cuda_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "atomicAdd" not in src and "red.global.add" not in src
    assert 'extern "C" int64_t swtpu_flash_attention_bwd_scratch_bytes(' in src
    fwd = (cuda_build.CSRC / "flash_attention.cu").read_text()
    assert "float* lse" in fwd


def test_forward_kernel_source_takes_wgmma_and_tma_at_d128():
    """Both 16-bit types at D = 128 take the warp-specialised forward on
    wgmma and TMA (the tensor maps and the wrappers shared with the
    backward)."""
    src = _translation_unit("flash_attention")
    assert "wgmma.mma_async" in src and "cp.async.bulk.tensor" in src
    assert "flash_attention_wgmma_kernel" in src
    assert "if constexpr (sizeof(T) == 2 && D == 128)" in src
    assert "atomicAdd" not in src and "torch/extension.h" not in src


def test_kernel_library_name_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header renames (so rebuilds) every kernel."""
    from sitewhere_tpu_torch import cuda_build

    for name in ("flash_attention", "flash_attention_bwd"):
        (tmp_path / f"{name}.cu").write_text("// src\n")
    (tmp_path / "flash_common.cuh").write_text("// a\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = [cuda_build._lib_path(n) for n in ("flash_attention", "flash_attention_bwd")]
    (tmp_path / "flash_common.cuh").write_text("// b\n")
    after = [cuda_build._lib_path(n) for n in ("flash_attention", "flash_attention_bwd")]
    assert all(a != b for a, b in zip(before, after))


def _grad_tol(dtype) -> tuple[float, float]:
    """(row share, step off each row) the card holds a gradient of ``dtype`` to."""
    return {torch.float32: (GRAD_TOL_F32, 0.0), torch.bfloat16: (GRAD_TOL_BF16, 0.0),
            torch.float16: (GRAD_TOL_F16, F16_STEP)}[dtype]


BWD_GPU_CASES = [  # (B, S, H, D, dtype)
    (2, 1000, 8, 32, torch.bfloat16),    # ragged: S % 64 != 0
    (3, 1, 8, 32, torch.bfloat16),
    (2, 63, 4, 32, torch.bfloat16),
    (2, 65, 4, 32, torch.bfloat16),
    (2, 129, 4, 32, torch.bfloat16),
    (2, 300, 2, 16, torch.bfloat16),
    (2, 777, 4, 64, torch.bfloat16),
    (2, 777, 4, 64, torch.float32),
    (2, 300, 2, 16, torch.float32),
    (2, 1000, 8, 32, torch.float32),
    # head dims between the instantiated ones (padded) and D = 128
    (2, 300, 4, 8, torch.bfloat16),
    (2, 333, 4, 48, torch.bfloat16),
    (2, 777, 2, 128, torch.bfloat16),
    (2, 65, 2, 100, torch.bfloat16),
    (2, 300, 2, 128, torch.float32),
    (2, 129, 2, 48, torch.float32),
    # float16 (the one-pass wgmma kernel at every head dim, its rows of P^T
    # and dS^T and of dS scaled); at S = 4096 many P and dS entries of a
    # row lie below float16's normal range
    (1, 4096, 2, 32, torch.float16),
    (1, 2048, 2, 128, torch.bfloat16),
    (2, 1000, 8, 32, torch.float16),
    (2, 63, 4, 16, torch.float16),
    (2, 300, 4, 8, torch.float16),
    (2, 333, 4, 48, torch.float16),
    (2, 777, 2, 128, torch.float16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", BWD_GPU_CASES)
def test_cuda_backward_kernel_matches_plain_version(case, causal):
    _cuda_or_skip()
    b, s, h, d, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn((b, s, 3, h, d), device="cuda", generator=gen).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]     # strided views
    do = torch.randn((b, s, h, d), device="cuda", generator=gen).to(dtype)
    before = (tatt.flash_attention.launches, tatt.flash_attention_backward.launches)
    o, lse = tatt.flash_attention_forward(q, k, v, causal=causal)
    got = tatt.flash_attention_backward(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert (tatt.flash_attention.launches,
            tatt.flash_attention_backward.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(lse, tatt.lse_reference(q, k, causal=causal),
                               rtol=1e-4, atol=1e-4)
    ref = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=causal)
    tol, step = _grad_tol(dtype)
    for name, g, r in zip("qkv", got, ref):
        assert g.is_contiguous() and g.dtype == dtype and g.shape == (b, s, h, d)
        assert bool(torch.isfinite(g.float()).all())
        assert_rows_close_of_max(g, r, tol, f"d{name}", causal=causal, atol=GRAD_ATOL,
                                 step=step)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", [c for c in BWD_GPU_CASES if c[4] != torch.float32])
def test_cuda_backward_kernel_is_bitwise_deterministic(case, causal):
    """dQ is summed across key blocks in a fixed order (a turn counter per
    query tile; in float16 in units of each query's fixed 2^e_i), dK and dV
    by one warpgroup each (the wgmma kernel, both 16-bit types at every
    D): two calls on the same inputs give the same bits."""
    _cuda_or_skip()
    b, s, h, d, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn((b, s, 3, h, d), device="cuda", generator=gen).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((b, s, h, d), device="cuda", generator=gen).to(dtype)
    o, lse = tatt.flash_attention_forward(q, k, v, causal=causal)
    first = tatt.flash_attention_backward(q, k, v, o, do, lse, causal=causal)
    second = tatt.flash_attention_backward(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    for name, x, y in zip("qkv", first, second):
        assert torch.equal(x, y), f"d{name} differs between two calls"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("sm_scale", [0.0, -0.3])
def test_cuda_backward_kernel_takes_any_sign_of_scale(sm_scale, dtype):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn((2, 333, 3, 4, 32), device="cuda", generator=gen).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((2, 333, 4, 32), device="cuda", generator=gen).to(dtype)
    o, lse = tatt.flash_attention_forward(q, k, v, causal=True, sm_scale=sm_scale)
    got = tatt.flash_attention_backward(q, k, v, o, do, lse, causal=True, sm_scale=sm_scale)
    ref = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=True, sm_scale=sm_scale)
    tol, step = _grad_tol(dtype)
    for name, g, r in zip("qkv", got, ref):
        if sm_scale == 0.0 and name != "v":
            assert not g.float().any()
        else:
            assert_rows_close_of_max(g, r, tol, f"d{name}", causal=True, atol=GRAD_ATOL,
                                     step=step)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_f16_takes_the_one_pass_backward(d):
    """float16 runs the one-pass wgmma/TMA backward at every head dim
    (``flash_bwd_wgmma_kernel<__half, D>``, after its norm and prep passes)
    and, at D = 128, the wgmma/TMA forward, by the profiler's kernel names;
    no mma.sync backward kernel runs."""
    _cuda_or_skip()
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(6)
    qkv = torch.randn((1, 300, 3, 2, d), device="cuda", generator=gen).half()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((1, 300, 2, d), device="cuda", generator=gen).half()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        o, lse = tatt.flash_attention_forward(q, k, v, causal=True)
        tatt.flash_attention_backward(q, k, v, o, do, lse, causal=True)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    fwd = "flash_attention_wgmma_kernel" if d == 128 else "flash_attention_bf16_kernel"
    for kernel in (fwd, "flash_bwd_vnorm_kernel", "flash_bwd_prep_kernel",
                   "flash_bwd_wgmma_kernel", "flash_bwd_dq_kernel"):
        assert any(kernel in n and (kernel == "flash_bwd_vnorm_kernel" or "__half" in n)
                   for n in names), (kernel, names)
    assert not any("_mma_kernel" in n for n in names), names


@pytest.mark.gpu
def test_cuda_grad_reaches_the_fused_qkv_weights():
    """The regression test of the silent fault: on the card the attention's
    output has a ``grad_fn`` (the Function), its backward runs the kernel
    once a layer, and every ``blocks.*.qkv`` parameter gets a finite,
    non-zero gradient, within GRAD_TOL_BF16 of the plain attention's."""
    _cuda_or_skip()
    from sitewhere_tpu_torch.models import transformer as ttf

    cfg = ttf.TransformerConfig(sensors=8, d_model=64, heads=2, layers=2, mlp=128)
    model = ttf.TelemetryTransformer(cfg, device="cuda",
                                     generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 200, 8), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    seen = []

    def spy(q, k, v):
        out = tatt.flash_attention(q, k, v, causal=True)
        seen.append(out.grad_fn)
        return out

    before = tatt.flash_attention_backward.launches
    ttf.loss_fn(model, x, attention_fn=spy).backward()
    torch.cuda.synchronize()
    assert all(fn is not None and "FlashAttentionFunction" in type(fn).__name__
               for fn in seen) and len(seen) == 2
    assert tatt.flash_attention_backward.launches == before + 2
    kernel = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    ttf.loss_fn(model, x, attention_fn=functools.partial(
        tatt.mha_reference, causal=True)).backward()
    for n, p in model.named_parameters():
        g = kernel[n]
        assert bool(torch.isfinite(g).all()) and bool(g.any()), n
        if ".qkv." in n:
            assert_close_of_max(g, p.grad, GRAD_TOL_BF16, n)


@pytest.mark.gpu
def test_cuda_backward_wrapper_refuses_what_the_kernel_does_not_take():
    _cuda_or_skip()
    q = torch.zeros((2, 8, 4, 32), device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros((2, 4, 8), device="cuda")
    with pytest.raises(ValueError):
        tatt.flash_attention_backward(q, q, q, q.clone(), q, lse[:, :, :4])
    with pytest.raises(TypeError):
        tatt.flash_attention_backward(q.double(), q.double(), q.double(), q.double(),
                                      q.double(), lse)
    big = torch.zeros((2, 8, 4, 256), device="cuda")
    with pytest.raises(ValueError, match="up to 128"):
        tatt.flash_attention_backward(big, big, big, big, big, lse)
