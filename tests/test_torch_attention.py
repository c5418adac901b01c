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
  float32 scores scaled inside ``exp2``, P rounded to bf16 per tile before
  the P·V product, float32 accumulation), against both ``mha_reference``s
  within the card's bf16 tolerance (``rtol = atol = 8e-3``, the limit the
  card's check holds the kernel to): the rounding of P fits that budget;
  and its handling of a zero or negative ``sm_scale`` (the scale inside
  ``exp2`` must be positive).
* The wrapper's argument checks, which need no card.
* The CUDA kernel itself runs only on the card (``gpu`` marker): against
  the plain version on strided views, ragged S and S=1, and the wrapper
  raising on what the kernel does not take.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ops import attention as jatt
from sitewhere_tpu_torch.ops import attention as tatt

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2**-7, atol=1e-6)
FLASH_TOL_BF16 = dict(rtol=8e-3, atol=8e-3)   # the kernel against its plain version
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
                        block_k: int = 64) -> torch.Tensor:
    """The arithmetic of the bf16 tensor-core kernel, on the CPU: key tiles
    of ``block_k``; float32 scores (exact products of bf16 values summed in
    float32) scaled inside the exp2 argument, p = exp2(s·c − m·c) with c =
    sm_scale·log2(e) made positive (a negative c as |c| on -q, a zero c as
    the smallest normal float); the running max starting at -1e30; masked
    entries p = 0; P rounded to bf16 before the P·V product, accumulated in
    float32; the normaliser summed from the float32 p; l == 0 writes 0."""
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
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vt
        m = mx
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


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
    (lambda q: (q.half(), q.half(), q.half()), TypeError),
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
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got, tatt.mha_reference(q, k, v, causal=causal),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sm_scale", [0.0, -0.3])
def test_cuda_kernel_takes_any_sign_of_scale(sm_scale, dtype, causal):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn((2, 333, 3, 4, 32), device="cuda", generator=gen).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = tatt.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(
        got, tatt.mha_reference(q, k, v, causal=causal, sm_scale=sm_scale),
        rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    _cuda_or_skip()
    q = torch.zeros((2, 8, 4, 32), device="cuda")
    with pytest.raises(TypeError):
        tatt.flash_attention(q.half(), q.half(), q.half())
    big = torch.zeros((2, 8, 4, 128), device="cuda")
    with pytest.raises(ValueError):
        tatt.flash_attention(big, big, big)
