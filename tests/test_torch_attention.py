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


def forward_block_k(d: int) -> int:
    """The key tile of the 16-bit forward kernel that runs head dim ``d``
    (padded as ``padded_head_dim`` pads it): 64 on the mma.sync kernel at D
    = 16 and 32, 128 on the wgmma kernel at D = 64 and 128, 64 on it at
    D = 256."""
    return 128 if tatt.padded_head_dim(d) in (64, 128) else 64


def box_scores(a: torch.Tensor, b: torch.Tensor, d_box: int | None) -> torch.Tensor:
    """a @ b^T over the last dim in float32: one product, or (``d_box``)
    the sum of the products of its d_box-column boxes taken in column
    order, as the wide kernels reduce S over the 64-column boxes that TMA
    brings one by one."""
    if d_box is None:
        return a @ b.transpose(-1, -2)
    out = None
    for c0 in range(0, a.shape[-1], d_box):
        part = a[..., c0:c0 + d_box] @ b[..., c0:c0 + d_box].transpose(-1, -2)
        out = part if out is None else out + part
    return out


def emulate_bf16_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, sm_scale: float | None = None,
                        block_k: int = 64, low: torch.dtype = torch.bfloat16,
                        d_box: int | None = None, chunk: int | None = None
                        ) -> torch.Tensor:
    """The arithmetic of the bf16 tensor-core kernel, on the CPU: key tiles
    of ``block_k`` (64 for the mma.sync kernel at D = 16 and 32, 128 for the
    wgmma kernel at D = 64 and 128, 64 for it at D = 256:
    ``forward_block_k``); float32 scores (exact products of bf16 values summed in
    float32) scaled inside the exp2 argument, p = exp2(s·c − m·c) with c =
    sm_scale·log2(e) made positive (a negative c as |c| on -q, a zero c as
    the smallest normal float); the running max starting at -1e30; masked
    entries p = 0; P rounded to bf16 before the P·V product, accumulated in
    float32; the normaliser summed from the float32 p; l == 0 writes 0.
    ``low`` is the type P is rounded to (float16 for the float16 kernel,
    or bf16 under float16 inputs as a control); the output has q's type.
    The wide kernel past D = 256 (``d_box`` 64, ``chunk`` its column
    chunk): S summed over 64-column boxes in order (``box_scores``), and
    each chunk of O's columns computed by a pass of its own over the keys,
    which recomputes S, its running max and P the same way each time."""
    if chunk is not None:
        parts = [emulate_bf16_kernel(q, k, v[..., c0:c0 + chunk], causal=causal,
                                     sm_scale=sm_scale if sm_scale is not None
                                     else 1.0 / math.sqrt(q.shape[-1]),
                                     block_k=block_k, low=low, d_box=d_box)
                 for c0 in range(0, v.shape[-1], chunk)]
        return torch.cat(parts, dim=-1)
    b, s, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    c = scale * math.log2(math.e)
    if c < 0:
        q, c = -q, -c
    c = c or float(torch.finfo(torch.float32).tiny)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, v.shape[-1]))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        sc = box_scores(qf, kt, d_box)
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


def forward_chunk(d: int) -> int | None:
    """The wide forward's column chunk at head dim ``d`` (padded): 256
    where the padded D is a multiple of 256, else 128; None at D <= 256."""
    dp = tatt.padded_head_dim(d)
    return None if dp <= 256 else (256 if dp % 256 == 0 else 128)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 63, 65, 200])
def test_bf16_kernel_arithmetic_fits_the_tolerance(s, d, causal):
    """The kernel's bf16 P (relative error up to 2**-9 a weight) stays
    within the card's bf16 limit of both plain versions: 64-key tiles on
    the mma.sync kernel at D = 16 and 32, 128 on the wgmma kernel at 64."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((2, s, 2, d), seed=5 + s + d), "bfloat16")
    got = emulate_bf16_kernel(tq, tk, tv, causal=causal, block_k=forward_block_k(d))
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


WGMMA_D64_CASES = [(dtype, s, causal, sm_scale)
                   for dtype in ("bfloat16", "float16") for s in (1, 65, 300)
                   for causal in (False, True) for sm_scale in (None, 0.0, -0.3)]


@pytest.mark.parametrize("case", WGMMA_D64_CASES + [("bfloat16", 300, True, "d48"),
                                                     ("float16", 300, True, "d48"),
                                                     ("bfloat16", 65, False, "d48"),
                                                     ("float16", 65, False, "d48")])
def test_wgmma_forward_arithmetic_at_d64_holds_to_jax(case):
    """The D = 64 forward on wgmma (``flash_attention_wgmma_kernel<T, 64>``)
    in bf16 and float16: 128-key tiles, a negative scale as its magnitude
    on -q (exact in both 16-bit types), a zero one as the smallest normal
    float, P rounded to the input type before P·V. Its outputs do not
    depend on the overlap of one tile's softmax with the other products
    (the same operations on each element in the same order), so this is
    the kernel's arithmetic. ``sm_scale`` "d48" is the d_model=384,
    heads=8 model's D = 48, zero-padded to 64 at the true scale and sliced
    back, as the wrapper runs it. It stays within the card's limit of JAX's
    oracle and of the Pallas kernel in interpret mode: bf16's 8e-3, and
    float16's 1e-3, which the same arithmetic with P rounded to bf16 fails
    under a causal mask past one key at a nonzero scale."""
    dtype, s, causal, sm_scale = case
    d = 48 if sm_scale == "d48" else 64
    scale = 1.0 / math.sqrt(d) if sm_scale == "d48" else sm_scale
    _wgmma_forward_arithmetic_holds_to_jax(dtype, (2, s, 2, d), causal, scale, 90 + s + d,
                                           dp=64, block_k=128)


def _wgmma_forward_arithmetic_holds_to_jax(dtype, shape, causal, scale, seed, *, dp, block_k,
                                           d_box=None, chunk=None):
    """The wgmma forward's emulated arithmetic (D padded to ``dp``, key
    tiles of ``block_k``) on ``shape`` against JAX's oracle and the Pallas
    kernel in interpret mode within the card's limit, and float16's
    bf16-rounded control past it (causal, past one key, a nonzero scale)."""
    s, d = shape[1], shape[-1]
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
                "float16": (jnp.float16, torch.float16)}[dtype]
    arrays = _qkv(shape, seed=seed)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    assert tatt.padded_head_dim(d) == dp and forward_block_k(d) == block_k

    def emulate(low):
        out = emulate_bf16_kernel(*(tatt.pad_head_dim(t, dp) for t in (tq, tk, tv)),
                                  causal=causal, sm_scale=scale, block_k=block_k, low=low,
                                  d_box=d_box, chunk=chunk)
        assert out.dtype == tdt and not out[..., d:].any()
        return out[..., :d]

    got = emulate(tdt)
    assert got.shape == shape and bool(torch.isfinite(got.float()).all())
    tol = FLASH_TOL_BF16 if tdt == torch.bfloat16 else FLASH_TOL_F16
    oracle = jatt.mha_reference(jq, jk, jv, causal=causal, sm_scale=scale)
    np.testing.assert_allclose(_np(got), _np(oracle), **tol)
    np.testing.assert_allclose(
        _np(got), _np(jatt.flash_attention(jq, jk, jv, causal=causal, sm_scale=scale,
                                           force_pallas=True)), **tol)
    if tdt == torch.float16 and causal and s > 1 and scale != 0.0:
        control = emulate(torch.bfloat16)
        assert float(np.max(np.abs(_np(control) - _np(oracle)) / (1 + np.abs(_np(oracle))))
                     ) > FLASH_TOL_F16["rtol"]


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
                                   (64, 64), (100, 128), (128, 128), (129, 256),
                                   (192, 256), (256, 256)])
def test_padded_head_dim_is_the_next_instantiated_one(d, dp):
    assert tatt.padded_head_dim(d) == dp


@pytest.mark.parametrize("d, dp", [(257, 384), (384, 384), (385, 512), (1000, 1024)])
def test_head_dims_past_the_largest_are_refused_with_the_limit(d, dp):
    """Past 256 a head dim runs at the next multiple of 128 (as the TPU
    kernel pads D), with no upper limit; the kernels refuse the unpadded D
    between two multiples, naming the rule."""
    assert tatt.padded_head_dim(d) == dp
    q = torch.zeros((1, 2, 1, d))
    if d == dp:
        assert tatt.kernel_args(q, q, q)[3] == d
    else:
        with pytest.raises(ValueError, match="multiples of 128 past 256"):
            tatt.kernel_args(q, q, q)


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
    # float32 at D = 128 (the register-tiled forward): ragged, one row, D =
    # 100 padded to 128
    (1, 1000, 2, 128, torch.float32),
    (3, 1, 2, 128, torch.float32),
    (2, 65, 2, 100, torch.float32),
    # float16
    (2, 1000, 8, 32, torch.float16),
    (2, 300, 4, 8, torch.float16),
    (2, 333, 4, 48, torch.float16),
    (2, 777, 2, 128, torch.float16),
    # D = 64 on the wgmma forward: float16, and the tile edges in both types
    (2, 777, 4, 64, torch.float16),
    (3, 1, 4, 64, torch.float16),
    (2, 65, 4, 64, torch.bfloat16),
    (2, 1000, 4, 64, torch.bfloat16),
    # D = 256 (its 64-key tiles: S = 1, one key past a tile, ragged) and
    # D = 192 padded to it, in each type
    (3, 1, 2, 256, torch.bfloat16),
    (2, 65, 2, 256, torch.bfloat16),
    (2, 777, 1, 256, torch.bfloat16),
    (2, 333, 2, 192, torch.bfloat16),
    (2, 65, 2, 256, torch.float16),
    (2, 1000, 1, 256, torch.float16),
    (2, 333, 2, 192, torch.float16),
    (2, 300, 2, 256, torch.float32),
    (2, 129, 2, 192, torch.float32),
    # past D = 256 (the wide kernels: column chunks of 256 or 128, S
    # reduced over 64-column boxes) and D = 300 padded to 384, in each type
    (3, 1, 2, 384, torch.bfloat16),
    (2, 65, 2, 512, torch.bfloat16),
    (2, 333, 1, 300, torch.bfloat16),
    (1, 777, 1, 1024, torch.bfloat16),
    (2, 65, 1, 384, torch.float16),
    (1, 1000, 1, 512, torch.float16),
    (2, 333, 1, 300, torch.float16),
    (1, 129, 1, 1024, torch.float16),
    (2, 129, 1, 384, torch.float32),
    (2, 300, 1, 512, torch.float32),
    (1, 65, 1, 300, torch.float32),
    (1, 129, 1, 1024, torch.float32),
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [48, 64])
def test_cuda_forward_at_d64_takes_the_wgmma_kernel(d, dtype):
    """A head dim from 33 to 64 runs the wgmma/TMA forward at D = 64
    (``flash_attention_wgmma_kernel<T, 64>``) by the profiler's kernel
    names, with and without lse, and no mma.sync forward kernel."""
    _cuda_or_skip()
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(8)
    qkv = torch.randn((2, 300, 3, 4, d), device="cuda", generator=gen).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tatt.flash_attention(q, k, v, causal=True)
        tatt.flash_attention_forward(q, k, v, causal=True)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    t = "__half" if dtype == torch.float16 else "__nv_bfloat16"
    wgmma = [n for n in names if "flash_attention_wgmma_kernel" in n]
    assert wgmma and all(t in n and "64" in n for n in wgmma), names
    assert not any("flash_attention_bf16_kernel" in n for n in names), names


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    _cuda_or_skip()
    q = torch.zeros((2, 8, 4, 32), device="cuda")
    with pytest.raises(TypeError):
        tatt.flash_attention(q.double(), q.double(), q.double())
    # a head dim past 256 is no longer refused: D = 257 runs padded to 384
    # on the wide kernel, held to the plain version
    gen = torch.Generator(device="cuda").manual_seed(12)
    wide = torch.randn((2, 70, 2, 257), device="cuda", generator=gen).bfloat16()
    torch.testing.assert_close(tatt.flash_attention(wide, wide, wide, causal=True),
                               tatt.mha_reference(wide, wide, wide, causal=True),
                               **FLASH_TOL_BF16)


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
                          low: torch.dtype = torch.bfloat16, d_box: int | None = None):
    """The arithmetic of the bf16 backward kernel, on the CPU: delta =
    rowsum(dO o) in float32 from the bf16 output; float32 scores of the
    bf16 inputs (exact products summed in float32); P = exp2(s·c − lse·log2
    e) with c = sm_scale·log2(e), masked entries 0; dS = P (dP − delta) in
    float32; P rounded to bf16 before the dV product and dS rounded to bf16
    before the dK and dQ products. dV and dK accumulate in float32 over
    64-row query tiles. dQ: each key block of 128 keys sums its two
    64-key parts (one a compute warpgroup) in float32 (at D = 128 one part
    of 128 keys, ``key_part=128``: a warpgroup's columns of dQ over the
    whole block in one product; at D = 256 blocks of 64 keys in one part,
    ``key_block=key_part=64``), and the blocks' sums
    are added in float32 in key-block order; dq, dk and dv are rounded to
    q's type once. ``low`` is the type P and dS are rounded to: float16
    for the float16 kernel (``round_rows``: each key's row of P^T and dS^T
    scaled first, as ``RowScale`` does; for dQ each query's row of dS
    scaled by the fixed 2^e_i of ``tatt.f16_dq_scale_exponents``, which
    the float32 sum keeps and the end takes off), or bf16 under float16
    inputs as a control. ``d_box`` (the wide kernel past D = 256: 64):
    the scores and dP summed over column boxes in order (``box_scores``);
    its column chunks of dK, dV and dQ change no element's sums (each
    chunk's blocks compute the same P and dS), so the dQ of a chunk is
    ``key_part=128`` over 128-key blocks as at D = 128."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    c = scale * math.log2(math.e)
    qf, kf, vf, of, dof = (t.float().transpose(1, 2) for t in (q, k, v, o, do))
    s = q.shape[1]
    delta = (dof * of).sum(-1)
    p = torch.exp2(box_scores(qf, kf, d_box) * c
                   - (lse.float() * math.log2(math.e))[..., None])
    if causal:
        p = p.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), 0.0)
    ds = p * (box_scores(dof, vf, d_box) - delta[..., None])
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
    _bf16_backward_arithmetic_holds_to_jax_grad((2, s, 2, 128), causal, sm_scale, 90 + s,
                                                key_block=128, key_part=128)


def _bf16_backward_arithmetic_holds_to_jax_grad(shape, causal, sm_scale, seed, *, key_block,
                                                key_part, d_box=None):
    """The bf16 wgmma backward's emulated arithmetic (64-row query tiles,
    key blocks of ``key_block`` whose dQ sums parts of ``key_part``) on
    ``shape`` against ``jax.vjp`` of JAX's oracle on the same bf16 values,
    every row within GRAD_TOL_BF16, delta from the float32 output on both
    sides; at a zero scale dq and dk are exactly 0 on both."""
    arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
              for a in _qkv(shape, seed=seed) + _qkv(shape, seed=seed + 1)[:1]]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    out, vjp = jax.vjp(lambda q, k, v: jatt.mha_reference(q, k, v, causal=causal,
                                                        sm_scale=sm_scale), jq, jk, jv)
    ref = [torch.from_numpy(np.array(g)) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in arrays)
    o = torch.from_numpy(np.array(out))
    lse = tatt.lse_reference(tq.float(), tk.float(), causal=causal, sm_scale=sm_scale)
    got = emulate_bf16_backward(tq, tk, tv, o, tdo, lse, causal=causal, sm_scale=sm_scale,
                                q_tile=64, key_block=key_block, key_part=key_part,
                                d_box=d_box)
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == shape
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
    # 128-key tiles on the wgmma kernel at D = 64 and 128 (D = 48 runs
    # padded to 64), 64 on mma.sync below
    block_k = forward_block_k(d)
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
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 384, 512])
@pytest.mark.parametrize("s", [1, 63, 65, 200])
def test_f16_one_pass_backward_arithmetic_fits_the_tolerance(s, d, causal):
    """The float16 arithmetic of the one-pass kernel
    (``flash_bwd_wgmma_kernel<__half, D>``): 64-row query tiles, 128-key
    blocks whose dQ sums two 64-key parts (one part of 128 at D = 128; at
    D = 256 blocks of 64 keys in one part, both compute warpgroups taking
    the same RowScale exponents, since they compute the same P^T and dS^T), a
    key's rows of P^T and dS^T scaled by its RowScale for dV and dK, a
    query's row of dS by the fixed 2^e_i of ``f16_dq_scale_exponents`` for
    dQ. Every row stays within GRAD_TOL_F16 of the plain backward after
    the float16 step (measured <= 1.05e-3 up to S = 4096); the same
    arithmetic rounded to bf16 fails the limit wherever anything is
    rounded (at S = 1 P is 1 and dq = dk = 0: the control has nothing to
    round there). Past D = 256 the wide kernel's: 128-key blocks whose dQ
    sums all 128 keys in one product per chunk, S^T and dP^T over
    64-column boxes."""
    q, k, v, o, do, lse = _f16_case(s, d, causal, None)
    plain = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=causal)
    key_block = 64 if d == 256 else 128
    key_part = 128 if d == 128 or d > 256 else 64
    d_box = 64 if d > 256 else None
    got = emulate_bf16_backward(q, k, v, o, do, lse, causal=causal, low=torch.float16,
                                key_block=key_block, key_part=key_part, d_box=d_box)
    control = emulate_bf16_backward(q, k, v, o, do, lse, causal=causal, key_block=key_block,
                                    key_part=key_part, d_box=d_box)
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
@pytest.mark.parametrize("s, d", [(1, 32), (63, 16), (200, 64), (300, 128), (300, 256)])
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


@pytest.mark.parametrize("which,causal,s", [("dq", True, 5), ("dq", False, 5), ("dk", True, 5),
                                            ("dv", True, 5), ("dq", False, 1), ("dk", True, 1)])
def test_row_errors_are_the_shares_before_the_division(which, causal, s):
    """``gradient_row_errors`` gives each row's absolute error (the step
    off), its largest |ref| element and the rows whose exact gradient is 0;
    the shares are the one over the other, GRAD_ATOL off those rows only
    (exact: every value below is a power of two or a small integer)."""
    gen = torch.Generator().manual_seed(3)
    ref = torch.randint(-8, 9, (2, s, 3, 4), generator=gen).float()
    got = ref + torch.randint(-2, 3, ref.shape, generator=gen).float() * 2.0 ** -10
    err, top, zero = tatt.gradient_row_errors(got, ref, which, causal=causal, step=2.0 ** -12)
    assert err.shape == top.shape == zero.shape == (2, s, 3)
    assert torch.equal(err, ((got - ref).abs().amax(-1) - 2.0 ** -12).clamp_min(0.0))
    assert torch.equal(top, ref.abs().amax(-1))
    want = torch.zeros_like(zero)
    if which in ("dq", "dk") and s == 1:
        want[:] = True
    elif which == "dq" and causal:
        want[:, 0] = True
    assert torch.equal(zero, want)
    shares = tatt.gradient_row_shares(got, ref, which, causal=causal, atol=GRAD_ATOL,
                                      step=2.0 ** -12)
    e = torch.where(zero, (err - GRAD_ATOL).clamp_min(0.0), err)
    assert torch.equal(shares, torch.where(top > 0, e / top,
                                           torch.where(e > 0, math.inf, 0.0)))


@pytest.mark.parametrize("causal,sm_scale", [(True, None), (False, -0.3), (True, 0.0)])
def test_c6_yardstick_is_the_exact_attention_in_float64(causal, sm_scale):
    """``chip_smoke.float64_reference``, the yardstick of the card's C6
    checks, in float64: its output is softmax attention's, and its
    gradients are the plain backward's formula; from the float64 output
    and lse they are autograd's gradient of float64 softmax attention (to
    1e-12 of the largest element), and from the float32 plain forward they
    lie within 1e-5 of each float32 plain gradient's largest element."""
    import chip_smoke as cs

    q, k, v, do = (torch.from_numpy(a) for a in _qkv((2, 37, 3, 16), seed=7) + [
        np.random.default_rng(8).standard_normal((2, 37, 3, 16)).astype(np.float32)])
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    do64 = do.double()
    scale = 1.0 / 4.0 if sm_scale is None else sm_scale
    s = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * scale
    if causal:
        s = s.masked_fill(torch.ones(37, 37, dtype=torch.bool).triu(1), -math.inf)
    o64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v64)
    want = torch.autograd.grad(o64, (q64, k64, v64), do64)
    got_o, _, got, _ = cs.float64_reference(q64.detach(), k64.detach(), v64.detach(),
                                            o64.detach(), do64, torch.logsumexp(s, -1).detach(),
                                            causal, sm_scale)
    assert float((got_o - o64.detach()).abs().max()) <= 1e-12
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert float((g - w).abs().max()) <= 1e-12 * max(float(w.abs().max()), 1.0)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o = tatt.mha_reference(qf, kf, vf, causal=causal, sm_scale=sm_scale)
    lse = tatt.lse_reference(qf, kf, causal=causal, sm_scale=sm_scale)
    plain = tatt.mha_backward_reference(qf, kf, vf, o, dof, lse, causal=causal,
                                        sm_scale=sm_scale)
    for g, p in zip(cs.float64_reference(qf, kf, vf, o, dof, lse, causal, sm_scale)[2], plain):
        assert float((g - p.double()).abs().max()) <= 1e-5 * max(float(p.abs().max()), 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_c6_float32_bound_frees_only_saturated_rows(dtype):
    """float32's first-order error bound (``chip_smoke.float64_reference``)
    at GRAD_ARITH_MARGIN times frees no gradient row and no output element
    from the type's limit at the default scale (D = 256, S = 333), frees
    dq rows at sm_scale -0.3, and there covers the plain float32 version's
    own error on every row past the type's limit (those rows read at most
    0.62 of the bound here)."""
    import chip_smoke as cs

    gen = torch.Generator().manual_seed(1)
    freed = {}
    for scale in (None, -0.3):
        q, k, v = cs.fused_qkv(2, 333, 2, 256, dtype, "cpu", gen)
        do = torch.randn(q.shape, generator=gen).to(dtype)
        o = tatt.mha_reference(q, k, v, causal=True, sm_scale=scale)
        lse = tatt.lse_reference(q, k, causal=True, sm_scale=scale)
        o64, o_bound, exact, bounds = cs.float64_reference(q, k, v, o, do, lse, True, scale)
        tol = cs.FLASH_TOL[dtype]
        freed[scale] = [int((cs.GRAD_ARITH_MARGIN * o_bound > tol * (1 + o64.abs())).sum())]
        plain = tatt.mha_backward_reference(q.float(), k.float(), v.float(), o.float(),
                                            do.float(), lse, causal=True, sm_scale=scale)
        for t, p, x, b in zip("qkv", plain, exact, bounds):
            err, top, zero = tatt.gradient_row_errors(p, x, f"d{t}", causal=True)
            floor = cs.GRAD_TOL[dtype] * top + cs.GRAD_ATOL * zero
            bound = cs.GRAD_ARITH_MARGIN * b.amax(-1).float()
            freed[scale].append(int((bound > floor).sum()))
            past = err > floor
            assert bool((err[past] <= bound[past]).all()), (scale, t, int(past.sum()))
    assert freed[None] == [0, 0, 0, 0]
    assert freed[-0.3][1] > 0 and freed[-0.3][3] == 0


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
    assert ("bool takes_wgmma(int dtype, int d) { return (dtype == 1 || dtype == 2) && "
            "(d <= 256 || wide(d)); }" in src)
    assert "bool wide(int d) { return d > 256 && d % 128 == 0; }" in src
    assert "mma_bf16(" not in src and "CU_TENSOR_MAP_DATA_TYPE_FLOAT16" in src
    assert "mma_16816" not in (cuda_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "atomicAdd" not in src and "red.global.add" not in src
    assert 'extern "C" int64_t swtpu_flash_attention_bwd_scratch_bytes(' in src
    fwd = (cuda_build.CSRC / "flash_attention.cu").read_text()
    assert "float* lse" in fwd


def test_forward_kernel_source_takes_wgmma_and_tma_at_d128():
    """Both 16-bit types at D = 128, and since the D = 64 redesign at D =
    64 too, take the warp-specialised forward on wgmma and TMA (the tensor
    maps and the wrappers shared with the backward); the mma.sync kernel
    keeps D = 16 and 32 only."""
    src = _translation_unit("flash_attention")
    assert "wgmma.mma_async" in src and "cp.async.bulk.tensor" in src
    assert "flash_attention_wgmma_kernel" in src
    assert "if constexpr (sizeof(T) == 2 && D >= 64)" in src
    assert "atomicAdd" not in src and "torch/extension.h" not in src
    assert 'static_assert(D == 16 || D == 32, "D must be 16 or 32");' in src


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
    # float32 at D = 128 (the one-pass kernel): 16 key blocks adding dQ in
    # turn, one row, D = 100 padded to 128
    (1, 1000, 2, 128, torch.float32),
    (3, 1, 2, 128, torch.float32),
    (2, 65, 2, 100, torch.float32),
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
    # D = 256 (64-key blocks, each compute warpgroup 128 of the columns)
    # and D = 192 padded to it, in each type; the 16-bit ones also in the
    # bitwise check below
    (3, 1, 2, 256, torch.bfloat16),
    (2, 65, 2, 256, torch.bfloat16),
    (2, 777, 1, 256, torch.bfloat16),
    (2, 333, 2, 192, torch.bfloat16),
    (1, 2048, 1, 256, torch.float16),
    (2, 65, 2, 256, torch.float16),
    (2, 333, 2, 192, torch.float16),
    (2, 300, 2, 256, torch.float32),
    (2, 129, 2, 192, torch.float32),
    # past D = 256 (the wide kernels: 128-key blocks, chunks of 128
    # columns) and D = 300 padded to 384, in each type; the 16-bit ones
    # also in the bitwise check below
    (3, 1, 2, 384, torch.bfloat16),
    (2, 65, 2, 512, torch.bfloat16),
    (2, 333, 1, 300, torch.bfloat16),
    (1, 777, 1, 1024, torch.bfloat16),
    (2, 65, 1, 384, torch.float16),
    (1, 1000, 1, 512, torch.float16),
    (2, 333, 1, 300, torch.float16),
    (1, 129, 1, 1024, torch.float16),
    (2, 129, 1, 384, torch.float32),
    (2, 300, 1, 512, torch.float32),
    (1, 65, 1, 300, torch.float32),
    (1, 129, 1, 1024, torch.float32),
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
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_cuda_f16_takes_the_one_pass_backward(d):
    """float16 runs the one-pass wgmma/TMA backward at every head dim
    (``flash_bwd_wgmma_kernel<__half, D>``, after its norm and prep passes)
    and, at D = 64, 128 and 256, the wgmma/TMA forward, by the profiler's kernel
    names; no mma.sync backward kernel runs."""
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
    fwd = "flash_attention_wgmma_kernel" if d >= 64 else "flash_attention_bf16_kernel"
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
    # a head dim past 256 is no longer refused: D = 257 runs padded to 384
    # on the wide kernels, held to the plain backward
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, do = (torch.randn((2, 70, 2, 257), device="cuda", generator=gen).bfloat16()
                   for _ in range(4))
    o, lse = tatt.flash_attention_forward(q, k, v, causal=True)
    got = tatt.flash_attention_backward(q, k, v, o, do, lse, causal=True)
    ref = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=True)
    for name, g, r in zip("qkv", got, ref):
        assert g.shape == (2, 70, 2, 257)
        assert_rows_close_of_max(g, r, GRAD_TOL_BF16, f"d{name}", causal=True, atol=GRAD_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [192, 256])
def test_cuda_head_dims_past_128_take_the_d256_kernels(d, dtype):
    """A head dim from 129 to 256 runs the wgmma/TMA forward and the
    one-pass backward at D = 256 (``flash_attention_wgmma_kernel<T, 256>``,
    ``flash_bwd_wgmma_kernel<T, 256>``) by the profiler's kernel names,
    through autograd as the trainer takes them."""
    _cuda_or_skip()
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(9)
    qkv = torch.randn((1, 300, 3, 2, d), device="cuda", generator=gen).to(dtype)
    qkv.requires_grad_(True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tatt.flash_attention(q, k, v, causal=True).float().square().sum().backward()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    t = "__half" if dtype == torch.float16 else "__nv_bfloat16"
    for kernel in ("flash_attention_wgmma_kernel", "flash_bwd_wgmma_kernel"):
        ran = [n for n in names if kernel in n]
        assert ran and all(t in n and "256" in n for n in ran), (kernel, names)
    assert bool(torch.isfinite(qkv.grad.float()).all()) and bool(qkv.grad.any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [300, 384, 512])
def test_cuda_head_dims_past_256_take_the_wide_kernels(d, dtype):
    """A head dim past 256 runs the wide forward (column chunks of 256
    columns where the padded D is a multiple of 256, else 128) and the wide
    one-pass backward (``flash_attention_wide_kernel<T, DC>``,
    ``flash_bwd_wide_kernel<T>``) by the profiler's kernel names, through
    autograd as the trainer takes them, and neither D = 256 kernel."""
    _cuda_or_skip()
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(10)
    qkv = torch.randn((1, 300, 3, 1, d), device="cuda", generator=gen).to(dtype)
    qkv.requires_grad_(True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tatt.flash_attention(q, k, v, causal=True).float().square().sum().backward()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    t = "__half" if dtype == torch.float16 else "__nv_bfloat16"
    chunk = 256 if tatt.padded_head_dim(d) % 256 == 0 else 128
    fwd = [n for n in names if "flash_attention_wide_kernel" in n]
    assert fwd and all(t in n and str(chunk) in n for n in fwd), names
    bwd = [n for n in names if "flash_bwd_wide_kernel" in n]
    assert bwd and all(t in n for n in bwd), names
    assert not any("wgmma_kernel" in n or "bf16_kernel" in n for n in names), names
    assert bool(torch.isfinite(qkv.grad.float()).all()) and bool(qkv.grad.any())


# ------------------------------------------------- head dims past 128
#
# D = 129 to 256 runs on the card at D = 256 (zero-padded up to it, as the
# TPU kernel pads 192 to 256). Tolerances: the plain versions against JAX
# as above (float16 one float16 ulp, ``rtol = 2**-10``: both sides compute
# in float32 and round once); the plain float16 backward against
# ``jax.vjp`` 2e-3 of each gradient's largest element (both round the
# gradients to float16 once, and the plain backward takes delta from the
# float16-rounded output where JAX's softmax transpose uses the float32
# one; measured <= 5.9e-4 at D = 192 and 256, S = 200); the kernels'
# emulated arithmetic to the card's limits (FLASH_TOL_*, GRAD_TOL_*).
F16 = dict(rtol=2**-10, atol=1e-6)
GRAD_F16_VS_JAX = 2e-3
WIDE_DTYPES = {"float32": (jnp.float32, torch.float32, F32, GRAD_F32),
               "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16, GRAD_BF16_VS_JAX),
               "float16": (jnp.float16, torch.float16, F16, GRAD_F16_VS_JAX)}


@pytest.mark.parametrize("dtype", list(WIDE_DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [192, 256, 300, 384, 512])
def test_plain_version_past_head_dim_128_matches_jax_and_pallas(d, causal, dtype):
    """The plain forward and its lse at D = 192, 256, 300, 384 and 512
    against JAX's oracle and the Pallas kernel in interpret mode (which
    pads 192 to 256 and 300 to 384 itself),
    and against ``jax.nn.logsumexp`` of JAX's scaled, masked float32
    scores (LSE_TOL)."""
    jdt, tdt, tol, _ = WIDE_DTYPES[dtype]
    arrays = _qkv((1, 256, 2, d), seed=30 + d)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    out, lse = tatt.flash_attention_forward(tq, tk, tv, causal=causal)
    assert out.dtype == tdt and out.shape == (1, 256, 2, d) and lse.shape == (1, 2, 256)
    np.testing.assert_allclose(_np(out), _np(jatt.mha_reference(jq, jk, jv, causal=causal)),
                               **tol)
    np.testing.assert_allclose(
        _np(out), _np(jatt.flash_attention(jq, jk, jv, causal=causal, force_pallas=True)), **tol)
    sc = jnp.einsum("bqhd,bkhd->bhqk", jq.astype(jnp.float32), jk.astype(jnp.float32)) * d ** -0.5
    if causal:
        sc = jnp.where(jnp.tril(jnp.ones((256, 256), bool)), sc, jatt._NEG_INF)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(sc, axis=-1)), **LSE_TOL)


@pytest.mark.parametrize("dtype", list(WIDE_DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [192, 256, 300, 384, 512])
def test_plain_backward_past_head_dim_128_matches_jax_vjp(d, causal, dtype):
    """The plain backward (from the forward's output and lse, as the kernel
    pair runs) and autograd of the plain attention at D = 192, 256, 300,
    384 and 512
    against ``jax.vjp`` of JAX's oracle, each gradient within its type's
    share of its largest element."""
    jdt, tdt, _, tol = WIDE_DTYPES[dtype]
    arrays = _qkv((1, 200, 2, d), seed=40 + d) + _qkv((1, 200, 2, d), seed=41 + d)[:1]
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jatt.mha_reference(q, k, v, causal=causal), jq, jk, jv)
    ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in arrays)
    o, lse = tatt.flash_attention_forward(tq, tk, tv, causal=causal)
    plain = tatt.flash_attention_backward(tq, tk, tv, o, tdo, lse, causal=causal)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(tatt.flash_attention(*leaves, causal=causal), leaves, tdo)
    for name, p, a, r in zip("qkv", plain, auto, ref):
        assert p.dtype == tdt and a.dtype == tdt and p.shape == (1, 200, 2, d)
        assert_close_of_max(p, r, tol, f"plain d{name}")
        assert_close_of_max(a, r, tol, f"autograd d{name}")


WGMMA_D256_CASES = [(dtype, s, causal, sm_scale)
                    for dtype in ("bfloat16", "float16") for s in (1, 65, 300)
                    for causal in (False, True) for sm_scale in (None, 0.0, -0.3)]


@pytest.mark.parametrize("case", WGMMA_D256_CASES + [("bfloat16", 300, True, "d192"),
                                                      ("float16", 300, True, "d192"),
                                                      ("bfloat16", 65, False, "d192"),
                                                      ("float16", 65, False, "d192")])
def test_wgmma_forward_arithmetic_at_d256_holds_to_jax(case):
    """The D = 256 forward (``flash_attention_wgmma_kernel<T, 256>``) in bf16
    and float16: 64-key tiles (``forward_block_k``), a negative scale as its
    magnitude on -q, a zero one as the smallest normal float, P rounded to
    the input type before P·V; the two P·V products of 128 columns each
    change no element's order of sums. ``sm_scale`` "d192" is the
    d_model=384, heads=2 model's D = 192, zero-padded to 256 at the true
    scale and sliced back, as the wrapper runs it. It stays within the
    card's limit of JAX's oracle and of the Pallas kernel in interpret
    mode (bf16 8e-3, float16 1e-3), and float16's bf16-rounded control
    fails under a causal mask past one key at a nonzero scale."""
    dtype, s, causal, sm_scale = case
    d = 192 if sm_scale == "d192" else 256
    scale = 1.0 / math.sqrt(d) if sm_scale == "d192" else sm_scale
    _wgmma_forward_arithmetic_holds_to_jax(dtype, (1, s, 2, d), causal, scale, 95 + s + d,
                                           dp=256, block_k=64)


@pytest.mark.parametrize("sm_scale", [None, 0.0, -0.3])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 65, 300])
def test_bf16_wgmma_backward_arithmetic_at_d256_holds_to_jax_grad(s, causal, sm_scale):
    """The D = 256 backward (``flash_bwd_wgmma_kernel<bf16, 256>``): 64-row
    query tiles, 64-key blocks whose dQ sums the block's 64 keys in one
    product (each compute warpgroup 128 of the columns: ``key_block`` =
    ``key_part`` = 64), dQ added over the blocks in their order, P and dS
    rounded to bf16. Every row of dq, dk and dv stays within GRAD_TOL_BF16
    of ``jax.vjp`` of JAX's oracle on the same bf16 values, delta taken
    from the float32 output on both sides."""
    _bf16_backward_arithmetic_holds_to_jax_grad((1, s, 2, 256), causal, sm_scale, 96 + s,
                                                key_block=64, key_part=64)


def test_both_kernel_sources_instantiate_head_dim_256():
    """The forward and the backward each dispatch D = 256 (a case of their
    head-dim switch) to layouts sized for it: the wgmma forward's 64-key
    tiles, the backward's 64-key blocks with their own compute path."""
    from sitewhere_tpu_torch import cuda_build

    fwd = (cuda_build.CSRC / "flash_attention.cu").read_text()
    bwd = (cuda_build.CSRC / "flash_attention_bwd.cu").read_text()
    for src in (fwd, bwd):
        assert "case 256:" in src and "<T, 256>" in src
    assert 'static_assert(D == 64 || D == 128 || D == 256, "the wgmma forward takes' in fwd
    assert "static constexpr int kBN = D == 256 ? 64 : 128;" in fwd
    assert "D == 16 || D == 32 || D == 64 || D == 128 || D == 256" in bwd
    assert "static constexpr int kBN = D == 256 ? 64 : 128;" in bwd
    assert "bwd_compute_d256<T>(" in bwd and "struct F32BwdTile" in bwd
    assert "struct F32Tile" in fwd
    assert tatt.HEAD_DIMS[-1] == 256


# ------------------------------------------------- head dims past 256
#
# D past 256 runs on the card at the next multiple of 128 (zero-padded, as
# the TPU kernel pads D) on the wide kernels. Their arithmetic, emulated:
# the forward by column chunks of 256 columns (128 where the padded D is
# not a multiple of 256; ``forward_chunk``) over 64-key tiles, S summed
# over 64-column boxes in column order; the backward by 128-key blocks
# whose dQ of a chunk sums the block's keys in one product, S^T and dP^T
# over the same boxes. Held to the card's limits as past 128 above.
WIDE_FWD_CASES = [(dtype, d, s, causal, None)
                  for dtype in ("bfloat16", "float16") for d in (300, 384, 512)
                  for s in (1, 65, 200) for causal in (False, True)]
WIDE_FWD_CASES += [(dtype, 512, 200, True, -0.3) for dtype in ("bfloat16", "float16")]
WIDE_FWD_CASES += [(dtype, 384, 65, False, 0.0) for dtype in ("bfloat16", "float16")]


@pytest.mark.parametrize("case", WIDE_FWD_CASES)
def test_wide_forward_arithmetic_past_d256_holds_to_jax(case):
    """The wide forward (``flash_attention_wide_kernel<T, DC>``) in bf16 and
    float16 at D = 300 (padded to 384: chunks of 128), 384 (chunks of 128)
    and 512 (chunks of 256): 64-key tiles, S over 64-column boxes in
    order, a negative scale as its magnitude on -S (the same values as on
    -q), a zero one as the smallest normal float, P rounded to the input
    type before each chunk's P·V. It stays within the card's limit of
    JAX's oracle and of the Pallas kernel in interpret mode (bf16 8e-3,
    float16 1e-3), and float16's bf16-rounded control fails under a causal
    mask past one key at a nonzero scale."""
    dtype, d, s, causal, scale = case
    dp = tatt.padded_head_dim(d)
    scale = 1.0 / math.sqrt(d) if scale is None else scale   # the true D's, as the wrapper
    assert forward_block_k(d) == 64 and forward_chunk(d) == (256 if d == 512 else 128)
    _wgmma_forward_arithmetic_holds_to_jax(dtype, (1, s, 1, d), causal, scale, 97 + s + d,
                                           dp=dp, block_k=64, d_box=64,
                                           chunk=forward_chunk(d))


@pytest.mark.parametrize("sm_scale", [None, 0.0, -0.3])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d, s", [(384, 65), (512, 200), (512, 1)])
def test_bf16_wide_backward_arithmetic_past_d256_holds_to_jax_grad(d, s, causal, sm_scale):
    """The wide backward (``flash_bwd_wide_kernel<bf16>``): 64-row query
    tiles, 128-key blocks whose dQ of a chunk sums the block's 128 keys in
    one product (each compute warpgroup 64 of the chunk's columns:
    ``key_part`` 128), dQ added over the blocks in their order, S^T and
    dP^T summed over 64-column boxes in order, P and dS rounded to bf16,
    delta from the float32 output as on JAX's side. Every row of dq, dk
    and dv stays within GRAD_TOL_BF16 of its largest element of
    ``jax.vjp`` of JAX's oracle on the same bf16 values, or, where that is
    larger, within GRAD_ARITH_MARGIN times float32's first-order error
    bound of the kernel's formula on the row (``chip_smoke.float64_reference``,
    the rule the card's C6 check holds every kernel to). The bound frees
    rows only where softmax rows saturate: at D = 512 and sm_scale -0.3
    (|scale q.k| ~ 7) dP - delta cancels to the rounding of its float32
    terms, and the same formula in float32 with nothing rounded to bf16
    misses dq rows by 7 % of the row; at the default scale it frees none."""
    import chip_smoke as cs

    shape = (1, s, 1, d)
    seed = 98 + s + d
    arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
              for a in _qkv(shape, seed=seed) + _qkv(shape, seed=seed + 1)[:1]]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    out, vjp = jax.vjp(lambda q, k, v: jatt.mha_reference(q, k, v, causal=causal,
                                                        sm_scale=sm_scale), jq, jk, jv)
    ref = [torch.from_numpy(np.array(g)) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(a.copy()).bfloat16() for a in arrays)
    o = torch.from_numpy(np.array(out))
    lse = tatt.lse_reference(tq.float(), tk.float(), causal=causal, sm_scale=sm_scale)
    got = emulate_bf16_backward(tq, tk, tv, o, tdo, lse, causal=causal, sm_scale=sm_scale,
                                q_tile=64, key_block=128, key_part=128, d_box=64)
    bounds = cs.float64_reference(tq, tk, tv, o, tdo, lse, causal, sm_scale)[3]
    for name, g, r, b in zip("qkv", got, ref, bounds):
        assert g.dtype == torch.bfloat16 and g.shape == shape
        assert bool(torch.isfinite(g.float()).all())
        if sm_scale == 0.0 and name != "v":
            assert not g.float().any() and not r.any()
            continue
        err, top, zero = tatt.gradient_row_errors(g, r, f"d{name}", causal=causal)
        floor = GRAD_TOL_BF16 * top + GRAD_ATOL * zero
        bound = cs.GRAD_ARITH_MARGIN * b.amax(-1).float()
        if sm_scale is None:
            assert not bool((bound > floor).any()), f"d{name}: the bound frees a row"
        over = float((err / torch.maximum(floor, bound)).max())
        assert over <= 1.0, f"d{name}: worst row {over} times its limit"


def test_box_scores_are_the_product_summed_in_box_order():
    """``box_scores`` is the float32 product summed over its boxes in
    column order: equal to the one product within float32 rounding, and
    bit for bit the left-to-right sum of the box products."""
    rng = np.random.default_rng(14)
    a, b = (torch.from_numpy(rng.standard_normal((2, 5, 512)).astype(np.float32))
            for _ in range(2))
    got = box_scores(a, b, 64)
    torch.testing.assert_close(got, box_scores(a, b, None), rtol=1e-5, atol=1e-4)
    want = a[..., :64] @ b[..., :64].transpose(-1, -2)
    for c0 in range(64, 512, 64):
        want = want + a[..., c0:c0 + 64] @ b[..., c0:c0 + 64].transpose(-1, -2)
    assert torch.equal(got, want)


def test_both_kernel_sources_take_head_dims_past_256():
    """The forward and the backward each dispatch every multiple of 128
    past 256 to their wide kernels (column chunks), in every type: float32
    to the forward's split kernel (two groups of warps, one chunk at D =
    384 and 512, chunks of 512 columns past it) and the backward's
    register-tiled pair (by the widest of 512, 384, 256 and 128 columns
    that divides D), which took the old float32 kernels' places."""
    from sitewhere_tpu_torch import cuda_build

    fwd = (cuda_build.CSRC / "flash_attention.cu").read_text()
    bwd = (cuda_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "if (d > 256 && d % 128 == 0)" in fwd and "launch_wide_d<T>(" in fwd
    assert "flash_attention_wide_kernel" in fwd and "flash_attention_f32_split_kernel" in fwd
    assert all(f"launch_f32_split<{c}, {x}>(" in fwd
               for c, x in ((384, "false"), (512, "false"), (512, "true")))
    assert "launch_wide<T, 256>" in fwd and "launch_wide<T, 128>" in fwd
    assert "if (!wide(d)) return cudaErrorInvalidValue;" in bwd
    assert "flash_bwd_wide_kernel" in bwd
    assert all(f"launch_f32_tiled<{c}>(a)" in bwd for c in (512, 384, 256, 128))
    assert "flash_bwd_dkdv_f32_tiled_kernel" in bwd and "flash_bwd_dq_f32_tiled_kernel" in bwd
    # the float32 kernels at 256 and past it were redesigned: the old
    # forward past 256 and its helpers, the old pair past 256 and its
    # eight-threads-a-row D = 256 branch are gone
    assert "f32_wide_kernel" not in bwd and "flash_attention_f32_tiled_kernel" in fwd
    assert "f32_wide" not in fwd and "kF32Wide" not in fwd
    assert "launch_f32_tiled<256>(a);" in bwd and "kSplit" not in bwd
    for d in (257, 300, 384, 385, 512, 1000, 1024, 4096):
        dp = tatt.padded_head_dim(d)
        assert dp % tatt.WIDE_STEP == 0 and d <= dp < d + tatt.WIDE_STEP
        assert tatt.kernel_head_dim(dp) and not tatt.kernel_head_dim(dp + 64)


# ------------------------------------ float32, register-tiled, CUDA cores
#
# float32 from D = 256 (and 129 to 255, padded) on runs register-tiled
# CUDA-core kernels (``flash_attention_f32_tiled_kernel`` at D = 256,
# ``flash_attention_f32_split_kernel`` past it, where two groups of warps
# each sum a partial S over half of D and the two halves are added;
# ``flash_bwd_{dkdv,dq}_f32_tiled_kernel<C>``). Their arithmetic, emulated
# on the CPU in the kernels' order of sums: every score and dP FMA chains
# over 64-column pieces in column order, the pieces' sums added in order
# (a lane's 4 x 4 micro-tile sums each element alone), delta one FMA chain
# over D (the prep pass), the forward's online softmax over 64-key tiles (each
# score times scale log2(e) before the max, any sign) with O += P V an FMA
# chain over the keys in order, the backward's P = exp2(fma(S, scale
# log2(e), -lse2)), dS = P (dP - delta), and dV, dK and dQ FMA chains over
# the other side's rows in order, per column chunk of each kernel (each
# chunk recomputes S and dP, which changes no element's sums). Held to JAX's oracle and
# ``jax.vjp`` of it under the float32 limits (F32; GRAD_TOL_F32 of each
# row's largest element), or, where that is larger, GRAD_ARITH_MARGIN
# times float32's first-order error bound (``chip_smoke.float64_reference``,
# the card's C6 rule): at sm_scale -0.3 softmax rows saturate.


def fma_dots(a: torch.Tensor, b: torch.Tensor, block: int | None = 64) -> torch.Tensor:
    """a [..., M, D] . b [..., N, D] -> [..., M, N] float32 as the tiled
    kernels sum it: each ``block`` of columns one FMA chain from 0 in
    column order (every step adds the exact product in float64 and rounds
    to float32: an FMA, up to the rare case where the double rounding
    differs), the blocks' sums added in float32 in order; ``block=None``
    one chain over the whole D (the prep pass's delta)."""
    a64, b64 = a.double(), b.double()
    total = None
    for c0 in range(0, a.shape[-1], block or a.shape[-1]):
        acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float64)
        for c in range(c0, min(c0 + (block or a.shape[-1]), a.shape[-1])):
            acc = acc.add_(a64[..., :, c, None] * b64[..., None, :, c]).float().double()
        total = acc.float() if total is None else total + acc.float()
    return total


def fma_step(acc: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """acc + w x as one FMA a float32 element (as in ``fma_dots``)."""
    return acc.double().add_(w.double() * x.double()).float()


def emulate_f32_tiled_forward(q, k, v, *, causal: bool, sm_scale: float | None = None,
                              block_k: int = 64, groups: int = 1,
                              chunk: int | None = None) -> tuple:
    """``(out, lse)`` of the float32 register-tiled forward on the CPU
    (float32 q, k, v [B, S, H, D]): ``flash_attention_f32_tiled_kernel`` at
    D = 128 and 256 (``groups=1``), ``flash_attention_f32_split_kernel`` past it
    (``groups=2``: each score the sum in float32 of the first half of D's
    columns and the second's, group 0's + group 1's, each half summed by
    64-column pieces; ``chunk``: O's columns by chunks of that width, each
    recomputing S and the softmax state, lse from chunk 0). Key tiles of
    ``block_k``; each half's score summed by 64-column pieces
    (``fma_dots``), times c = scale log2(e) rounded to float32 as the
    kernel is handed it; a tile's live scores' max; alpha = exp2(m -
    m_new), P = exp2(s c - m_new) (masked 0); l = l alpha + the tile's
    sum; O = O alpha, then O += P_j V_j an FMA a key in key order; out = O
    / l (l = 0 writes 0, lse +inf); lse = (m + log2 l) ln 2."""
    b, s, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
    half = d // groups
    rows = torch.arange(s)[:, None]
    outs, lse = [], None
    for c0 in range(0, d, chunk or d):
        cols = slice(c0, c0 + (chunk or d))
        m = torch.full((b, h, s), -1e30)
        l = torch.zeros((b, h, s))
        acc = torch.zeros((b, h, s, vf[..., cols].shape[-1]))
        for k0 in range(0, s, block_k):
            kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k, cols]
            sc = fma_dots(qf[..., :half], kt[..., :half])
            for g in range(1, groups):
                sc = sc + fma_dots(qf[..., g * half:(g + 1) * half], kt[..., g * half:(g + 1) * half])
            sc = sc * c
            live = torch.ones(s, kt.shape[2], dtype=torch.bool)
            if causal:
                live &= torch.arange(k0, k0 + kt.shape[2])[None, :] <= rows
            m_new = torch.maximum(m, sc.masked_fill(~live, -1e30).amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(live, torch.exp2(sc - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None]
            for j in range(kt.shape[2]):
                acc = fma_step(acc, p[..., j, None], vt[:, :, j, None, :])
            m = m_new
        outs.append(acc / torch.where(l == 0, 1.0, l)[..., None])
        if lse is None:
            lse = torch.where(l == 0, math.inf, (m + torch.log2(l)) * math.log(2.0))
    return torch.cat(outs, -1).transpose(1, 2).contiguous(), lse


def f32_forward_layout(dp: int) -> dict:
    """How the float32 forward runs a padded head dim ``dp`` >= 128, as
    ``emulate_f32_tiled_forward``'s arguments: one group at 128 and 256,
    two past 256, O by chunks of 512 columns past 512."""
    return dict(groups=1 if dp <= 256 else 2, chunk=512 if dp > 512 else None)


def emulate_f32_tiled_backward(q, k, v, o, do, lse, *, causal: bool,
                               sm_scale: float | None = None, chunk: int = 512) -> tuple:
    """``(dq, dk, dv)`` of the float32 backward past D = 256 (the prep pass,
    then ``flash_bwd_dkdv_f32_tiled_kernel<chunk>`` and
    ``flash_bwd_dq_f32_tiled_kernel<chunk>``) on the CPU: delta an FMA
    chain over D of o dO, lse2 = lse log2(e); per column chunk of each
    kernel, S and dP recomputed (``fma_dots``), P = exp2(fma(S, c, -lse2))
    with c = scale log2(e) (masked 0), dS = P (dP - delta); the chunk's
    columns of dV and dK FMA chains over the queries in order, of dQ over
    the keys in order; dk and dq times the float32 scale at the end."""
    b, s, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    c32, scale32 = (torch.tensor(x, dtype=torch.float32).double()
                    for x in (scale * math.log2(math.e), scale))
    qf, kf, vf, of, dof = (t.float().transpose(1, 2) for t in (q, k, v, o, do))
    delta = fma_dots(of[..., None, :], dof[..., None, :], None)[..., 0, 0]   # [B, H, S]
    lse2 = lse.float() * torch.tensor(math.log2(math.e), dtype=torch.float32)
    live = torch.ones(s, s, dtype=torch.bool)
    if causal:
        live = live.tril()

    def p_ds():
        sc, dp = fma_dots(qf, kf), fma_dots(dof, vf)
        p = (sc.double() * c32 - lse2.double()[..., None]).float()
        p = torch.where(live, torch.exp2(p), 0.0)
        return p, p * (dp - delta[..., None])

    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for c0 in range(0, d, chunk):
        cols = slice(c0, c0 + chunk)
        p, ds = p_ds()
        for i in range(s):
            dv[..., cols] = fma_step(dv[..., cols], p[..., i, :, None], dof[:, :, i, None, cols])
            dk[..., cols] = fma_step(dk[..., cols], ds[..., i, :, None], qf[:, :, i, None, cols])
    for c0 in range(0, d, chunk):
        cols = slice(c0, c0 + chunk)
        ds = p_ds()[1]
        for j in range(s):
            dq[..., cols] = fma_step(dq[..., cols], ds[..., :, j, None], kf[:, :, j, None, cols])
    return tuple(g.transpose(1, 2).contiguous() for g in (
        (dq.double() * scale32).float(), (dk.double() * scale32).float(), dv))


def emulate_f32_onepass_backward(q, k, v, o, do, lse, *, causal: bool,
                                 sm_scale: float | None = None, block: int = 64) -> tuple:
    """``(dq, dk, dv)`` of the float32 one-pass backward at D = 128 (the
    prep pass, then ``flash_bwd_f32_onepass_kernel``) on the CPU: delta an
    FMA chain over D of o dO, lse2 = lse log2(e); S and dP by 64-column
    pieces (``fma_dots``), P = exp2(fma(S, c, -lse2)) with c = scale
    log2(e) (masked 0), dS = P (dP - delta); dV and dK FMA chains over the
    queries in the order a key block walks them: query tiles of ``block``
    rows from the last one down, each tile's rows in order; dQ by key
    blocks of ``block`` keys, each block's part an FMA chain over its keys
    in order from 0, the parts added in float32 in key-block order (block 0
    first), the sum times the float32 scale; dk times the scale at the
    end."""
    b, s, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    c32, scale32 = (torch.tensor(x, dtype=torch.float32).double()
                    for x in (scale * math.log2(math.e), scale))
    qf, kf, vf, of, dof = (t.float().transpose(1, 2) for t in (q, k, v, o, do))
    delta = fma_dots(of[..., None, :], dof[..., None, :], None)[..., 0, 0]   # [B, H, S]
    lse2 = lse.float() * torch.tensor(math.log2(math.e), dtype=torch.float32)
    live = torch.ones(s, s, dtype=torch.bool)
    if causal:
        live = live.tril()
    sc, dp = fma_dots(qf, kf), fma_dots(dof, vf)
    p = torch.where(live, torch.exp2((sc.double() * c32 - lse2.double()[..., None]).float()), 0.0)
    ds = p * (dp - delta[..., None])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for t0 in reversed(range(0, s, block)):
        for i in range(t0, min(t0 + block, s)):
            dv = fma_step(dv, p[..., i, :, None], dof[:, :, i, None, :])
            dk = fma_step(dk, ds[..., i, :, None], qf[:, :, i, None, :])
    dq = None
    for k0 in range(0, s, block):
        part = torch.zeros_like(qf)
        for j in range(k0, min(k0 + block, s)):
            part = fma_step(part, ds[..., :, j, None], kf[:, :, j, None, :])
        dq = part if dq is None else dq + part
    return tuple(g.transpose(1, 2).contiguous() for g in (
        (dq.double() * scale32).float(), (dk.double() * scale32).float(), dv))


F32_TILED_FWD_CASES = [(256, s, causal, sm_scale) for s in (1, 65, 300)
                       for causal in (False, True) for sm_scale in (None, 0.0, -0.3)]
F32_TILED_FWD_CASES += [(192, 300, True, None), (192, 65, False, None), (192, 300, True, -0.3)]


@pytest.mark.parametrize("case", F32_TILED_FWD_CASES)
def test_f32_tiled_forward_arithmetic_at_d256_holds_to_jax(case):
    """The float32 forward at D = 256 (``flash_attention_f32_tiled_kernel``;
    D = 192 zero-padded to it at the true D's scale, the output sliced
    back, as the wrapper runs it): every output element within F32 of
    JAX's oracle on the same float32 values, or within GRAD_ARITH_MARGIN
    times float32's first-order bound where that is larger (it frees
    elements only at sm_scale -0.3, none at the default scale); lse within
    F32 of ``jax.nn.logsumexp`` of JAX's scaled, masked scores."""
    _f32_forward_arithmetic_holds_to_jax(*case, seed=120)


# past D = 256 (``flash_attention_f32_split_kernel``): D = 384 (two groups
# of 192 columns) and 512 (of 256), D = 300 padded to 384, and D = 1024 by
# chunks of 512 columns of O, each recomputing S
F32_SPLIT_FWD_CASES = [(d, s, causal, sm_scale) for d, s in ((384, 300), (512, 1), (512, 65))
                       for causal in (False, True) for sm_scale in (None, 0.0, -0.3)]
F32_SPLIT_FWD_CASES += [(300, 300, True, None), (300, 65, False, -0.3),
                        (1024, 65, True, None), (1024, 65, False, -0.3)]


@pytest.mark.parametrize("case", F32_SPLIT_FWD_CASES)
def test_f32_split_forward_arithmetic_past_d256_holds_to_jax(case):
    """The float32 forward past D = 256 (``flash_attention_f32_split_kernel``:
    each score the sum of two groups' partial dots over the halves of D,
    each by 64-column pieces; past 512 by chunks of 512 columns, each
    recomputing S; D = 300 zero-padded to 384 at the true D's scale):
    every output element within F32 of JAX's oracle, or within
    GRAD_ARITH_MARGIN times float32's first-order bound where that is
    larger (none freed at the default scale); lse within F32 of
    ``jax.nn.logsumexp``."""
    _f32_forward_arithmetic_holds_to_jax(*case, seed=150)


# at D = 128 (``flash_attention_f32_tiled_kernel<128>``: 16 rows a warp, a
# lane 4 rows by 8 keys of S and 16 rows by 4 columns of O; each element
# summed as at D = 256), and D = 100 padded to it
F32_D128_FWD_CASES = [(d, s, causal, sm_scale) for d in (128, 100) for s in (1, 65, 300)
                      for causal in (False, True) for sm_scale in (None, 0.0, -0.3)]


@pytest.mark.parametrize("case", F32_D128_FWD_CASES)
def test_f32_tiled_forward_arithmetic_at_d128_holds_to_jax(case):
    """The float32 forward at D = 128 (the register-tiled kernel's D = 128
    instantiation; D = 100 zero-padded to 128 at the true D's scale, the
    output sliced back): every output element within F32 of JAX's oracle,
    or within GRAD_ARITH_MARGIN times float32's first-order bound where
    that is larger (none freed at the default scale); lse within F32 of
    ``jax.nn.logsumexp``."""
    _f32_forward_arithmetic_holds_to_jax(*case, seed=170)


def _f32_forward_arithmetic_holds_to_jax(d, s, causal, sm_scale, *, seed):
    import chip_smoke as cs

    arrays = _qkv((1, s, 2, d), seed=seed + s + d) + _qkv((1, s, 2, d), seed=seed + 1 + s + d)[:1]
    jq, jk, jv = (jnp.asarray(a) for a in arrays[:3])
    ref = np.array(jatt.mha_reference(jq, jk, jv, causal=causal, sm_scale=sm_scale))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in arrays)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    dp = tatt.padded_head_dim(d)
    out, lse = emulate_f32_tiled_forward(*(tatt.pad_head_dim(t, dp) for t in (tq, tk, tv)),
                                         causal=causal, sm_scale=scale, **f32_forward_layout(dp))
    out = out[..., :d]
    assert out.dtype == torch.float32 and out.shape == (1, s, 2, d)
    assert bool(torch.isfinite(out).all())
    o64, o_bound = cs.float64_reference(tq, tk, tv, out, tdo, lse, causal, sm_scale)[:2]
    floor = F32["atol"] + F32["rtol"] * torch.from_numpy(ref).abs().double()
    limit = torch.maximum(floor, cs.GRAD_ARITH_MARGIN * o_bound)
    if sm_scale is None:
        assert not bool((limit > floor).any()), "the bound frees an element"
    over = float(((out.double() - torch.from_numpy(ref).double()).abs() / limit).max())
    assert over <= 1.0, f"worst element {over} times its limit"
    sc = jnp.einsum("bqhd,bkhd->bhqk", jq, jk) * scale
    if causal:
        sc = jnp.where(jnp.tril(jnp.ones((s, s), bool)), sc, jatt._NEG_INF)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(sc, axis=-1)), **F32)


@pytest.mark.parametrize("sm_scale", [None, 0.0, -0.3])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d, s", [(384, 300), (512, 65), (512, 1)])
def test_f32_tiled_backward_arithmetic_past_d256_holds_to_jax_grad(d, s, causal, sm_scale):
    """The float32 backward past D = 256 (``flash_bwd_*_f32_tiled_kernel``,
    by chunks of 512 columns at D = 512, of 384 at 384): every row of dq,
    dk and
    dv within GRAD_TOL_F32 of its largest element of ``jax.vjp`` of JAX's
    oracle on the same float32 values (GRAD_ATOL on the rows whose exact
    gradient is 0), or within GRAD_ARITH_MARGIN times float32's
    first-order error bound of the formula on the row where that is larger
    (the C6 rule; at the default scale it frees no row); a zero scale
    gives dq = dk = 0 exactly."""
    _f32_tiled_backward_holds_to_jax_grad(d, s, causal, sm_scale, seed=130)


@pytest.mark.parametrize("sm_scale", [None, 0.0, -0.3])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d, s", [(256, 300), (256, 65), (256, 1), (192, 65)])
def test_f32_tiled_backward_arithmetic_at_d256_holds_to_jax_grad(d, s, causal, sm_scale):
    """The float32 backward at D = 256 (the same register-tiled pair, one
    chunk of 256 columns; D = 192 zero-padded to 256 at the true D's
    scale, the gradients sliced back): held to ``jax.vjp`` of JAX's oracle
    by the rule above."""
    _f32_tiled_backward_holds_to_jax_grad(d, s, causal, sm_scale, seed=160)


@pytest.mark.parametrize("sm_scale", [None, 0.0, -0.3])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d, s", [(128, 300), (128, 65), (128, 1), (100, 300), (100, 65),
                                  (100, 1)])
def test_f32_onepass_backward_arithmetic_at_d128_holds_to_jax_grad(d, s, causal, sm_scale):
    """The float32 backward at D = 128 (``flash_bwd_f32_onepass_kernel``:
    dV and dK over the query tiles from the last one down, dQ by key
    blocks added in key-block order; D = 100 zero-padded to 128 at the
    true D's scale, the gradients sliced back): held to ``jax.vjp`` of
    JAX's oracle by the rule above."""
    _f32_tiled_backward_holds_to_jax_grad(d, s, causal, sm_scale, seed=180)


def _f32_tiled_backward_holds_to_jax_grad(d, s, causal, sm_scale, *, seed):
    import chip_smoke as cs

    shape = (1, s, 1, d)
    seed += s + d
    arrays = _qkv(shape, seed=seed) + _qkv(shape, seed=seed + 1)[:1]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    out, vjp = jax.vjp(lambda q, k, v: jatt.mha_reference(q, k, v, causal=causal,
                                                        sm_scale=sm_scale), jq, jk, jv)
    ref = [torch.from_numpy(np.array(g)) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in arrays)
    o = torch.from_numpy(np.array(out))
    lse = tatt.lse_reference(tq, tk, causal=causal, sm_scale=sm_scale)
    dp = tatt.padded_head_dim(d)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    padded = [tatt.pad_head_dim(t, dp) for t in (tq, tk, tv, o, tdo)]
    if dp == 128:
        got = emulate_f32_onepass_backward(*padded, lse, causal=causal, sm_scale=scale)
    else:
        chunk = next(x for x in (512, 384, 256, 128) if dp % x == 0)
        got = emulate_f32_tiled_backward(*padded, lse, causal=causal, sm_scale=scale,
                                         chunk=chunk)
    got = [g[..., :d] for g in got]
    bounds = cs.float64_reference(tq, tk, tv, o, tdo, lse, causal, sm_scale)[3]
    for name, g, r, b in zip("qkv", got, ref, bounds):
        assert g.dtype == torch.float32 and g.shape == shape
        assert bool(torch.isfinite(g).all())
        if sm_scale == 0.0 and name != "v":
            assert not g.any() and not r.any()
            continue
        err, top, zero = tatt.gradient_row_errors(g, r, f"d{name}", causal=causal)
        floor = GRAD_TOL_F32 * top + GRAD_ATOL * zero
        bound = cs.GRAD_ARITH_MARGIN * b.amax(-1).float()
        if sm_scale is None:
            assert not bool((bound > floor).any()), f"d{name}: the bound frees a row"
        over = float((err / torch.maximum(floor, bound)).max())
        assert over <= 1.0, f"d{name}: worst row {over} times its limit"


def test_fma_dots_sums_pieces_of_fma_chains_in_column_order():
    """``fma_dots`` sums each element in column order, one rounding to
    float32 a step within a piece: equal to the product within float32
    rounding, bit for bit the float32 sum where every partial sum and
    product is exact (small integers), and rounding at every step of a
    chain but only once where a piece's sum meets the total."""
    rng = np.random.default_rng(15)
    a, b = (torch.from_numpy(rng.standard_normal((2, 5, 256)).astype(np.float32))
            for _ in range(2))
    for block in (64, None):
        torch.testing.assert_close(fma_dots(a, b, block), a @ b.transpose(-1, -2),
                                   rtol=1e-5, atol=1e-5)
    ai, bi = (torch.from_numpy(rng.integers(-8, 8, (3, 4, 128)).astype(np.float32))
              for _ in range(2))
    assert torch.equal(fma_dots(ai, bi), ai @ bi.transpose(-1, -2))
    # 1 + 2^-24 rounds to 1 (ties to even): twice in one chain, once where
    # the second piece's 2^-23 meets the first's 1
    x = torch.tensor([1.0, 2.0 ** -24, 2.0 ** -24, 0.0])
    assert fma_dots(x[None], torch.ones(1, 4), None)[0, 0] == 1.0
    assert fma_dots(x[None], torch.ones(1, 4), 2)[0, 0] == 1.0
    y = torch.tensor([1.0, 0.0, 2.0 ** -24, 2.0 ** -24])
    assert fma_dots(y[None], torch.ones(1, 4), 2)[0, 0] == 1.0 + 2.0 ** -23


@pytest.mark.parametrize("case", [(2, 300, 2, 256, False, None), (2, 65, 1, 192, True, -0.3),
                                  (2, 200, 2, 512, False, None), (1, 65, 1, 300, True, -0.3),
                                  (1, 65, 1, 1024, True, None), (2, 300, 2, 128, True, None),
                                  (2, 65, 1, 100, False, -0.3)])
def test_f32_tiled_forward_emulation_matches_the_plain_version(case):
    """The emulated float32 forward (at D = 128 and 256, and past it the
    split kernel's, by chunks of 512 columns at D = 1024; D = 100 padded
    to 128) and its lse against the port's plain versions on the same
    inputs, within F32: the two differ only in the order of their float32
    sums."""
    b, s, h, d, causal, sm_scale = case
    q, k, v = (torch.from_numpy(a) for a in _qkv((b, s, h, d), seed=140 + s))
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    dp = tatt.padded_head_dim(d)
    out, lse = emulate_f32_tiled_forward(*(tatt.pad_head_dim(t, dp) for t in (q, k, v)),
                                         causal=causal, sm_scale=scale, **f32_forward_layout(dp))
    torch.testing.assert_close(out[..., :d], tatt.mha_reference(q, k, v, causal=causal,
                                                              sm_scale=sm_scale), **F32)
    torch.testing.assert_close(lse, tatt.lse_reference(q, k, causal=causal, sm_scale=sm_scale),
                               **F32)


@pytest.mark.parametrize("case", [(2, 300, 2, 128, True, None), (1, 200, 1, 100, False, -0.3),
                                  (1, 65, 2, 128, True, 0.0)])
def test_f32_onepass_backward_emulation_matches_the_plain_version(case):
    """The emulated float32 one-pass backward at D = 128 (D = 100 padded
    to it) against the port's plain backward on the same inputs: every
    row of dq, dk and dv within GRAD_TOL_F32 of its largest element (the
    two differ only in the order of their float32 sums)."""
    b, s, h, d, causal, sm_scale = case
    arrays = _qkv((b, s, h, d), seed=190 + s) + _qkv((b, s, h, d), seed=191 + s)[:1]
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o = tatt.mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    lse = tatt.lse_reference(q, k, causal=causal, sm_scale=sm_scale)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    got = emulate_f32_onepass_backward(*(tatt.pad_head_dim(t, 128) for t in (q, k, v, o, do)),
                                       lse, causal=causal, sm_scale=scale)
    ref = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=causal, sm_scale=sm_scale)
    for name, g, r in zip("qkv", got, ref):
        assert_rows_close_of_max(g[..., :d], r, GRAD_TOL_F32, f"d{name}", causal=causal,
                                 atol=GRAD_ATOL)


def test_f32_onepass_backward_sums_in_the_kernels_orders():
    """The one-pass emulation's orders of sums, where float32 rounding
    tells them apart: dQ is each key block's part added in key-block order
    (a first block's -2^30 absorbs each later block's -64 in turn, where
    the later parts first would leave -(2^30 + 256)); dV sums the query
    tiles from the last one down (the last tile's 2^30 absorbs each earlier
    query's 1, where the queries in order would leave 2^30 + 256)."""
    s, d = 256, 128
    q, k, v, o, do = (torch.zeros((1, s, 1, d)) for _ in range(5))
    # q = 0 and lse = 0: P = 1 on every pair; v = 0: dP = 0, so dS = -delta
    # = -o . dO = -1
    o[..., 0] = do[..., 0] = 1.0
    k[0, :64, 0, 1] = 2.0 ** 24      # the first key block's keys
    k[0, 64:, 0, 1] = 1.0
    do[0, 192:, 0, 2] = 2.0 ** 24    # the last query tile's rows
    do[0, :192, 0, 2] = 1.0
    lse = torch.zeros((1, 1, s))
    dq, dk, dv = emulate_f32_onepass_backward(q, k, v, o, do, lse, causal=False, sm_scale=1.0)
    assert bool((dq[0, :, 0, 1] == -(2.0 ** 30)).all()), dq[0, :4, 0, 1]
    assert bool((dv[0, :, 0, 2] == 2.0 ** 30).all()), dv[0, :4, 0, 2]
    assert bool((dv[0, :, 0, 0] == s).all()) and not dk[..., 1:].any()
    # the other orders round otherwise
    parts = [torch.tensor(-(2.0 ** 30))] + [torch.tensor(-64.0)] * 3
    assert float(parts[1] + parts[2] + parts[3] + parts[0]) == -(2.0 ** 30 + 256)
    rows = torch.tensor(192.0) + torch.tensor(2.0 ** 30)
    assert float(rows) == 2.0 ** 30 + 256


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_cuda_f32_tiled_backward_is_bitwise_deterministic(d, causal):
    """The float32 backward at D = 128 (dQ added over key blocks in their
    order by turn counters), at D = 256 and past it (each gradient element
    summed by one thread in a fixed order) uses no atomics in an order that
    varies: two calls on the same inputs give the same bits."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(11)
    qkv = torch.randn((1, 1000, 3, 1, d), device="cuda", generator=gen)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((1, 1000, 1, d), device="cuda", generator=gen)
    o, lse = tatt.flash_attention_forward(q, k, v, causal=causal)
    first = tatt.flash_attention_backward(q, k, v, o, do, lse, causal=causal)
    second = tatt.flash_attention_backward(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    for name, x, y in zip("qkv", first, second):
        assert torch.equal(x, y), f"d{name} differs between two calls"


@pytest.mark.gpu
@pytest.mark.parametrize("d", [192, 256, 300, 512, 1024])
def test_cuda_float32_past_128_takes_the_tiled_kernels(d):
    """float32 at D = 129 to 256 runs the register-tiled forward
    (``flash_attention_f32_tiled_kernel``) and past 256 its split over two
    groups of warps (``flash_attention_f32_split_kernel<C, kStreamQ>``:
    C = 384 or 512 with Q resident at D = 384 and 512, chunks of 512
    columns with Q streamed past 512); from D = 129 on the register-tiled
    backward pair (``flash_bwd_{dkdv,dq}_f32_tiled_kernel<C>``, C the
    widest of 512, 384, 256 and 128 that divides the padded D), by the
    profiler's kernel names through autograd; none of the kernels they
    replaced runs."""
    _cuda_or_skip()
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(12)
    qkv = torch.randn((1, 300, 3, 1, d), device="cuda", generator=gen).requires_grad_(True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tatt.flash_attention(q, k, v, causal=True).square().sum().backward()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and "flash" in e.key]
    dp = tatt.padded_head_dim(d)
    if dp == 256:
        assert any("flash_attention_f32_tiled_kernel" in n for n in names), names
    else:
        split = "384" if dp == 384 else "512"
        assert any("flash_attention_f32_split_kernel" in n and split in n for n in names), names
    chunk = next(str(x) for x in (512, 384, 256, 128) if dp % x == 0)
    want = ("flash_bwd_dkdv_f32_tiled_kernel", "flash_bwd_dq_f32_tiled_kernel")
    assert all(any(w in n and chunk in n for n in names) for w in want), names
    for old in ("flash_attention_f32_kernel", "flash_attention_f32_wide_kernel",
                "flash_bwd_dkdv_f32_kernel", "flash_bwd_dq_f32_kernel"):
        assert not any(old in n for n in names), (old, names)
    assert bool(torch.isfinite(qkv.grad).all()) and bool(qkv.grad.any())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [100, 128])
def test_cuda_float32_at_128_takes_the_register_tiled_forward_and_one_pass_backward(d):
    """float32 at D = 65 to 128 runs the register-tiled forward's D = 128
    instantiation (``flash_attention_f32_tiled_kernel<128>``) and the
    one-pass backward (``flash_bwd_f32_onepass_kernel``), by the profiler's
    kernel names through autograd; none of the one-thread-a-row kernels
    they replaced (``flash_attention_f32_kernel<128>``,
    ``flash_bwd_{dkdv,dq}_f32_kernel<128>``) nor the tiled pair runs."""
    _cuda_or_skip()
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(13)
    qkv = torch.randn((1, 300, 3, 2, d), device="cuda", generator=gen).requires_grad_(True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tatt.flash_attention(q, k, v, causal=True).square().sum().backward()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and "flash" in e.key]
    assert any("flash_attention_f32_tiled_kernel" in n and "128" in n for n in names), names
    assert any("flash_bwd_f32_onepass_kernel" in n for n in names), names
    for old in ("flash_attention_f32_kernel", "flash_bwd_dkdv_f32", "flash_bwd_dq_f32"):
        assert not any(old in n for n in names), (old, names)
    assert bool(torch.isfinite(qkv.grad).all()) and bool(qkv.grad.any())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
def test_cuda_float32_register_tiled_kernels_read_misaligned_views(d):
    """The register-tiled float32 kernels copy q, k, v (and dO) 16 bytes at
    a time only where every row starts 16-byte aligned, else 4 bytes at a
    time: views whose base lies one float past a 16-byte boundary give the
    plain version's output, lse and gradients."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(14)
    b, s, h = 1, 300, 2
    flat = torch.randn(3 * b * s * h * d + 1, device="cuda", generator=gen)
    q, k, v = flat[1:].view(3, b, s, h, d).unbind(0)
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    do = torch.randn((b, s, h, d), device="cuda", generator=gen)
    o, lse = tatt.flash_attention_forward(q, k, v, causal=True)
    got = tatt.flash_attention_backward(q, k, v, o, do, lse, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, tatt.mha_reference(q, k, v, causal=True), **F32)
    torch.testing.assert_close(lse, tatt.lse_reference(q, k, causal=True),
                               rtol=1e-4, atol=1e-4)
    ref = tatt.mha_backward_reference(q, k, v, o, do, lse, causal=True)
    for name, g, r in zip("qkv", got, ref):
        assert_rows_close_of_max(g, r, GRAD_TOL_F32, f"d{name}", causal=True, atol=GRAD_ATOL)


def test_float32_at_d128_takes_the_register_tiled_kernels_in_source():
    """Both sources route float32 at D = 128 to the register-tiled designs:
    the forward's ``launch_f32_tiled<D>`` (the kernel templated on D, a
    lane's O columns D / 32) and the backward's one-pass kernel with its
    turn counters in the scratch; the one-thread-a-row forward and backward
    pair stay for D <= 64 only."""
    from sitewhere_tpu_torch import cuda_build

    fwd = (cuda_build.CSRC / "flash_attention.cu").read_text()
    bwd = (cuda_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "} else if constexpr (D >= 128) {\n    return launch_f32_tiled<D>(" in fwd
    assert 'static_assert(D == 128 || D == 256, "the register-tiled forward' in fwd
    assert 'static_assert(D <= 64, "D = 128 and 256 have the register-tiled kernel");' in fwd
    assert "static constexpr int kCols = D / 32;" in fwd
    # one predicate routes D = 128 to the one-pass kernel and gives it the
    # scratch's turn counters
    assert "constexpr bool f32_onepass(int d) { return d == 128; }" in bwd
    assert "else if constexpr (f32_onepass(D))\n        return launch_f32_onepass(a);" in bwd
    assert "flash_bwd_f32_onepass_kernel<<<" in bwd
    assert "static_assert(D <= 64, \"D = 128 takes the one-pass kernel" in bwd
    assert "const bool onepass = dtype == 0 && f32_onepass(static_cast<int>(d));" in bwd
    assert "launch_f32_tiled<128>(a)" in bwd   # still the chunk past 256 where 256 does not divide D


def test_c6_profiler_check_names_the_float32_kernels():
    """``chip_smoke.py``'s C6 phase reads the kernels that ran at its
    float32 timed shapes from the profiler's names (demangled or mangled,
    ``_kernel_name``) and holds them to ``TF_C6_TAKES``: the register-tiled
    forward at D = 256, the split forward at D = 512 and the register-tiled
    backward pair at both (by chunks of 256 and 512 columns) pass; the
    kernels they replaced, or a missing one, fail."""
    import chip_smoke as cs

    ns = "void (anonymous namespace)::"
    args = "(float const*, float const*, float const*, float*, float*, int)"
    new = {"d128_f32": [f"{ns}flash_attention_f32_tiled_kernel<128>{args}",
                        f"{ns}flash_bwd_f32_onepass_kernel{args}"],
           "d256_f32": [f"{ns}flash_attention_f32_tiled_kernel<256>{args}",
                        f"{ns}flash_bwd_dkdv_f32_tiled_kernel<256>{args}",
                        f"{ns}flash_bwd_dq_f32_tiled_kernel<256>{args}"],
           "d512_f32": [f"{ns}flash_attention_f32_split_kernel<512, false>{args}",
                        "_ZN12_GLOBAL__N_131flash_bwd_dkdv_f32_tiled_kernelILi512EEEvPKfS2_",
                        f"{ns}flash_bwd_dq_f32_tiled_kernel<512>{args}"]}
    old = {"d128_f32": [f"{ns}flash_attention_f32_kernel<128>{args}",
                        f"{ns}flash_bwd_dkdv_f32_kernel<128>{args}",
                        f"{ns}flash_bwd_dq_f32_kernel<128>{args}",
                        f"{ns}flash_bwd_dkdv_f32_tiled_kernel<128>{args}",
                        f"{ns}flash_bwd_dq_f32_tiled_kernel<128>{args}"],
           "d256_f32": [f"{ns}flash_attention_f32_kernel<256>{args}",
                        f"{ns}flash_bwd_dkdv_f32_kernel<256>{args}",
                        f"{ns}flash_bwd_dq_f32_kernel<256>{args}"],
           "d512_f32": [f"{ns}flash_attention_f32_wide_kernel{args}",
                        f"{ns}flash_bwd_dkdv_f32_wide_kernel{args}",
                        f"{ns}flash_bwd_dq_f32_wide_kernel{args}"]}
    for name, keys in new.items():
        ran = [cs._kernel_name(k) for k in keys]
        assert cs._takes(ran, name) == (True, []), (name, ran)
        assert not cs._takes(ran[:-1], name)[0]
        bad = cs._takes(ran + [cs._kernel_name(k) for k in old[name]], name)
        assert not bad[0] and len(bad[1]) == len(old[name]), bad
    assert cs._kernel_name(new["d512_f32"][1]) == "flash_bwd_dkdv_f32_tiled_kernel<512>"
