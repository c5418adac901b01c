"""The port's window features against the JAX package's.

* The plain PyTorch version against ``window_features_reference`` (jnp,
  two-pass ``jnp.std``): ``rtol = atol = 2e-5`` (float32 sums taken in
  another order), on standard-normal windows and on a large-offset ramp.
* Against the Pallas kernel run in interpret mode (as
  ``tests/test_models.py`` runs it): equal within the same tolerance on
  standard-normal windows. On windows with a large offset and a small
  spread the Pallas kernel's ``E[x^2] - mean^2`` cancels and its std is
  wrong by orders of magnitude; the port's plain version (and the CUDA
  kernel's Welford recurrence) stays with the stable reference. The test
  pins that divergence.
* The CUDA kernel's arithmetic, emulated here in float32 numpy: W split
  into 8 contiguous segments (one a thread), Welford in each with a
  multiply by the reciprocal of the count, the segments merged with Chan's
  formula in the kernel's butterfly order. Against both references within
  the kernel's tolerance on the card (``rtol = atol = 1e-4``): a float32
  running mean near 1e3 rounds by up to ulp(1e3) = 6e-5 at each update,
  which a two-pass reference does not. On offset windows too, and at
  W < 8 (empty segments) and W % 8 != 0.
* The CUDA kernel itself runs only on the card (``gpu`` marker), on its
  float4 path (C % 4 == 0) and its scalar path (C = 30, a misaligned
  pointer).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ops import window_features as jwf
from sitewhere_tpu_torch.ops import window_features as twf

TOL = dict(rtol=2e-5, atol=2e-5)
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)   # the CUDA kernel against its plain version


def _normal(shape=(100, 16, 8), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ramp(seed=1):
    """1e3 * (t + 1) plus unit noise — the wild device of the JAX package's
    analytics test."""
    t = np.arange(1, 17, dtype=np.float32)[None, :, None]
    noise = np.random.default_rng(seed).standard_normal((100, 16, 8))
    return (1e3 * t + noise).astype(np.float32)


def _offset(seed=2):
    """Offset 1e3, spread 0.1: E[x^2] ~ 1e6 leaves float32 no digits for a
    variance of 1e-2."""
    x = 1e3 + 0.1 * np.random.default_rng(seed).standard_normal((100, 16, 8))
    return x.astype(np.float32)


@pytest.mark.parametrize("make", [_normal, _ramp, _offset])
def test_plain_version_matches_jax_reference(make):
    x = make()
    ref = np.asarray(jwf.window_features_reference(jnp.asarray(x)))
    got = twf.window_features_reference(torch.from_numpy(x)).numpy()
    assert got.shape == (100, 8, twf.NUM_FEATURES)
    np.testing.assert_allclose(got, ref, **TOL)


def test_plain_version_matches_pallas_interpret():
    x = _normal()
    pal = np.asarray(jwf.window_features(jnp.asarray(x), tile_m=32,
                                         force_pallas=True))
    got = twf.window_features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, pal, **TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int32"])
def test_other_window_types_are_cast_as_the_pallas_kernel_casts(dtype):
    """The TPU kernel casts its windows to float32 (``astype``) and returns
    float32; so does the port, on the CPU and on the card alike."""
    x = np.round(_normal() * 8)
    jx = jnp.asarray(x).astype(dtype)
    pal = np.asarray(jwf.window_features(jx, tile_m=32, force_pallas=True))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = twf.window_features(tx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pal, **TOL)


def test_complex_windows_are_refused():
    with pytest.raises(TypeError, match="real windows"):
        twf.window_features(torch.zeros((2, 4, 3), dtype=torch.complex64))


def test_pallas_std_cancels_on_offset_windows_where_port_does_not():
    x = _offset()
    ref = np.asarray(jwf.window_features_reference(jnp.asarray(x)))
    pal = np.asarray(jwf.window_features(jnp.asarray(x), tile_m=32,
                                         force_pallas=True))
    got = twf.window_features(torch.from_numpy(x)).numpy()
    std = ref[..., 1]
    pal_err = np.max(np.abs(pal[..., 1] - std) / std)
    port_err = np.max(np.abs(got[..., 1] - std) / std)
    assert pal_err > 1.0          # the Pallas E[x^2]-mean^2 std is garbage
    assert port_err < 1e-4
    # the other five features agree with the Pallas kernel
    keep = [0, 2, 3, 4, 5]
    np.testing.assert_allclose(got[..., keep], pal[..., keep], **TOL)


def emulate_segmented_welford(x: np.ndarray, segments: int = 8) -> np.ndarray:
    """Kernel B1's arithmetic in float32: [M, W, C] -> [M, C, 6]. Segment
    ``i`` takes timesteps [W·i/segments, W·(i+1)/segments); each runs
    Welford with ``mean += d · (1/n)``; segments merge pairwise, partner
    ``i ^ 1``, ``i ^ 2``, then ``i ^ 4`` (the kernel's shuffles), by Chan's formula
    with B's share ``nb / (na + nb)`` (0 for an empty B); first and last
    from the windows' ends."""
    f32 = np.float32
    x = np.asarray(x, f32)
    m, w, c = x.shape
    stats = []
    for i in range(segments):
        begin, end = w * i // segments, w * (i + 1) // segments
        mean, m2 = np.zeros((m, c), f32), np.zeros((m, c), f32)
        for j, t in enumerate(range(begin, end)):
            v = x[:, t]
            d = v - mean
            mean = mean + d * (f32(1) / f32(j + 1))
            m2 = m2 + d * (v - mean)
        stats.append((f32(end - begin), mean, m2))
    off = 1
    while off < segments:
        merged = []
        for i in range(segments):
            (na, ma, m2a), (nb, mb, m2b) = stats[i], stats[i ^ off]
            share = nb / (na + nb) if nb > 0 else f32(0)
            delta = mb - ma
            merged.append((na + nb, ma + delta * share,
                           m2a + m2b + delta * delta * (na * share)))
        stats, off = merged, off * 2
    _, mean, m2 = stats[0]
    last, first = x[:, -1], x[:, 0]
    return np.stack([mean, np.sqrt(m2 / f32(w)), x.min(1), x.max(1), last,
                     last - first], -1)


def _short(seed=4):
    return _normal((50, 3, 8), seed)          # W < 8: empty segments


def _uneven(seed=5):
    return _offset(seed)[:, :13] * _normal((100, 13, 8), seed)   # W % 8 != 0


@pytest.mark.parametrize("make", [_normal, _ramp, _offset, _short, _uneven])
def test_kernel_segment_merge_matches_both_references(make):
    x = make()
    got = emulate_segmented_welford(x)
    assert got.dtype == np.float32 and got.shape == (x.shape[0], x.shape[2], 6)
    np.testing.assert_allclose(
        got, twf.window_features_reference(torch.from_numpy(x)).numpy(), **KERNEL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jwf.window_features(jnp.asarray(x))), **KERNEL_TOL)


def test_normalize_windows_matches_jax():
    x = _normal(seed=3)
    jf = jwf.window_features_reference(jnp.asarray(x))
    tf = twf.window_features(torch.from_numpy(x))
    np.testing.assert_allclose(
        twf.normalize_windows(torch.from_numpy(x), tf).numpy(),
        np.asarray(jwf.normalize_windows(jnp.asarray(x), jf)), **TOL)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    before = twf.window_features.launches
    x = torch.from_numpy(_normal((5, 4, 3)))
    torch.testing.assert_close(twf.window_features(x),
                               twf.window_features_reference(x), rtol=0, atol=0)
    assert twf.window_features.launches == before


def test_kernel_source_is_plain_c_for_sm90a():
    """The kernel is built from the repo's source with a plain C entry point
    (ctypes route) for sm_90a."""
    from sitewhere_tpu_torch import cuda_build

    src = (cuda_build.CSRC / "window_features.cu").read_text()
    assert 'extern "C" int swtpu_window_features(' in src
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert "torch/extension.h" not in src


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8192, 128, 100), (1237, 128, 100),
                                   (4096, 128, 8), (3, 1, 5), (1024, 128, 30),
                                   (5, 3, 30)])
def test_cuda_kernel_matches_plain_version(shape):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, device="cuda", generator=gen)
    before = twf.window_features.launches
    got = twf.window_features(x)
    torch.cuda.synchronize()
    assert twf.window_features.launches == before + 1
    torch.testing.assert_close(got, twf.window_features_reference(x),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_kernel_scalar_path_on_a_misaligned_pointer():
    """C % 4 == 0 but the windows start 4 bytes past a 16-byte boundary:
    the kernel takes its scalar path and still agrees."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a GPU")
    gen = torch.Generator(device="cuda").manual_seed(1)
    flat = torch.randn(64 * 128 * 100 + 1, device="cuda", generator=gen)
    x = flat[1:].view(64, 128, 100)
    assert x.data_ptr() % 16 != 0
    torch.testing.assert_close(twf.window_features(x), twf.window_features_reference(x),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_cuda_kernel_casts_other_window_types(dtype):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a GPU")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((1024, 128, 100), device="cuda", generator=gen).to(dtype)
    before = twf.window_features.launches
    got = twf.window_features(x)
    torch.cuda.synchronize()
    assert twf.window_features.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, twf.window_features_reference(x.float()),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a GPU")
    x = torch.zeros((4, 8, 3), device="cuda")
    with pytest.raises(TypeError):
        twf.window_features(x.to(torch.complex64))
    with pytest.raises(ValueError):
        twf.window_features(x.transpose(1, 2))
