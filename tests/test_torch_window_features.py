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
* The CUDA kernel itself runs only on the card (``gpu`` marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ops import window_features as jwf
from sitewhere_tpu_torch.ops import window_features as twf

TOL = dict(rtol=2e-5, atol=2e-5)


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
                                   (4096, 128, 8), (3, 1, 5)])
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
def test_cuda_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a GPU")
    x = torch.zeros((4, 8, 3), device="cuda")
    with pytest.raises(TypeError):
        twf.window_features(x.double())
    with pytest.raises(ValueError):
        twf.window_features(x.transpose(1, 2))
