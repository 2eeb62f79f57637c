"""Port parity: kmsr_tpu_torch.ops.{sigma,nlm} vs kmsr_tpu.ops.{sigma,nlm}.

The same seeded numpy inputs go through the JAX function and its port
(device="cpu": the same torch code the card runs). JAX's
`nlm_denoise_2d` is called with unroll=1 (its own static argument: the
same arithmetic, compiled in a fraction of the default unroll's time on
a CPU); the goldens in tests/fixtures/denoise_golden/ are held at
the JAX suite's own bounds, and the brute-force definition
(tests/helpers/nlm_bruteforce.py) at rtol 1e-4 / atol 1e-5. The
per-band / per-stack / batch contracts are held against JAX's numpy path
(use_device=False), which needs no compile.
"""
import glob
import os

import numpy as np
import pytest
import torch

from kmsr_tpu.ops import nlm as jnlm
from kmsr_tpu.ops import sigma as jsigma
from kmsr_tpu_torch.ops import nlm as tnlm
from kmsr_tpu_torch.ops import sigma as tsigma
from tests.helpers.nlm_bruteforce import nlm_bruteforce

TOL = dict(rtol=1e-4, atol=1e-5)
#: sigma parity; below 1e-7 (a smooth image) both float32 versions give
#: rounding residue, held to that absolute bound
SIGMA = dict(rel=1e-5, abs=1e-7)
_GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "denoise_golden")
_GOLDEN_FILES = sorted(glob.glob(os.path.join(_GOLDEN_DIR, "*.npz")))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _jax_nlm(img, h, sigma, ps=jnlm.PATCH_SIZE, pd=jnlm.PATCH_DISTANCE):
    return np.asarray(jnlm.nlm_denoise_2d(img, h, sigma, patch_size=ps,
                                          patch_distance=pd, unroll=1))


def _images():
    rng = np.random.default_rng(3)
    yy, xx = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 64))
    half = rng.normal(2.0, 0.3, (48, 48))
    half[:, :24] = 1.5  # a constant (NaN-filled-like) region: exact-zero HH
    return {
        "white_noise": rng.normal(0, 0.37, (128, 128)),
        "smooth": np.sin(3 * xx) + yy**2,
        "structured": 5 * np.sin(4 * xx) * np.cos(3 * yy) + rng.normal(0, 0.2, xx.shape),
        "half_constant": half,
        "odd_shape": rng.normal(1.0, 0.1, (37, 29)),
    }


def test_db2_constants_equal_jax():
    np.testing.assert_array_equal(tsigma._DB2_LO, jsigma._DB2_LO)
    np.testing.assert_array_equal(tsigma._DB2_HI, jsigma._DB2_HI)
    assert tsigma._MAD_TO_SIGMA == jsigma._MAD_TO_SIGMA


@pytest.mark.parametrize("name", sorted(_images()))
def test_estimate_sigma_matches_jax(name):
    img = _images()[name].astype(np.float32)
    got = float(tsigma.estimate_sigma(_t(img)))
    want = float(jsigma.estimate_sigma(img))
    assert got == pytest.approx(want, **SIGMA)
    np.testing.assert_allclose(tsigma.hh_subband(_t(img)).numpy(),
                               jsigma.hh_subband_np(img), rtol=1e-5, atol=1e-6)
    if name == "half_constant":
        # float32 (JAX's device path, the port) leaves the constant half's
        # HH exactly zero and drops it; the float64 reference keeps ~1e-17
        # residues there, which pull its median far down
        assert got == pytest.approx(0.3, rel=0.25)
        assert jsigma.estimate_sigma_np(img) < 0.1
    elif name == "smooth":
        assert got < 5e-3 and jsigma.estimate_sigma_np(img) < 5e-3
    else:
        assert got == pytest.approx(jsigma.estimate_sigma_np(img), rel=1e-3)
    if name == "white_noise":
        assert got == pytest.approx(0.37, rel=0.08)


@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
def test_pad_index_equals_numpy(mode):
    """The padded index maps (built on the device) equal np.pad's, pads
    wider than the side included (sigma's symmetric 3, the NLM's reflect
    14 on small images)."""
    for n in range(1, 14):
        for pad in range(0, 31):
            np.testing.assert_array_equal(
                tsigma.pad_index(n, pad, mode, torch.device("cpu")).numpy(),
                np.pad(np.arange(n), pad, mode=mode), err_msg=f"n={n} pad={pad}")


@pytest.mark.parametrize("value", [0.0, 1.0, 3.7, 5.0, 123.456])
def test_estimate_sigma_constant_image(value):
    """An exactly constant image: sigma 0 up to rounding residue (0 or
    ~1e-15 in float32, ~1e-30 in the float64 reference); the port keeps
    JAX's residue exactly."""
    img = np.full((32, 32), value, np.float32)
    got = float(tsigma.estimate_sigma(_t(img)))
    assert got == float(jsigma.estimate_sigma(img))
    assert abs(got) < 1e-12
    assert abs(tsigma.estimate_sigma_np(img)) < 1e-12


def test_estimate_sigma_even_count_takes_the_mean_of_the_middle_pair():
    """62x62 gives a 32x32 HH subband, 1024 non-zero values: the median is
    the mean of the two middle ones (numpy, jnp.nanmedian), which the lower
    middle value (torch.nanmedian) misses."""
    img = np.random.default_rng(5).normal(0, 1.0, (62, 62)).astype(np.float32)
    hh = tsigma.hh_subband(_t(img)).abs().flatten()
    assert hh.shape == (1024,) and bool((hh != 0).all())
    got = float(tsigma.estimate_sigma(_t(img)))
    assert got == pytest.approx(float(jsigma.estimate_sigma(img)), **SIGMA)
    lower = float(torch.nanmedian(hh)) * tsigma._MAD_TO_SIGMA
    assert abs(lower - got) / got > 1e-5


def test_estimate_sigma_batched_equals_per_image():
    x = np.random.default_rng(6).normal(0, 1, (3, 2, 40, 36)).astype(np.float32)
    x[1, 0, :, :20] = 0.5  # a different kept count in one image
    got = tsigma.estimate_sigma(_t(x))
    assert got.shape == (3, 2) and got.dtype == torch.float32
    for i in range(3):
        for c in range(2):
            assert float(got[i, c]) == pytest.approx(
                float(tsigma.estimate_sigma(_t(x[i, c]))), rel=1e-6)
            assert float(got[i, c]) == pytest.approx(
                float(jsigma.estimate_sigma(x[i, c])), **SIGMA)


@pytest.mark.parametrize("ps,pd,h,sigma", [(3, 3, 0.4, 0.2), (5, 4, 0.6, 0.0)])
def test_nlm_matches_jax_and_bruteforce(ps, pd, h, sigma):
    img = np.random.default_rng(0).normal(2.0, 0.5, (16, 16)).astype(np.float32)
    got = tnlm.nlm_denoise_2d(_t(img), h, sigma, ps, pd).numpy()
    np.testing.assert_allclose(got, nlm_bruteforce(img, h, sigma, ps, pd), **TOL)
    np.testing.assert_allclose(got, _jax_nlm(img, h, sigma, ps, pd), **TOL)
    np.testing.assert_allclose(tnlm.nlm_denoise_np(img, h, sigma, ps, pd),
                               jnlm.nlm_denoise_np(img, h, sigma, ps, pd),
                               rtol=0, atol=0)


def test_nlm_per_image_h_and_sigma_over_a_batch():
    rng = np.random.default_rng(1)
    x = rng.normal(3.0, 0.4, (2, 3, 12, 14)).astype(np.float32)
    h = np.array([[0.3, 0.5, 0.7], [0.4, 0.0, 0.9]], np.float32)
    sigma = np.array([0.1, 0.2, 0.0], np.float32)  # broadcast over the files
    got = tnlm.nlm_denoise_2d(_t(x), _t(h), _t(sigma), 3, 4).numpy()
    np.testing.assert_allclose(got, _jax_nlm(x, h, sigma, 3, 4), **TOL)
    for i in range(2):
        for c in range(3):
            one = tnlm.nlm_denoise_2d(_t(x[i, c]), float(h[i, c]), float(sigma[c]), 3, 4)
            np.testing.assert_allclose(got[i, c], one.numpy(), rtol=1e-6, atol=1e-6)


def test_nlm_pad_wider_than_the_image():
    """10x10 at the defaults: the reflect pad (11 + 3 = 14) exceeds the
    side, which F.pad refuses and jnp.pad / np.pad take. The port equals
    JAX's device path and the brute-force definition; its numpy reference
    too (the JAX package's numpy copy slices its border mask with a
    negative stop at shifts longer than the side, and does not)."""
    img = np.random.default_rng(2).normal(2.0, 0.5, (10, 10)).astype(np.float32)
    h, sigma = 0.5, 0.2
    got = tnlm.nlm_denoise_2d(_t(img), h, sigma).numpy()
    brute = nlm_bruteforce(img, h, sigma, 7, 11)
    np.testing.assert_allclose(got, _jax_nlm(img, h, sigma), **TOL)
    np.testing.assert_allclose(got, brute, **TOL)
    np.testing.assert_allclose(tnlm.nlm_denoise_np(img, h, sigma), brute,
                               rtol=1e-10, atol=1e-12)
    assert np.abs(jnlm.nlm_denoise_np(img, h, sigma) - brute).max() > 1e-3


@pytest.mark.parametrize(
    "path", _GOLDEN_FILES, ids=[os.path.basename(p) for p in _GOLDEN_FILES]
)
def test_against_skimage_golden(path):
    """The assertions of tests/test_denoise.py's golden test, on the port."""
    z = np.load(path)
    img = z["img"]
    sig = float(tsigma.estimate_sigma(_t(img)))
    assert sig == pytest.approx(float(z["sigma"]), rel=1e-3)
    den = tnlm.nlm_denoise_2d(
        _t(img), float(z["h"]), float(z["sigma"]),
        patch_size=int(z["patch_size"]), patch_distance=int(z["patch_distance"]),
    ).numpy()
    scale = float(np.std(img)) or 1.0
    rmse_exact = float(np.sqrt(np.mean((den - z["denoised_exact"]) ** 2)))
    assert rmse_exact / scale < 1e-3, f"RMSE vs exact-exp golden {rmse_exact}"
    rmse_sk = float(np.sqrt(np.mean((den - z["denoised_skimage"]) ** 2)))
    assert rmse_sk / scale < 3e-3, f"RMSE vs skimage-internals golden {rmse_sk}"


def test_denoise_band_nan_contract():
    """A 5x5 hole: NaNs restored, the rest finite, against JAX's device
    path (its estimate, then its NLM at h = h_factor * sigma); with
    scattered one-pixel holes also against JAX's numpy path. (The mean
    fill of a wide hole makes HH coefficients that are exactly 0 in
    float32 and ~1e-17 in the float64 reference, which keeps them: its
    sigma then differs by a few per cent.)"""
    rng = np.random.default_rng(4)
    band = rng.normal(3.0, 0.2, (40, 40)).astype(np.float32)
    band[:5, :5] = np.nan
    den, sig = tnlm.denoise_band(band, h_factor=1.8, device="cpu")
    assert np.isnan(den[:5, :5]).all() and np.isfinite(den[5:, 5:]).all()
    assert sig > 0 and isinstance(sig, float)
    filled = np.where(np.isnan(band), np.float32(np.nanmean(band)), band)
    want_sig = float(jsigma.estimate_sigma(filled))
    assert sig == pytest.approx(want_sig, **SIGMA)
    want = np.where(np.isnan(band), np.nan,
                    _jax_nlm(filled, np.float32(want_sig) * np.float32(1.8), want_sig))
    np.testing.assert_allclose(den, want, equal_nan=True, **TOL)

    band = rng.normal(3.0, 0.2, (40, 40)).astype(np.float32)
    band.flat[rng.choice(band.size, 30, replace=False)] = np.nan
    den, sig = tnlm.denoise_band(band, h_factor=1.8, device="cpu")
    want, want_sig = jnlm.denoise_band(band, h_factor=1.8, use_device=False)
    assert sig == pytest.approx(want_sig, rel=1e-3)
    np.testing.assert_allclose(den, want, equal_nan=True, **TOL)
    np.testing.assert_array_equal(np.isnan(den), np.isnan(band))
    ref, ref_sig = tnlm.denoise_band_np(band, h_factor=1.8)
    np.testing.assert_array_equal(ref, want)
    assert ref_sig == want_sig


def test_denoise_band_all_nan():
    band = np.full((16, 16), np.nan, np.float32)
    for den, sig in (tnlm.denoise_band(band, device="cpu"), tnlm.denoise_band_np(band)):
        assert np.isnan(den).all() and sig == 0.0


def test_denoise_stack_against_jax_numpy_reference():
    """denoise_stack(device="cpu") vs JAX's numpy path band by band, with a
    NaN hole and an all-NaN band (passed through bit for bit, sigma 0.0);
    the port's numpy path equals JAX's exactly."""
    stack = np.random.default_rng(7).normal(3.0, 0.3, (3, 24, 24)).astype(np.float32)
    stack[0, 3:7, 10:15] = np.nan
    stack[2] = np.nan
    den, sig = tnlm.denoise_stack(stack, h_factor=1.5, device="cpu")
    want, want_sig = jnlm.denoise_stack(stack, h_factor=1.5, use_device=False)
    assert den.shape == stack.shape and den.dtype == np.float32 and len(sig) == 3
    assert all(isinstance(s, float) for s in sig)
    np.testing.assert_allclose(den, want, equal_nan=True, **TOL)
    np.testing.assert_allclose(sig, want_sig, rtol=1e-3)
    np.testing.assert_array_equal(np.isnan(den), np.isnan(stack))
    np.testing.assert_array_equal(den[2], stack[2])
    assert sig[2] == 0.0
    ref, ref_sig = tnlm.denoise_stack_np(stack, h_factor=1.5)
    np.testing.assert_array_equal(ref, want)
    assert ref_sig == want_sig


def test_denoise_batch_matches_per_stack():
    stacks = np.random.default_rng(8).normal(3.0, 0.2, (3, 2, 24, 24)).astype(np.float32)
    stacks[1, 0, :4, :4] = np.nan
    stacks[2, 1] = np.nan
    den_b, sig_b = tnlm.denoise_batch(stacks, h_factor=1.5, device="cpu")
    assert den_b.shape == stacks.shape and sig_b.shape == (3, 2)
    assert sig_b.dtype == np.float32 and sig_b[2, 1] == 0.0
    for i in range(3):
        den_s, sig_s = tnlm.denoise_stack(stacks[i], h_factor=1.5, device="cpu")
        np.testing.assert_allclose(den_b[i], den_s, rtol=1e-5, atol=1e-6, equal_nan=True)
        np.testing.assert_allclose(sig_b[i], sig_s, rtol=1e-5)
    assert np.isnan(den_b[1, 0, :4, :4]).all()
    np.testing.assert_array_equal(den_b[2, 1], stacks[2, 1])
    handle = tnlm.denoise_batch_dispatch(stacks, h_factor=1.5, device="cpu")
    den_h, sig_h = tnlm.denoise_batch_finalize(handle)
    np.testing.assert_allclose(den_h, den_b, rtol=1e-6, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(sig_h, sig_b, rtol=1e-6)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the check is for machines without one")
    band = np.ones((16, 16), np.float32)
    for call in (lambda: tnlm.denoise_band(band),
                 lambda: tnlm.denoise_band(np.full_like(band, np.nan)),
                 lambda: tnlm.denoise_stack(band[None]),
                 lambda: tnlm.denoise_batch(band[None, None]),
                 lambda: tnlm.denoise_batch_dispatch(band[None, None])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
