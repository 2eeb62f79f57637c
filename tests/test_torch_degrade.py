"""Port parity: kmsr_tpu_torch.ops.degrade vs kmsr_tpu.ops.degrade.

The same seeded numpy inputs go through the JAX function and its PyTorch
counterpart (CPU); tolerance rtol 1e-4 / atol 1e-5, the degrade family's
(`tests/test_degrade_pallas.py`).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu_torch.ops import degrade as tdeg

# the module (kmsr_tpu.ops re-exports a function of the same name)
jdeg = importlib.import_module("kmsr_tpu.ops.degrade")

TOL = dict(rtol=1e-4, atol=1e-5)
CASES = [(8, 13), (4, 13), (8, 5), (4, 5)]  # (factor, blur kernel size)


def _inputs(rng, factor, ksize, b=3, h=32):
    img = rng.normal(5, 2, (b, 5, h, h)).astype(np.float32)
    kernel = rng.uniform(0, 1, (5, ksize, ksize)).astype(np.float32)
    return img, kernel


@pytest.mark.parametrize("factor,ksize", CASES)
def test_degrade_matches_jax(rng, factor, ksize):
    img, kernel = _inputs(rng, factor, ksize)
    want = np.asarray(jdeg.degrade(jnp.asarray(img), jnp.asarray(kernel), factor=factor))
    got = tdeg.degrade(torch.from_numpy(img), torch.from_numpy(kernel), factor=factor)
    assert got.shape == want.shape == (3, 5, 32 // factor, 32 // factor)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("factor,ksize", CASES)
def test_degrade_strided_matches_jax(rng, factor, ksize):
    img, kernel = _inputs(rng, factor, ksize)
    want = np.asarray(jdeg.degrade_strided(jnp.asarray(img), jnp.asarray(kernel), factor=factor))
    got = tdeg.degrade_strided(torch.from_numpy(img), torch.from_numpy(kernel), factor=factor)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the strided single-conv form equals the unfused blur + block mean
    np.testing.assert_allclose(
        got.numpy(),
        tdeg.degrade(torch.from_numpy(img), torch.from_numpy(kernel), factor=factor).numpy(),
        **TOL)


@pytest.mark.parametrize("factor,ksize", CASES)
def test_compose_with_box_matches_jax(rng, factor, ksize):
    kernel = rng.uniform(0, 1, (5, ksize, ksize)).astype(np.float32)
    want = np.asarray(jdeg.compose_with_box(jnp.asarray(kernel), factor))
    got = tdeg.compose_with_box(torch.from_numpy(kernel), factor)
    assert got.shape == want.shape == (5, ksize + factor - 1, ksize + factor - 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_normalize_kernel_matches_jax(rng):
    k = rng.uniform(0, 1, (5, 13, 13)).astype(np.float32)
    k[2] = -k[2]  # a band summing below zero is left as it is
    want = np.asarray(jdeg.normalize_kernel(jnp.asarray(k)))
    got = tdeg.normalize_kernel(torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[[0, 1, 3, 4]].sum(axis=(1, 2)), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(got[2], k[2])


def test_unbatched_and_2d_kernel_match_jax(rng):
    """[C, H, W] input and a [kH, kW] kernel broadcast to every band."""
    img = rng.normal(5, 2, (5, 32, 32)).astype(np.float32)
    k = rng.uniform(0, 1, (13, 13)).astype(np.float32)
    for fn in ("degrade", "degrade_strided"):
        want = np.asarray(getattr(jdeg, fn)(jnp.asarray(img), jnp.asarray(k), factor=8))
        got = getattr(tdeg, fn)(torch.from_numpy(img), torch.from_numpy(k), factor=8)
        assert got.shape == (5, 4, 4)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pads_and_pools_match_jax(rng):
    x = rng.normal(size=(2, 3, 9, 11)).astype(np.float32)
    np.testing.assert_array_equal(
        tdeg.replicate_pad(torch.from_numpy(x), 2, 3).numpy(),
        np.asarray(jdeg.replicate_pad(jnp.asarray(x), 2, 3)))
    np.testing.assert_allclose(
        tdeg.avg_pool2(torch.from_numpy(x)).numpy(),
        np.asarray(jdeg.avg_pool2(jnp.asarray(x))), **TOL)
    y = x[:, :, :8, :8]
    np.testing.assert_allclose(
        tdeg.block_mean(torch.from_numpy(np.ascontiguousarray(y)), 4).numpy(),
        np.asarray(jdeg.block_mean(jnp.asarray(y), 4)), **TOL)
