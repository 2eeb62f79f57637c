"""The port's known-kernel deconvolution oracle against the JAX package's:
the operator, the batch solves, the matched prior and CG.

`kmsr_tpu_torch.analysis.oracle` vs `kmsr_tpu.analysis.oracle` on the same
seeded numpy inputs (the JAX oracle is XLA: no Pallas kernel on this path;
the sweeps are in `test_torch_oracle_sweep.py`). In float64 (JAX under
`jax.enable_x64`) the two solves agree to ~1e-11 of the HR range: the
operator, its adjoint, the priors and CG are JAX's. In float32 CG
amplifies each package's rounding: where a prediction is off the JAX one
by more than rtol 1e-3 / atol 1e-4 of the HR range, the port's distance
from a float64 solve (the port's own, on the CPU) must be at most twice
JAX's, in every route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu.analysis import oracle as jo
from kmsr_tpu_torch.analysis import oracle as to
from tests.helpers.torch_oracle import (  # noqa: F401
    C, FACTOR, ITERS, assert_close_or_f64 as _assert_close_or_f64,
    gauss_kernel as _gauss_kernel, jax_batch as _jax_batch, make_lr as _lr,
    one_torch_thread, port_batch as _port_batch, route as _route, x8_case)


def test_grad_sq_op_matches_jax(rng):
    x = rng.normal(0, 1, (2, C, 16, 20)).astype(np.float32)
    want = np.asarray(jo._grad_sq_op(jnp.asarray(x)))
    got = to._grad_sq_op(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_known_kernel_deconv_delta_kernel_factor1(rng):
    """f=1 with a delta kernel: A is the identity, so the solve returns
    the input, in both packages."""
    x = rng.normal(5, 1, (2, 16, 16)).astype(np.float32)
    kernel = np.zeros((2, 5, 5), np.float32)
    kernel[:, 2, 2] = 1.0
    got = to.known_kernel_deconv(torch.from_numpy(x), torch.from_numpy(kernel), 1,
                                 x.shape, 1e-8, iters=30).numpy()
    want = np.asarray(jo.known_kernel_deconv(jnp.asarray(x), jnp.asarray(kernel), 1,
                                             x.shape, 1e-8, iters=30))
    np.testing.assert_allclose(got, x, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_known_kernel_deconv_x8_matches_jax(x8_case):
    hr, kernel, lr = x8_case
    got = to.known_kernel_deconv(torch.from_numpy(lr[0]), torch.from_numpy(kernel),
                                 FACTOR, hr[0].shape, 1e-3, iters=ITERS).numpy()
    want = np.asarray(jo.known_kernel_deconv(jnp.asarray(lr[0]), jnp.asarray(kernel),
                                             FACTOR, hr[0].shape, 1e-3, iters=ITERS))
    f64 = to.known_kernel_deconv(torch.from_numpy(lr[0]).double(),
                                 torch.from_numpy(kernel).double(), FACTOR,
                                 hr[0].shape, 1e-3, iters=ITERS).numpy()
    assert got.shape == hr[0].shape and np.isfinite(got).all()
    _assert_close_or_f64(got, want, f64, float(np.ptp(hr[0])))


@pytest.mark.parametrize("route", ["grad", "matched", "per_sample"])
def test_deconv_batch_matches_jax(x8_case, route):
    hr, kernel, lr, lam, w, inv = _route(x8_case, route)
    got = _port_batch(lr, kernel, lam, w, inv, route == "per_sample")
    want = _jax_batch(lr, kernel, lam, w, inv, route == "per_sample")
    f64 = _port_batch(lr, kernel, lam, w, inv, route == "per_sample", torch.float64)
    assert got.shape == hr.shape and np.isfinite(got).all()
    _assert_close_or_f64(got, want, f64, float(np.ptp(hr)))


@pytest.mark.parametrize("route", ["grad", "matched", "per_sample"])
def test_deconv_batch_float64_matches_jax_x64(x8_case, route):
    """The same solve in float64 in both packages: equal to 1e-9 of the HR
    range (measured ~1e-11), so every difference in float32 is rounding."""
    hr, kernel, lr, lam, w, inv = _route(x8_case, route)
    got = _port_batch(lr, kernel, lam, w, inv, route == "per_sample", torch.float64)
    with jax.enable_x64(True):
        want = _jax_batch(lr, kernel, lam, w, inv, route == "per_sample", jnp.float64)
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * float(np.ptp(hr)))


def test_matched_prior_bit_equal(rng):
    hr = rng.normal(5, 1, (6, C, 16, 16)).astype(np.float32)
    hr[0, 1, 2, 3] = np.nan
    nvar = np.array([0.5, 2.0, 1e-3, 0.1, 1.0])
    for got, want in zip(to.matched_prior(hr, nvar), jo.matched_prior(hr, nvar)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_cg_stops_before_maxiter_where_jax_does(x8_case):
    """tol stops CG before maxiter on this system (the joint <r, r> over
    the chunk); the port's stop iteration is JAX's: JAX's solve with
    maxiter = k equals its solve with maxiter = ITERS bit for bit, and
    the one with maxiter = k - 1 does not."""
    hr, kernel, lr = x8_case
    _, k = to._deconv_batch(torch.from_numpy(lr), torch.from_numpy(kernel), FACTOR,
                            3e-3, None, None, iters=ITERS, return_iters=True)
    k = int(k)
    assert 1 < k < ITERS

    def jax_solve(maxiter):
        return np.asarray(jo._deconv_batch(jnp.asarray(lr), jnp.asarray(kernel), FACTOR,
                                           jnp.float32(3e-3), None, None, iters=maxiter))

    full = jax_solve(ITERS)
    assert np.array_equal(jax_solve(k), full)
    assert not np.array_equal(jax_solve(k - 1), full)


def test_cg_early_exit_equals_the_frozen_loop(x8_case, monkeypatch):
    """Leaving the loop at a look at the stop flag gives the result of
    running all maxiter iterations with the state frozen after the stop."""
    hr, kernel, lr = x8_case
    args = (torch.from_numpy(lr), torch.from_numpy(kernel), FACTOR, 3e-3, None, None)
    x, k = to._deconv_batch(*args, iters=ITERS, return_iters=True)
    assert int(k) <= ITERS - to._STOP_CHECK  # the loop did leave early
    monkeypatch.setattr(to, "_STOP_CHECK", 10**9)
    x_all, k_all = to._deconv_batch(*args, iters=ITERS, return_iters=True)
    assert int(k) == int(k_all) and torch.equal(x, x_all)


def test_cg_matches_a_plain_solve_on_a_small_spd_system(rng):
    """The port's CG on an explicit SPD matrix reaches numpy's solve, and
    a stop at iteration 0 (b = A x0) leaves x0 untouched."""
    m = rng.normal(0, 1, (12, 12))
    a = torch.from_numpy(m @ m.T + 12 * np.eye(12))
    b = torch.from_numpy(rng.normal(0, 1, 12))
    x, k = to.cg(lambda v: a @ v, b, torch.zeros(12, dtype=torch.float64), maxiter=50)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a.numpy(), b.numpy()),
                               rtol=1e-4, atol=1e-6)
    assert 0 < int(k) <= 12
    x0 = torch.from_numpy(rng.normal(0, 1, 12))
    x, k = to.cg(lambda v: a @ v, a @ x0, x0, maxiter=5)
    assert int(k) == 0 and torch.equal(x, x0)


def test_per_sample_route_uses_replicate_padding(x8_case, monkeypatch):
    """Per-sample kernels are JAX's vmap of `degrade` (replicate padding,
    block mean). The same solve with zero padding in place of the
    replicate pad (`degrade_batch_kernels`' default, the MoE model's)
    lands off JAX's by far more than the tolerance: this route's padding
    is under test."""
    hr, _, _ = x8_case
    kernel = np.stack([_gauss_kernel(C, 13, s) for s in (1.5, 2.0, 2.5)])
    lr = _lr(hr, kernel, FACTOR, seed=3)
    want = np.asarray(jo._deconv_batch(jnp.asarray(lr), jnp.asarray(kernel), FACTOR,
                                       jnp.float32(1e-3), None, None, iters=ITERS,
                                       per_sample=True))
    rng_hr = float(np.ptp(hr))
    got = _port_batch(lr, kernel, 1e-3, None, None, True)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * rng_hr)

    monkeypatch.setattr(to, "replicate_pad",
                        lambda x, ph, pw: torch.nn.functional.pad(x, (pw, pw, ph, ph)))
    zero = _port_batch(lr, kernel, 1e-3, None, None, True)
    assert np.abs(zero - want).max() > 100 * np.abs(got - want).max()
    assert not np.allclose(zero, want, rtol=1e-3, atol=1e-3 * rng_hr)
