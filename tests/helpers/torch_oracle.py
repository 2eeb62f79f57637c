"""Shared setup of the port's oracle tests (`tests/test_torch_oracle*.py`):
the seeded x8 case (3 HR patches of 5x64^2, a 13x13 Gaussian, noisy LRs
made by JAX's `degrade`), the three `_deconv_batch` routes, both packages'
batch solves and the float32 yardstick."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu.analysis import oracle as jo
from kmsr_tpu.ops.degrade import degrade as jax_degrade
from kmsr_tpu_torch.analysis import oracle as to

FACTOR, N, C, HW, ITERS = 8, 3, 5, 64, 30


def gauss_kernel(c, k, sigma):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (2 * sigma**2))
    return np.broadcast_to(g / g.sum(), (c, k, k)).astype(np.float32).copy()


def scene(n, hw, seed):
    """n structured [C, hw, hw] HR patches (waves plus fine noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw), indexing="ij")
    return np.stack([np.stack([
        5 + np.sin((8 + i + c) * xx) * np.cos((6 + c) * yy)
        + 0.1 * rng.normal(size=xx.shape) for c in range(C)]) for i in range(n)]
    ).astype(np.float32)


def make_lr(hr, kernel, factor, seed, sigma=0.02):
    lr = np.stack([np.asarray(jax_degrade(jnp.asarray(h), jnp.asarray(k), factor=factor))
                   for h, k in zip(hr, kernel if kernel.ndim == 4 else [kernel] * len(hr))])
    return lr + np.random.default_rng(seed).normal(0, sigma, lr.shape).astype(np.float32)


def assert_close_or_f64(got, want, f64, hr_range):
    """Within rtol 1e-3 / atol 1e-4 of the HR range, or no further from
    the float64 solve than twice JAX's float32 distance from it."""
    if np.allclose(got, want, rtol=1e-3, atol=1e-4 * hr_range):
        return
    d_port, d_jax = np.abs(got - f64).max(), np.abs(want - f64).max()
    assert d_port <= 2 * d_jax, (np.abs(got - want).max(), d_port, d_jax)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module. These CPU solves are small, and
    under pytest-xdist's workers torch's default of a thread a core
    oversubscribes the host: the oracle's files ran many times slower
    there than alone, with the same results."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def x8_case():
    hr = scene(N, HW, seed=0)
    kernel = gauss_kernel(C, 13, 2.0)
    return hr, kernel, make_lr(hr, kernel, FACTOR, seed=1)


def port_batch(lr, kernel, lam, w, inv, per_sample, dtype=torch.float32):
    t = lambda a: None if a is None else torch.from_numpy(a).to(dtype)  # noqa: E731
    return to._deconv_batch(t(lr), t(kernel), FACTOR, lam, t(w), t(inv), iters=ITERS,
                            per_sample=per_sample).numpy()


def route(x8_case, name):
    """(hr, kernel, lr, lam, w_prior, inv_nvar) of one _deconv_batch route."""
    hr, kernel, lr = x8_case
    w = inv = None
    lam = 1e-3
    if name == "matched":
        w, inv = jo.matched_prior(scene(4, HW, seed=5), np.full(C, 4e-4))
        lam = 1.0
    if name == "per_sample":
        kernel = np.stack([gauss_kernel(C, 13, s) for s in (1.5, 2.0, 2.5)])
        lr = make_lr(hr, kernel, FACTOR, seed=2)
    return hr, kernel, lr, lam, w, inv


def jax_batch(lr, kernel, lam, w, inv, per_sample, dtype=jnp.float32):
    a = lambda x: None if x is None else jnp.asarray(x, dtype)  # noqa: E731
    return np.asarray(jo._deconv_batch(a(lr), a(kernel), FACTOR, dtype(lam), a(w), a(inv),
                                       iters=ITERS, per_sample=per_sample))
