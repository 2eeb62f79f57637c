"""How far the port's float32 oracle lies from a float64 solve, against JAX's,
with the normal operator run in float64 (the port's spelling since the
oracle's repair: one rounding to float32 an application) and in float32,
its adjoint taken by `torch.func.vjp` or spelt out by hand.

The x8 case of `tests/test_torch_oracle.py` (3 structured 5x64^2 HR
patches, a 13x13 Gaussian, 30 CG iterations) through
`_deconv_batch`'s three routes (the gradient prior, the matched spectral
prior with its 1/sigma^2 data weights, per-sample kernels). For each route
it prints the largest distance of the port's float32 prediction from the
port's float64 solve over JAX's float32 distance from it (per image and
overall), once for each spelling, and checks first that the written-out
adjoint equals the vjp in float64. The tests hold the port to a ratio of
at most 2 where it is not within rtol 1e-3 / atol 1e-4 of JAX.

The written-out adjoint of degrade = replicate pad -> depthwise
correlation -> block mean: the block mean's adjoint (repeat each pixel
f x f, divide by f^2), a correlation of the zero-padded result with the
180-degree-rotated kernel, and the replicate pad's adjoint (the padded
border rows and columns summed back onto the edge rows and columns).

CPU only, ~30 s: JAX_PLATFORMS=cpu python scripts/torch_oracle_adjoint_ab.py
"""
from __future__ import annotations

import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.func import vjp  # noqa: E402

from kmsr_tpu.analysis import oracle as jo  # noqa: E402
from kmsr_tpu.ops.degrade import degrade as jax_degrade  # noqa: E402
from kmsr_tpu_torch.analysis import oracle as to  # noqa: E402
from kmsr_tpu_torch.ops.degrade import (  # noqa: E402
    degrade,
    degrade_batch_kernels,
    fp32_convs,
    normalize_kernel,
)

FACTOR, N, C, HW, ITERS = 8, 3, 5, 64, 30


def gauss_kernel(c, k, sigma):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (2 * sigma**2))
    return np.broadcast_to(g / g.sum(), (c, k, k)).astype(np.float32).copy()


def scene(n, hw, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw), indexing="ij")
    return np.stack([np.stack([
        5 + np.sin((8 + i + c) * xx) * np.cos((6 + c) * yy)
        + 0.1 * rng.normal(size=xx.shape) for c in range(C)]) for i in range(n)]
    ).astype(np.float32)


def make_lr(hr, kernel, seed, sigma=0.02):
    ks = kernel if kernel.ndim == 4 else [kernel] * len(hr)
    lr = np.stack([np.asarray(jax_degrade(jnp.asarray(h), jnp.asarray(k), factor=FACTOR))
                   for h, k in zip(hr, ks)])
    return lr + np.random.default_rng(seed).normal(0, sigma, lr.shape).astype(np.float32)


def adjoint(y: torch.Tensor, kernel: torch.Tensor, factor: int,
            per_sample: bool) -> torch.Tensor:
    """degrade's adjoint, written out: [N, C, h, w] -> [N, C, h*f, w*f]."""
    n, c, h, w = y.shape
    k = torch.flip(normalize_kernel(kernel), (-2, -1))
    kh, kw = k.shape[-2:]
    u = y.repeat_interleave(factor, -2).repeat_interleave(factor, -1) / (factor * factor)
    up = F.pad(u, (kw - 1, kw - 1, kh - 1, kh - 1))
    with fp32_convs():
        if per_sample:
            z = F.conv2d(up.reshape(1, n * c, *up.shape[2:]), k.reshape(n * c, 1, kh, kw),
                         groups=n * c)
        else:
            z = F.conv2d(up, k[:, None], groups=c)
    z = z.reshape(n, c, *z.shape[-2:])  # the replicate-padded extent
    ph, pw, hh, ww = kh // 2, kw // 2, h * factor, w * factor
    r = z[:, :, ph:ph + hh].clone()
    r[:, :, 0] += z[:, :, :ph].sum(-2)
    r[:, :, -1] += z[:, :, ph + hh:].sum(-2)
    out = r[..., pw:pw + ww].clone()
    out[..., 0] += r[..., :pw].sum(-1)
    out[..., -1] += r[..., pw + ww:].sum(-1)
    return out


def deconv(lr_b, kernel, lam, w_prior, inv_nvar, per_sample, spelling):
    """`to._deconv_batch` ("float64 op"), or its float32 operator with the
    vjp ("float32 op, vjp") or the written-out adjoint ("float32 op,
    written-out")."""
    if spelling == "float64 op":
        return to._deconv_batch(lr_b, kernel, FACTOR, lam, w_prior, inv_nvar, iters=ITERS,
                                per_sample=per_sample)
    if per_sample:
        kn = normalize_kernel(kernel)

        def fwd(x):
            return degrade_batch_kernels(x, kn, factor=FACTOR, padding="replicate")
    else:
        def fwd(x):
            return degrade(x, kernel, factor=FACTOR)
    dscale = 1.0 if inv_nvar is None else inv_nvar[None, :, None, None]
    if w_prior is None:
        pen = to._grad_sq_op
    else:
        def pen(x):
            return torch.fft.ifft2(w_prior * torch.fft.fft2(x)).real.to(x.dtype)

    with fp32_convs():
        if spelling == "float32 op, written-out":
            def at(y):
                return adjoint(y, kernel, FACTOR, per_sample)
        else:
            n, c, h, w = lr_b.shape
            _, vjp_at = vjp(fwd, torch.zeros(n, c, h * FACTOR, w * FACTOR, dtype=lr_b.dtype))

            def at(y):
                return vjp_at(y)[0]
        x0 = to._zero_order_hold(lr_b, FACTOR)
        x, _ = to.cg(lambda x: at(fwd(x) * dscale) + lam * pen(x), at(lr_b * dscale), x0,
                     maxiter=ITERS)
    return x


SPELLINGS = ("float64 op", "float32 op, vjp", "float32 op, written-out")


def main() -> None:
    hr = scene(N, HW, seed=0)
    kernel = gauss_kernel(C, 13, 2.0)
    lr = make_lr(hr, kernel, seed=1)
    ks = np.stack([gauss_kernel(C, 13, s) for s in (1.5, 2.0, 2.5)])
    routes = {
        "grad": (lr, kernel, 1e-3, None, None, False),
        "matched": (lr, kernel, 1.0) + jo.matched_prior(scene(4, HW, seed=5), np.full(C, 4e-4))
        + (False,),
        "per_sample": (make_lr(hr, ks, seed=2), ks, 1e-3, None, None, True),
    }
    for per_sample, k in ((False, kernel), (True, ks)):
        kk = torch.from_numpy(k).double()
        x = torch.zeros(N, C, HW, HW, dtype=torch.float64)
        y = torch.from_numpy(np.random.default_rng(3).normal(size=(N, C, 8, 8)))
        if per_sample:
            _, at = vjp(lambda v: degrade_batch_kernels(v, normalize_kernel(kk), factor=FACTOR,
                                                        padding="replicate"), x)
        else:
            _, at = vjp(lambda v: degrade(v, kk, factor=FACTOR), x)
        err = float((at(y)[0] - adjoint(y, kk, FACTOR, per_sample)).abs().max())
        print(f"float64 adjoint vs vjp ({'per-sample' if per_sample else 'shared'} "
              f"kernel): max |diff| {err:.3e}")
        assert err < 1e-12
    for route, (l, k, lam, w, inv, per_sample) in routes.items():
        def t(a, dtype):
            return None if a is None else torch.from_numpy(np.asarray(a)).to(dtype)
        want = np.asarray(jo._deconv_batch(
            jnp.asarray(l), jnp.asarray(k), FACTOR, jnp.float32(lam),
            None if w is None else jnp.asarray(w), None if inv is None else jnp.asarray(inv),
            iters=ITERS, per_sample=per_sample))
        f64 = deconv(t(l, torch.float64), t(k, torch.float64), lam, t(w, torch.float64),
                     t(inv, torch.float64), per_sample, SPELLINGS[0]).numpy()
        d_jax = [float(np.abs(want[i] - f64[i]).max()) for i in range(N)]
        for spelling in SPELLINGS:
            got = deconv(t(l, torch.float32), t(k, torch.float32), lam, t(w, torch.float32),
                         t(inv, torch.float32), per_sample, spelling).numpy()
            d = [float(np.abs(got[i] - f64[i]).max()) for i in range(N)]
            ratio = max(d) / max(d_jax)
            print(f"{route:10s} {spelling:23s} "
                  f"d_port/d_jax overall {ratio:.2f}, per image "
                  + ", ".join(f"{a / b:.2f}" for a, b in zip(d, d_jax)))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
