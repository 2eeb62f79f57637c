"""Known-kernel deconvolution oracle for the SR quality reports.

Counterpart of `kmsr_tpu.analysis.oracle`: reconstruct the holdout HR from
its LR with the EXACT factory degradation operator (`ops.degrade.degrade`:
replicate-pad depthwise blur with the known kernel + factor x factor block
mean, spelt as `degrade_strided`'s one strided correlation), knowledge the
SR network does not have, so that SR-vs-oracle turns "+N dB over
bilinear" into a share of the measured oracle-bilinear gap.

Method: Tikhonov-regularized least squares,

    x* = argmin_x ||A x - y||^2 + lam * ||grad x||^2,

by conjugate gradients on the normal equations
(A^T A + lam * grad^T grad) x = A^T y. A^T is the vjp of the forward op
(`torch.func.vjp` at zeros; the op is linear, so one vjp serves every
iteration), not a hand-derived transpose. lam is swept over a grid and the
best holdout PSNR is kept: the oracle is an upper bound. prior="matched"
replaces the gradient penalty by the Wiener/LMMSE one (per-band data term
weighted by 1/sigma_b^2, spectral penalty mu * sigma_b^2 / S_b(k) from the
empirical mean power spectrum of example HR patches); see the JAX module's
docstring for the argument.

`cg` reproduces `jax.scipy.sparse.linalg.cg` (tol=1e-5, atol=0: stop once
<r, r> <= tol^2 <b, b> or after maxiter steps; the inner products run over
the whole [N, C, H, W] chunk, one joint system, so the stop is joint). It
freezes the state on the device once the stop holds (`torch.where`, no
host sync an iteration) and looks at the stop on the host once every
`_STOP_CHECK` iterations, leaving the loop when it holds: the result is
the same as with maxiter frozen iterations, and at most `_STOP_CHECK - 1`
iterations past the stop run.
Everything runs under `fp32_convs()` (backward convs included): cuDNN's
TF32 default would keep ~3 digits, and CG amplifies every rounding. The
normal operator (forward, adjoint, data weights, prior) runs in float64
and rounds once to the solve's dtype an application; CG's state, inner
products and stop test stay in that dtype, as in JAX's cg, so float32
solves stop where JAX's do. A float32 operator rounds each pixel of
ATen's convolutions ~3x more than XLA's, and CG carried that into the x8
null space (2.96-8.63x JAX's distance from a float64 solve, against
0.28-0.34x now: `scripts/torch_oracle_adjoint_ab.py`).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import vjp

from ..device import resolve_device
from ..ops.degrade import (compose_with_box, degrade_strided, fp32_convs, normalize_kernel,
                           replicate_pad)

#: iterations between two host reads of CG's stop flag
_STOP_CHECK = 10
#: the dtype the normal operator runs in, whatever the solve's
_WIDE = torch.float64


def _grad_sq_op(x: torch.Tensor) -> torch.Tensor:
    """grad^T grad x for forward differences with replicate boundary
    (== graph Laplacian of the 4-neighbor grid), per channel."""
    dy = x.diff(dim=-2)  # [..., H-1, W]
    dx = x.diff(dim=-1)  # [..., H, W-1]
    out = torch.zeros_like(x)
    out[..., :-1, :] += -dy
    out[..., 1:, :] += dy
    out[..., :, :-1] += -dx
    out[..., :, 1:] += dx
    return out


def cg(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    maxiter: int,
    tol: float = 1e-5,
    atol: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.scipy.sparse.linalg.cg's iteration (no preconditioner).

    Returns (x, k): the solution and the 0-dim tensor of the iterations
    run before the stop (<r, r> <= max(tol^2 <b, b>, atol^2)) held or
    maxiter was reached, as JAX's while_loop counts them.
    """
    def vdot(u, v):
        return (u * v).sum()

    atol2 = torch.clamp_min(tol * tol * vdot(b, b), atol * atol)
    x = x0
    r = b - A(x0)
    p = r
    gamma = vdot(r, r)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for i in range(maxiter):
        go = gamma > atol2
        if i % _STOP_CHECK == 0 and i and not bool(go):
            break
        ap = A(p)
        alpha = gamma / vdot(p, ap)
        x_ = x + alpha * p
        r_ = r - alpha * ap
        gamma_ = vdot(r_, r_)
        p_ = r_ + (gamma_ / gamma) * p
        x = torch.where(go, x_, x)
        r = torch.where(go, r_, r)
        p = torch.where(go, p_, p)
        gamma = torch.where(go, gamma_, gamma)
        k = k + go
    return x, k


def _forward(kernel: torch.Tensor, factor: int, per_sample: bool = False):
    """The factory's degrade as one stride-`factor` correlation with the
    blur composed with the factor x factor box (`degrade_strided`: the
    same operator as `degrade`'s blur then block mean, with
    ~(k+f-1)^2 / (k f)^2 of its work); per-sample [N, C, k, k] kernels,
    normalized, folded into the groups (JAX's vmap of `degrade`)."""
    if not per_sample:
        return lambda x: degrade_strided(x, kernel, factor=factor)
    kh, kw = kernel.shape[-2:]
    comp = compose_with_box(normalize_kernel(kernel), factor)

    def fwd(x):
        n, c = x.shape[:2]
        xp = replicate_pad(x, kh // 2, kw // 2)
        y = F.conv2d(xp.reshape(1, n * c, *xp.shape[2:]), comp.reshape(n * c, 1, *comp.shape[2:]),
                     stride=factor, groups=n * c)
        return y.reshape(n, c, *y.shape[2:])
    return fwd


def _zero_order_hold(lr: torch.Tensor, factor: int) -> torch.Tensor:
    return lr.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)


def known_kernel_deconv(
    lr: torch.Tensor,
    kernel: torch.Tensor,
    factor: int,
    hr_shape: tuple,
    lam: float,
    iters: int = 100,
) -> torch.Tensor:
    """Oracle reconstruction of one [C, H, W] HR image from its LR.

    lr: [C, H/f, W/f]; kernel: [C, kH, kW] (the factory kernel);
    hr_shape: (C, H, W); lam: Tikhonov gradient weight; iters: CG steps.
    Initialized at the zero-order hold upsample. Runs where `lr` lies.
    """
    fwd = _forward(kernel.to(lr.device, _WIDE), factor)
    with fp32_convs():
        x0 = _zero_order_hold(lr, factor)
        _, at = vjp(fwd, torch.zeros(hr_shape, dtype=_WIDE, device=lr.device))

        def normal_op(x):
            w = x.to(_WIDE)
            return (at(fwd(w))[0] + lam * _grad_sq_op(w)).to(x.dtype)

        x, _ = cg(normal_op, at(lr.to(_WIDE))[0].to(lr.dtype), x0, maxiter=iters)
    return x


def _deconv_batch(
    lr_b: torch.Tensor,
    kernel: torch.Tensor,
    factor: int,
    lam: float,
    w_prior: torch.Tensor | None,
    inv_nvar: torch.Tensor | None,
    iters: int = 100,
    per_sample: bool = False,
    return_iters: bool = False,
):
    """One batched CG solve over [N, C, h, w] LRs (shared [C, kh, kw] or
    per-sample [N, C, kh, kw] kernels). The system is block-diagonal
    across samples, so solving jointly is exact. w_prior [C, H, W]
    switches the penalty from the gradient Laplacian (None) to the matched
    spectral prior; inv_nvar [C] adds the per-band noise weighting of the
    data term. Per-sample kernels are JAX's vmap of `degrade`: normalized,
    replicate padding, block mean (`_forward`). With return_iters, returns
    (x, the CG stop iteration)."""
    n, c, h, w = lr_b.shape
    hr_shape = (n, c, h * factor, w * factor)
    fwd = _forward(kernel.to(lr_b.device, _WIDE), factor, per_sample)
    dscale = 1.0 if inv_nvar is None else inv_nvar.to(lr_b.device, _WIDE)[None, :, None, None]
    if w_prior is None:
        pen = _grad_sq_op
    else:
        w_prior = w_prior.to(lr_b.device, _WIDE)

        def pen(x):
            return torch.fft.ifft2(w_prior * torch.fft.fft2(x)).real.to(x.dtype)

    with fp32_convs():
        x0 = _zero_order_hold(lr_b, factor)
        _, at = vjp(fwd, torch.zeros(hr_shape, dtype=_WIDE, device=lr_b.device))

        def normal_op(x):
            w = x.to(_WIDE)
            return (at(fwd(w) * dscale)[0] + lam * pen(w)).to(x.dtype)

        b = at(lr_b.to(_WIDE) * dscale)[0].to(lr_b.dtype)
        x, k = cg(normal_op, b, x0, maxiter=iters)
    return (x, k) if return_iters else x


def matched_prior(hr_examples, noise_var):
    """Wiener weights from data: per-band spectral penalty
    w_b(k) = sigma_b^2 / S_b(k) with S_b the empirical mean power
    spectrum of `hr_examples` [N, C, H, W] (use TRAIN pairs, not the
    eval holdout), and the data-term weights 1/sigma_b^2. DC is left to
    the data term. Returns (w_prior [C, H, W] f32, inv_nvar [C] f32)."""
    hr_examples = np.nan_to_num(np.asarray(hr_examples))
    _, _, H, W = hr_examples.shape
    spec = np.abs(np.fft.fft2(hr_examples)) ** 2
    S = spec.mean(axis=0) / (H * W)
    S = np.maximum(S, S.max(axis=(-2, -1), keepdims=True) * 1e-9)
    nv = np.asarray(noise_var, np.float64)
    w = (nv[:, None, None] / S).astype(np.float32)
    w[:, 0, 0] = 0.0
    return w, (1.0 / nv).astype(np.float32)


def oracle_sweep(
    lr_batch,
    hr_batch,
    kernel,
    factor: int,
    lams: Sequence[float] | None = None,
    iters: int = 100,
    prior: str = "grad",
    noise_var=None,
    spec_examples=None,
    chunk: int = 24,
    device: str | torch.device = "cuda",
    cg_iters: dict | None = None,
):
    """Best-lam oracle over a holdout batch.

    lr_batch: [N, C, h, w]; hr_batch: [N, C, H, W]; kernel: [C, kh, kw]
    shared across the batch, or [N, C, kh, kw] per-sample (the MoE
    factory routes each patch through its selected expert); numpy in,
    float32 on `device`. Returns (best_lam, preds [N, C, H, W] numpy,
    per_lam_psnr dict). PSNR uses each image's HR dynamic range (same
    convention as the quality report); ties go to the first lam in grid
    order. A dict passed as cg_iters receives, per lam, each chunk's CG
    stop iteration.

    prior="grad" sweeps the gradient-Tikhonov weight; prior="matched"
    requires noise_var [C] (measured pool variance) and spec_examples
    [M, C, H, W] (HR patches whose mean spectrum defines the Wiener
    prior) and sweeps the global multiplier mu around its matched
    value 1."""
    from ..ops.metrics import psnr

    dev = resolve_device(device)
    if lams is None:
        lams = ((0.3, 1.0, 3.0, 10.0) if prior == "matched"
                else (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1))
    if prior == "matched":
        if noise_var is None or spec_examples is None:
            raise ValueError(
                "prior='matched' needs noise_var and spec_examples")
        w_np, inv_np = matched_prior(spec_examples, noise_var)
        w_prior, inv_nvar = torch.from_numpy(w_np).to(dev), torch.from_numpy(inv_np).to(dev)
    elif prior == "grad":
        w_prior = inv_nvar = None
    else:
        raise ValueError(f"unknown prior {prior!r}")

    kernel = torch.as_tensor(np.asarray(kernel, np.float32)).to(dev)
    per_sample = kernel.ndim == 4
    lr_all = torch.as_tensor(np.asarray(lr_batch, np.float32))
    n = lr_all.shape[0]
    results = {}
    preds_by_lam = {}
    for lam in lams:
        preds, stops = [], []
        for s in range(0, n, chunk):
            kc = kernel[s : s + chunk] if per_sample else kernel
            x, k = _deconv_batch(
                lr_all[s : s + chunk].to(dev), kc, factor, float(lam), w_prior,
                inv_nvar, iters=iters, per_sample=per_sample, return_iters=True)
            preds.append(x.cpu().numpy())
            stops.append(int(k))
        preds = np.concatenate(preds)
        if cg_iters is not None:
            cg_iters[lam] = stops
        scores = []
        for i in range(n):
            hr = np.asarray(hr_batch[i])
            dr = float(np.nanmax(hr) - np.nanmin(hr)) or 1.0
            scores.append(float(psnr(torch.from_numpy(preds[i]),
                                     torch.from_numpy(np.asarray(hr, np.float32)), dr)))
        results[lam] = float(np.mean(scores))
        preds_by_lam[lam] = preds
    best = max(results, key=results.get)
    return best, preds_by_lam[best], results
