"""GAN losses and kernel regularizers (pure functions).

Counterpart of `kmsr_tpu.losses`: the LSGAN D/G losses, the 5-term kernel
regularizer (sum-to-1, boundary, sqrt-sparsity, centroid-to-center,
center-must-be-max) and its 4-term variant, the noise-sigma regularizer
and the MoE load-balance loss. Clamps at zero use `clip_nonneg`, which
splits the gradient at a tie as `jnp.clip` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops.kernel_algebra import clip_nonneg
from .parallel.mesh import batch_mean


def scene_mean(x: torch.Tensor, scenes: int, dim: int = 1) -> torch.Tensor:
    """The mean of each scene's part of x [scenes], x's `dim` holding the
    scenes' equal blocks in order (the fleet's folded channels)."""
    return x.movedim(dim, 0).reshape(scenes, -1).mean(dim=1)


def lsgan_d_loss(pred_real: torch.Tensor, pred_fake: torch.Tensor,
                 scenes: int | None = None) -> torch.Tensor:
    """0.5*mean[(D(real)-1)^2] + 0.5*mean[D(fake)^2]; with scenes=m, of
    each scene's maps [B, m, H, W] -> [m]."""
    if scenes is not None:
        return (0.5 * scene_mean((pred_real - 1.0) ** 2, scenes)
                + 0.5 * scene_mean(pred_fake**2, scenes))
    return 0.5 * torch.mean((pred_real - 1.0) ** 2) + 0.5 * torch.mean(pred_fake**2)


def lsgan_g_loss(pred_fake: torch.Tensor, scenes: int | None = None) -> torch.Tensor:
    """0.5*mean[(D(fake)-1)^2]; with scenes=m, of each scene's -> [m]."""
    if scenes is not None:
        return 0.5 * scene_mean((pred_fake - 1.0) ** 2, scenes)
    return 0.5 * torch.mean((pred_fake - 1.0) ** 2)


def kernel_regularization(
    k: torch.Tensor,
    alpha: float = 0.5,
    beta: float = 0.5,
    gamma: float = 5.0,
    delta: float = 1.0,
    epsilon: float = 2.0,
    center_max: bool = True,
) -> torch.Tensor:
    """Physicality regularizer on a blur kernel [..., kH, kW] -> [...].

    Terms: alpha*(sum-1)^2 + beta*boundary-energy + gamma*sum(sqrt(k)) +
    delta*centroid-offset^2 + epsilon*(max - center)^2. Set
    `center_max=False` for the 4-term variant. A leading axis takes the
    place of the JAX package's vmap over bands.
    """
    kh, kw = k.shape[-2:]
    dims = (-2, -1)
    sum1 = (k.sum(dims) - 1.0) ** 2
    boundaries = (
        (k[..., 0, :] ** 2).sum(-1)
        + (k[..., -1, :] ** 2).sum(-1)
        + (k[..., :, 0] ** 2).sum(-1)
        + (k[..., :, -1] ** 2).sum(-1)
    )
    # sqrt with a zero (not inf) gradient at 0: both wheres are needed, a
    # single one still back-propagates 0 * inf = NaN through the sqrt
    k_pos = clip_nonneg(k)
    sparse = torch.where(
        k_pos > 0, torch.sqrt(torch.where(k_pos > 0, k_pos, 1.0)), 0.0
    ).sum(dims)
    yy, xx = torch.meshgrid(torch.arange(kh, device=k.device),
                            torch.arange(kw, device=k.device), indexing="ij")
    mass = clip_nonneg(k) + 1e-12
    msum = mass.sum(dims)
    cy = (yy * mass).sum(dims) / msum
    cx = (xx * mass).sum(dims) / msum
    c_y, c_x = (kh - 1) / 2.0, (kw - 1) / 2.0
    center = (cy - c_y) ** 2 + (cx - c_x) ** 2
    loss = alpha * sum1 + beta * boundaries + gamma * sparse + delta * center
    if center_max:
        center_val = k[..., int(c_y), int(c_x)]
        # amax splits the gradient among tied maxima, as jnp.max does
        loss = loss + epsilon * (k.amax(dims) - center_val) ** 2
    return loss


def per_band_kernel_regularization(
    kernels: torch.Tensor, weights: dict | None = None, center_max: bool = True
) -> torch.Tensor:
    """Mean of the regularizer over the band axis. kernels: [C, kH, kW], or
    [m, C, kH, kW] for m scenes -> [m]. Default weights: alpha=.5 beta=.5
    gamma=5 delta=1 epsilon=3."""
    w = dict(alpha=0.5, beta=0.5, gamma=5.0, delta=1.0, epsilon=3.0)
    if weights:
        w.update(weights)
    if kernels.ndim == 4:
        reg = kernel_regularization(kernels.flatten(0, 1), center_max=center_max, **w)
        return scene_mean(reg, kernels.shape[0], dim=0)
    return kernel_regularization(kernels, center_max=center_max, **w).mean()


def noise_reg_loss(
    sigma: torch.Tensor, target: torch.Tensor | float = 0.01, mode: str = "l2"
) -> torch.Tensor:
    """Penalize per-band noise sigma away from a target level."""
    t = torch.as_tensor(target, dtype=sigma.dtype, device=sigma.device)
    if mode == "l1":
        return torch.mean(torch.abs(sigma - t))
    return torch.mean((sigma - t) ** 2)


def load_balance_loss(weights: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary load-balance loss on routing weights [B, K]:
    K * sum_k f_k * P_k, f_k the (detached) fraction of the batch
    hard-routed to expert k, P_k the mean soft routing probability. 1 at
    uniform routing, K when every sample routes to one expert."""
    k = weights.shape[-1]
    hard = F.one_hot(weights.argmax(dim=-1), k).to(weights.dtype)
    # the global batch's fractions inside a data-parallel step
    f = batch_mean(hard.mean(dim=0).detach())
    p = batch_mean(weights.mean(dim=0))
    return k * torch.sum(f * p)
