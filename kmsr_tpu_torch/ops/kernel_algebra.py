"""Closed-form composition of stacked linear conv layers into one kernel.

Counterpart of `kmsr_tpu.ops.kernel_algebra`: a chain of bias-free conv
layers is itself one linear convolution, whose effective kernel is the
channel-contracted full convolution of the per-layer weights. Each layer
composition is one `F.conv2d` with "full" padding, run in full float32
(`fp32_convs`, the JAX path's Precision.HIGHEST).

Shapes follow OIHW: layer weights `[C_out, C_in, kH, kW]`. `compose_pair`
and `compose_chain` also take a leading band axis (`[G, C_out, C_in, kH,
kW]`): the G independent chains then compose in one grouped conv per
layer, where JAX vmaps the single-chain function over the bands.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .degrade import fp32_convs


def compose_pair(w_next: torch.Tensor, k_cur: torch.Tensor) -> torch.Tensor:
    """Compose `w_next` applied after the accumulated kernel `k_cur`.

    k_cur: [C_mid, C_in, aH, aW]; w_next: [C_out, C_mid, bH, bW] ->
    [C_out, C_in, aH+bH-1, aW+bW-1] (each with an optional leading band
    axis G, the same on both).

    Two stacked cross-correlations with kernels A then B act as one
    cross-correlation with the full convolution A (*) B, contracted over
    the middle channels: k_cur is a batch of C_in images with C_mid
    channels, correlated with the spatially flipped w_next at full padding.
    """
    single = k_cur.ndim == 4
    if single:
        w_next, k_cur = w_next[None], k_cur[None]
    g, c_mid, c_in, ah, aw = k_cur.shape
    g2, c_out, c_mid2, bh, bw = w_next.shape
    if (g, c_mid) != (g2, c_mid2):
        raise ValueError(f"cannot compose {tuple(w_next.shape)} after "
                         f"{tuple(k_cur.shape)}")
    lhs = k_cur.permute(2, 0, 1, 3, 4).reshape(c_in, g * c_mid, ah, aw)
    rhs = w_next.flip((-2, -1)).reshape(g * c_out, c_mid, bh, bw)
    with fp32_convs():
        out = F.conv2d(lhs, rhs, padding=(bh - 1, bw - 1), groups=g)
    out = out.reshape(c_in, g, c_out, *out.shape[-2:]).permute(1, 2, 0, 3, 4)
    return out[0] if single else out


def compose_chain(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Compose a list of OIHW layer weights into the effective kernel
    [C_out_last, C_in_first, KH, KW], K = sum(k_i) - n + 1 (with the
    leading band axis if the weights have one)."""
    k = weights[0]
    for w in weights[1:]:
        k = compose_pair(w, k)
    return k


def clip_nonneg(k: torch.Tensor) -> torch.Tensor:
    """max(k, 0) with `jnp.clip`'s gradient: half of it at k == 0, where
    `torch.clamp` passes all of it."""
    return torch.maximum(k, k.new_zeros(()))


def effective_kernel(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Scalar-I/O chain -> normalized 2-D blur kernel: mean over (C_out,
    C_in), clamp >= 0, sum-normalize."""
    k = compose_chain(weights).mean(dim=(0, 1))
    k = clip_nonneg(k)
    s = k.sum()
    return k / torch.where(s <= 1e-12, torch.ones_like(s), s)


def full_conv2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full 2-D convolution of two small 2-D kernels."""
    return compose_pair(b[None, None], a[None, None])[0, 0]
