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


#: samples a pass of `_GemmWeightGradConv`'s weight gradient takes, and
#: the length of each GEMM's share of the summed pixels
_WGRAD_CHUNK, _WGRAD_SEG = 4, 4096


def _seg_matmul_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[k, g, :]^T b[k, g, :] per group: a [K, G, M], b [K, G, N] ->
    [G, M, N], as one GEMM per segment of _WGRAD_SEG rows (zero-padded),
    summed in a fixed order: a long K in one GEMM leaves the card idle."""
    k = a.shape[0]
    n_seg = -(-k // _WGRAD_SEG)
    pad = n_seg * _WGRAD_SEG - k
    a = F.pad(a, (0, 0, 0, 0, 0, pad)).reshape(n_seg, _WGRAD_SEG, *a.shape[1:])
    b = F.pad(b, (0, 0, 0, 0, 0, pad)).reshape(n_seg, _WGRAD_SEG, *b.shape[1:])
    return torch.matmul(a.permute(2, 0, 3, 1), b.permute(2, 0, 1, 3)).sum(dim=1)


class _GemmWeightGradConv(torch.autograd.Function):
    """Grouped VALID conv (cuDNN forward, full float32) whose weight
    gradient is GEMMs over the pixels: per group dW = dY @ cols^T, with
    cols the input's im2col (the input itself for a 1x1 conv), summed over
    the batch in chunks of _WGRAD_CHUNK samples. The input's gradient, for
    1x1 convs only, is a matmul over the groups. cuBLAS runs both
    deterministically with CUBLAS_WORKSPACE_CONFIG set; cuDNN's
    deterministic weight gradients of these layers doubled the generator
    chains' time on an H100 (`scripts/torch_det_ab.py`).
    """

    @staticmethod
    def forward(ctx, x, w, groups):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        with fp32_convs():
            return F.conv2d(x, w, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = ctx.groups
        cout, cin, kh, kw = w.shape
        co = cout // g
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            gx = None
            if ctx.needs_input_grad[0]:  # 1x1 only (see `chain_conv`)
                b, _, h, wd = gy.shape
                gx = torch.einsum("ngo,goi->ngi", gy.permute(0, 2, 3, 1).reshape(-1, g, co),
                                  w.reshape(g, co, cin))
                gx = gx.reshape(b, h, wd, g * cin).permute(0, 3, 1, 2)
            dw = None
            for s in range(0, gy.shape[0], _WGRAD_CHUNK):
                xs, gys = x[s:s + _WGRAD_CHUNK], gy[s:s + _WGRAD_CHUNK]
                rows = gys.shape[0] * gys.shape[2] * gys.shape[3]
                if kh == kw == 1:
                    cols = xs.permute(0, 2, 3, 1).reshape(rows, g, cin)
                else:
                    cols = F.unfold(xs, (kh, kw)).transpose(1, 2).reshape(rows, g, cin * kh * kw)
                part = _seg_matmul_sum(gys.permute(0, 2, 3, 1).reshape(rows, g, co), cols)
                dw = part if dw is None else dw + part
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return gx, dw.reshape(cout, cin, kh, kw), None


def chain_conv(x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    """One layer of a generator's grouped conv chain: F.conv2d(x, w,
    groups=groups), VALID, in full float32, with the backward spelt so
    that it stays fast under the trainers' deterministic algorithms on
    the card: a 1x1 layer, and a layer whose input needs no gradient (the
    first: the padded input batch), take their gradients from
    `_GemmWeightGradConv`; any other layer is cuDNN's throughout.

    x: [B, Cin, H, W]; w: [Cout, Cin/groups, k, k].
    """
    if w.shape[-1] == w.shape[-2] == 1 or not x.requires_grad:
        return _GemmWeightGradConv.apply(x, w, groups)
    with fp32_convs():
        return F.conv2d(x, w, groups=groups)
