"""Degradation math: per-band blur + downsample, plain PyTorch path.

Counterpart of `kmsr_tpu.ops.degrade` (same semantics: per-band kernel
renormalization, replicate padding, depthwise cross-correlation, x`factor`
block mean). The JAX package lowers these to XLA convolutions; here they
are grouped `F.conv2d` calls, run in full float32: cuDNN's TF32 default
keeps ~3 decimal digits, and the JAX path asks for Precision.HIGHEST.
`degrade_batch_kernels` (per-sample kernels: the MoE model and the MoE
factory route) is one batch-as-groups conv.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_convs() -> Iterator[None]:
    """Run cuDNN float32 convolutions in full float32 (TF32 off), the
    counterpart of the JAX path's Precision.HIGHEST."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def normalize_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """Renormalize each band's kernel to sum 1 (no-op if the sum is <= 0)."""
    s = kernel.sum(dim=(-2, -1), keepdim=True)
    return torch.where(s > 0, kernel / s, kernel)


def replicate_pad(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Edge-replicate padding on the last two axes of [B, C, H, W]."""
    return F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="replicate")


def depthwise_conv2d(
    x: torch.Tensor, kernel: torch.Tensor, stride: int = 1
) -> torch.Tensor:
    """Depthwise VALID cross-correlation.

    x: [B, C, H, W]; kernel: [C, kH, kW] -> [B, C, H', W'].
    """
    with fp32_convs():
        return F.conv2d(
            x, kernel[:, None].to(x.dtype), stride=stride, groups=x.shape[1]
        )


def block_mean(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Block-mean downsample by `factor` on the last two axes."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // factor, factor, w // factor, factor)
    return x.mean(dim=(3, 5))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """A single 2x2/stride-2 average pool (floors odd sizes)."""
    b, c, h, w = x.shape
    x = x[:, :, : (h // 2) * 2, : (w // 2) * 2]
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.mean(dim=(3, 5))


def _batched_bands(img: torch.Tensor, kernel: torch.Tensor):
    squeeze = img.ndim == 3
    if squeeze:
        img = img[None]
    c = img.shape[1]
    if kernel.ndim == 2:
        kernel = kernel[None].expand(c, *kernel.shape)
    return img, kernel.to(img.device), squeeze


def degrade(
    img: torch.Tensor,
    kernel: torch.Tensor,
    factor: int = 8,
    normalize: bool = True,
) -> torch.Tensor:
    """Blur with a per-band kernel and downsample by `factor`.

    img: [B, C, H, W] or [C, H, W]; kernel: [C, kH, kW] or [kH, kW].
    Returns the same rank with H, W divided by `factor`.
    """
    img, kernel, squeeze = _batched_bands(img, kernel)
    if normalize:
        kernel = normalize_kernel(kernel)
    kh, kw = kernel.shape[-2:]
    x = replicate_pad(img, kh // 2, kw // 2)
    x = depthwise_conv2d(x, kernel)
    out = block_mean(x, factor)
    return out[0] if squeeze else out


def compose_with_box(kernel: torch.Tensor, factor: int) -> torch.Tensor:
    """Compose a blur kernel with the `factor`-wide box mean.

    blur(k) then block_mean(d) == strided conv with (k (*) box_d)/d^2 at
    stride d. Returns the composed [..., kH+d-1, kW+d-1] kernel.
    """
    *lead, kh, kw = kernel.shape
    flat = kernel.reshape(-1, 1, kh, kw)
    box = torch.full((1, 1, factor, factor), 1.0 / (factor * factor),
                     dtype=kernel.dtype, device=kernel.device)
    with fp32_convs():
        comp = F.conv2d(flat, box, padding=factor - 1)
    return comp.reshape(*lead, kh + factor - 1, kw + factor - 1)


def degrade_strided(
    img: torch.Tensor,
    kernel: torch.Tensor,
    factor: int = 8,
    normalize: bool = True,
) -> torch.Tensor:
    """Fused-form degrade: one strided grouped conv.

    Same result as `degrade` (same replicate padding, same blur+box
    composition) as a single stride-`factor` conv with the composed kernel.
    """
    img, kernel, squeeze = _batched_bands(img, kernel)
    if normalize:
        kernel = normalize_kernel(kernel)
    kh, kw = kernel.shape[-2], kernel.shape[-1]
    comp = compose_with_box(kernel, factor)  # [C, kh+f-1, kw+f-1]
    x = replicate_pad(img, kh // 2, kw // 2)
    out = depthwise_conv2d(x, comp, stride=factor)
    return out[0] if squeeze else out


def degrade_batch_kernels(
    img: torch.Tensor,
    kernels: torch.Tensor,
    factor: int = 8,
    decimate: bool = False,
    padding: str = "same",
) -> torch.Tensor:
    """Per-sample per-band kernels: img [B,C,H,W], kernels [B,C,kH,kW].

    One grouped F.conv2d with the batch folded into the channels (groups =
    B*C), the reference's batch-as-groups spelling; the JAX package's
    patch einsum needs a batch chunk to bound its im2col, this spelling
    builds none and runs the whole batch at once.

    padding: "same" zero-pads (kH//2, kW//2), the MoE model's semantics;
    "replicate" edge-pads instead (the factory's and apply_kernel's MoE
    routes). The two differ on a kH//2 rim and are never unified.
    decimate=True keeps every `factor`-th output of the SAME-size blur (the
    MoE model's ::f), computed as a stride-f conv, which evaluates exactly
    those outputs; decimate=False block-means the full blur (the factory).
    """
    b, c, h, w = img.shape
    kh, kw = kernels.shape[-2:]
    if padding == "replicate":
        img = F.pad(img, (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
        pad = (0, 0)
    elif padding == "same":
        pad = (kh // 2, kw // 2)
    else:
        raise ValueError(f"padding must be same|replicate, got {padding!r}")
    stride = factor if decimate else 1
    with fp32_convs():
        out = F.conv2d(img.reshape(1, b * c, *img.shape[2:]),
                       kernels.reshape(b * c, 1, kh, kw).to(img.dtype),
                       stride=stride, padding=pad, groups=b * c)
    out = out.reshape(b, c, *out.shape[2:])
    return out if decimate else block_mean(out, factor)
