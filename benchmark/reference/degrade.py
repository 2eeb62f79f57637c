"""Plain degradation model of the factory: lr = blur(hr) decimated by an
x`factor` block mean, plus a noise-pool draw.

Each band's kernel is renormalised to sum 1, the patch edge-replicated by
half the kernel, the blur taken at full resolution as a cross-correlation,
and every `factor` x `factor` block averaged (the semantics of the
pipeline's degrade: `kmsr_tpu/ops/degrade.py`). Computed in float64 for
the check; `tf32=True` rounds the operands to TF32 (10 mantissa bits) and
accumulates in float32, the control one precision step down.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def degrade(hr: torch.Tensor, kernel: torch.Tensor, factor: int,
            tf32: bool = False) -> torch.Tensor:
    """hr [n, C, H, W], kernel [C, k, k] -> [n, C, H/factor, W/factor]."""
    dtype = torch.float32 if tf32 else torch.float64
    k = kernel.to(torch.float64)
    k = (k / k.sum(dim=(-2, -1), keepdim=True)).to(dtype)
    x = hr.to(dtype)
    if tf32:
        k, x = round_tf32(k), round_tf32(x)
    n, c, h, w = x.shape
    p = k.shape[-1] // 2
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(F.pad(x, (p, p, p, p), mode="replicate"), k[:, None], groups=c)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return y.reshape(n, c, h // factor, factor, w // factor, factor).mean(dim=(3, 5))


def pool_indices(seed: int, n_files: int, pool_size: int):
    """The noise-pool entry of each file, files in sorted order: one draw a
    file from `numpy.random.default_rng(seed)`, the pipeline's rule, so a
    file's lr does not depend on batching or on other files failing."""
    import numpy as np

    return np.random.default_rng(seed).integers(0, pool_size, size=n_files)
