"""Image-quality metrics: PSNR and SSIM.

Counterpart of `kmsr_tpu.ops.metrics`, the SR stages' "PSNR/SSIM parity"
metrics. SSIM follows Wang et al. 2004 with the standard 11x11 sigma=1.5
Gaussian window (a VALID depthwise filter, full float32) and K1=0.01,
K2=0.03.

Both take [..., C, H, W] pairs and reduce the last three axes: a scalar
for one [C, H, W] pair, as the JAX functions; one value a sample for a
batch. `data_range` is a number or a tensor of the leading shape; the
constants built from it are rounded to float32 once, as JAX rounds a
Python number.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .degrade import fp32_convs


def _squared(data_range, scale: float, lead: torch.Size):
    """(scale * data_range)^2: for a tensor of the leading shape, computed
    in float64 and rounded to float32; for a number, a Python float (the
    ops round it to float32, as JAX does a weakly typed constant)."""
    if isinstance(data_range, torch.Tensor):
        return ((scale * data_range.double()) ** 2).float().expand(lead)
    return (scale * data_range) ** 2


def psnr(a: torch.Tensor, b: torch.Tensor, data_range) -> torch.Tensor:
    mse = ((a.float() - b.float()) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(_squared(data_range, 1.0, mse.shape) / mse.clamp_min(1e-12))


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The [size, size] window on `device` (made once per device)."""
    xs = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(xs**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g).to(device)


def _filter2d(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID filter of [N, C, H, W] in full float32."""
    c = x.shape[1]
    with fp32_convs():
        return F.conv2d(x, win.expand(c, 1, *win.shape), groups=c)


def ssim(
    a: torch.Tensor,
    b: torch.Tensor,
    data_range,
    win_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM of each [C, H, W] pair."""
    lead, (c, h, w) = a.shape[:-3], a.shape[-3:]
    a = a.float().reshape(-1, c, h, w)
    b = b.float().reshape(-1, c, h, w)
    # the five local moments in one grouped filter
    moments = _filter2d(torch.cat([a, b, a * a, b * b, a * b], dim=1),
                        _gaussian_window(win_size, sigma, a.device))
    mu_a, mu_b, mu_aa, mu_bb, mu_ab = moments.split(c, dim=1)
    var_a = mu_aa - mu_a**2
    var_b = mu_bb - mu_b**2
    cov = mu_ab - mu_a * mu_b
    c1, c2 = (_squared(data_range, k, lead) for k in (0.01, 0.03))
    if isinstance(data_range, torch.Tensor):
        c1, c2 = c1.reshape(-1, 1, 1, 1), c2.reshape(-1, 1, 1, 1)
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    return s.mean(dim=(1, 2, 3)).reshape(lead)
