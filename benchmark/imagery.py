"""Seeded synthetic imagery, weights and kernels, made on the run's device
in a few large calls.

Ocean-colour bands are smooth: radiance falls from the blue to the NIR
band, varies over tens of pixels with fronts and eddies, and carries
sensor noise of about a percent. `fields` draws that: per sample and band
a mean, a sum of separable random sinusoids and white noise.
"""
from __future__ import annotations

import torch

#: band means (TOA radiance, W m-2 sr-1 um-1) of the five bands, 443 to 865 nm
BAND_MEANS = (60.0, 50.0, 35.0, 20.0, 8.0)


def fields(gen: torch.Generator, n: int, bands: int, h: int, w: int,
           device: torch.device, terms: int = 4, noise: float = 0.01) -> torch.Tensor:
    """[n, bands, h, w] float32: mean x (1 + 0.1 * sum of `terms` separable
    sinusoids of 1 to 8 periods a side + `noise` white noise)."""
    def draw(*shape):
        return torch.rand(shape, generator=gen, device=device)

    mean = torch.tensor(BAND_MEANS[:bands], device=device)
    mean = mean * (0.8 + 0.4 * draw(n, bands))  # [n, bands]
    fy = 2 * torch.pi * (1 + 7 * draw(n, bands, terms, 1)) / h
    fx = 2 * torch.pi * (1 + 7 * draw(n, bands, terms, 1)) / w
    py, px = 2 * torch.pi * draw(n, bands, terms, 1), 2 * torch.pi * draw(n, bands, terms, 1)
    amp = draw(n, bands, terms, 1) / terms
    ys = torch.arange(h, device=device, dtype=torch.float32)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    rows = torch.sin(fy * ys + py) * amp  # [n, bands, terms, h]
    cols = torch.cos(fx * xs + px)  # [n, bands, terms, w]
    smooth = torch.einsum("nbth,nbtw->nbhw", rows, cols)
    white = torch.randn((n, bands, h, w), generator=gen, device=device)
    return mean[:, :, None, None] * (1 + 0.1 * smooth + noise * white)


def blur_kernel(gen: torch.Generator, bands: int, size: int,
                device: torch.device) -> torch.Tensor:
    """[bands, size, size] float32, each band a normalised anisotropic
    Gaussian (sigma 1.2 to 3 px a side, rotated) times a positive
    perturbation: the shape of a learned KernelGAN kernel."""
    def draw(*shape):
        return torch.rand(shape, generator=gen, device=device)

    r = torch.arange(size, device=device, dtype=torch.float32) - size // 2
    y, x = r[:, None], r[None, :]
    sy, sx = 1.2 + 1.8 * draw(bands, 1, 1), 1.2 + 1.8 * draw(bands, 1, 1)
    th = torch.pi * draw(bands, 1, 1)
    u = torch.cos(th) * x + torch.sin(th) * y
    v = -torch.sin(th) * x + torch.cos(th) * y
    k = torch.exp(-0.5 * ((u / sx) ** 2 + (v / sy) ** 2)) * (0.9 + 0.2 * draw(bands, size, size))
    return k / k.sum(dim=(1, 2), keepdim=True)


def uniform(gen: torch.Generator, shape: tuple, bound: float,
            device: torch.device) -> torch.Tensor:
    """Uniform in [-bound, bound), float32."""
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound
