"""Carry the JAX package's state across to this one.

On the factory path that state is two arrays, both plain numpy on disk:

* the kernel artifact (`kernel_per_band.npy` from KernelGAN, or any array
  `kmsr_tpu.pipeline.apply_kernel.load_kernel` takes) — `kernel_from_jax`;
* the noise pool ([N, C, h, w], `kmsr_tpu.data.noise_pool`) —
  `noise_pool_from_jax`.

The whole-scene degrade path (`pipeline.degrade_scene`) carries nothing
more: its only state is the same kernel artifact, so `kernel_from_jax`
serves it too. Generator, discriminator and MoE parameters come with their
own slices.
"""
from __future__ import annotations

import numpy as np
import torch

from .data.noise_pool import validate_noise_pool
from .device import resolve_device
from .pipeline.apply_kernel import kernel_bands


def _array(arr_or_path, what: str) -> tuple[np.ndarray, str]:
    if isinstance(arr_or_path, (str, bytes)) or hasattr(arr_or_path, "__fspath__"):
        return np.load(arr_or_path), str(arr_or_path)
    return np.asarray(arr_or_path), what


def kernel_from_jax(
    arr_or_path, n_bands: int = 5, device: str | torch.device = "cuda"
) -> torch.Tensor:
    """A JAX-side kernel (array or `.npy` path) as a [C, kH, kW] float32
    tensor on `device`, under the JAX `load_kernel` rules: [kH, kW]
    broadcasts to all bands, [C, kH, kW] is per band, [B, C, kH, kW] is
    mean-reduced over B, and a band that sums to ~0 or is non-finite
    raises ValueError."""
    dev = resolve_device(device)
    k, name = _array(arr_or_path, "kernel")
    return torch.from_numpy(kernel_bands(k, n_bands, name)).to(dev)


def noise_pool_from_jax(
    arr_or_path, device: str | torch.device = "cuda"
) -> torch.Tensor:
    """A JAX-side noise pool (array or `.npy` path) as a validated
    [N, C, h, w] float32 tensor on `device`."""
    dev = resolve_device(device)
    pool, _ = _array(arr_or_path, "noise pool")
    return torch.from_numpy(validate_noise_pool(pool)).to(dev)
