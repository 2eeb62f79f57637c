"""Carry the JAX package's state across to this one.

On the factory path that state is two arrays, both plain numpy on disk:

* the kernel artifact (`kernel_per_band.npy` from KernelGAN, or any array
  `kmsr_tpu.pipeline.apply_kernel.load_kernel` takes) — `kernel_from_jax`;
* the noise pool ([N, C, h, w], `kmsr_tpu.data.noise_pool`) —
  `noise_pool_from_jax`.

The whole-scene degrade path (`pipeline.degrade_scene`) carries nothing
more: its only state is the same kernel artifact, so `kernel_from_jax`
serves it too.

KernelGAN's generator and discriminator parameters (and the
discriminator's spectral-norm / BatchNorm state) are pytrees of the same
layout in both packages: `generator_from_jax` and `discriminator_from_jax`
take them as numpy arrays (`jax.device_get` on the JAX side) and copy them
leaf for leaf. The MoE model (selector, kernel and sigma banks, and the
selector's BatchNorm state) and the dynamic degradation model (modulated
chain, condition encoder, noise estimator) carry across the same way:
`moe_from_jax`, `dynamic_from_jax`. Their `.npz` model files need no
conversion: `utils.params_io` reads and writes JAX's layout.
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


def _tree_to(tree, dev: torch.device):
    """numpy leaves of nested dicts / lists -> float32 tensors on dev."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, dev) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(dev)


def generator_from_jax(g_params: dict, device: str | torch.device = "cuda") -> dict:
    """JAX generator params ({"layers": [[band, out, in, k, k]], and
    "log_sigma" [band] when present}, numpy leaves) as the port's params
    on `device`."""
    return _tree_to(g_params, resolve_device(device))


def discriminator_from_jax(
    d_params: dict, d_state: dict, device: str | torch.device = "cuda"
) -> tuple[dict, dict]:
    """JAX discriminator params (conv "w" / "b", "bn_scale", "bn_bias") and
    state ("u", "bn_mean", "bn_var"), numpy leaves, as the port's
    (params, state) on `device`."""
    dev = resolve_device(device)
    return _tree_to(d_params, dev), _tree_to(d_state, dev)


def moe_from_jax(
    params: dict, state: dict, device: str | torch.device = "cuda"
) -> tuple[dict, dict]:
    """JAX MoE params ({"selector": {...}, "kernel_bank", "sigma_bank"}) and
    state ({"selector": {"bn_mean", "bn_var"}}), numpy leaves, as the
    port's (params, state) on `device`."""
    dev = resolve_device(device)
    return _tree_to(params, dev), _tree_to(state, dev)


def dynamic_from_jax(params: dict, device: str | torch.device = "cuda") -> dict:
    """JAX dynamic degradation-model params ({"generator": {"layers",
    "encoder"}, "noise": {"log_sigma"}}, or the generator dict alone),
    numpy leaves, as the port's params on `device`."""
    return _tree_to(params, resolve_device(device))
