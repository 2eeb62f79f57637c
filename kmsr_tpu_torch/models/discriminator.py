"""Fully-convolutional patch discriminator with spectral normalization.

Counterpart of `kmsr_tpu.models.discriminator`: a 7x7 spectrally
normalized conv -> LeakyReLU(0.2) -> `num_blocks` x (1x1 SN conv +
BatchNorm + LeakyReLU) -> 1x1 SN conv, emitting a per-pixel realness map
[B, 1, H, W].

Parameters and mutable state are explicit dicts in the JAX package's
layout: params {"convs": [{"w", "b"}], "bn_scale": [...], "bn_bias": [...]},
state {"u": [...], "bn_mean": [...], "bn_var": [...]}; `discriminator_forward`
returns the new state instead of mutating it. Spectral norm is written out
by hand, not `torch.nn.utils.spectral_norm`: the JAX version takes one
power step, recomputes v from the u it uses, and differentiates through
the whole iteration (only the returned u is detached), where PyTorch's
runs its iteration under no_grad in another order.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.degrade import fp32_convs
from ..parallel.mesh import active_mesh, batch_mean

_SN_EPS = 1e-12
_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1
LEAKY_SLOPE = 0.2


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    in_ch: int = 5
    base_ch: int = 64
    num_blocks: int = 4


def init_discriminator(
    cfg: DiscriminatorConfig = DiscriminatorConfig(),
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> Tuple[dict, dict]:
    """(params, state): fan-in uniform convs (bound 1/sqrt(fan_in), the
    torch Conv2d default), unit-norm normal u vectors, BN at identity.

    Drawn from a CPU `torch.Generator` seeded with `seed` and then moved to
    `device`, so every device starts from the same weights. The draws are
    not JAX's (`jax.random`); parity with a JAX init goes through
    `convert.discriminator_from_jax`.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: dict = {"convs": [], "bn_scale": [], "bn_bias": []}
    state: dict = {"u": [], "bn_mean": [], "bn_var": []}

    def add_conv(out_c, in_c, k):
        bound = 1.0 / (in_c * k * k) ** 0.5
        w = (torch.rand(out_c, in_c, k, k, generator=gen) * 2 - 1) * bound
        b = (torch.rand(out_c, generator=gen) * 2 - 1) * bound
        params["convs"].append({"w": w.to(dev), "b": b.to(dev)})
        u0 = torch.randn(out_c, generator=gen)
        state["u"].append((u0 / (torch.linalg.vector_norm(u0) + _SN_EPS)).to(dev))

    add_conv(cfg.base_ch, cfg.in_ch, 7)
    for _ in range(cfg.num_blocks):
        add_conv(cfg.base_ch, cfg.base_ch, 1)
        params["bn_scale"].append(torch.ones(cfg.base_ch, device=dev))
        params["bn_bias"].append(torch.zeros(cfg.base_ch, device=dev))
        state["bn_mean"].append(torch.zeros(cfg.base_ch, device=dev))
        state["bn_var"].append(torch.ones(cfg.base_ch, device=dev))
    add_conv(1, cfg.base_ch, 1)
    return params, state


def _normalized(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + _SN_EPS)


def _spectral_normalize(w: torch.Tensor, u: torch.Tensor, update: bool):
    """One power-iteration step; returns (w / sigma, new_u). sigma is
    differentiated through the iteration; only new_u is detached."""
    w_mat = w.reshape(w.shape[0], -1)
    v = _normalized(w_mat.T @ u)
    u_new = _normalized(w_mat @ v)
    u_used = u_new if update else u
    v_used = _normalized(w_mat.T @ u_used)
    sigma = torch.dot(u_used, w_mat @ v_used)
    w_sn = w / (sigma + _SN_EPS)
    return w_sn, (u_new.detach() if update else u)


def batch_norm(x, scale, bias, mean_run, var_run, train: bool):
    """BN over (B, H, W): normalize with the biased batch variance, update
    the running variance with the unbiased one; running stats detached.

    Inside a `parallel.mesh.data_parallel` block the statistics are the
    global batch's, as JAX's sharded step computes them: the ranks' means
    are averaged, and the variance is the mean of each rank's variance plus
    its mean's squared distance from the global mean (exact for equal
    per-rank batches), both differentiable across ranks."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        mesh = active_mesh()
        if mesh is not None:
            local_mean, mean = mean, batch_mean(mean)
            var = batch_mean(var + (local_mean - mean) ** 2)
            n *= mesh.size
        unbiased = var * n / max(n - 1, 1)
        new_mean = (1 - _BN_MOMENTUM) * mean_run + _BN_MOMENTUM * mean
        new_var = (1 - _BN_MOMENTUM) * var_run + _BN_MOMENTUM * unbiased
    else:
        mean, var = mean_run, var_run
        new_mean, new_var = mean_run, var_run
    inv = torch.rsqrt(var + _BN_EPS)
    y = (x - mean[None, :, None, None]) * inv[None, :, None, None]
    y = y * scale[None, :, None, None] + bias[None, :, None, None]
    return y, new_mean.detach(), new_var.detach()


def discriminator_forward(
    params: dict, state: dict, x: torch.Tensor, train: bool = True
) -> Tuple[torch.Tensor, dict]:
    """x: [B, C, H, W] -> (score map [B, 1, H, W], new_state)."""
    new_state: dict = {"u": [], "bn_mean": [], "bn_var": []}
    convs = params["convs"]

    def sn_conv(i, h, pad):
        w_sn, u_new = _spectral_normalize(convs[i]["w"], state["u"][i], train)
        new_state["u"].append(u_new)
        with fp32_convs():
            return F.conv2d(h, w_sn, convs[i]["b"], padding=pad)

    h = F.leaky_relu(sn_conv(0, x, 3), LEAKY_SLOPE)
    for i in range(len(params["bn_scale"])):
        h, m, v = batch_norm(
            sn_conv(1 + i, h, 0), params["bn_scale"][i], params["bn_bias"][i],
            state["bn_mean"][i], state["bn_var"][i], train)
        new_state["bn_mean"].append(m)
        new_state["bn_var"].append(v)
        h = F.leaky_relu(h, LEAKY_SLOPE)
    return sn_conv(1 + len(params["bn_scale"]), h, 0), new_state
