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

Under a (data, model) mesh (`parallel.gan_sharding`) a conv's `w`, `b`, `u`
and its BatchNorm's vectors may be this rank's slice of its O channels: the
rank convolves the full activation into its channels (column-parallel),
normalizes them, and the activations are gathered before the next conv;
spectral norm's contractions over O are partial sums summed over 'model'.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.degrade import fp32_convs
from ..parallel.gan_sharding import sharded_axis
from ..parallel.mesh import (active_mesh, batch_mean, copy_to_model, gather_from_model,
                             model_mesh, model_norm, reduce_from_model)

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


def _spectral_normalize(w: torch.Tensor, u: torch.Tensor, update: bool, rows: bool = False):
    """One power-iteration step; returns (w / sigma, new_u). sigma is
    differentiated through the iteration; only new_u is detached.

    rows: w's O rows (and u) are this rank's shard over 'model': W^T u and
    sigma are partial sums over the rank's rows, summed over the ranks, and
    so is ||W v||^2 (`parallel.mesh.model_norm`); at m = 1 the step is the
    unsharded one bit for bit."""

    def same(x):
        return x

    red, cp, norm = (reduce_from_model, copy_to_model, model_norm) if rows else (same,) * 3
    w_mat = w.reshape(w.shape[0], -1)
    v = _normalized(red(w_mat.T @ u))
    u_new = w_mat @ cp(v)
    u_new = u_new / (norm(torch.linalg.vector_norm(u_new)) + _SN_EPS)
    u_used = u_new if update else u
    v_used = _normalized(red(w_mat.T @ u_used))
    sigma = red(torch.dot(u_used, w_mat @ cp(v_used))[None])[0]
    w_sn = w / (cp(sigma) + _SN_EPS)
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
    tp = model_mesh() is not None

    def sn_conv(i, h, pad):
        """The conv's output: this rank's channels if its weight is sharded
        over 'model', then (True) or the full output (False)."""
        w = convs[i]["w"]
        rows = tp and sharded_axis(w) == 0
        w_sn, u_new = _spectral_normalize(w, state["u"][i], train, rows)
        new_state["u"].append(u_new)
        with fp32_convs():
            return F.conv2d(copy_to_model(h) if rows else h, w_sn, convs[i]["b"],
                            padding=pad), rows

    def full(h, rows):
        return gather_from_model(h, 1) if rows else h

    h, rows = sn_conv(0, x, 3)
    h = F.leaky_relu(h, LEAKY_SLOPE)
    for i in range(len(params["bn_scale"])):
        h, rows = sn_conv(1 + i, full(h, rows), 0)
        h, m, v = batch_norm(
            h, params["bn_scale"][i], params["bn_bias"][i],
            state["bn_mean"][i], state["bn_var"][i], train)
        new_state["bn_mean"].append(m)
        new_state["bn_var"].append(v)
        h = F.leaky_relu(h, LEAKY_SLOPE)
    h, rows = sn_conv(1 + len(params["bn_scale"]), full(h, rows), 0)
    return full(h, rows), new_state
