"""Mixture-of-experts kernel bank (content-adaptive degradation).

Counterpart of `kmsr_tpu.models.moe`: a light CNN selector produces K
logits; a Gumbel-softmax (annealed temperature, optional straight-through
hard selection) mixes a learnable kernel bank [K, C, 13, 13] (spatial
softmax -> non-negative, each band sums to 1) and a sigma bank [K, C]
(softplus); the mixed per-sample kernels degrade the input (SAME zero
padding, ::f decimation) and Gaussian noise scaled by the mixed sigma is
added.

Parameters and the selector's BatchNorm state are explicit dicts in the
JAX package's layout (params {"selector": {"convs": [{"w", "b"}],
"bn_scale", "bn_bias", "fc_w", "fc_b"}, "kernel_bank", "sigma_bank"},
state {"selector": {"bn_mean", "bn_var"}}), so `convert.moe_from_jax` and
`utils.params_io` are plain copies. The BatchNorm is threaded by hand, as
the discriminator's: train mode normalizes with the biased batch variance
and updates the running variance with the unbiased one (momentum 0.1);
eval mode uses the running stats.

Random draws (Gumbel uniforms, output noise) come from a `torch.Generator`
or are passed in as tensors (`gumbel_u`, `noise`); the streams are not
`jax.random`'s.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.degrade import degrade_batch_kernels, fp32_convs
from .discriminator import batch_norm

#: the selector's three stride-2 convs: (out, in) channels after the input
_SELECTOR_CHANNELS = (32, 64, 128)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_kernels: int = 10
    n_channels: int = 5
    kernel_size: int = 13
    factor: int = 4          # the reference decimates ::4
    sigma_init: float = 0.5


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2 - 1) * bound


# ---------------------------------------------------------------- selector
def init_selector(cfg: MoEConfig, gen: torch.Generator,
                  device: torch.device) -> tuple[dict, dict]:
    """Fan-in uniform convs and classifier, BN at identity; (params, state).
    Drawn from the CPU generator `gen`, then moved to `device`."""
    params: dict = {"convs": [], "bn_scale": [], "bn_bias": []}
    state: dict = {"bn_mean": [], "bn_var": []}
    in_c = cfg.n_channels
    for out_c in _SELECTOR_CHANNELS:
        bound = 1.0 / (in_c * 9) ** 0.5
        params["convs"].append({"w": _uniform(gen, (out_c, in_c, 3, 3), bound).to(device),
                                "b": _uniform(gen, (out_c,), bound).to(device)})
        params["bn_scale"].append(torch.ones(out_c, device=device))
        params["bn_bias"].append(torch.zeros(out_c, device=device))
        state["bn_mean"].append(torch.zeros(out_c, device=device))
        state["bn_var"].append(torch.ones(out_c, device=device))
        in_c = out_c
    bound = 1.0 / in_c ** 0.5
    params["fc_w"] = _uniform(gen, (cfg.n_kernels, in_c), bound).to(device)
    params["fc_b"] = _uniform(gen, (cfg.n_kernels,), bound).to(device)
    return params, state


def selector_forward(
    params: dict, state: dict, x: torch.Tensor, train: bool = True
) -> tuple[torch.Tensor, dict]:
    """x: [B, C, H, W] -> (logits [B, K], new BN state)."""
    new_state: dict = {"bn_mean": [], "bn_var": []}
    h = x
    for i, conv in enumerate(params["convs"]):
        with fp32_convs():
            h = F.conv2d(h, conv["w"], conv["b"], stride=2, padding=1)
        h, m, v = batch_norm(h, params["bn_scale"][i], params["bn_bias"][i],
                             state["bn_mean"][i], state["bn_var"][i], train)
        new_state["bn_mean"].append(m)
        new_state["bn_var"].append(v)
        h = F.relu(h)
    feat = h.mean(dim=(2, 3))  # GAP [B, 128]
    return feat @ params["fc_w"].T + params["fc_b"], new_state


# ---------------------------------------------------------------- banks
def init_moe(cfg: MoEConfig = MoEConfig(), seed: int = 0,
             device: str | torch.device = "cuda") -> tuple[dict, dict]:
    """(params, state): the selector, a near-delta kernel bank (1 at the
    centre plus N(0, 0.01)) and sigma_init everywhere. Drawn from a CPU
    generator seeded with `seed`; parity with a JAX init goes through
    `convert.moe_from_jax`."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    sel_params, sel_state = init_selector(cfg, gen, dev)
    c = cfg.kernel_size // 2
    shape = (cfg.n_kernels, cfg.n_channels, cfg.kernel_size, cfg.kernel_size)
    bank = torch.randn(shape, generator=gen) * 0.01
    bank[:, :, c, c] += 1.0
    params = {
        "selector": sel_params,
        "kernel_bank": bank.to(dev),
        "sigma_bank": torch.full((cfg.n_kernels, cfg.n_channels), cfg.sigma_init,
                                 device=dev),
    }
    return params, {"selector": sel_state}


def effective_kernels(params: dict) -> torch.Tensor:
    """Spatial-softmax kernels: non-negative, each band sums to 1. [K,C,kh,kw]."""
    bank = params["kernel_bank"]
    k, c, kh, kw = bank.shape
    return torch.softmax(bank.reshape(k, c, kh * kw), dim=-1).reshape(k, c, kh, kw)


def effective_sigmas(params: dict) -> torch.Tensor:
    return F.softplus(params["sigma_bank"])


def gumbel_uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniforms in [1e-10, 1), as the JAX package draws them (in float32
    the largest draw, 1 - 2^-24, stays below 1 after the shift)."""
    return torch.rand(shape, generator=gen, device=device) + 1e-10


def standard_normal(gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """A standard normal draw shaped like `like` (the output noise)."""
    return torch.randn(like.shape, generator=gen, device=like.device, dtype=like.dtype)


def gumbel_softmax(logits: torch.Tensor, tau, hard: bool = False, *,
                   gen: torch.Generator | None = None,
                   u: torch.Tensor | None = None) -> torch.Tensor:
    """softmax((logits + Gumbel) / tau) from uniforms `u` (drawn from `gen`
    when not given). hard=True is straight-through: the forward value is
    the one-hot of the argmax, the gradient the soft sample's."""
    if u is None:
        u = gumbel_uniform(gen, logits.shape, logits.device)
    y = torch.softmax((logits - torch.log(-torch.log(u))) / tau, dim=-1)
    if hard:
        y_hard = F.one_hot(y.argmax(dim=-1), logits.shape[-1]).to(y.dtype)
        y = y_hard + y - y.detach()
    return y


def moe_forward(
    params: dict,
    state: dict,
    x: torch.Tensor,
    temp=1.0,
    hard: bool = False,
    train: bool = True,
    cfg: MoEConfig = MoEConfig(),
    *,
    gen: torch.Generator | None = None,
    gumbel_u: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
):
    """Returns (degraded [B,C,H/f,W/f], weights [B,K], kernels [K,C,kh,kw],
    new_state). The Gumbel uniforms and the standard-normal noise come from
    `gen` unless given."""
    logits, sel_state = selector_forward(params["selector"], state["selector"], x, train)
    weights = gumbel_softmax(logits, temp, hard, gen=gen, u=gumbel_u)
    valid_kernels = effective_kernels(params)
    valid_sigmas = effective_sigmas(params)
    batch_kernels = torch.einsum("bk,kchw->bchw", weights, valid_kernels)
    batch_sigmas = weights @ valid_sigmas
    out = degrade_batch_kernels(x, batch_kernels, factor=cfg.factor, decimate=True)
    if noise is None:
        noise = standard_normal(gen, out)
    return (out + noise * batch_sigmas[:, :, None, None], weights, valid_kernels,
            {"selector": sel_state})
