"""Content-conditioned (dynamic) degradation model.

Counterpart of `kmsr_tpu.models.dynamic`: a light CNN condition encoder
emits per-band x per-layer x per-out-channel scale factors (`1 +
0.1*tanh`, ~[0.9, 1.1]) that modulate a bank of learnable deep-linear conv
chains per sample; a learnable per-band noise sigma (clamped exp) adds
Gaussian noise to the degraded output.

The JAX package vmaps one (sample, band) chain over batch and band, each
conv with its weights scaled per sample and output channel. Scaling a
conv's output channel scales its weights' rows, so here the chain is
KernelGAN's grouped conv chain (groups = bands, the batch as the batch)
with each layer's output multiplied by the sample's scales, and reflect
padding before each k > 1 layer, then a x`factor` block mean. (Folding
the batch into the groups with per-sample weights, groups = B*C, took
0.84-0.88 s of device time a training step on an H100 at batch 8, most
of it in cuDNN's weight gradient; PERF.md, PR 8.) Every conv runs in full
float32 (`fp32_convs`). The activations are channels_last by default:
cuDNN's float32 grouped convs transpose NCHW ones on an H100 (the
KernelGAN chain's lesson; 75 vs 188 ms a training step here, PERF.md).

Parameters are dicts in the JAX package's layout ({"generator":
{"layers": [w_i [band, out, in, k, k]], "encoder": {...}}, "noise":
{"log_sigma"}}), so `convert.dynamic_from_jax` is a plain copy. Effective
kernels compose each modulated chain in closed form
(`ops.kernel_algebra.compose_chain`), detached by default as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.degrade import block_mean, fp32_convs
from ..ops.kernel_algebra import clip_nonneg, compose_chain, chain_conv
from .moe import standard_normal

DEFAULT_KS = (7, 5, 3, 1, 1, 1)


@dataclasses.dataclass(frozen=True)
class DynamicConfig:
    in_ch: int = 5
    mid_ch: int = 32
    ks: Sequence[int] = DEFAULT_KS
    scale_gain: float = 0.1
    factor: int = 8
    noise_init: float = 0.3
    noise_max: float = 1.2

    @property
    def layer_out_channels(self) -> list[int]:
        return [self.mid_ch] * (len(self.ks) - 1) + [1]

    @property
    def total_scales(self) -> int:
        return self.in_ch * sum(self.layer_out_channels)


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2 - 1) * bound


# ---------------------------------------------------------------- encoder
def init_condition_encoder(cfg: DynamicConfig, gen: torch.Generator,
                           device: torch.device) -> dict:
    """Fan-in uniform convs (5->32 s1, 32->64 s2, 64->64 s2, all 3x3) and
    the 64 -> total_scales classifier, drawn from the CPU generator `gen`."""

    def conv_init(out_c, in_c, k):
        bound = 1.0 / (in_c * k * k) ** 0.5
        return {"w": _uniform(gen, (out_c, in_c, k, k), bound).to(device),
                "b": _uniform(gen, (out_c,), bound).to(device)}

    enc = {"conv1": conv_init(32, cfg.in_ch, 3), "conv2": conv_init(64, 32, 3),
           "conv3": conv_init(64, 64, 3)}
    enc["fc_w"] = _uniform(gen, (cfg.total_scales, 64), 1.0 / 8.0).to(device)
    enc["fc_b"] = _uniform(gen, (cfg.total_scales,), 1.0 / 8.0).to(device)
    return enc


def condition_encoder_forward(params: dict, x: torch.Tensor, cfg: DynamicConfig) -> torch.Tensor:
    """x: [B, C, H, W] -> raw scale logits [B, total_scales]."""
    h = x
    with fp32_convs():
        for name, stride in (("conv1", 1), ("conv2", 2), ("conv3", 2)):
            h = F.relu(F.conv2d(h, params[name]["w"], params[name]["b"],
                                stride=stride, padding=1))
    return h.mean(dim=(2, 3)) @ params["fc_w"].T + params["fc_b"]


def split_scales(raw: torch.Tensor, cfg: DynamicConfig) -> list[list[torch.Tensor]]:
    """[B, total] -> scales[band][layer] of [B, out_c], each 1+gain*tanh."""
    scales, start = [], 0
    for _ in range(cfg.in_ch):
        band = []
        for out_c in cfg.layer_out_channels:
            band.append(1.0 + cfg.scale_gain * torch.tanh(raw[:, start:start + out_c]))
            start += out_c
        scales.append(band)
    return scales


def _layer_scales(raw: torch.Tensor, cfg: DynamicConfig) -> list[torch.Tensor]:
    """[B, total] -> per layer [B, band, out_c] (the band-major order of
    `split_scales`)."""
    s = 1.0 + cfg.scale_gain * torch.tanh(raw.reshape(raw.shape[0], cfg.in_ch, -1))
    return list(torch.split(s, cfg.layer_out_channels, dim=-1))


def _modulated(layers: Sequence[torch.Tensor], scales: Sequence[torch.Tensor]):
    """Per-(sample, band) chain weights [B*C, out, in, k, k] per layer:
    layer weights [C, out, in, k, k] times scales [B, C, out]."""
    return [(w[None] * s[:, :, :, None, None, None]).reshape(-1, *w.shape[1:])
            for w, s in zip(layers, scales)]


# ---------------------------------------------------------------- generator
def init_dynamic_generator(cfg: DynamicConfig = DynamicConfig(), seed: int = 0,
                           device: str | torch.device = "cuda") -> dict:
    """N(0, 0.01) chain weights [band, out, in, k, k] and the encoder, drawn
    from a CPU generator seeded with `seed` (not JAX's draws; parity with a
    JAX init goes through `convert.dynamic_from_jax`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    layers, in_c = [], 1
    for k, out_c in zip(cfg.ks, cfg.layer_out_channels):
        layers.append((torch.randn(cfg.in_ch, out_c, in_c, k, k, generator=gen)
                       * 0.01).to(dev))
        in_c = out_c
    return {"layers": layers, "encoder": init_condition_encoder(cfg, gen, dev)}


def _chain(layers: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
           x: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """The B*C modulated chains: per layer a grouped conv (groups = bands)
    with the shared weights [C, out, in, k, k], then each sample's scales
    [B, C, out] on its output channels. x: [B, C, H, W] -> [B, C, H, W]."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    h = x.contiguous(memory_format=fmt)
    with fp32_convs():
        for w, s in zip(layers, scales):
            bands, out_c, in_c, k, _ = w.shape
            if k > 1:
                p = k // 2
                h = F.pad(h, (p, p, p, p), mode="reflect").contiguous(memory_format=fmt)
            h = chain_conv(h, w.reshape(bands * out_c, in_c, k, k), bands)
            h = h * s.reshape(s.shape[0], bands * out_c, 1, 1)
    return h


def dynamic_generator_forward(params: dict, x: torch.Tensor,
                              cfg: DynamicConfig = DynamicConfig(),
                              channels_last: bool = True) -> torch.Tensor:
    """x: [B, C, H, W] -> [B, C, H/f, W/f] with per-sample dynamic kernels;
    channels_last=False runs the chain on NCHW activations."""
    raw = condition_encoder_forward(params["encoder"], x, cfg)
    return block_mean(_chain(params["layers"], _layer_scales(raw, cfg), x, channels_last),
                      cfg.factor)


def extract_dynamic_kernels(
    params: dict,
    x: torch.Tensor | None = None,
    cfg: DynamicConfig = DynamicConfig(),
    reduce_batch: bool = True,
    differentiable: bool = False,
) -> torch.Tensor:
    """Per-sample effective kernels [B, C, KH, KW] (or the batch mean
    [C, KH, KW]), each clamped >= 0 and sum-normalized.

    With x=None, unit scales are used (the unmodulated bank). Detached by
    default (the reference's quirk, kept by the JAX package): the kernel
    regularizer then gives the generator no gradient.
    """
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        layers = params["layers"]
        if x is None:
            b = 1
            scales = [w.new_ones(1, cfg.in_ch, oc)
                      for w, oc in zip(layers, cfg.layer_out_channels)]
        else:
            b = x.shape[0]
            scales = _layer_scales(condition_encoder_forward(params["encoder"], x, cfg), cfg)
        k = compose_chain(_modulated(layers, scales)).mean(dim=(1, 2))  # [B*C, K, K]
        k = clip_nonneg(k)
        s = k.sum(dim=(1, 2), keepdim=True)
        k = k / torch.where(s <= 1e-12, torch.ones_like(s), s)
        kernels = k.reshape(b, cfg.in_ch, *k.shape[1:])
        return kernels.mean(dim=0) if reduce_batch else kernels


# ---------------------------------------------------------------- noise
def init_noise_estimator(cfg: DynamicConfig = DynamicConfig(),
                         device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    return {"log_sigma": torch.log(torch.full((cfg.in_ch,), cfg.noise_init)).to(dev)}


def noise_sigma(params: dict, cfg: DynamicConfig = DynamicConfig()) -> torch.Tensor:
    """clip(exp(log_sigma), 1e-5, noise_max), with `jnp.clip`'s gradient (a
    tie at a bound splits it)."""
    e = torch.exp(params["log_sigma"])
    return torch.minimum(torch.maximum(e, e.new_tensor(1e-5)), e.new_tensor(cfg.noise_max))


def add_estimated_noise(
    params: dict, x: torch.Tensor, cfg: DynamicConfig = DynamicConfig(), *,
    gen: torch.Generator | None = None, noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + N(0, 1) * sigma per band, sigma); the standard-normal draw comes
    from `gen` unless given."""
    sigma = noise_sigma(params, cfg)
    if noise is None:
        noise = standard_normal(gen, x)
    return x + noise * sigma[None, :, None, None], sigma


# ---------------------------------------------------------------- composite
def init_degradation_model(cfg: DynamicConfig = DynamicConfig(), seed: int = 0,
                           device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    return {"generator": init_dynamic_generator(cfg, seed, dev),
            "noise": init_noise_estimator(cfg, dev)}


def degradation_model_forward(
    params: dict, x: torch.Tensor, cfg: DynamicConfig = DynamicConfig(), *,
    gen: torch.Generator | None = None, noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (clean, noisy, sigma) — `DegradationModel.forward` parity."""
    clean = dynamic_generator_forward(params["generator"], x, cfg)
    noisy, sigma = add_estimated_noise(params["noise"], clean, cfg, gen=gen, noise=noise)
    return clean, noisy, sigma
