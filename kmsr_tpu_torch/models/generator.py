"""Multi-band deep-linear degradation generator (KernelGAN-style).

Counterpart of `kmsr_tpu.models.generator`: per band an independent
bias-free linear conv chain with kernel sizes [7,5,3,1,1,1] and reflect
padding, Gaussian(sigma=2)/identity/mean initialization, then an x8 block
mean. Parameters are a dict of tensors, {"layers": [w_i]} with w_i shaped
[band, out, in, k, k] (and "log_sigma" [band] when the trainer learns the
fake-side noise), the JAX package's layout, so `convert.generator_from_jax`
is a plain copy.

The 5 band chains run as one grouped conv chain (groups = bands), and
`forward_mode="compose"` runs one depthwise conv with the composed 13x13
kernel instead (identical away from a 6-pixel border rim). Every conv runs
in full float32 (`fp32_convs`), as the JAX path's Precision.HIGHEST
composition and float32 XLA convolutions do.

A fleet's m stacked generators (every leaf [m, band, ...], the JAX
package's vmap over scenes) run as one generator of m*band bands
(`fold_scenes`): one grouped chain (groups = m*bands) or one depthwise
conv over [B, m*C, H, W], scene-major channels, and one extraction whose
[m*C, K, K] kernels are the scenes' in order.

Under a (data, model) mesh (`parallel.gan_sharding`) a layer's weights may
be this rank's slice of its OUT channels (the chain runs column-parallel)
or, for the out = 1 last layer, of its IN channels (row-parallel); compose
mode and kernel extraction gather the full weights first.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.degrade import block_mean, fp32_convs
from ..ops.kernel_algebra import clip_nonneg, compose_chain, chain_conv
from ..parallel.gan_sharding import sharded_axis
from ..parallel.mesh import copy_to_model, gather_from_model, model_mesh, reduce_from_model

DEFAULT_KS = (7, 5, 3, 1, 1, 1)


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    in_ch: int = 5
    mid_ch: int = 32
    ks: Sequence[int] = DEFAULT_KS
    gaussian_sigma: float = 2.0
    factor: int = 8
    forward_mode: str = "chain"  # "chain" (reference-exact) | "compose"

    @property
    def layer_channels(self) -> list[tuple[int, int]]:
        """(out, in) channel pairs per layer."""
        n = len(self.ks)
        chans = []
        in_c = 1
        for i, _ in enumerate(self.ks):
            out_c = 1 if i == n - 1 else self.mid_ch
            chans.append((out_c, in_c))
            in_c = out_c
        return chans

    @property
    def effective_kernel_size(self) -> int:
        return sum(self.ks) - len(self.ks) + 1  # 13 for the default chain


def gaussian_kernel(size: int, sigma: float, dtype=torch.float32) -> torch.Tensor:
    """Centered 2-D Gaussian, sum 1 (the init target)."""
    coords = torch.arange(size, dtype=dtype) - (size - 1) * 0.5
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    g = torch.exp(-(xx**2 + yy**2) / (2.0 * sigma**2))
    return g / g.sum()


def init_generator(cfg: GeneratorConfig = GeneratorConfig(),
                   device: str | torch.device = "cuda") -> dict:
    """Gaussian/identity/mean init, so a fresh generator's effective kernel
    is the sigma=2 Gaussian. Deterministic, and equal to the JAX init.

    Returns {"layers": [w_i]} with w_i shaped [band, out, in, k, k].
    """
    dev = resolve_device(device)
    layers = []
    n = len(cfg.ks)
    for i, (k, (out_c, in_c)) in enumerate(zip(cfg.ks, cfg.layer_channels)):
        if i == 0:
            w = gaussian_kernel(k, cfg.gaussian_sigma).expand(
                cfg.in_ch, out_c, in_c, k, k)
        elif i == n - 1:
            w = torch.full((cfg.in_ch, out_c, in_c, k, k), 1.0 / cfg.mid_ch)
        else:
            eye = torch.zeros(out_c, in_c, k, k)
            idx = torch.arange(min(out_c, in_c))
            eye[idx, idx, k // 2, k // 2] = 1.0
            w = eye.expand(cfg.in_ch, out_c, in_c, k, k)
        layers.append(w.to(dev, torch.float32).contiguous())
    return {"layers": layers}


def fold_scenes(params: dict) -> dict:
    """m stacked generators' parameters ([m, band, ...] leaves) as one
    generator's of m*band bands, scene-major (views, module docstring)."""
    return {k: [w.flatten(0, 1) for w in v] if isinstance(v, list) else v.flatten(0, 1)
            for k, v in params.items()}


def _chain_forward_grouped(layers: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """All band chains as one grouped conv chain (channels band-major, the
    JAX rhs reshape's order). layers: [(band,out,in,k,k)], x: [B,C,H,W].

    The activations are channels_last: on an H100, cuDNN's float32 grouped
    convs transpose every NCHW activation, and the chain's forward +
    backward at batch 16 took 3.4x as long (`scripts/torch_kernelgan_ab.py`).
    Each layer goes through `ops.kernel_algebra.chain_conv` (the first and
    the 1x1 layers' weight gradients as GEMMs): under the trainers'
    deterministic algorithms, cuDNN's doubled the chain's time.

    Under a model mesh an OUT-sharded layer convolves the full activation
    into this rank's output channels, and the shards are gathered before a
    layer that needs them all; an IN-sharded layer convolves this rank's
    input channels and the partial results are summed over 'model'.
    """
    nhwc = torch.channels_last
    sharded = model_mesh() is not None
    h = x.contiguous(memory_format=nhwc)
    split = False  # h holds this rank's channel shard of every band
    with fp32_convs():
        for w in layers:
            bands, out_c, in_c, k, _ = w.shape
            ax = sharded_axis(w) if sharded else None
            # an IN-sharded layer (the rules shard IN only after an OUT-
            # sharded layer of the same split) takes this rank's shard as is
            if ax != 2 and split:
                h, split = gather_from_model(h, 1, bands).contiguous(memory_format=nhwc), False
            if k > 1:
                p = k // 2
                h = F.pad(h, (p, p, p, p), mode="reflect").contiguous(memory_format=nhwc)
            wg = w.reshape(bands * out_c, in_c, k, k)
            if ax == 1:
                h, split = chain_conv(copy_to_model(h), wg, bands), True
            elif ax == 2:
                h, split = reduce_from_model(chain_conv(h, wg, bands)), False
            else:
                h = chain_conv(h, wg, bands)
        if split:
            h = gather_from_model(h, 1, bands).contiguous(memory_format=nhwc)
    return h


def _full_layers(layers: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The layers' full weights: each sharded layer gathered over 'model'
    under a model mesh."""
    if model_mesh() is None:
        return list(layers)
    return [w if (ax := sharded_axis(w)) is None else gather_from_model(w, ax)
            for w in layers]


def raw_effective_kernels(params: dict) -> torch.Tensor:
    """Per-band composed chain kernels [C, KH, KW], RAW (no clip or
    normalization): exactly the linear map the chain applies."""
    return compose_chain(_full_layers(params["layers"]))[:, 0, 0]


def _compose_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """One depthwise conv with the composed kernel (reflect pad once)."""
    ks = raw_effective_kernels(params)  # [C, K, K]
    p = ks.shape[-1] // 2
    with fp32_convs():
        h = F.pad(x, (p, p, p, p), mode="reflect")
        return F.conv2d(h, ks[:, None], groups=ks.shape[0])


def generator_forward(
    params: dict, x: torch.Tensor, factor: int = 8, forward_mode: str = "chain"
) -> torch.Tensor:
    """x: [B, C, H, W] -> degraded [B, C, H/factor, W/factor]."""
    if forward_mode == "compose":
        y = _compose_forward(params, x)
    else:
        y = _chain_forward_grouped(params["layers"], x)
    return block_mean(y, factor)


def extract_kernels_raw(params: dict) -> torch.Tensor:
    """Per-band composed kernels [C, KH, KW] without clamp/normalize,
    differentiable (feeds `SingleKernelConfig.raw_sum_reg`)."""
    return compose_chain(_full_layers(params["layers"])).mean(dim=(1, 2))


def extract_kernels(params: dict, differentiable: bool = False) -> torch.Tensor:
    """Per-band effective blur kernels [C, KH, KW], clamped + normalized.

    Default `differentiable=False` is the reference's quirk, which the JAX
    package keeps with a stop_gradient: the result is detached, so the
    kernel regularizer gives G no gradient. True lets autograd through.
    """
    k = clip_nonneg(extract_kernels_raw(params))
    s = k.sum(dim=(1, 2), keepdim=True)
    ks = k / torch.where(s <= 1e-12, torch.ones_like(s), s)
    return ks if differentiable else ks.detach()


def extract_merged_kernel(params: dict) -> torch.Tensor:
    """Cross-band mean kernel [KH, KW]."""
    return extract_kernels(params).mean(dim=0)


def generator_weight_stats(params: dict) -> str:
    """First/last-layer weight norms per band chain."""
    first, last = params["layers"][0], params["layers"][-1]
    out = []
    for b in range(first.shape[0]):
        n0 = float(torch.linalg.vector_norm(first[b]))
        nl = float(torch.linalg.vector_norm(last[b]))
        out.append(f"B{b}(L0n={n0:.3f},Ln={nl:.3f})")
    return " ".join(out)
