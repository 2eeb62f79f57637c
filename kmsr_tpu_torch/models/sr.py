"""Super-resolution CNN: compact EDSR-style residual trunk, pixel-shuffle
upsampler and a global bilinear skip.

Counterpart of `kmsr_tpu.models.sr`, with the same configuration, the
same parameter tree and the same arithmetic:

- The parameters are a dict in the JAX package's layout, {"head",
  "blocks": [{"c1", "c2"}], "body_tail", "ups": [...], "tail"}, each
  {"w": HWIO, "b"}. So `utils.params_io` reads and writes the JAX
  package's `sr_model.npz` files unchanged. The weights are permuted to
  OIHW where a conv is called.
- The public API is channel-first ([B, C, H, W]); the trunk runs on
  channels_last activations, the counterpart of JAX's NHWC.
- Each conv runs in the compute dtype (bfloat16 by default) and is
  rounded to it; the bias is added after, in the compute dtype, as JAX
  does (`preferred_element_type=dtype`, then `+ b.astype(dtype)`). A
  conv with a fused bias would add it in float32 before the rounding.
- The skip is two interpolation matmuls (`R_h @ x @ R_w^T`) in the
  compute dtype, cast to float32 only after the second one, as JAX's
  `_skip_nhwc`.
- Under compute_dtype=float32 every conv and matmul runs in full float32
  (`precision`: cuDNN's and cuBLAS's TF32 off), the counterpart of JAX's
  float32 convs and of `bilinear_upsample`'s Precision.HIGHEST.

Two upsamplers (`SRConfig.upsampler`): "progressive" (×2 pixel-shuffle
stages, the last one folded into the output conv at factor/2) and
"oneshot" (one width -> in_ch·factor² conv at LR, one shuffle).

`sr_forward` is the one forward entry of the SR stage: given a
`models.swinir.SwinIRConfig` it runs SwinIR instead, given a
`models.hat.HATConfig` HAT.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.degrade import fp32_convs
from ..utils.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class SRConfig:
    in_ch: int = 5
    width: int = 64
    n_blocks: int = 8
    factor: int = 8              # total upscale (power of 2 for progressive)
    res_scale: float = 0.1
    upsampler: str = "progressive"  # "progressive" | "oneshot"


def _conv_init(gen: torch.Generator, k: int, in_c: int, out_c: int,
               dev: torch.device) -> dict:
    """HWIO conv weights + bias, uniform fan-in init."""
    bound = 1.0 / np.sqrt(in_c * k * k)

    def uniform(shape):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(dev)

    return {"w": uniform((k, k, in_c, out_c)), "b": uniform((out_c,))}


def init_sr(cfg: SRConfig = SRConfig(), seed: int = 0,
            device: str | torch.device = "cuda") -> dict:
    """Fan-in uniform parameters in the JAX layout, drawn from a CPU
    `torch.Generator` seeded with `seed` (a different stream from
    `jax.random`'s), then moved to `device`."""
    dev = resolve_device(device)
    n_up = int(np.log2(cfg.factor))
    if cfg.upsampler == "progressive" and 2**n_up != cfg.factor:
        raise ValueError(f"progressive upsampler needs power-of-2 factor, got {cfg.factor}")
    gen = torch.Generator().manual_seed(seed)
    conv = functools.partial(_conv_init, gen, 3, dev=dev)
    params = {
        "head": conv(cfg.in_ch, cfg.width),
        "blocks": [{"c1": conv(cfg.width, cfg.width), "c2": conv(cfg.width, cfg.width)}
                   for _ in range(cfg.n_blocks)],
        "body_tail": conv(cfg.width, cfg.width),
        "ups": [],
    }
    if cfg.upsampler == "oneshot":
        params["tail"] = conv(cfg.width, cfg.in_ch * cfg.factor * cfg.factor)
    else:
        params["ups"] = [conv(cfg.width, cfg.width * 4) for _ in range(n_up - 1)]
        # final projection at factor/2 resolution: width -> in_ch*4 subpixels
        params["tail"] = conv(cfg.width, cfg.in_ch * 4)
    return params


@contextlib.contextmanager
def precision(compute_dtype: torch.dtype) -> Iterator[None]:
    """Full float32 convs and matmuls (cuDNN's and cuBLAS's TF32 off) when
    compute_dtype is float32; nothing to set for bfloat16. Wrap a backward
    pass too: autograd's convs run outside the forward's scope."""
    if compute_dtype != torch.float32:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with fp32_convs():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _conv(x: torch.Tensor, p: dict, dtype: torch.dtype) -> torch.Tensor:
    """3x3 SAME conv in `dtype`, rounded to it, then the bias in `dtype`."""
    y = F.conv2d(x, p["w"].to(dtype).permute(3, 2, 0, 1), padding=1)  # HWIO -> OIHW
    return y + p["b"].to(dtype)[:, None, None]


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, C*r^2, H, W] -> [B, C, H*r, W*r]: out[b, c, r*i + s, r*j + t] =
    x[b, c*r^2 + s*r + t, i, j], JAX's channel order (and F.pixel_shuffle's)."""
    b, crr, h, w = x.shape
    c = crr // (r * r)
    return x.reshape(b, c, r, r, h, w).permute(0, 1, 4, 2, 5, 3).reshape(b, c, h * r, w * r)


def _pixel_shuffle_cl(x: torch.Tensor, r: int) -> torch.Tensor:
    """`pixel_shuffle` of a channels_last tensor, returned channels_last:
    JAX's `_pixel_shuffle_nhwc` on the NHWC storage (one copy)."""
    b, crr, h, w = x.shape
    c = crr // (r * r)
    y = x.permute(0, 2, 3, 1).reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(b, h * r, w * r, c).permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=32)
def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Row-stochastic [n_out, n_in] matrix implementing half-pixel-centers
    bilinear resampling along one axis (JAX's, entry for entry). Callers
    must not write to the cached array."""
    scale = n_in / n_out
    m = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        f = src - i0
        m[o, min(max(i0, 0), n_in - 1)] += 1.0 - f
        m[o, min(max(i0 + 1, 0), n_in - 1)] += f
    return m


@functools.lru_cache(maxsize=64)
def _device_matrix(n_in: int, n_out: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """`_bilinear_matrix` on `device`, uploaded once: a pageable upload
    per call would wait for the device's queue each time."""
    return torch.from_numpy(_bilinear_matrix(n_in, n_out)).to(device, dtype)


def _interp(x: torch.Tensor, factor: int, dtype: torch.dtype) -> torch.Tensor:
    """R_h @ x @ R_w^T on [B, C, H, W] in `dtype` (each product rounded)."""
    h, w = x.shape[-2:]
    rh = _device_matrix(h, h * factor, x.device, dtype)
    rw = _device_matrix(w, w * factor, x.device, dtype)
    return torch.matmul(torch.matmul(rh, x.to(dtype)), rw.T)


def bilinear_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, C, H, W] bilinear x`factor` in full float32: the PSNR/SSIM
    baseline and the eval skip (JAX runs it at Precision.HIGHEST)."""
    with precision(torch.float32):
        return _interp(x.float(), factor, torch.float32)


def sr_forward(
    params: dict,
    x: torch.Tensor,
    cfg: SRConfig = SRConfig(),
    compute_dtype: torch.dtype = torch.bfloat16,
    channels_last: bool = True,
    item=None,
) -> torch.Tensor:
    """x: [B, C, h, w] -> [B, C, h*factor, w*factor], float32 (contiguous),
    through the network `cfg` configures: this EDSR for an `SRConfig`,
    `models.swinir.swinir_forward` for a `SwinIRConfig`,
    `models.hat.hat_forward` for a `HATConfig` (`item` goes to their
    spans). channels_last=False runs the EDSR's trunk on NCHW activations
    instead (same arithmetic; for timing the layout)."""
    if not isinstance(cfg, SRConfig):
        from .hat import HATConfig, hat_forward
        from .swinir import swinir_forward

        forward = hat_forward if isinstance(cfg, HATConfig) else swinir_forward
        return forward(params, x, cfg, compute_dtype, item=item)
    dt = compute_dtype
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    # JAX's weakly typed `res_scale * r`: the scale rounded to the dtype
    res_scale = float(torch.tensor(cfg.res_scale, dtype=dt))
    with precision(dt):
        skip = _interp(x, cfg.factor, dt)
        h = _conv(x.to(dt).contiguous(memory_format=fmt), params["head"], dt)
        body = h
        for blk in params["blocks"]:
            r = F.relu(_conv(body, blk["c1"], dt))
            r = _conv(r, blk["c2"], dt)
            body = body + res_scale * r
        body = _conv(body, params["body_tail"], dt) + h
        shuffle = _pixel_shuffle_cl if channels_last else pixel_shuffle
        if cfg.upsampler == "oneshot":
            out = shuffle(_conv(body, params["tail"], dt), cfg.factor)
        else:
            up = body
            for p_up in params["ups"]:
                up = shuffle(_conv(up, p_up, dt), 2)
            out = shuffle(_conv(up, params["tail"], dt), 2)
        # skip first: the sum takes its contiguous NCHW layout
        return torch.add(skip.float(), out)


def require_edsr(cfg, what: str) -> None:
    """ValueError unless cfg is the EDSR's `SRConfig`: `what` runs no other
    network."""
    if not isinstance(cfg, SRConfig):
        raise ValueError(f"{what} runs the EDSR (SRConfig) only, not "
                         f"{type(cfg).__name__}: SwinIR and HAT are served by sr_infer")


def count_params(params: dict) -> int:
    return sum(t.numel() for t in tree_leaves(params))
