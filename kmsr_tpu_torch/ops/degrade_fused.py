"""Fused degrade (blur + x`factor` downsample + noise) on the hand-written
Hopper kernel — the counterpart of `kmsr_tpu.ops.degrade_pallas`.

Every entry point computes
    out[c,i,j,b] = sum_{dy,dx<K} comp[c,dy,dx]
                   * x[c, clamp(f*i+dy-h), clamp(f*j+dx-h), b] (+ noise)
with comp = compose_with_box(normalize_kernel(kernel), f), K = k+f-1 and
h = (K-f)//2, the same function as `ops.degrade.degrade_strided`:

* `degrade_fused(img NCHW, ...)`      <- `degrade_pallas` (`:1040`); runs the
  kernel on the NCHW layout directly (no transpose copy, no batch padding);
* `degrade_fused_chwb(x CHWB, ...)`   <- `degrade_pallas_chwb` (`:716`), v3;
* `degrade_fused_presplit(xp, ...)`   <- `degrade_pallas_presplit` (`:460`)
  with baked_halo=False (the v3psn kernel);
* `phase_split_chwb`                  <- `phase_split_chwb(halo=False)` (`:414`).

A CUDA tensor launches `kernels.degrade_stencil` (`kernels/degrade_stencil.cu`)
or raises; a CPU tensor runs the plain PyTorch reference of the same
layout (`degrade_fused_ref`, `degrade_fused_chwb_ref`,
`degrade_fused_presplit_ref`: clamped-index gathers and an explicit tap
sum in the kernel's order). Nothing falls back from one to the other.

Dropped TPU-only knobs of the JAX signatures: `batch_tile` (lane tiling),
`interpret` (Pallas interpret mode), `perm_mode` (precision of the
in-kernel column-permutation matmul — the CUDA kernel gathers columns
exactly, with no matmul) and `v4_x_terms`; the batch is not padded to a
multiple of 128 lanes either. Not ported yet (NotImplementedError, see
ROADMAP.md "TPU kernels to port"): `version` 1, 2 and 4, spans above
5*factor (where JAX auto-selects v4 or v2) and `baked_halo=True` (v3ps).
"""
from __future__ import annotations

import torch

from .degrade import compose_with_box, normalize_kernel

_ROADMAP = "ROADMAP.md, queue 2 (TPU kernels to port)"


def _composed(kernel: torch.Tensor, factor: int, c: int,
              device: torch.device) -> torch.Tensor:
    """[C, K, K] float32 composed kernels on `device` (guards: square)."""
    if kernel.shape[-1] != kernel.shape[-2]:
        raise ValueError(
            f"the fused kernels assume square blur kernels, got "
            f"{kernel.shape[-2]}x{kernel.shape[-1]} (use ops.degrade instead)"
        )
    kernel = kernel.to(device=device, dtype=torch.float32)
    if kernel.ndim == 2:
        kernel = kernel[None].expand(c, *kernel.shape)
    if kernel.ndim != 3 or kernel.shape[0] != c:
        raise ValueError(
            f"kernel shape {tuple(kernel.shape)} does not give one kernel "
            f"per band for {c} bands")
    return compose_with_box(normalize_kernel(kernel), factor).contiguous()


def _check_span(ksize: int, factor: int, what: str) -> None:
    if ksize > 5 * factor:
        raise ValueError(
            f"{what} supports kernel span <= 5*factor, got "
            f"{ksize} > {5 * factor}"
        )


def _noise(noise: torch.Tensor | None, shape: tuple,
           device: torch.device) -> torch.Tensor | None:
    if noise is None:
        return None
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise shape {tuple(noise.shape)} != {tuple(shape)}")
    return noise.to(device=device, dtype=torch.float32).contiguous()


def _clamped_taps(n_out: int, size: int, factor: int, ksize: int,
                  device: torch.device) -> torch.Tensor:
    """[K, n_out] source indices clamp(f*i + d - h, 0, size-1)."""
    half = (ksize - factor) // 2
    i = torch.arange(n_out, device=device)
    d = torch.arange(ksize, device=device)
    return (factor * i[None, :] + d[:, None] - half).clamp_(0, size - 1)


def _stencil_ref(x: torch.Tensor, comp: torch.Tensor,
                 noise: torch.Tensor | None, factor: int,
                 layout: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel on one layout: gather each
    clamped tap and accumulate acc = acc + comp * tap, dy outer, dx inner
    (the kernel's order and rounding), then add the noise."""
    c, ksize = comp.shape[0], comp.shape[-1]
    if layout == "nchw":
        b, _, h, w = x.shape
    elif layout == "chwb":
        _, h, w, b = x.shape
    else:
        _, _, oh, w, b = x.shape
        h = oh * factor
    oh, ow = h // factor, w // factor
    ys = _clamped_taps(oh, h, factor, ksize, x.device)
    xs = _clamped_taps(ow, w, factor, ksize, x.device)
    if layout == "presplit":
        xs = (xs % factor) * ow + xs // factor  # permuted column index
    if layout == "nchw":
        acc = torch.zeros(b, c, oh, ow, device=x.device)
        kshape = (1, c, 1, 1)
    else:
        acc = torch.zeros(c, oh, ow, b, device=x.device)
        kshape = (c, 1, 1, 1)
    for dy in range(ksize):
        y = ys[dy]
        if layout == "nchw":
            rows = x[:, :, y]                        # [B, C, oh, W]
        elif layout == "chwb":
            rows = x[:, y]                           # [C, oh, W, B]
        else:
            rows = x[:, y % factor, y // factor]     # [C, oh, W, B]
        rows = rows.float()
        for dx in range(ksize):
            tap = rows[..., xs[dx]] if layout == "nchw" else rows[:, :, xs[dx]]
            acc = acc + comp[:, dy, dx].reshape(kshape) * tap
    if noise is not None:
        acc = acc + noise
    return acc


def _stencil(x, comp, noise, factor, layout, dims):
    """Launch the kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return _stencil_ref(x, comp, noise, factor, layout)
    if x.device.type != "cuda":
        raise ValueError(f"fused degrade runs on cuda or cpu, got {x.device}")
    from ..kernels import degrade_stencil

    c, h, w, b = dims
    oh, ow = h // factor, w // factor
    shape = (b, c, oh, ow) if layout == "nchw" else (c, oh, ow, b)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    return degrade_stencil(x.contiguous(), comp, noise, out, layout=layout,
                           dims=dims, factor=factor)


def _chwb_setup(x, kernel, noise, factor, version):
    c, h, w, b = x.shape
    if h % factor or w % factor:
        raise ValueError(f"H, W must be multiples of factor: {(h, w, factor)}")
    comp = _composed(kernel, factor, c, x.device)
    ksize = comp.shape[-1]
    if version is None:
        if ksize > 5 * factor:
            raise NotImplementedError(
                f"kernel span {ksize} > 5*factor needs the v4/v2 kernels, "
                f"which are not ported yet ({_ROADMAP})")
        version = 3
    if version in (1, 2, 4):
        raise NotImplementedError(
            f"version={version} (degrade_pallas.py v{version} kernel) is not "
            f"ported yet ({_ROADMAP}); version 3 is")
    if version != 3:
        raise ValueError(f"version must be 1..4 or None, got {version!r}")
    _check_span(ksize, factor, "v3")
    return comp, _noise(noise, (c, h // factor, w // factor, b), x.device)


def degrade_fused_chwb(
    x: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
    version: int | None = None,
) -> torch.Tensor:
    """Fused degrade on factory-layout data (the v3 kernel).

    x: [C, H, W, B] float32 or bfloat16 (unpadded); kernel: [C, kh, kw]
    (normalized per band inside); noise: optional [C, H/f, W/f, B].
    Returns float32 [C, H/f, W/f, B]. Any B works (no lane padding).
    """
    comp, noise = _chwb_setup(x, kernel, noise, factor, version)
    return _stencil(x, comp, noise, factor, "chwb", tuple(x.shape))


def degrade_fused_chwb_ref(
    x: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
) -> torch.Tensor:
    """Plain PyTorch version of `degrade_fused_chwb`, on any device."""
    comp, noise = _chwb_setup(x, kernel, noise, factor, None)
    return _stencil_ref(x, comp, noise, factor, "chwb")


def _nchw_setup(img, kernel, noise, factor):
    b, c, h, w = img.shape
    if h % factor or w % factor:
        raise ValueError(f"H, W must be multiples of factor: {(h, w, factor)}")
    comp = _composed(kernel, factor, c, img.device)
    ksize = comp.shape[-1]
    if ksize > 5 * factor:
        raise NotImplementedError(
            f"kernel span {ksize} > 5*factor needs the v4/v2 kernels, "
            f"which are not ported yet ({_ROADMAP})")
    return comp, _noise(noise, (b, c, h // factor, w // factor), img.device)


def degrade_fused(
    img: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
) -> torch.Tensor:
    """NCHW entry point: img [B, C, H, W] (or [C, H, W]), kernel [C, kh, kw]
    or [kh, kw], optional noise [B, C, H/f, W/f]. Returns float32
    [B, C, H/f, W/f] from the kernel's NCHW instantiation."""
    squeeze = img.ndim == 3
    if squeeze:
        img = img[None]
        noise = None if noise is None else noise[None]
    comp, noise = _nchw_setup(img, kernel, noise, factor)
    b, c, h, w = img.shape
    out = _stencil(img, comp, noise, factor, "nchw", (c, h, w, b))
    return out[0] if squeeze else out


def degrade_fused_ref(
    img: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
) -> torch.Tensor:
    """Plain PyTorch version of `degrade_fused` ([B, C, H, W] input)."""
    comp, noise = _nchw_setup(img, kernel, noise, factor)
    return _stencil_ref(img, comp, noise, factor, "nchw")


def phase_split_chwb(x: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """[C, H, W, B] -> the halo-free pre-split degrade layout
    [C, f, H/f, W, B]: rows regrouped by row phase p = y % f, columns
    permuted to v = (x % f)*(W/f) + x//f (the layout the native loader's
    split gather writes, and `degrade_fused_presplit` takes). The JAX
    function's baked-halo layout (halo=True) belongs to the unported v3ps
    kernel and is not offered here."""
    c, h, w, b = x.shape
    if h % factor or w % factor:
        raise ValueError(f"H, W must be multiples of factor: {(h, w, factor)}")
    out_h, out_w = h // factor, w // factor
    xr = x.reshape(c, out_h, factor, out_w, factor, b)
    return xr.permute(0, 2, 1, 4, 3, 5).reshape(c, factor, out_h, w, b)


def _presplit_setup(xp, kernel, noise, factor, baked_halo, halo_rows):
    c, f, hrows, w, b = xp.shape
    if f != factor:
        raise ValueError(f"xp phase dim {f} != factor {factor}")
    if w % factor:
        raise ValueError(f"W must be a multiple of factor: {(w, factor)}")
    comp = _composed(kernel, factor, c, xp.device)
    _check_span(comp.shape[-1], factor, "pre-split degrade")
    if baked_halo:
        raise NotImplementedError(
            f"baked_halo=True (the v3ps kernel, degrade_pallas.py:320) is "
            f"not ported yet ({_ROADMAP}); use baked_halo=False")
    if halo_rows not in (None, 0):
        raise ValueError(
            f"baked_halo=False expects a halo-free layout "
            f"(phase_split_chwb(halo=False)); got halo_rows={halo_rows}"
        )
    return comp, _noise(noise, (c, hrows, w // factor, b), xp.device)


def degrade_fused_presplit(
    xp: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
    baked_halo: bool = False,
    halo_rows: int | None = None,
) -> torch.Tensor:
    """Fused degrade on PRE-SPLIT factory data (the halo-free v3psn kernel).

    xp: [C, f, H/f, W, B] float32 or bfloat16, the
    `phase_split_chwb(halo=False)` layout (also what the native loader's
    split gather writes); kernel: [C, kh, kw]; noise: optional
    [C, H/f, W/f, B]. Returns float32 [C, H/f, W/f, B], equal to
    `degrade_fused_chwb` on the un-split input. Replicate padding is
    rebuilt from clamped indices, so the layout carries no halo rows.
    """
    comp, noise = _presplit_setup(xp, kernel, noise, factor, baked_halo,
                                  halo_rows)
    c, _, hrows, w, b = xp.shape
    return _stencil(xp, comp, noise, factor, "presplit",
                    (c, hrows * factor, w, b))


def degrade_fused_presplit_ref(
    xp: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
) -> torch.Tensor:
    """Plain PyTorch version of `degrade_fused_presplit`, on any device."""
    comp, noise = _presplit_setup(xp, kernel, noise, factor, False, None)
    return _stencil_ref(xp, comp, noise, factor, "presplit")
