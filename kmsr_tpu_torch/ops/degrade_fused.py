"""Fused degrade (blur + x`factor` downsample + noise) on hand-written
Hopper kernels — the counterpart of `kmsr_tpu.ops.degrade_pallas`.

Every entry point computes
    out[c,i,j,b] = sum_{dy,dx<K} comp[c,dy,dx]
                   * x[c, clamp(f*i+dy-h), clamp(f*j+dx-h), b] (+ noise)
with comp = compose_with_box(normalize_kernel(kernel), f) and K = k+f-1,
the same function as `ops.degrade.degrade_strided`. Like the JAX package,
each version keeps its own tap offset h: (K-f)//2 for v3/v3ps/v3psn/v4,
kernel.shape[-1]//2 for v1/v2 (the two differ only for even k).

* `degrade_fused(img NCHW, ...)`      <- `degrade_pallas` (`:1040`); runs the
  kernels on the NCHW layout directly (no transpose copy, no batch padding);
* `degrade_fused_chwb(x CHWB, ...)`   <- `degrade_pallas_chwb` (`:716`);
* `degrade_fused_presplit(xp, ...)`   <- `degrade_pallas_presplit` (`:460`),
  the v3psn kernel (baked_halo=False) or v3ps (baked_halo=True);
* `phase_split_chwb`                  <- `phase_split_chwb` (`:414`).

Versions (`select_version`, JAX's rule `:764-794`): v3 when K <= 5f, else
v4 (the dense stencil matrix) when its shape rule holds, else v2.
`degrade_fused`, like `degrade_pallas`, always selects so;
`degrade_fused_chwb(version=1..4)` pins one (v1 is reached only there).
A CUDA tensor launches `kernels.degrade_stencil`
(`kernels/degrade_stencil.cu`: v3, v3psn, v3ps; `kernels/degrade_wide.cu`:
v2, v1) or `kernels.degrade_dense` (`kernels/degrade_dense.cu`: v4, which
generates the stencil matrix on chip from the composed kernels), or
raises; a CPU tensor runs the plain PyTorch version of the same layout and
version (`degrade_fused_ref`, `degrade_fused_chwb_ref`,
`degrade_fused_presplit_ref`, `degrade_v4_ref`: clamped-index gathers and
an explicit tap sum in the kernel's order, or the six term products on the
stencil matrix's terms built here). Nothing falls back from one to the
other.

Dropped TPU-only knobs of the JAX signatures: `batch_tile` (lane tiling),
`interpret` (Pallas interpret mode), `perm_mode` (precision of the
in-kernel column-permutation matmul — the CUDA kernel gathers columns
exactly, with no matmul) and `v4_x_terms` (x always takes three terms, the
JAX default); the batch is not padded to a multiple of 128 lanes either.
Defaults that differ from JAX's: `phase_split_chwb(halo=False)` and
`degrade_fused_presplit(baked_halo=False)`, the halo-free layout the
factory's `.npy` route uses.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator

import numpy as np
import torch

from .degrade import compose_with_box, normalize_kernel

#: v4's shape rule (JAX `:772-775`): the dense [out_hw, h*w] matrix must
#: stay this small
V4_MAX_ELEMENTS = 64 * 64 * 64 * 8


def col_halo(ksize: int, factor: int) -> int:
    """Row/column block over-reach m of the composed stencil (every tap's
    block offset q satisfies |q| <= m): the halo depth of the baked-halo
    presplit layout. Copy of JAX's `_col_halo`."""
    half = (ksize - factor) // 2
    return max((half + factor - 1) // factor, (ksize - 1 - half) // factor, 1)


def select_version(ksize: int, factor: int, h: int, w: int,
                   dtype: torch.dtype, version: int | None) -> int:
    """The kernel version JAX's `degrade_pallas_chwb` runs for these shapes
    (auto when version is None), with its guards. Depends on the span, the
    image size and the storage dtype only, never on the batch."""
    w_tile = 16 if dtype == torch.bfloat16 else 8
    out_h, out_w = h // factor, w // factor
    v4_ok = not (w % w_tile or out_w % 8
                 or out_h * out_w * h * w > V4_MAX_ELEMENTS)
    if version is None:
        version = 3 if ksize <= 5 * factor else (4 if v4_ok else 2)
    if version not in (1, 2, 3, 4):
        raise ValueError(f"version must be 1..4 or None, got {version!r}")
    if version == 4 and not v4_ok:
        raise ValueError(
            f"v4 needs w, w//factor multiples of 8 and a VMEM-sized "
            f"stencil matrix; got h={h}, w={w}, factor={factor}"
        )
    if version == 3:
        _check_span(ksize, factor, "v3")
    return version


#: the last composition: (kernel tensor, its key, comp)
_LAST_COMPOSED: tuple | None = None


def _composed(kernel: torch.Tensor, factor: int, c: int,
              device: torch.device) -> torch.Tensor:
    """[C, K, K] float32 composed kernels on `device` (guards: square).

    The last result is reused while the same kernel tensor comes back
    unchanged (same object, same in-place version counter) at the same
    factor, band count and device: the factory degrades every batch with
    one kernel, and the composition's half a dozen small ops cost more
    host time than the v4 kernel itself. Inference tensors keep no
    version counter and are composed anew each call."""
    global _LAST_COMPOSED
    if kernel.shape[-1] != kernel.shape[-2]:
        raise ValueError(
            f"the fused kernels assume square blur kernels, got "
            f"{kernel.shape[-2]}x{kernel.shape[-1]} (use ops.degrade instead)"
        )
    try:
        key = (kernel._version, factor, c, device)
    except RuntimeError:  # an inference tensor: no version to check
        key = None
    last = _LAST_COMPOSED
    if key is not None and last is not None and last[0] is kernel and last[1] == key:
        return last[2]
    src = kernel
    kernel = kernel.to(device=device, dtype=torch.float32)
    if kernel.ndim == 2:
        kernel = kernel[None].expand(c, *kernel.shape)
    if kernel.ndim != 3 or kernel.shape[0] != c:
        raise ValueError(
            f"kernel shape {tuple(kernel.shape)} does not give one kernel "
            f"per band for {c} bands")
    comp = compose_with_box(normalize_kernel(kernel), factor).contiguous()
    if key is not None:
        _LAST_COMPOSED = (src, key, comp)
    return comp


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
    """[K, n_out] source indices clamp(f*i + d - h, 0, size-1), h = (K-f)//2."""
    half = (ksize - factor) // 2
    i = torch.arange(n_out, device=device)
    d = torch.arange(ksize, device=device)
    return (factor * i[None, :] + d[:, None] - half).clamp_(0, size - 1)


def _tap_order(ksize: int, factor: int, version: int) -> list:
    """The (dy, dx) taps in each kernel's summation order, as a list of
    phases: v1 sums each row phase dyi into its own partial; v2 runs the
    same taps in one sum (dyi, dxi, dxo, dyo over the ceil(K/f)*f lattice,
    skipping the zero-padded taps dy, dx >= K); v3 is dy outer, dx inner."""
    if version == 3:
        return [[(dy, dx) for dy in range(ksize) for dx in range(ksize)]]
    n_o = -(-ksize // factor)
    lattice = range(0, n_o * factor, factor)
    phases = [[(dyo + dyi, dxo + dxi)
               for dxi in range(factor) for dxo in lattice for dyo in lattice
               if dyo + dyi < ksize and dxo + dxi < ksize]
              for dyi in range(factor)]
    return phases if version == 1 else [sum(phases, [])]


def _stencil_ref(x: torch.Tensor, comp: torch.Tensor,
                 noise: torch.Tensor | None, factor: int, layout: str,
                 version: int = 3, half: int | None = None,
                 halo: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the stencil kernel on one layout: gather
    each tap's source pixels (clamped indices; rows of the baked-halo
    layout read unclamped) and accumulate acc = acc + comp * tap in the
    kernel's order (`_tap_order`) and rounding, then add the noise."""
    c, ksize = comp.shape[0], comp.shape[-1]
    dev = x.device
    half = (ksize - factor) // 2 if half is None else half
    if layout == "nchw":
        b, _, h, w = x.shape
        flat = x.reshape(b, c, h * w)
    elif layout == "chwb":
        _, h, w, b = x.shape
        flat = x.reshape(c, h * w, b)
    else:
        _, _, hrows, w, b = x.shape
        h = (hrows - 2 * halo) * factor
        flat = x.reshape(c, -1, b)
    flat = flat.float()
    oh, ow = h // factor, w // factor
    out_i, out_j = torch.arange(oh, device=dev), torch.arange(ow, device=dev)

    def tap(dy: int, dx: int) -> torch.Tensor:
        y = factor * out_i + dy - half
        xc = (factor * out_j + dx - half).clamp(0, w - 1)
        if layout == "presplit_halo":  # the layout carries the edge rows
            row = (y % factor) * (oh + 2 * halo) + halo + torch.div(
                y, factor, rounding_mode="floor")
        else:
            y = y.clamp(0, h - 1)
            row = y if layout in ("nchw", "chwb") else (y % factor) * oh + y // factor
        if layout not in ("nchw", "chwb"):
            xc = (xc % factor) * ow + xc // factor  # permuted column index
        idx = (row[:, None] * w + xc[None, :]).reshape(-1)
        if layout == "nchw":
            return flat[:, :, idx].reshape(b, c, oh, ow)
        return flat[:, idx].reshape(c, oh, ow, b)

    shape = (b, c, oh, ow) if layout == "nchw" else (c, oh, ow, b)
    kshape = (1, c, 1, 1) if layout == "nchw" else (c, 1, 1, 1)
    acc = torch.zeros(shape, device=dev)
    for phase in _tap_order(ksize, factor, version):
        part = torch.zeros(shape, device=dev) if version == 1 else acc
        for dy, dx in phase:
            part = part + comp[:, dy, dx].reshape(kshape) * tap(dy, dx)
        acc = acc + part if version == 1 else part
    if noise is not None:
        acc = acc + noise
    return acc


def _stencil(x, comp, noise, factor, layout, dims, version=3, half=None,
             halo=0):
    """Launch the stencil kernel for a CUDA tensor, the plain version for
    a CPU one."""
    if x.device.type == "cpu":
        return _stencil_ref(x, comp, noise, factor, layout, version, half, halo)
    if x.device.type != "cuda":
        raise ValueError(f"fused degrade runs on cuda or cpu, got {x.device}")
    from ..kernels import degrade_stencil

    c, h, w, b = dims
    oh, ow = h // factor, w // factor
    shape = (b, c, oh, ow) if layout == "nchw" else (c, oh, ow, b)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    return degrade_stencil(x.contiguous(), comp, noise, out, layout=layout,
                           dims=dims, factor=factor, version=version,
                           half=half, halo=halo)


# ---------------------------------------------------------------- v4 (dense)

def bf16_terms(a: torch.Tensor, n: int) -> list[torch.Tensor]:
    """Split float32 `a` into n bfloat16 terms, a ~= sum(terms), by
    MANTISSA MASKING as JAX's `_bf16_terms` does: term i carries mantissa
    bits [8i, 8i+8); every term but the last is exact, and so is each
    subtraction. (An f32 -> bf16 -> f32 round trip is not used: XLA on a
    TPU folded it to identity, ROADMAP.md section 3.)"""
    terms, r = [], a.float().contiguous()
    for i in range(n):
        t = r if i == n - 1 else (r.view(torch.int32) & -65536).view(torch.float32)
        terms.append(t.to(torch.bfloat16))
        r = r - t
    return terms


@functools.lru_cache(maxsize=16)
def _stencil_passes(ksize: int, factor: int, h: int, w: int,
                    device: torch.device) -> tuple:
    """The dense stencil matrix's scatter as passes of UNIQUE flat indices:
    pass r adds the r-th tap (in JAX's (i, j, dy, dx) order) that lands on
    each entry, so every entry is summed sequentially in JAX's order and
    no pass has two writes to one entry: deterministic on any device."""
    half = (ksize - factor) // 2
    oh, ow = h // factor, w // factor
    d = np.arange(ksize)
    ys = np.clip(factor * np.arange(oh)[:, None] + d - half, 0, h - 1)  # [oh, K]
    xs = np.clip(factor * np.arange(ow)[:, None] + d - half, 0, w - 1)  # [ow, K]
    row = np.arange(oh)[:, None, None, None] * ow + np.arange(ow)[None, :, None, None]
    col = ys[:, None, :, None] * w + xs[None, :, None, :]
    flat = (row * (h * w) + col).reshape(-1)
    kidx = np.broadcast_to(d[:, None] * ksize + d[None, :],
                           (oh, ow, ksize, ksize)).reshape(-1)
    order = np.argsort(flat, kind="stable")
    fs = flat[order]
    pos = np.arange(len(fs))
    run_start = np.maximum.accumulate(np.where(np.r_[True, fs[1:] != fs[:-1]], pos, 0))
    rank = pos - run_start
    passes = []
    for r in range(int(rank.max()) + 1):
        sel = order[rank == r]
        passes.append((torch.from_numpy(flat[sel]).to(device),
                       torch.from_numpy(kidx[sel].copy()).to(device)))
    return tuple(passes)


def stencil_matrix(comp: torch.Tensor, factor: int, h: int, w: int) -> torch.Tensor:
    """[C, out_h*out_w, h*w] dense stencil matrix (JAX `_stencil_matrix`):
    A[o, y*w + x] sums the composed-kernel taps that read input pixel
    (y, x) for output o, replicate padding folded in as clamped indices.
    Built on comp's device, deterministically (`_stencil_passes`)."""
    c, ksize, _ = comp.shape
    oh, ow = h // factor, w // factor
    a = torch.zeros(c, oh * ow * h * w, device=comp.device)
    taps = comp.reshape(c, -1).float()
    for flat, kidx in _stencil_passes(ksize, factor, h, w, comp.device):
        a[:, flat] += taps[:, kidx]
    return a.reshape(c, oh * ow, h * w)


def _a_terms(comp: torch.Tensor, factor: int, h: int, w: int) -> torch.Tensor:
    """[C, 3, out_hw, h*w] bfloat16: the stencil matrix's three mask terms
    (JAX builds them outside its kernel too, `:795-797`)."""
    return torch.stack(bf16_terms(stencil_matrix(comp, factor, h, w), 3),
                       dim=1).contiguous()


@contextlib.contextmanager
def _fp32_matmuls() -> Iterator[None]:
    """float32 matrix products in full float32 (TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dense_operands(x, layout):
    """x as [C, h*w, B] and the output's (out_h*out_w -> out layout) map."""
    if layout == "nchw":
        b, c, h, w = x.shape
        return x.reshape(b, c, h * w).permute(1, 2, 0), (c, h, w, b)
    c, h, w, b = x.shape
    return x.reshape(c, h * w, b), (c, h, w, b)


def degrade_v4_ref(x: torch.Tensor, a_terms: torch.Tensor,
                   noise: torch.Tensor | None, factor: int,
                   layout: str) -> torch.Tensor:
    """Plain PyTorch version of the dense kernel, on the kernel's operands:
    out[c] = sum_{i+j<=2} A_i[c] . x_j[c] in float32 (TF32 off), i outer,
    j inner, x split into three mask terms (one if bf16-stored), + noise.
    x: [B, C, h, w] ("nchw") or [C, h, w, B]; a_terms: [C, 3, out_hw, h*w]."""
    xm, (c, h, w, b) = _dense_operands(x, layout)
    xs = [xm] if x.dtype == torch.bfloat16 else bf16_terms(xm, 3)
    acc = None
    with _fp32_matmuls():
        for i in range(3):
            for j, xj in enumerate(xs):
                if i + j > 2:
                    continue
                d = torch.matmul(a_terms[:, i].float(), xj.float())
                acc = d if acc is None else acc + d
    oh, ow = h // factor, w // factor
    if layout == "nchw":
        out = acc.permute(2, 0, 1).reshape(b, c, oh, ow)
    else:
        out = acc.reshape(c, oh, ow, b)
    return out if noise is None else out + noise


def _dense(x, comp, noise, factor, layout):
    """v4: launch the banded kernel, which generates the stencil matrix's
    terms per tile from comp (a CUDA tensor), or run the plain version on
    the terms built here, as JAX builds them outside its kernel (a CPU
    tensor)."""
    b, c, h, w = x.shape if layout == "nchw" else x.permute(3, 0, 1, 2).shape
    if x.device.type == "cpu":
        return degrade_v4_ref(x, _a_terms(comp, factor, h, w), noise, factor,
                              layout)
    if x.device.type != "cuda":
        raise ValueError(f"fused degrade runs on cuda or cpu, got {x.device}")
    from ..kernels import degrade_dense

    oh, ow = h // factor, w // factor
    shape = (b, c, oh, ow) if layout == "nchw" else (c, oh, ow, b)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    return degrade_dense(x.contiguous(), comp, noise, out, layout=layout,
                         factor=factor)


def _tap_half(kernel: torch.Tensor, version: int) -> int | None:
    """The version's tap offset: kh//2 for v1/v2, None ((K-f)//2) for v3."""
    return kernel.shape[-1] // 2 if version in (1, 2) else None


def _run(x, kernel, comp, noise, factor, layout, version):
    """Dispatch one natural-layout (nchw/chwb) call to its version's
    kernel (on a CPU tensor, its plain version)."""
    if version == 4:
        return _dense(x, comp, noise, factor, layout)
    b, c, h, w = x.shape if layout == "nchw" else x.permute(3, 0, 1, 2).shape
    return _stencil(x, comp, noise, factor, layout, (c, h, w, b), version,
                    _tap_half(kernel, version))


def _run_ref(x, kernel, comp, noise, factor, layout, version):
    """The plain twin of `_run`, on any device."""
    if version == 4:
        _, (_, h, w, _) = _dense_operands(x, layout)
        return degrade_v4_ref(x, _a_terms(comp, factor, h, w), noise, factor,
                              layout)
    return _stencil_ref(x, comp, noise, factor, layout, version,
                        _tap_half(kernel, version))


def _chwb_setup(x, kernel, noise, factor, version):
    c, h, w, b = x.shape
    if h % factor or w % factor:
        raise ValueError(f"H, W must be multiples of factor: {(h, w, factor)}")
    comp = _composed(kernel, factor, c, x.device)
    version = select_version(comp.shape[-1], factor, h, w, x.dtype, version)
    return comp, _noise(noise, (c, h // factor, w // factor, b), x.device), version


def degrade_fused_chwb(
    x: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
    version: int | None = None,
) -> torch.Tensor:
    """Fused degrade on factory-layout data.

    x: [C, H, W, B] float32 or bfloat16 (unpadded); kernel: [C, kh, kw]
    (normalized per band inside); noise: optional [C, H/f, W/f, B];
    version: 1..4, or None for JAX's auto selection (`select_version`).
    Returns float32 [C, H/f, W/f, B]. Any B works (no lane padding).
    """
    comp, noise, version = _chwb_setup(x, kernel, noise, factor, version)
    return _run(x, kernel, comp, noise, factor, "chwb", version)


def degrade_fused_chwb_ref(
    x: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
    version: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of `degrade_fused_chwb`, on any device."""
    comp, noise, version = _chwb_setup(x, kernel, noise, factor, version)
    return _run_ref(x, kernel, comp, noise, factor, "chwb", version)


def _nchw_setup(img, kernel, noise, factor):
    b, c, h, w = img.shape
    if h % factor or w % factor:
        raise ValueError(f"H, W must be multiples of factor: {(h, w, factor)}")
    comp = _composed(kernel, factor, c, img.device)
    version = select_version(comp.shape[-1], factor, h, w, img.dtype, None)
    return comp, _noise(noise, (b, c, h // factor, w // factor), img.device), version


def degrade_fused(
    img: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
) -> torch.Tensor:
    """NCHW entry point: img [B, C, H, W] (or [C, H, W]), kernel [C, kh, kw]
    or [kh, kw], optional noise [B, C, H/f, W/f]. Returns float32
    [B, C, H/f, W/f] from the kernels' NCHW instantiations, the version
    selected as JAX's `degrade_pallas` does (`select_version`: v3, v4 or
    v2 by shape and storage dtype; pin one with `degrade_fused_chwb`)."""
    squeeze = img.ndim == 3
    if squeeze:
        img = img[None]
        noise = None if noise is None else noise[None]
    comp, noise, version = _nchw_setup(img, kernel, noise, factor)
    out = _run(img, kernel, comp, noise, factor, "nchw", version)
    return out[0] if squeeze else out


def degrade_fused_ref(
    img: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
) -> torch.Tensor:
    """Plain PyTorch version of `degrade_fused` ([B, C, H, W] input)."""
    comp, noise, version = _nchw_setup(img, kernel, noise, factor)
    return _run_ref(img, kernel, comp, noise, factor, "nchw", version)


def phase_split_chwb(x: torch.Tensor, factor: int = 8, halo: bool = False,
                     halo_rows: int = 1) -> torch.Tensor:
    """[C, H, W, B] -> the pre-split degrade layout: rows regrouped by row
    phase p = y % f, columns permuted to v = (x % f)*(W/f) + x//f.

    halo=False (the default here; JAX defaults to True): [C, f, H/f, W, B],
    the layout the native loader's split gather writes and
    `degrade_fused_presplit(baked_halo=False)` takes. halo=True:
    [C, f, H/f + 2*halo_rows, W, B] with `halo_rows` replicate rows per
    end of every phase (all image row 0 on top, row H-1 below), the
    `baked_halo=True` layout; halo_rows must be `col_halo(K, factor)` of
    the span to be degraded."""
    c, h, w, b = x.shape
    if h % factor or w % factor:
        raise ValueError(f"H, W must be multiples of factor: {(h, w, factor)}")
    out_h, out_w = h // factor, w // factor
    xr = x.reshape(c, out_h, factor, out_w, factor, b)
    xp = xr.permute(0, 2, 1, 4, 3, 5).reshape(c, factor, out_h, w, b)
    if not halo:
        return xp
    edge = (c, factor, halo_rows, w, b)
    top = xp[:, 0:1, 0:1].expand(edge)
    bot = xp[:, factor - 1:factor, out_h - 1:out_h].expand(edge)
    return torch.cat([top, xp, bot], dim=2)


def _presplit_setup(xp, kernel, noise, factor, baked_halo, halo_rows):
    """(comp, noise, baked halo depth m or 0), with JAX's guards."""
    c, f, hrows, w, b = xp.shape
    if f != factor:
        raise ValueError(f"xp phase dim {f} != factor {factor}")
    if w % factor:
        raise ValueError(f"W must be a multiple of factor: {(w, factor)}")
    comp = _composed(kernel, factor, c, xp.device)
    ksize = comp.shape[-1]
    _check_span(ksize, factor, "pre-split degrade")
    m = col_halo(ksize, factor)
    if baked_halo and halo_rows is not None and halo_rows != m:
        raise ValueError(
            f"presplit layout was built with halo_rows={halo_rows} but the "
            f"composed span {ksize} at factor {factor} needs halo depth "
            f"m={m}; rebuild with phase_split_chwb(..., halo_rows={m}) "
            f"(or use baked_halo=False, which needs no halo rows)"
        )
    if not baked_halo and halo_rows not in (None, 0):
        raise ValueError(
            f"baked_halo=False expects a halo-free layout "
            f"(phase_split_chwb(halo=False)); got halo_rows={halo_rows}"
        )
    out_h = hrows - 2 * m if baked_halo else hrows
    if out_h < 1:
        raise ValueError(
            f"presplit layout has {hrows} row-blocks but the composed span "
            f"{ksize} implies {2 * m} halo rows — no image rows remain "
            f"(layout/kernel mismatch?)"
        )
    noise = _noise(noise, (c, out_h, w // factor, b), xp.device)
    return comp, noise, (m if baked_halo else 0)


def degrade_fused_presplit(
    xp: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
    baked_halo: bool = False,
    halo_rows: int | None = None,
) -> torch.Tensor:
    """Fused degrade on PRE-SPLIT factory data.

    xp: float32 or bfloat16, the `phase_split_chwb` layout: [C, f, H/f, W, B]
    with baked_halo=False (the v3psn kernel rebuilds replicate padding
    from clamped indices; also what the native loader's split gather
    writes), or [C, f, H/f + 2m, W, B] with baked_halo=True (the v3ps
    kernel reads the m baked rows; m = `col_halo(K, factor)`, and
    halo_rows, if given, must equal it). kernel: [C, kh, kw]; noise:
    optional [C, H/f, W/f, B]. Returns float32 [C, H/f, W/f, B], equal to
    `degrade_fused_chwb` (v3) on the un-split input.
    """
    comp, noise, m = _presplit_setup(xp, kernel, noise, factor, baked_halo,
                                     halo_rows)
    c, _, hrows, w, b = xp.shape
    layout = "presplit_halo" if baked_halo else "presplit"
    return _stencil(xp, comp, noise, factor, layout,
                    (c, (hrows - 2 * m) * factor, w, b), halo=m)


def degrade_fused_presplit_ref(
    xp: torch.Tensor,
    kernel: torch.Tensor,
    noise: torch.Tensor | None = None,
    factor: int = 8,
    baked_halo: bool = False,
    halo_rows: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of `degrade_fused_presplit`, on any device."""
    comp, noise, m = _presplit_setup(xp, kernel, noise, factor, baked_halo,
                                     halo_rows)
    layout = "presplit_halo" if baked_halo else "presplit"
    return _stencil_ref(xp, comp, noise, factor, layout, halo=m)
