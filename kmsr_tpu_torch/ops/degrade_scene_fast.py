"""Whole-scene degrade of row slabs on the hand-written Hopper scene stencil
— the counterpart of `kmsr_tpu.ops.degrade_scene_fast`.

Both entry points compute, for every output cell of a row slab,
    out[c,i,j] = sum_{dy<K} sum_{dx<K} comp[c,dy,dx]
                 * row(c, f*i+dy-half)[clamp(f*j+dx-half, 0, W-1)]
with comp = compose_with_box(normalize_kernel(k), f) ([C, K, K]) and
half = (K-f)//2: the stride-f blur+box stencil with replicate padding in
W. They differ in where row y of the slab comes from:

* `degrade_rows_fast(x, comp, f, top_rows, bot_rows)` <- `:553`: a RAW
  slab x [C, Hs, W] and its thin halos, three separate tensors (no
  slab-sized concat is ever built): y < 0 reads top_rows, y >= Hs reads
  bot_rows. Kernel `colsplit_raw` (TPU `_colsplit_raw_kernel`, `:358`).
* `degrade_slab_fast(x_ext, comp, f)` <- `:656`: a halo-extended slab
  [C, TOP + Hs + BOT, W], (TOP, BOT) = `slab_halo(f, K)`; row y is
  x_ext[TOP + y]. Kernel `colsplit` (TPU `_colsplit_kernel`, `:215`).

A CUDA tensor launches `kernels.scene_stencil_*` (`kernels/scene_stencil.cu`)
or raises; a CPU tensor runs the plain PyTorch version of the same map
(`degrade_rows_fast_ref`, `degrade_slab_fast_ref`: a tap-by-tap
gather-and-add in the kernel's order). Nothing falls back from one to the
other, and neither needs a shape-triggered fallback: the kernel takes thin
slabs as they are.

What the TPU path needs and this one does not: the `col_split` pre-pass
(Mosaic has no strided lane slice; a CUDA thread gathers its strided
columns directly), the sublane tile pickers `_pick_tile*`, the zero-shifted
kernel embedding, and the strip convs (`_row_band`, `_border_cols_raw`,
`_border_cols`) that overwrite the Pallas kernel's contaminated edge rows
and border columns — the halo map and the column clamp give the edges
directly. `phase_split` and `col_split` are kept as public layout helpers.
The `interpret` argument (Pallas interpret mode) has no counterpart.
"""
from __future__ import annotations

import torch

from .degrade_fused import _clamped_taps

#: The JAX path's sublane block (Mosaic: multiples of 8). It fixes the
#: halo contract `slab_halo` shared by both packages, so it is kept here.
_SUBLANE = 8
_IMPLS = ("auto", "cuda", "plain")


def _round_sublane(n: int) -> int:
    return _SUBLANE * (-(-n // _SUBLANE))


def _geometry(factor: int, ksize: int):
    """(half, nb, shift, ke, qmax, sliver) for a composed kernel span."""
    half = (ksize - factor) // 2          # blur half-width
    nb = -(-half // factor) if half else 0  # border cols / halo phase rows
    shift = nb * factor - half            # static zero-shift, in [0, f)
    ke = ksize + shift                    # embedded tap-lattice span
    qmax = (ke - 1) // factor
    sliver = _round_sublane(qmax)
    return half, nb, shift, ke, qmax, sliver


def slab_halo(factor: int, ksize: int) -> tuple[int, int]:
    """(top, bottom) extension rows `degrade_slab_fast` expects around a
    slab: top = f*nb absorbs the blur half-offset; bottom is the JAX
    kernel's next-block reach, rounded so top+Hs+bottom stays a factor
    multiple. Identical to the JAX package's contract."""
    _, nb, shift, _, _, _ = _geometry(factor, ksize)
    top = nb * factor
    bot = max(_round_sublane(ksize + shift - factor) - top,
              (ksize - factor) // 2, 1)
    bot += (-(top + bot)) % factor
    return top, bot


def halo_rows(factor: int, ksize: int) -> tuple[int, int]:
    """(top, bottom) real neighbour rows `degrade_rows_fast` needs: the
    blur half-width above the slab and the kernel's reach below its last
    stride window (6 each for f=8 with a 13x13 blur, K=20)."""
    half = (ksize - factor) // 2
    return half, max(ksize - half - factor, 0)


def extend_rows_edge(x: torch.Tensor, factor: int, ksize: int) -> torch.Tensor:
    """Edge-replicate the `slab_halo` TOP/BOT rows onto a raw [C, H, W]
    scene (one concat)."""
    top, bot = slab_halo(factor, ksize)
    return torch.cat([x[:, :1].expand(-1, top, -1), x,
                      x[:, -1:].expand(-1, bot, -1)], dim=1)


def phase_split(x: torch.Tensor, factor: int,
                strategy: str = "transpose") -> torch.Tensor:
    """[C, H, W] -> [C, f, f, H/f, W/f] phase planes (H, W multiples of f):
    phases[c, p, q, r, s] = x[c, f*r + p, f*s + q]. Both JAX spellings are
    kept ('transpose': a reshape/permute; 'slices': f strided slices
    stacked); they give the same planes."""
    c, h, w = x.shape
    if h % factor or w % factor:
        raise ValueError(f"H, W must be multiples of factor: {(h, w, factor)}")
    r, s = h // factor, w // factor
    if strategy == "transpose":
        byq = x.reshape(c, h, s, factor).transpose(2, 3).permute(0, 2, 1, 3)
    elif strategy == "slices":
        byq = torch.stack([x[:, :, q::factor] for q in range(factor)], dim=1)
    else:
        raise ValueError(f"strategy must be transpose|slices, got {strategy!r}")
    return byq.reshape(c, factor, r, factor, s).permute(0, 3, 1, 2, 4)


def col_split(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[C, H, W] -> [C, f(q), H, S] column phase planes:
    byq[c, q, y, s] = x[c, y, f*s + q]."""
    c, h, w = x.shape
    if w % factor:
        raise ValueError(f"W must be a multiple of factor: {(w, factor)}")
    return x.reshape(c, h, w // factor, factor).transpose(2, 3).permute(0, 2, 1, 3)


def _check_span(factor: int, ksize: int) -> None:
    _, nb, _, _, qmax, _ = _geometry(factor, ksize)
    if qmax > 2 * nb:
        raise ValueError(
            f"kernel span {ksize} too wide for factor {factor} "
            f"(qmax {qmax} > 2*nb {2 * nb}); use ops.degrade instead"
        )


def _route(impl: str, x: torch.Tensor) -> str:
    """'cuda' for a CUDA tensor, 'plain' for a CPU one; an explicit impl
    that does not match the tensor's device raises."""
    if impl not in _IMPLS:
        raise ValueError(f"impl must be auto|cuda|plain, got {impl!r}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the scene degrade runs on cuda or cpu, got {x.device}")
    route = "cuda" if x.device.type == "cuda" else "plain"
    if impl not in ("auto", route):
        raise ValueError(
            f"impl={impl!r} needs a {'CUDA' if impl == 'cuda' else 'CPU'} "
            f"tensor, got one on {x.device}")
    return route


def _comp(comp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if comp.ndim != 3 or comp.shape[0] != x.shape[0] \
            or comp.shape[1] != comp.shape[2]:
        raise ValueError(
            f"comp must be [C, K, K] with C={x.shape[0]}, got {tuple(comp.shape)}")
    return comp.to(device=x.device, dtype=torch.float32).contiguous()


def _rows_setup(x, comp, factor, top_rows, bot_rows):
    """The JAX guards of `degrade_rows_fast`, then its halo trim to the
    last th / first bh rows."""
    c, h, w = x.shape
    comp = _comp(comp, x)
    th, bh = halo_rows(factor, comp.shape[-1])
    if h % factor or w % factor:
        raise ValueError(f"slab dims must be factor multiples: {(h, w)}")
    if top_rows.shape[1] < th or bot_rows.shape[1] < bh:
        raise ValueError(
            f"halos too thin: need ({th}, {bh}), "
            f"got ({top_rows.shape[1]}, {bot_rows.shape[1]})"
        )
    for name, t in (("top_rows", top_rows), ("bot_rows", bot_rows)):
        if t.ndim != 3 or t.shape[0] != c or t.shape[2] != w:
            raise ValueError(
                f"{name} must be [{c}, rows, {w}], got {tuple(t.shape)}")
    _check_span(factor, comp.shape[-1])
    top_rows = top_rows[:, top_rows.shape[1] - th:]
    bot_rows = bot_rows[:, :bh]
    return comp, top_rows, bot_rows


def _slab_setup(x_ext, comp, factor):
    """The JAX guards of `degrade_slab_fast`; returns (comp, top, Hs)."""
    comp = _comp(comp, x_ext)
    _, hin, w = x_ext.shape
    top, bot = slab_halo(factor, comp.shape[-1])
    if hin - top - bot <= 0 or (hin - top - bot) % factor or w % factor:
        raise ValueError(
            f"slab rows/cols must fit the halo contract: {(hin, w, top, bot)}"
        )
    _check_span(factor, comp.shape[-1])
    return comp, top, hin - top - bot


def _stencil_ref(rows_of, comp: torch.Tensor, factor: int, hs: int,
                 w: int) -> torch.Tensor:
    """Plain version of the scene stencil: for each tap row dy, gather the
    slab rows f*i+dy-half through `rows_of` ([oh] row numbers -> [C, oh, W]),
    then add comp * (clamped column tap), dy outer, dx inner — the
    kernel's order and rounding (separate multiply and add)."""
    c, ksize = comp.shape[0], comp.shape[-1]
    half = (ksize - factor) // 2
    oh, ow = hs // factor, w // factor
    dev = comp.device
    xs = _clamped_taps(ow, w, factor, ksize, dev)
    ys = factor * torch.arange(oh, device=dev)
    acc = torch.zeros(c, oh, ow, device=dev)
    for dy in range(ksize):
        rows = rows_of(ys + (dy - half)).float()
        for dx in range(ksize):
            acc = acc + comp[:, dy, dx].reshape(c, 1, 1) * rows[:, :, xs[dx]]
    return acc


def _raw_rows(x, top_rows, bot_rows):
    """The raw map: row y of the slab from top_rows (y < 0), x, or
    bot_rows (y >= Hs), gathered without concatenating them."""
    hs, th, bh = x.shape[1], top_rows.shape[1], bot_rows.shape[1]

    def rows_of(y):
        out = x[:, y.clamp(0, hs - 1)]
        if th:
            out = torch.where((y < 0)[None, :, None],
                              top_rows[:, (y + th).clamp(0, th - 1)], out)
        if bh:
            out = torch.where((y >= hs)[None, :, None],
                              bot_rows[:, (y - hs).clamp(0, bh - 1)], out)
        return out

    return rows_of


def degrade_rows_fast(
    x: torch.Tensor,
    comp: torch.Tensor,
    factor: int,
    top_rows: torch.Tensor,
    bot_rows: torch.Tensor,
    impl: str = "auto",
) -> torch.Tensor:
    """Degrade a RAW row slab given thin real halos.

    x: [C, Hs, W] float32 (Hs, W multiples of `factor`; any row-major view
    with unit column stride, e.g. a row slab of a scene); top_rows /
    bot_rows: [C, >= halo_rows()[0], W] / [C, >= halo_rows()[1], W] of
    neighbour (sharded) or edge-replicated (global edge) content — only
    the last th / first bh rows are read; comp: [C, K, K] composed kernels.
    Returns float32 [C, Hs/f, W/f], the replicate-pad strided conv of the
    composed kernel. impl: 'auto' (by the tensor's device), 'cuda' (the
    `colsplit_raw` kernel) or 'plain' (a CPU tensor's plain version).
    """
    if _route(impl, x) == "plain":
        return degrade_rows_fast_ref(x, comp, factor, top_rows, bot_rows)
    comp, top_rows, bot_rows = _rows_setup(x, comp, factor, top_rows, bot_rows)
    from ..kernels import scene_stencil_raw

    c, hs, w = x.shape
    out = torch.empty(c, hs // factor, w // factor, device=x.device)
    return scene_stencil_raw(x, top_rows, bot_rows, comp, out, factor=factor)


def degrade_rows_fast_ref(
    x: torch.Tensor,
    comp: torch.Tensor,
    factor: int,
    top_rows: torch.Tensor,
    bot_rows: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of `degrade_rows_fast`, on any device."""
    comp, top_rows, bot_rows = _rows_setup(x, comp, factor, top_rows, bot_rows)
    return _stencil_ref(_raw_rows(x, top_rows, bot_rows), comp, factor,
                        x.shape[1], x.shape[2])


def degrade_slab_fast(
    x_ext: torch.Tensor,
    comp: torch.Tensor,
    factor: int,
    impl: str = "auto",
) -> torch.Tensor:
    """Degrade a halo-extended slab with the composed blur-box kernel.

    x_ext: [C, TOP + Hs + BOT, W] float32 with (TOP, BOT) = `slab_halo`
    rows of neighbour or edge content (`extend_rows_edge` for a whole
    scene) and W a multiple of `factor`; comp: [C, K, K]. Returns float32
    [C, Hs/f, W/f], the replicate-pad strided conv of the composed kernel.
    impl: 'auto', 'cuda' (the `colsplit` kernel) or 'plain'.
    """
    if _route(impl, x_ext) == "plain":
        return degrade_slab_fast_ref(x_ext, comp, factor)
    comp, top, hs = _slab_setup(x_ext, comp, factor)
    from ..kernels import scene_stencil_ext

    c, _, w = x_ext.shape
    out = torch.empty(c, hs // factor, w // factor, device=x_ext.device)
    return scene_stencil_ext(x_ext, comp, out, factor=factor, top=top)


def degrade_slab_fast_ref(
    x_ext: torch.Tensor,
    comp: torch.Tensor,
    factor: int,
) -> torch.Tensor:
    """Plain PyTorch version of `degrade_slab_fast`, on any device."""
    comp, top, hs = _slab_setup(x_ext, comp, factor)
    return _stencil_ref(lambda y: x_ext[:, top + y], comp, factor, hs,
                        x_ext.shape[2])
