"""The geometry the redesigned stencil kernels read, checked on the CPU.

The dense (v4) kernel never builds the stencil matrix in device memory: a
block generates the entries of its output tile over the tile's band only
(`kernels.dense_tiles`). Here the band must cover every nonzero of JAX's
`_stencil_matrix` for the tile, and a plain PyTorch mirror of the kernel's
per-entry generation rule must equal the matching block of JAX's matrix,
of the port's `stencil_matrix` and of their `bf16_terms`, bit for bit,
border tiles included. The v1/v2 kernel stages its input window one row
phase at a time (`kernels.wide_tiles`); every clamped tap of `_tap_order`
must find its pixel in the staged window. The v3-family and scene kernels
stream the input rows a tile reads through a ring and keep an
accumulator for each output still open in a column (`kernels.stencil_tiles`,
`kernels.scene_tiles`); every tap of every output must then read, from
the window row and column a mirror of the kernel's staging gives it, the
pixel the plain version reads, through each layout's row and column map,
with the tiles covering each output once. No Pallas call: each case takes
well under a second.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu.ops.degrade_pallas import _stencil_matrix
from kmsr_tpu_torch import kernels
from kmsr_tpu_torch.kernels import (
    RING, RING_SLOTS, SMEM_MAX, WIDE_R, dense_tiles, ring_smem, scene_tiles,
    stencil_tiles, wide_tiles,
)
from kmsr_tpu_torch.ops.degrade import compose_with_box, normalize_kernel
from kmsr_tpu_torch.ops.degrade_fused import (
    _tap_order, bf16_terms, col_halo, phase_split_chwb, select_version,
    stencil_matrix,
)
from kmsr_tpu_torch.ops.degrade_scene_fast import halo_rows, slab_halo

C = 2
#: (h, w, factor) where v4's shape rule holds: every square side of
#: {16, 32, 48} at f in {2, 4, 8} that passes it, a 64x64 one at f=8 (the
#: card's f=8 case), and two non-square ones (tn = 8 of w/f = 40; one row
#: of outputs). Border tiles have clamped, shorter bands, and most bands
#: end in a partial 32-pixel stage of the kernel's pipeline.
V4_SHAPES = [(16, 16, 2), (32, 32, 2), (32, 32, 4), (48, 48, 2), (64, 64, 8),
             (16, 80, 2), (8, 64, 8)]


def _comp(seed, ksize, factor):
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.uniform(0.1, 1, (C, ksize, ksize)).astype(np.float32))
    return compose_with_box(normalize_kernel(k), factor).contiguous()


def _clamp(v, n):
    return np.clip(v, 0, n - 1)


def _window(comp, factor, h, w, tile, tn):
    """Plain mirror of the kernel's generation rule for one tile: entry
    (output column j0 + n, band pixel q) = sequential float32 sum from 0,
    dy-major, dx-minor, of comp[dy, dx] over the taps with
    clamp(f*i + dy - half) = y and clamp(f*j + dx - half) = x."""
    i, j0, y0, nr, x0, nc = tile
    ksize = comp.shape[-1]
    half = (ksize - factor) // 2
    q = np.arange(nr * nc)
    y, x = y0 + q // nc, x0 + q % nc                       # [band]
    j = j0 + np.arange(tn)                                 # [tn]
    d = np.arange(ksize)
    hit_y = _clamp(factor * i + d - half, h) == y[None, :, None]      # [1, band, K]
    hit_x = _clamp(factor * j[:, None] + d - half, w)[:, None, :] == x[None, :, None]
    acc = torch.zeros(C, tn, nr * nc)
    for dy in range(ksize):
        for dx in range(ksize):
            hit = torch.from_numpy(hit_y[..., dy] & hit_x[..., dx])
            acc = torch.where(hit, acc + comp[:, dy, dx, None, None], acc)
    return acc, y * w + x


@pytest.mark.parametrize("ksize", [12, 13])
@pytest.mark.parametrize("h,w,factor", V4_SHAPES)
def test_dense_band_covers_stencil_matrix(h, w, factor, ksize):
    """Every tile's band holds every nonzero of JAX's stencil matrix rows
    for that tile (positive taps: nonzero = reached), the tiles cover each
    output once, and the mirror of the kernel's generation rule equals
    JAX's block, the port's `stencil_matrix` block and their three bf16
    terms bit for bit."""
    assert select_version(ksize + factor - 1, factor, h, w, torch.float32, 4) == 4
    comp = _comp(h + ksize, ksize, factor)
    ow = w // factor
    want = np.asarray(_stencil_matrix(jnp.asarray(comp.numpy()), factor, h, w))
    mine = stencil_matrix(comp, factor, h, w)
    np.testing.assert_array_equal(mine.numpy(), want)
    terms = torch.stack(bf16_terms(mine, 3), dim=1)         # [C, 3, M, h*w]
    tn, tiles = dense_tiles(ksize + factor - 1, factor, h, w)
    assert ow % tn == 0 and tiles.dtype == torch.int32
    seen = np.zeros((h // factor, ow), int)
    for tile in tiles.tolist():
        i, j0, y0, nr, x0, nc = tile
        assert x0 % 8 == 0 and nc % 8 == 0 and x0 + nc <= w and y0 + nr <= h
        seen[i, j0:j0 + tn] += 1
        rows = i * ow + j0 + np.arange(tn)
        block = want[:, rows]                               # [C, tn, h*w]
        ys, xs = np.divmod(np.nonzero(block.any(axis=(0, 1)))[0], w)
        assert ys.min() >= y0 and ys.max() < y0 + nr, tile
        assert xs.min() >= x0 and xs.max() < x0 + nc, tile
        gen, p = _window(comp, factor, h, w, tile, tn)
        np.testing.assert_array_equal(gen.numpy(), block[:, :, p])
        outside = np.setdiff1d(np.arange(h * w), p)
        assert not block[:, :, outside].any()
        got_terms = torch.stack(bf16_terms(gen, 3), dim=1)
        assert torch.equal(got_terms, terms[:, :, rows][..., p])
    assert (seen == 1).all()


def _check_wide_window(layout, h, w, factor, ksize, version):
    """Mirror of the kernel's staging and indexing: for every output and
    every tap of its version's order, the phase-buffer row and column it
    reads lie inside the staged window and hold exactly the clamped pixel
    the tap needs."""
    half = ksize // 2
    kside = ksize + factor - 1
    ti, tj, rows, cols, noc = wide_tiles(layout, kside, factor, h)
    n_o = -(-kside // factor)
    oh, ow = h // factor, w // factor
    i = np.arange(oh)[:, None]
    j = np.arange(ow)[None, :]
    i0, j0 = i // ti * ti, j // tj * tj                    # each output's tile
    il, jl = i - i0, j - j0
    grp = il // WIDE_R
    n_taps = 0
    for phase in _tap_order(kside, factor, version):
        for dy, dx in phase:
            dyo, dyi = divmod(dy, factor)
            dxo, dxi = divmod(dx, factor)
            q = il + dyo                                    # phase-buffer row
            # the thread's register window: rows grp*R + dyo0 + [0, R+noc-1)
            dyo0 = dyo // noc * noc
            assert ((q - grp * WIDE_R - dyo0 >= 0)
                    & (q - grp * WIDE_R - dyo0 < WIDE_R + noc - 1)).all()
            assert (q < rows).all()
            staged_y = _clamp(factor * i0 - half + factor * q + dyi, h)
            assert (staged_y == _clamp(factor * i + dy - half, h)).all()
            wc = factor * jl + dx                           # window column
            if layout == "nchw":                            # stored at (dxi, jl + dxo)
                assert ((jl + dxo < cols) & (wc < factor * cols)).all()
                assert (wc % factor == dxi).all() and (wc // factor == jl + dxo).all()
            else:
                assert (wc < cols).all()
            staged_x = _clamp(factor * j0 - half + wc, w)
            assert (staged_x == _clamp(factor * j + dx - half, w)).all()
            n_taps += 1
    assert n_taps == kside * kside
    assert rows >= ti - 1 + n_o and noc in (4, 7)
    if noc == 7:  # the compile-time x2 lattice's geometry
        assert (factor, n_o) == (2, 7)
        assert (tj, cols) == ((32, 38) if layout == "nchw" else (8, 28))
    n_chunk = -(-n_o // noc) * noc
    table = -(-factor * kside * (-(-n_chunk // 4) * 4) // 4) * 4
    phase_floats = rows * factor * cols if layout == "nchw" else rows * cols * 32
    assert 4 * (table + 2 * phase_floats) <= SMEM_MAX


@pytest.mark.parametrize("h,w,factor,ksize", [
    (256, 256, 2, 13),   # the x2 factory's shape
    (256, 256, 8, 13),   # chip_smoke.py's f=8 case (K = 20)
    (64, 64, 2, 12),     # even kernel: tap offset k//2
    (72, 40, 2, 13),     # H, W not multiples of the tile
    (40, 24, 4, 13),
])
@pytest.mark.parametrize("layout,version", [("nchw", 2), ("chwb", 2), ("chwb", 1)])
def test_wide_window_covers_every_tap(layout, version, h, w, factor, ksize):
    _check_wide_window(layout, h, w, factor, ksize, version)


def test_wide_tiles_refuses_other_layouts():
    with pytest.raises(ValueError, match="nchw or chwb"):
        wide_tiles("presplit", 14, 2, 64)
    with pytest.raises(ValueError, match="multiples of 8"):
        dense_tiles(14, 2, 48, 44)


def _rolling_taps(oh, ow, ti, tj, factor, kside):
    """Mirror of the ring kernels' walk: for every output (i, j) and tap
    (dy, dx), its block's first output (i0, j0), the window row q and the
    window column wc it reads, after checking that q lies among the rows
    the block streams, that the slot v = r - lo holding the block's output
    r (lo: the oldest output still open in row q's group g) is one of the
    min(ceil(K/f), rows of the block) <= RING_SLOTS the walk keeps, and
    that the output's last tap falls in the group at whose end the walk
    writes slot 0."""
    n_o = -(-kside // factor)
    i = np.arange(oh)[:, None]
    j = np.arange(ow)[None, :]
    i0, j0 = i // ti * ti, j // tj * tj
    r, jl = i - i0, j - j0
    tiv = np.minimum(ti, oh - i0)
    rows = factor * (tiv - 1) + kside                   # rows the block streams
    assert (r < tiv).all() and (jl < tj).all()
    assert (np.minimum(n_o, tiv) <= RING_SLOTS).all()
    for dy in range(kside):
        q = factor * r + dy
        g = q // factor
        lo = np.maximum(0, g - n_o + 1)
        v = r - lo
        assert ((q < rows) & (0 <= v) & (v <= np.minimum(g, tiv - 1) - lo)).all()
        assert (v < np.minimum(n_o, tiv)).all()
        assert (dy == q % factor + factor * (g - lo - v)).all()
        if dy == kside - 1:  # complete at the end of group r + n_o - 1, slot 0
            assert ((g == r + n_o - 1) & (v == 0)).all()
            assert (g <= (rows - 1) // factor).all()
        for dx in range(kside):
            yield dy, dx, i, j, i0, j0, q, factor * jl + dx


def _check_phase_split(wc, factor, cols, row):
    """NCHW / scene storage: window column wc at (wc % f, wc // f) of a
    row of f phases x cols; a warp's 32 consecutive columns hit 32 banks
    where f divides 32."""
    assert (wc // factor < cols).all()
    assert ((wc % factor) * cols + wc // factor < row).all()
    if 32 % factor == 0:
        lanes = np.arange(32)
        assert len(set(((lanes % factor) * cols + lanes // factor) % 32)) == 32


def _plan_rows(ti_default, oh, kside, factor):
    """The output rows a ring block takes: ti_default, no more than oh,
    nor than RING_SLOTS where ceil(K/f) exceeds them."""
    n_o = -(-kside // factor)
    return min(ti_default, oh) if n_o <= RING_SLOTS else min(ti_default, oh, RING_SLOTS)


def _check_stencil_plan(layout, factor, kside, h, w, b):
    half = (kside - factor) // 2
    oh, ow = h // factor, w // factor
    ti, tj, cols, row = stencil_tiles(layout, kside, factor, h, w, b)
    assert ti == _plan_rows(8, oh, kside, factor)
    span = factor * (tj - 1) + kside
    assert ring_smem(kside, row, span, 2 if layout == "nchw" else 1) <= SMEM_MAX
    img = np.arange(h * w).reshape(h, w)              # pixel ids
    m = col_halo(kside, factor) if layout == "presplit_halo" else 0
    if layout.startswith("presplit"):
        xp = phase_split_chwb(torch.from_numpy(img)[None, :, :, None], factor,
                              halo=bool(m), halo_rows=max(m, 1))
        plane = xp.reshape(-1, w).numpy()            # [f * (oh + 2m), W]
    else:
        plane = img
    for dy, dx, i, j, i0, j0, q, wc in _rolling_taps(oh, ow, ti, tj, factor, kside):
        y = factor * i0 - half + q                    # the kernel's row map
        if layout == "presplit_halo":
            p = y % factor
            prow = p * (oh + 2 * m) + m + (y - p) // factor
        else:
            yc = _clamp(y, h)
            prow = (yc % factor) * oh + yc // factor if layout == "presplit" else yc
        xc = _clamp(factor * j0 - half + wc, w)       # the kernel's column map
        pcol = (xc % factor) * ow + xc // factor if layout.startswith("presplit") else xc
        want = img[_clamp(factor * i + dy - half, h), _clamp(factor * j + dx - half, w)]
        assert (plane[prow, pcol] == want).all(), (dy, dx)
        if layout == "nchw":
            _check_phase_split(wc, factor, cols, row)
        else:
            assert (wc < cols).all() and cols == span and row == cols * 32


#: (h, w, b): the factory's patch; ragged tiles (h/f below a tile, w/f not
#: a multiple of the column tile) with batches of 1, 3 or 33
STENCIL_SHAPES = [(256, 256, 128), (40, 72, 3), (24, 296, 33), (16, 8, 1)]
LAYOUTS = ["nchw", "chwb", "presplit", "presplit_halo"]


@pytest.mark.parametrize("h,w,b", STENCIL_SHAPES)
@pytest.mark.parametrize("factor", [8, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_stencil_window_covers_every_tap(layout, factor, h, w, b):
    """Every tap of every output reads, through the kernel's row map
    (clamp; presplit phase and block; baked-halo rows unclamped) and
    column map (clamp; permuted presplit column) applied while staging,
    the clamped pixel of the image; the plan fits shared memory."""
    kside = 13 + factor - 1                       # K = 20 at f=8, 16 at f=4
    if layout == "presplit_halo":
        assert col_halo(kside, factor) == {8: 1, 4: 2}[factor]
    _check_stencil_plan(layout, factor, kside, h, w, b)


@pytest.mark.parametrize("h,w,b", [(64, 72, 3), (24, 40, 1)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_stencil_window_covers_wide_spans(layout, h, w, b):
    """A span beyond the walk's run-time slots (f=2, K=20: ceil(K/f) = 10
    > RING_SLOTS), which the C ABI takes as it did before the ring: the
    plan holds a block to RING_SLOTS output rows, and every tap still
    reads the plain version's pixel."""
    assert -(-20 // 2) > RING_SLOTS
    _check_stencil_plan(layout, 2, 20, h, w, b)


@pytest.mark.parametrize("raw", [True, False])
@pytest.mark.parametrize("hs,w,factor,ksize", [
    (64, 8192, 8, 13),   # the scene path's width (K = 20)
    (64, 7992, 8, 13),   # the uneven scene's width: w/f = 999
    (16, 8192, 8, 13),   # a 16-row slab, thinner than the 2K rows of a tile
    (48, 200, 4, 13),    # f=4 (K = 16)
    (36, 36, 3, 5),      # f=3 (K = 7): no bank padding
    (64, 96, 2, 33),     # f=2, a 33x33 blur (K = 34): 17 open outputs > slots
    (40, 72, 1, 17),     # f=1 (K = 17): 17 open outputs
])
def test_scene_window_covers_every_tap(raw, hs, w, factor, ksize):
    """Every tap of every output of the scene kernel's plan reads the slab
    row of the plain version (RAW: top halo, slab or bottom halo; EXT: the
    extended slab from row TOP) and the clamped column, from a staged
    phase-split window that fits shared memory."""
    kside = ksize + factor - 1
    half = (kside - factor) // 2
    oh, ow = hs // factor, w // factor
    ti, tj, cols, row = scene_tiles(kside, factor, hs, w)
    assert ti == _plan_rows(16, oh, kside, factor) and tj % 32 == 0
    span = factor * (tj - 1) + kside
    assert ring_smem(kside, row, span, 2) <= SMEM_MAX
    th, bh = halo_rows(factor, kside)
    top, bot = slab_halo(factor, kside)
    for dy, dx, i, j, i0, j0, q, wc in _rolling_taps(oh, ow, ti, tj, factor, kside):
        y = factor * i0 - half + q                    # slab row staged
        assert (y == factor * i + dy - half).all()
        if raw:
            assert ((y >= -th) & (y < hs + bh)).all()
        else:
            assert ((top + y >= 0) & (top + y < top + hs + bot)).all()
        xc = _clamp(factor * j0 - half + wc, w)
        assert (xc == _clamp(factor * j + dx - half, w)).all()
        _check_phase_split(wc, factor, cols, row)


def test_ring_plans_refuse_what_they_cannot_cover():
    with pytest.raises(ValueError, match="unknown layout"):
        stencil_tiles("nhwc", 20, 8, 64, 64, 4)
    with pytest.raises(ValueError, match="empty"):
        stencil_tiles("chwb", 20, 8, 64, 64, 0)
    with pytest.raises(ValueError, match="empty"):
        scene_tiles(20, 8, 0, 64)


def test_ring_constants_match_the_kernels():
    """The plans' RING, RING_SLOTS and SMEM_MAX are the values the CUDA
    sources compile with (kRing, kSlots, kSmemMax)."""
    src = Path(kernels.__file__).parent
    ring = (src / "stencil_ring.cuh").read_text()
    assert re.search(r"constexpr int kRing = (\d+);", ring)[1] == str(RING)
    assert re.search(r"constexpr int kSlots = (\d+);", ring)[1] == str(RING_SLOTS)
    for name in ("degrade_stencil.cu", "scene_stencil.cu"):
        text = (src / name).read_text()
        assert re.search(r"constexpr int kSmemMax = (\d+);", text)[1] == str(SMEM_MAX)


def _ring_fits(layout, ksize, factor, ow):
    """Whether some ring tile of the plan's search fits shared memory."""
    split = layout in ("nchw", "scene")
    n_o = -(-ksize // factor)
    for n in (4, 2, 1):
        tj = (32 if split else 1) * n
        span = factor * (tj - 1) + ksize
        if split:
            cols = tj - 1 + n_o
            cols += (32 // factor - cols) % 32 if 32 % factor == 0 else 0
            row, tables = -(-factor * cols // 4) * 4, 2
        else:
            row, tables = span * 32, 1
        if ring_smem(ksize, row, span, tables) <= SMEM_MAX:
            return True
    return False


@pytest.mark.parametrize("factor", [2, 3, 4, 8, 16, 40, 48])
def test_planners_take_every_span_jax_accepts(factor):
    """Every span JAX's guards accept gets a plan, never a refusal: v3 at
    K <= 5f (each layout), v1/v2 at any K > 5f (`select_version` picks v2
    when v4's shape rule fails), the scene wherever JAX's `_check_span`
    holds. Where no shared-memory tile fits (the old refusals: batch-minor
    K > 184, phase-split K > 236 at f <= 4, wide CHWB K > 32 at f = 2), the
    plan is the global-read one, and only there."""
    from kmsr_tpu.ops.degrade_scene_fast import _geometry

    hw = 2 * factor * 8
    spans = sorted({factor, 5 * factor, 20, 33, 150, 185, 237, 240, 400} - {0})
    for ksize in spans:
        for layout in ("nchw", "chwb", "presplit", "presplit_halo"):
            if ksize > 5 * factor:
                continue
            plan = stencil_tiles(layout, ksize, factor, hw, hw, 8)
            direct = plan == kernels.RING_DIRECT
            assert direct != _ring_fits("nchw" if layout == "nchw" else "chwb", ksize,
                                        factor, hw // factor), (layout, ksize)
        if ksize > 5 * factor:
            assert select_version(ksize, factor, hw, hw, torch.float32, None) in (2, 4)
            for layout in ("nchw", "chwb"):
                plan = wide_tiles(layout, ksize, factor, hw)
                assert len(plan) == 5 and plan[-1] in (4, 7)
        _, nb, _, _, qmax, _ = _geometry(factor, ksize)
        if qmax <= 2 * nb:
            plan = scene_tiles(ksize, factor, hw, 8192)
            assert (plan == kernels.RING_DIRECT) != _ring_fits("scene", ksize, factor,
                                                                8192 // factor)
    # the old limits: the first span past each takes the global-read plan
    assert stencil_tiles("chwb", 184, 40, 80, 80, 8) != kernels.RING_DIRECT
    assert stencil_tiles("chwb", 185, 40, 80, 80, 8) == kernels.RING_DIRECT
    assert scene_tiles(236, 4, 64, 256) != kernels.RING_DIRECT
    assert scene_tiles(237, 4, 64, 256) == kernels.RING_DIRECT
    assert wide_tiles("chwb", 32, 2, 64) != kernels.WIDE_DIRECT
    assert wide_tiles("chwb", 33, 2, 64) == kernels.WIDE_DIRECT
    assert wide_tiles("nchw", 151, 2, 64) == kernels.WIDE_DIRECT


def test_global_read_plans_are_the_c_abi_sentinels():
    """The kernels take the all-zero plan (wide: rows = cols = 0 with a
    valid noc) as the global-read instantiation."""
    src = Path(kernels.__file__).parent
    for name in ("degrade_stencil.cu", "scene_stencil.cu"):
        text = (src / name).read_text()
        assert "ti == 0 && tj == 0 && cols == 0 && row == 0" in text
    assert kernels.RING_DIRECT == (0, 0, 0, 0)
    assert kernels.WIDE_DIRECT[:4] == (0, 0, 0, 0) and kernels.WIDE_DIRECT[4] == 4
    assert "if (t.TI == 0) return launch_direct" in (src / "degrade_wide.cu").read_text()
