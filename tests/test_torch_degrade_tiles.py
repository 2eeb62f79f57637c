"""The geometry the redesigned wide-span kernels read, checked on the CPU.

The dense (v4) kernel never builds the stencil matrix in device memory: a
block generates the entries of its output tile over the tile's band only
(`kernels.dense_tiles`). Here the band must cover every nonzero of JAX's
`_stencil_matrix` for the tile, and a plain PyTorch mirror of the kernel's
per-entry generation rule must equal the matching block of JAX's matrix,
of the port's `stencil_matrix` and of their `bf16_terms`, bit for bit,
border tiles included. The v1/v2 kernel stages its input window one row
phase at a time (`kernels.wide_tiles`); every clamped tap of `_tap_order`
must find its pixel in the staged window. No Pallas call: each case takes
well under a second.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu.ops.degrade_pallas import _stencil_matrix
from kmsr_tpu_torch.kernels import SMEM_MAX, WIDE_R, dense_tiles, wide_tiles
from kmsr_tpu_torch.ops.degrade import compose_with_box, normalize_kernel
from kmsr_tpu_torch.ops.degrade_fused import (
    _tap_order, bf16_terms, select_version, stencil_matrix,
)

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
