"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip on hosts
without a card. On the card: python -m pytest tests/test_torch_kernels.py -m cuda
"""
import pytest
import torch

from kmsr_tpu_torch import kernels
from kmsr_tpu_torch.ops.degrade import compose_with_box, normalize_kernel
from kmsr_tpu_torch.ops.degrade_fused import (
    _a_terms, _dense, _stencil, _stencil_ref, degrade_fused, degrade_fused_chwb,
    degrade_fused_chwb_ref, col_halo, degrade_fused_presplit,
    degrade_fused_presplit_ref, degrade_fused_ref, degrade_v4_ref,
    phase_split_chwb, select_version,
)
from kmsr_tpu_torch.ops.degrade_scene_fast import (
    degrade_rows_fast, degrade_rows_fast_ref, degrade_slab_fast,
    degrade_slab_fast_ref, extend_rows_edge, halo_rows,
)
from kmsr_tpu_torch.parallel.spatial import degrade_scene_sharded

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, factor, b=32, h=64, c=5, ksize=13, seed=0, w=None):
    w = h if w is None else w
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(c, h, w, b, generator=g) * 2 + 5).to(dev)
    kernel = torch.rand(c, ksize, ksize, generator=g).to(dev)
    noise = (torch.randn(c, h // factor, w // factor, b, generator=g) * 0.1).to(dev)
    return x, kernel, noise


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_every_layout(cuda, factor, dtype):
    """Every instantiation (NCHW / CHWB / presplit x noise), f=8 (span 20)
    and f=4 (span 16), float32 and bfloat16 storage; each launch counted."""
    x, kernel, noise = _inputs(cuda, factor)
    xd = x.to(dtype)
    kernels.reset_launches()
    for n in (None, noise):
        torch.testing.assert_close(
            degrade_fused_chwb(xd, kernel, n, factor=factor),
            degrade_fused_chwb_ref(xd, kernel, n, factor=factor), **TOL)
        xp = phase_split_chwb(xd, factor).contiguous()
        torch.testing.assert_close(
            degrade_fused_presplit(xp, kernel, n, factor=factor),
            degrade_fused_presplit_ref(xp, kernel, n, factor=factor), **TOL)
        img = xd.permute(3, 0, 1, 2).contiguous()
        nn = None if n is None else n.permute(3, 0, 1, 2).contiguous()
        torch.testing.assert_close(
            degrade_fused(img, kernel, nn, factor=factor),
            degrade_fused_ref(img, kernel, nn, factor=factor), **TOL)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"degrade_v3": 4, "degrade_v3psn": 2,
                                "degrade_v3ps": 0, "degrade_v2": 0,
                                "degrade_v1": 0, "degrade_v4": 0,
                                "colsplit_raw": 0, "colsplit": 0,
                                "swin_norm_rows": 0, "swin_add_norm_rows": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("factor,h,ksize", [(2, 64, 13), (8, 64, 13), (2, 32, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_span_kernels_match_plain(cuda, factor, h, ksize, dtype):
    """CHWB pinned to v1 and v2 bit for bit and to v4 (the dense
    tensor-core kernel; 64x64 at f=2 is too large for it, so 32x32 then)
    within the tolerance; NCHW through auto-selection (v2 at 64x64 f=2, v3
    at f=8, v4 at 32x32 f=2); v3ps bit for bit where K <= 5f; with and
    without noise, float32 and bfloat16 storage, an even kernel side too;
    each launch counted under its own name."""
    x, kernel, noise = _inputs(cuda, factor, b=20, h=h, ksize=ksize)
    xd = x.to(dtype)
    img = xd.permute(3, 0, 1, 2).contiguous()
    auto = select_version(ksize + factor - 1, factor, h, h, dtype, None)
    assert auto == {(2, 64): 2, (8, 64): 3, (2, 32): 4}[factor, h]
    kernels.reset_launches()
    want = {"degrade_v1": 0, "degrade_v2": 0, "degrade_v3": 0, "degrade_v4": 0,
            "degrade_v3ps": 0}
    for n in (None, noise):
        nn = None if n is None else n.permute(3, 0, 1, 2).contiguous()
        for version in (1, 2):
            torch.testing.assert_close(
                degrade_fused_chwb(xd, kernel, n, factor=factor, version=version),
                degrade_fused_chwb_ref(xd, kernel, n, factor=factor, version=version),
                rtol=0, atol=0)
            want[f"degrade_v{version}"] += 1
        if h * h * (h // factor) ** 2 <= 64 * 64 * 64 * 8:
            torch.testing.assert_close(
                degrade_fused_chwb(xd, kernel, n, factor=factor, version=4),
                degrade_fused_chwb_ref(xd, kernel, n, factor=factor, version=4), **TOL)
            want["degrade_v4"] += 1
        torch.testing.assert_close(
            degrade_fused(img, kernel, nn, factor=factor),
            degrade_fused_ref(img, kernel, nn, factor=factor),
            **(TOL if auto == 4 else dict(rtol=0, atol=0)))
        want[f"degrade_v{auto}"] += 1
        if ksize + factor - 1 <= 5 * factor:
            m = col_halo(ksize + factor - 1, factor)
            xp = phase_split_chwb(xd, factor, halo=True, halo_rows=m).contiguous()
            got = degrade_fused_presplit(xp, kernel, n, factor=factor, baked_halo=True)
            torch.testing.assert_close(got, degrade_fused_presplit_ref(
                xp, kernel, n, factor=factor, baked_halo=True), rtol=0, atol=0)
            torch.testing.assert_close(
                got, degrade_fused_chwb(xd, kernel, n, factor=factor), rtol=0, atol=0)
            want["degrade_v3ps"] += 1
            want["degrade_v3"] += 1  # the CHWB call it is held against
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] for k in want} == want


@pytest.mark.cuda
def test_auto_selection_launches_v4_then_v2(cuda):
    """At f=2 (span 14) a 48x48 batch goes to the dense kernel and a
    256x256 one to the v2 stencil, whatever the batch."""
    kernels.reset_launches()
    for h, name in ((48, "degrade_v4"), (256, "degrade_v2")):
        x, kernel, noise = _inputs(cuda, 2, b=3, h=h)
        img = x.permute(3, 0, 1, 2).contiguous()
        nn = noise.permute(3, 0, 1, 2).contiguous()
        before = kernels.LAUNCHES[name]
        got = degrade_fused(img, kernel, nn, factor=2)
        torch.testing.assert_close(got, degrade_fused_ref(img, kernel, nn, factor=2),
                                   **TOL)
        assert kernels.LAUNCHES[name] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,factor,ksize,b", [
    (72, 72, 2, 13, 3),     # H, W not multiples of the tile
    (40, 104, 2, 13, 20),
    (136, 136, 8, 12, 20),  # f=8 (K = 19), even kernel
    (64, 64, 8, 12, 3),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_kernel_odd_shapes(cuda, h, w, factor, ksize, b, dtype):
    """The tiled v1/v2 kernel bit for bit against its plain version where
    tiles are ragged, batches are 3 or 20 wide, at f=8 and with an even
    kernel (tap offset k//2): v2 on NCHW and CHWB, v1 on CHWB, +- noise."""
    x, kernel, noise = _inputs(cuda, factor, b=b, h=h, w=w, ksize=ksize)
    comp = compose_with_box(normalize_kernel(kernel), factor).contiguous()
    xd, half = x.to(dtype), ksize // 2
    dims = (5, h, w, b)
    kernels.reset_launches()
    for n in (None, noise):
        for layout, version in (("nchw", 2), ("chwb", 2), ("chwb", 1)):
            xl, nl = xd, n
            if layout == "nchw":
                xl = xd.permute(3, 0, 1, 2).contiguous()
                nl = None if n is None else n.permute(3, 0, 1, 2).contiguous()
            got = _stencil(xl, comp, nl, factor, layout, dims, version, half)
            want = _stencil_ref(xl, comp, nl, factor, layout, version, half)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["degrade_v2"] == 4 and kernels.LAUNCHES["degrade_v1"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,factor,ksize,b", [
    (48, 48, 2, 13, 3),    # the x2 factory's v4 shape, a 3-wide batch
    (16, 80, 2, 13, 20),   # tiles of 8 output columns, non-square
    (64, 64, 8, 12, 3),    # f=8 (K = 19), even kernel
    (32, 32, 2, 12, 130),  # two batch passes over one generated window
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernel_odd_shapes(cuda, h, w, factor, ksize, b, dtype):
    """The banded v4 kernel (stencil matrix generated on chip) against its
    plain version on the wrapper-built matrix terms, NCHW and CHWB, +-
    noise, within the tolerance."""
    x, kernel, noise = _inputs(cuda, factor, b=b, h=h, w=w, ksize=ksize)
    comp = compose_with_box(normalize_kernel(kernel), factor).contiguous()
    xd = x.to(dtype)
    a_terms = _a_terms(comp, factor, h, w)
    kernels.reset_launches()
    for n in (None, noise):
        for layout in ("nchw", "chwb"):
            xl, nl = xd, n
            if layout == "nchw":
                xl = xd.permute(3, 0, 1, 2).contiguous()
                nl = None if n is None else n.permute(3, 0, 1, 2).contiguous()
            torch.testing.assert_close(
                _dense(xl, comp, nl, factor, layout),
                degrade_v4_ref(xl, a_terms, nl, factor, layout), **TOL)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["degrade_v4"] == 4


@pytest.mark.cuda
def test_dense_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 16, 16, 4, device=cuda)
    comp = torch.zeros(2, 14, 14, device=cuda)
    out = torch.empty(2, 8, 8, 4, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        kernels.degrade_dense(x, comp.bfloat16(), None, out, layout="chwb", factor=2)
    with pytest.raises(ValueError, match="comp shape"):
        kernels.degrade_dense(x, comp[:, :, :13].contiguous(), None, out,
                              layout="chwb", factor=2)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.degrade_dense(x.transpose(1, 2), comp, None, out, layout="chwb",
                              factor=2)
    with pytest.raises(ValueError, match="nchw or chwb"):
        kernels.degrade_dense(x, comp, None, out, layout="presplit", factor=2)
    with pytest.raises(ValueError, match="noise shape"):
        kernels.degrade_dense(x, comp, out[..., :2].contiguous(), out,
                              layout="chwb", factor=2)
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels.degrade_dense(torch.zeros(2, 16, 12, 4, device=cuda), comp, None,
                              torch.empty(2, 8, 6, 4, device=cuda), layout="chwb",
                              factor=2)
    with pytest.raises(RuntimeError, match="arguments refused"):
        comp = torch.zeros(5, 20, 20, device=cuda)
        xs = torch.zeros(5, 64, 64, 4, device=cuda)
        kernels.degrade_stencil(xs, comp, None, torch.empty(5, 8, 8, 4, device=cuda),
                                layout="presplit", dims=(5, 64, 64, 4), factor=8,
                                version=2)
    with pytest.raises(RuntimeError, match="arguments refused"):  # v1: CHWB only
        kernels.degrade_stencil(xs.permute(3, 0, 1, 2).contiguous(), comp, None,
                                torch.empty(4, 5, 8, 8, device=cuda), layout="nchw",
                                dims=(5, 64, 64, 4), factor=8, version=1)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, kernel, noise = _inputs(cuda, 8, b=4)
    comp = torch.zeros(5, 20, 20, device=cuda)
    out = torch.empty(5, 8, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.degrade_stencil(x.transpose(1, 2), comp, None, out, layout="chwb",
                                dims=(5, 64, 64, 4), factor=8)
    with pytest.raises(TypeError, match="dtype"):
        kernels.degrade_stencil(x.half(), comp, None, out, layout="chwb",
                                dims=(5, 64, 64, 4), factor=8)
    with pytest.raises(ValueError, match="out shape"):
        kernels.degrade_stencil(x, comp, None, torch.empty(5, 4, 8, 4, device=cuda),
                                layout="chwb",
                                dims=(5, 64, 64, 4), factor=8)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,factor,b", [
    (40, 72, 8, 1),      # h/f = 5 below a row tile, w/f = 9 not a column tile
    (24, 296, 8, 33),    # w/f = 37: ragged 32-column NCHW tile; two batch slices
    (48, 80, 4, 3),      # f=4 (K = 16), the run-time shape
    (256, 256, 8, 3),    # the factory's patch, a 3-wide batch (4-byte staging)
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v3_kernel_odd_shapes(cuda, h, w, factor, b, dtype):
    """The ring-staged v3 family on every map (NCHW, CHWB, presplit,
    baked-halo presplit) where tiles, 32-wide batch slices and 16-byte
    runs are ragged, +- noise: bit for bit against the plain versions in
    float32, within the tolerance in bfloat16; each launch counted."""
    x, kernel, noise = _inputs(cuda, factor, b=b, h=h, w=w)
    xd = x.to(dtype)
    tol = dict(rtol=0, atol=0) if dtype == torch.float32 else TOL
    m = col_halo(13 + factor - 1, factor)
    kernels.reset_launches()
    for n in (None, noise):
        nn = None if n is None else n.permute(3, 0, 1, 2).contiguous()
        img = xd.permute(3, 0, 1, 2).contiguous()
        xp = phase_split_chwb(xd, factor).contiguous()
        xh = phase_split_chwb(xd, factor, halo=True, halo_rows=m).contiguous()
        for got, want in (
            (degrade_fused(img, kernel, nn, factor=factor),
             degrade_fused_ref(img, kernel, nn, factor=factor)),
            (degrade_fused_chwb(xd, kernel, n, factor=factor),
             degrade_fused_chwb_ref(xd, kernel, n, factor=factor)),
            (degrade_fused_presplit(xp, kernel, n, factor=factor),
             degrade_fused_presplit_ref(xp, kernel, n, factor=factor)),
            (degrade_fused_presplit(xh, kernel, n, factor=factor, baked_halo=True),
             degrade_fused_presplit_ref(xh, kernel, n, factor=factor,
                                        baked_halo=True)),
        ):
            torch.testing.assert_close(got, want, **tol)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] for k in ("degrade_v3", "degrade_v3psn",
                                             "degrade_v3ps")} == \
        {"degrade_v3": 4, "degrade_v3psn": 2, "degrade_v3ps": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,b", [(64, 72, 3), (48, 48, 33)])
def test_v3_kernel_spans_beyond_the_slots(cuda, h, w, b):
    """The v3 kernel's C ABI at a span wider than the walk's run-time slots
    (f=2, K=20: ceil(K/f) = 10), which it took before the ring and still
    takes, on every map, +- noise: bit for bit against the plain version."""
    factor, ksize = 2, 19
    x, kernel, noise = _inputs(cuda, factor, b=b, h=h, w=w, ksize=ksize)
    comp = compose_with_box(normalize_kernel(kernel), factor).contiguous()
    assert -(-comp.shape[-1] // factor) > kernels.RING_SLOTS
    m = col_halo(comp.shape[-1], factor)
    dims = (5, h, w, b)
    kernels.reset_launches()
    for n in (None, noise):
        nn = None if n is None else n.permute(3, 0, 1, 2).contiguous()
        for layout, xl, nl, halo in (
            ("nchw", x.permute(3, 0, 1, 2).contiguous(), nn, 0),
            ("chwb", x, n, 0),
            ("presplit", phase_split_chwb(x, factor).contiguous(), n, 0),
            ("presplit_halo", phase_split_chwb(x, factor, halo=True,
                                               halo_rows=m).contiguous(), n, m),
        ):
            got = _stencil(xl, comp, nl, factor, layout, dims, halo=halo)
            want = _stencil_ref(xl, comp, nl, factor, layout, halo=halo)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] for k in ("degrade_v3", "degrade_v3psn",
                                             "degrade_v3ps")} == \
        {"degrade_v3": 4, "degrade_v3psn": 2, "degrade_v3ps": 2}


def test_build_tag_covers_shared_headers(tmp_path, monkeypatch):
    """An edited header the kernels include (stencil_ring.cuh) changes the
    library's name, so a stale build is never loaded; runs without a
    card (no nvcc call)."""
    for name in ("scene_stencil.cu", "stencil_ring.cuh"):
        (tmp_path / name).write_bytes((kernels._DIR / name).read_bytes())
    monkeypatch.setattr(kernels, "_DIR", tmp_path)
    before = kernels._source_tag("scene_stencil")
    assert kernels._source_tag("scene_stencil") == before
    with open(tmp_path / "stencil_ring.cuh", "a") as fh:
        fh.write("// edited\n")
    assert kernels._source_tag("scene_stencil") != before


def _scene(dev, c, h, w, factor, ksize=13, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(c, h, w, generator=g) * 2 + 5).to(dev)
    k = torch.rand(c, ksize, ksize, generator=g).to(dev)
    return x, compose_with_box(normalize_kernel(k), factor).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w,factor,ksize", [
    (5, 256, 192, 8, 13), (3, 128, 128, 4, 13), (2, 36, 36, 3, 5),
    (2, 8, 96, 8, 13),  # a slab thinner than the blur's reach
    (2, 64, 96, 2, 33),  # f=2, a 33x33 blur (K = 34): 17 open outputs a column
    (2, 40, 72, 1, 17),  # f=1 (K = 17)
])
def test_scene_kernels_match_plain(cuda, c, h, w, factor, ksize):
    """Both scene stencil instantiations (raw rows + halos, extended slab)
    against their plain versions: edge halos, two slabs fed each other's
    rows, and a W-cropped view read in place; every launch counted."""
    x, comp = _scene(cuda, c, h, w + 5, factor, ksize)
    x = x[:, :, :w]  # cropped view: row stride w + 5
    th, bh = halo_rows(factor, comp.shape[-1])
    top = x[:, :1].expand(-1, max(th, 1), -1)
    bot = x[:, -1:].expand(-1, max(bh, 1), -1)
    kernels.reset_launches()
    want = degrade_rows_fast_ref(x, comp, factor, top, bot)
    torch.testing.assert_close(
        degrade_rows_fast(x, comp, factor, top, bot, impl="cuda"), want,
        rtol=0, atol=0)
    x_ext = extend_rows_edge(x, factor, comp.shape[-1])
    torch.testing.assert_close(
        degrade_slab_fast(x_ext, comp, factor),
        degrade_slab_fast_ref(x_ext, comp, factor), rtol=0, atol=0)
    torch.testing.assert_close(degrade_slab_fast(x_ext, comp, factor), want,
                               **TOL)
    launches = 1
    if h >= 2 * factor and (h // 2) % factor == 0:
        lo, hi = x[:, : h // 2], x[:, h // 2:]
        got = torch.cat([
            degrade_rows_fast(lo, comp, factor, top, hi[:, :max(bh, 1)]),
            degrade_rows_fast(hi, comp, factor, lo[:, -max(th, 1):], bot),
        ], dim=1)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        launches += 2
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["colsplit_raw"] == launches
    assert kernels.LAUNCHES["colsplit"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_thin_slab_scene_launches_kernel(cuda, n):
    """Slabs thinner than 2*K rows (where JAX switches to its 'bands'
    conv) still go through the `colsplit_raw` kernel, one launch a slab,
    and agree with the single-slab kernel result."""
    x, _ = _scene(cuda, 2, 16, 32, 4, ksize=5)
    k = torch.rand(2, 5, 5, generator=torch.Generator().manual_seed(1)).to(cuda)
    want = degrade_scene_sharded(x, k, n_shards=1, factor=4)
    kernels.reset_launches()
    got = degrade_scene_sharded(x, k, n_shards=n, factor=4)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["colsplit_raw"] == n
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_scene_kernel_rejects_what_it_does_not_take(cuda):
    x, comp = _scene(cuda, 2, 64, 64, 8)
    top, bot = x[:, :6], x[:, -6:]
    out = torch.empty(2, 8, 8, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        kernels.scene_stencil_raw(x.double(), top, bot, comp, out, factor=8)
    with pytest.raises(ValueError, match="column stride"):
        kernels.scene_stencil_raw(x.transpose(1, 2), top, bot, comp, out,
                                  factor=8)
    with pytest.raises(RuntimeError, match="arguments refused"):
        kernels.scene_stencil_raw(x, top[:, :2], bot, comp, out, factor=8)
    with pytest.raises(ValueError, match="impl='plain' needs a CPU"):
        degrade_rows_fast(x, comp, 8, top, bot, impl="plain")


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [8, 4])
def test_scene_raw_strided_views(cuda, factor):
    """The ring-staged scene kernel on a W-cropped view whose row stride
    (203) is odd, so its rows are not 16-byte aligned, with stride-0
    `expand`ed edge halos, whole and as four 16-row slabs fed each
    other's rows: bit for bit against the plain versions."""
    x, comp = _scene(cuda, 5, 64, 203, factor)
    x = x[:, :, :200]
    assert x.stride(1) == 203
    th, bh = halo_rows(factor, comp.shape[-1])
    top = x[:, :1].expand(-1, th, -1)
    bot = x[:, -1:].expand(-1, bh, -1)
    assert top.stride(1) == 0 and bot.stride(1) == 0
    kernels.reset_launches()
    want = degrade_rows_fast_ref(x, comp, factor, top, bot)
    assert torch.equal(degrade_rows_fast(x, comp, factor, top, bot), want)
    slabs = [x[:, k * 16:(k + 1) * 16] for k in range(4)]
    got = torch.cat([
        degrade_rows_fast(s, comp, factor,
                          slabs[k - 1][:, -th:] if k else top,
                          slabs[k + 1][:, :bh] if k < 3 else bot)
        for k, s in enumerate(slabs)], dim=1)
    assert torch.equal(got, want)
    x_ext = extend_rows_edge(x, factor, comp.shape[-1])
    assert torch.equal(degrade_slab_fast(x_ext, comp, factor),
                       degrade_slab_fast_ref(x_ext, comp, factor))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["colsplit_raw"] == 5 and kernels.LAUNCHES["colsplit"] == 1
