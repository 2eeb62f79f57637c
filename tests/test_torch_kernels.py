"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip on hosts
without a card. On the card: python -m pytest tests/test_torch_kernels.py -m cuda
"""
import pytest
import torch

from kmsr_tpu_torch import kernels
from kmsr_tpu_torch.ops.degrade import compose_with_box, normalize_kernel
from kmsr_tpu_torch.ops.degrade_fused import (
    degrade_fused, degrade_fused_chwb, degrade_fused_chwb_ref,
    degrade_fused_presplit, degrade_fused_presplit_ref, degrade_fused_ref,
    phase_split_chwb,
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


def _inputs(dev, factor, b=32, h=64, c=5, ksize=13, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(c, h, h, b, generator=g) * 2 + 5).to(dev)
    kernel = torch.rand(c, ksize, ksize, generator=g).to(dev)
    noise = (torch.randn(c, h // factor, h // factor, b, generator=g) * 0.1).to(dev)
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
                                "colsplit_raw": 0, "colsplit": 0}


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


def _scene(dev, c, h, w, factor, ksize=13, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(c, h, w, generator=g) * 2 + 5).to(dev)
    k = torch.rand(c, ksize, ksize, generator=g).to(dev)
    return x, compose_with_box(normalize_kernel(k), factor).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w,factor,ksize", [
    (5, 256, 192, 8, 13), (3, 128, 128, 4, 13), (2, 36, 36, 3, 5),
    (2, 8, 96, 8, 13),  # a slab thinner than the blur's reach
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
