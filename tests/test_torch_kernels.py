"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip on hosts
without a card. On the card: python -m pytest tests/test_torch_kernels.py -m cuda
"""
import pytest
import torch

from kmsr_tpu_torch import kernels
from kmsr_tpu_torch.ops.degrade_fused import (
    degrade_fused, degrade_fused_chwb, degrade_fused_chwb_ref,
    degrade_fused_presplit, degrade_fused_presplit_ref, degrade_fused_ref,
    phase_split_chwb,
)

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
    assert kernels.LAUNCHES == {"degrade_v3": 4, "degrade_v3psn": 2}


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
