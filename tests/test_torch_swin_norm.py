"""SwinIR's row norm (`models.swinir.norm_rows`, `add_norm_rows`): LN1 with
the window gather, and the attention's residual add (gathered back) with
LN2, in one pass over the stream.

On the CPU the plain version must equal the parent's spelling exactly:
F.layer_norm then index_select; the add through index_select then
F.layer_norm. The kernel's plan (`kernels.norm_plan`) is checked there too.

The model carries its stream wider than the norm (`models.swinir.
stream_width`: rows of Cp = 184 for SwinIR-M's C = 180), so rows of width Cp
with a weight of width C are checked too, on both paths: the statistics
those of F.layer_norm over the first C columns, the pad columns of y and
f_new exactly 0 whatever the input's pad holds (the test fills it with
noise, so a norm that read it would show).

On the card (marked `cuda`, skipped without one; python -m pytest
tests/test_torch_swin_norm.py -m cuda) the kernel is held against the plain
version run on the card: f_new bit for bit (the same add, rounded the same);
y within one bf16 unit in the last place, or rtol 1e-6 / atol 1e-6 in
float32 and 1e-12 in float64. The statistics are two sums in registers, not
F.layer_norm's Welford, so their float32 values differ in the last bits,
and the outputs are O(1): where w * t and b cancel to a y far below 1, a
bf16 ulp of y is finer than float32 resolves the sum, so bf16 takes
float32's absolute floor too, 1e-6 (SwinIR-M's stream: 40 of 23.6 M outputs
past one ulp, all below 4e-6 in size and 4.5e-8 off).
"""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from kmsr_tpu_torch import kernels
from kmsr_tpu_torch.models import swinir as sw
from kmsr_tpu_torch.utils import profiling

DTYPES = [torch.bfloat16, torch.float32, torch.float64]
#: (C, maps, (H, W), window): the test configuration's width on a 12x8 map
#: (288 rows: no multiple of a block's 256), SwinIR-M's on a 16x16 one
CPU_SHAPES = [(24, 3, (12, 8), 4), (180, 2, (16, 16), 8)]


def _stream(c, maps, hw, dtype, dev, seed=0):
    """f, a (the attention branch) and the LayerNorm's w, b: the stream
    N(0.5, 2), a N(0, 1), w 1 +- 0.25, b +- 0.25."""
    g = torch.Generator().manual_seed(seed)
    p = hw[0] * hw[1]
    f = torch.randn(maps, p, c, generator=g) * 2 + 0.5
    a = torch.randn(maps, p, c, generator=g)
    w = 1 + (torch.rand(c, generator=g) * 2 - 1) / 4
    b = (torch.rand(c, generator=g) * 2 - 1) / 4
    return tuple(t.to(dev, dtype) for t in (f, a, w, b))


def _plain_norm(f, w, b, idx):
    y = F.layer_norm(f, f.shape[-1:], w, b, sw.LN_EPS)
    return y if idx is None else y.index_select(1, idx)


def _plain_add_norm(f, a, idx, w, b):
    f = f + a.index_select(1, idx)
    return f, F.layer_norm(f, f.shape[-1:], w, b, sw.LN_EPS)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", range(len(CPU_SHAPES)))
@pytest.mark.parametrize("shifted", [False, True])
def test_cpu_norm_rows_is_the_plain_spelling(dtype, shape, shifted):
    c, maps, hw, ws = CPU_SHAPES[shape]
    f, a, w, b = _stream(c, maps, hw, dtype, "cpu", seed=shape)
    fwd, inv = sw._window_order(*hw, ws, ws // 2 if shifted else 0, torch.device("cpu"))
    f0 = f.clone()
    assert torch.equal(sw.norm_rows(f, w, b, fwd), _plain_norm(f, w, b, fwd))
    assert torch.equal(sw.norm_rows(f, w, b), _plain_norm(f, w, b, None))
    f_new, y = sw.add_norm_rows(f, a, inv, w, b)
    want_f, want_y = _plain_add_norm(f, a, inv, w, b)
    assert torch.equal(f_new, want_f) and torch.equal(y, want_y)
    assert torch.equal(f, f0)  # f stays: the first STL's input is the RSTB's residual
    # the weights are taken in the stream's dtype, whatever theirs
    assert torch.equal(sw.norm_rows(f, w.double(), b.float(), fwd), _plain_norm(f, w, b, fwd))


#: (C, Cp, maps, (H, W), window): rows of Cp with a norm over their first C:
#: SwinIR-M's stream (180 in 184), the test configuration padded (24 in 32),
#: an odd width (181 in 184)
PADDED = [(180, 184, 2, (16, 16), 8), (24, 32, 3, (12, 8), 4), (181, 184, 2, (16, 16), 8)]


def _padded_stream(c, cp, maps, hw, dtype, dev, seed=0):
    """`_stream` at width Cp, its pad columns noise (N(0, 4)); w, b of C."""
    f, a, w, b = _stream(cp, maps, hw, dtype, dev, seed)
    g = torch.Generator().manual_seed(seed + 100)
    noise = (torch.randn(2, maps, hw[0] * hw[1], cp - c, generator=g) * 4).to(dev, dtype)
    f, a = (torch.cat([t[..., :c], n], -1) for t, n in zip((f, a), noise))
    return f, a, w[:c].contiguous(), b[:c].contiguous()


def _plain_padded_norm(f, w, b, idx):
    """LN over the first C columns (a copy of them), zeros past them."""
    c = w.shape[0]
    y = F.layer_norm(f[..., :c].contiguous(), (c,), w, b, sw.LN_EPS)
    y = torch.cat([y, y.new_zeros(*y.shape[:-1], f.shape[-1] - c)], -1)
    return y if idx is None else y.index_select(1, idx)


def _plain_padded_add_norm(f, a, idx, w, b):
    c = w.shape[0]
    g = f[..., :c] + a[..., :c].index_select(1, idx)
    g = torch.cat([g, g.new_zeros(*g.shape[:-1], f.shape[-1] - c)], -1)
    return g, _plain_padded_norm(g, w, b, None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", range(len(PADDED)))
@pytest.mark.parametrize("shifted", [False, True])
def test_cpu_padded_rows_norm_their_first_c_columns(dtype, shape, shifted):
    c, cp, maps, hw, ws = PADDED[shape]
    f, a, w, b = _padded_stream(c, cp, maps, hw, dtype, "cpu", seed=shape)
    assert f.shape[-1] == cp and w.shape == (c,) and f[..., c:].abs().sum() > 0
    fwd, inv = sw._window_order(*hw, ws, ws // 2 if shifted else 0, torch.device("cpu"))
    y = sw.norm_rows(f, w, b, fwd)
    assert torch.equal(y, _plain_padded_norm(f, w, b, fwd))
    assert torch.equal(sw.norm_rows(f, w, b), _plain_padded_norm(f, w, b, None))
    f_new, y2 = sw.add_norm_rows(f, a, inv, w, b)
    want_f, want_y = _plain_padded_add_norm(f, a, inv, w, b)
    assert torch.equal(f_new, want_f) and torch.equal(y2, want_y)
    for t in (y, f_new, y2):
        assert t.shape == f.shape and not t[..., c:].any()


@pytest.mark.parametrize("c,esize,ptrs,want", [
    (184, 2, (0, 256), (16, 4)),     # a 184-wide norm: 368-byte rows, 23 vectors, 4 lanes
    (180, 2, (0, 256), (8, 8)),      # SwinIR-M bf16: 360-byte rows, 45 vectors, 8 lanes of 5-6
    (180, 4, (0,), (16, 8)),         # float32: 45 vectors of 4
    (180, 8, (0,), (16, 16)),        # float64: 90 vectors of 2
    (24, 2, (0,), (16, 1)),          # the test configuration: one lane a row
    (240, 2, (0,), (16, 4)),         # SwinIR-L
    (180, 2, (0, 258), (2, 32)),     # a view 2 bytes off: single elements
    (181, 4, (0,), (4, 32)),         # an odd width
    (1030, 2, (0,), (4, 32)),        # wider than a warp's registers hold: 259 vectors read again
])
def test_plan_takes_the_widest_vector_and_fewest_lanes(c, esize, ptrs, want):
    vb, lpr = kernels.norm_plan(c, esize, ptrs)
    assert (vb, lpr) == want
    assert (c * esize) % vb == 0 and all(p % vb == 0 for p in ptrs)
    nvec = c * esize // vb
    assert lpr == 32 or lpr * kernels.NORM_CHUNKS >= nvec > lpr // 2 * kernels.NORM_CHUNKS


@pytest.mark.parametrize("c,cw,esize,want", [
    (180, 184, 2, (8, 8)),     # SwinIR-M's stream as carried: 45 norm vectors of 8 bytes, 1 pad
    (180, 184, 4, (16, 8)),    # float32: 45 of 16 bytes, 1 pad
    (24, 32, 2, (16, 1)),      # the test configuration padded: 3 norm vectors, 1 pad
    (181, 184, 2, (2, 32)),    # an odd norm: single elements, 3 of them pad
    (60, 64, 2, (8, 2)),       # HAT's narrow configuration: 15 of 8 bytes, 1 pad
])
def test_plan_of_a_padded_row_splits_no_vector(c, cw, esize, want):
    """Rows of cw normed over their first c: the widest vector dividing
    both, so each vector is all norm or all pad; lanes by the norm's."""
    vb, lpr = kernels.norm_plan(cw, esize, (0, 256), c)
    assert (vb, lpr) == want
    assert (c * esize) % vb == 0 and (cw * esize) % vb == 0
    nvec = c * esize // vb
    assert lpr == 32 or lpr * kernels.NORM_CHUNKS >= nvec > lpr // 2 * kernels.NORM_CHUNKS


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in bfloat16 units in the last place: the distance of
    their bit patterns in the order of the values."""
    def order(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (order(got) - order(want)).abs()


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    if got.dtype == torch.bfloat16:
        off = (bf16_ulps(got, want) > 1) & ((got.float() - want.float()).abs() > 1e-6)
        assert not off.any(), f"{int(off.sum())} outputs past one ulp and 1e-6"
    elif got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


#: (C, maps, (H, W), window): SwinIR-M's stream (32 maps of 64x64, 131,072
#: rows), the test configuration's (288 rows: a ragged last block), an odd
#: width (one-element vectors) and one wider than the registers hold (read
#: again from memory)
CARD_SHAPES = [(180, 32, (64, 64), 8), (24, 3, (12, 8), 4), (181, 2, (16, 16), 8),
               (1030, 2, (8, 8), 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", range(len(CARD_SHAPES)))
def test_card_kernel_matches_plain(cuda, dtype, shape):
    c, maps, hw, ws = CARD_SHAPES[shape]
    f, a, w, b = _stream(c, maps, hw, dtype, cuda, seed=shape)
    kernels.reset_launches()
    for shift in (0, ws // 2):
        fwd, inv = sw._window_order(*hw, ws, shift, cuda)
        _close(sw.norm_rows(f, w, b, fwd), _plain_norm(f, w, b, fwd))
        f_new, y = sw.add_norm_rows(f, a, inv, w, b)
        want_f, want_y = _plain_add_norm(f, a, inv, w, b)
        assert torch.equal(f_new, want_f)
        _close(y, want_y)
    _close(sw.norm_rows(f, w, b), _plain_norm(f, w, b, None))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["swin_norm_rows"] == 3
    assert kernels.LAUNCHES["swin_add_norm_rows"] == 2


#: PADDED's widths on the card, SwinIR-M's at its cell's 32 maps of 64x64
CARD_PADDED = [(180, 184, 32, (64, 64), 8)] + PADDED[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", range(len(CARD_PADDED)))
def test_card_padded_rows_match_plain(cuda, dtype, shape):
    """Rows of Cp, a norm of C: y within the bounds above of the plain
    version over the first C columns, f_new bit for bit, both 0 in the pad
    whatever the input's pad holds."""
    c, cp, maps, hw, ws = CARD_PADDED[shape]
    f, a, w, b = _padded_stream(c, cp, maps, hw, dtype, cuda, seed=shape)
    for shift in (0, ws // 2):
        fwd, inv = sw._window_order(*hw, ws, shift, cuda)
        y = sw.norm_rows(f, w, b, fwd)
        _close(y, _plain_padded_norm(f, w, b, fwd))
        f_new, y2 = sw.add_norm_rows(f, a, inv, w, b)
        want_f, want_y = _plain_padded_add_norm(f, a, inv, w, b)
        assert torch.equal(f_new, want_f)
        _close(y2, want_y)
        for t in (y, f_new, y2):
            assert not t[..., c:].any()
    _close(sw.norm_rows(f, w, b), _plain_padded_norm(f, w, b, None))


@pytest.mark.cuda
def test_card_kernel_on_a_misaligned_view(cuda):
    """A view one element into its storage: 2-byte vectors, one element each."""
    c, maps, hw, ws = CARD_SHAPES[0]
    f, a, w, b = _stream(c, maps, hw, torch.bfloat16, cuda)
    f = torch.cat([f.new_zeros(1), f.flatten()])[1:].view(f.shape)
    assert f.data_ptr() % 4 and f.is_contiguous()
    fwd, inv = sw._window_order(*hw, ws, ws // 2, cuda)
    _close(sw.norm_rows(f, w, b, fwd), _plain_norm(f, w, b, fwd))
    f_new, y = sw.add_norm_rows(f, a, inv, w, b)
    want_f, want_y = _plain_add_norm(f, a, inv, w, b)
    assert torch.equal(f_new, want_f)
    _close(y, want_y)


@pytest.mark.cuda
def test_card_swinir_m_forward_launches_74(cuda):
    """One SwinIR-M forward: 2 launches an STL (36) and the two plain norms."""
    cfg = sw.SwinIRConfig()
    params = sw.init_swinir(cfg, seed=0, device=cuda)
    x = torch.randn(2, 5, 64, 64, device=cuda)
    sw.swinir_forward(params, x, cfg)
    profiling.timing_report(reset=True)
    before = dict(kernels.LAUNCHES)
    sw.swinir_forward(params, x, cfg)
    torch.cuda.synchronize()
    grew = {k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]}
    assert grew == {"swin_norm_rows": 38, "swin_add_norm_rows": 36}
    fw = [s for s in profiling.spans() if s.name == "swinir.forward"]
    profiling.timing_report(reset=True)
    assert len(fw) == 1 and fw[0].counts["norm_kernels"] == 2 * sum(cfg.depths) + 2 == 74
    assert fw[0].counts["stream_width"] == 184


@pytest.mark.cuda
def test_card_kernel_refuses_what_it_does_not_take(cuda):
    f, a, w, b = _stream(24, 2, (8, 8), torch.bfloat16, cuda)
    fwd, inv = sw._window_order(8, 8, 4, 2, cuda)
    with pytest.raises(ValueError, match="w is on cpu"):
        kernels.swin_norm_rows(f, w.cpu(), b, fwd, sw.LN_EPS)
    with pytest.raises(ValueError, match="idx is on cpu"):
        sw.norm_rows(f, w, b, fwd.cpu())
    with pytest.raises(TypeError, match="a has dtype"):
        sw.add_norm_rows(f, a.float(), inv, w, b)
    with pytest.raises(TypeError, match="w has dtype"):
        kernels.swin_norm_rows(f, w.float(), b, fwd, sw.LN_EPS)
    with pytest.raises(TypeError, match="takes"):
        sw.norm_rows(f.half(), w, b, fwd)
    with pytest.raises(ValueError, match="contiguous"):
        sw.norm_rows(f.transpose(0, 1), w, b)
    with pytest.raises(ValueError, match="idx shape"):
        sw.add_norm_rows(f, a, inv[:-1], w, b)
    with pytest.raises(ValueError, match="w shape"):  # a norm wider than the row
        kernels.swin_norm_rows(f[..., :16].contiguous(), w, b, fwd, sw.LN_EPS)
    with pytest.raises(ValueError, match="b shape"):
        kernels.swin_norm_rows(f, w, b[:20].contiguous(), fwd, sw.LN_EPS)
