"""HAT (`kmsr_tpu_torch.models.hat`) on the CPU against the plain reference
(`tests/helpers/hat_reference.py`: float32, TF32 off, written from the
published `hat_arch.py`), its route through the SR stage
(`pipeline.sr_infer`: `run_batches`, the CLI's `--arch hat`, `.npz` model
files, a published-style state dict), its derived indices, the spans, and
SwinIR's forward held to its own composition now that HAT shares its parts.
One `cuda` test runs HAT at its published widths on the card.

A small configuration that keeps every ratio of HAT-SRx4: embed 60, 6 heads
of dim 10 (padded to 16 for the fused attention), window 4 with shift 2 and
overlap 0.5 (a 6 x 6 key window, padding 1), compress 3 (20 channels),
squeeze 30 (2 channels), depths (2, 2), x4, on 16 x 16 maps (4 x 4 windows,
so the OCAB has corner, edge and inner windows) and 14 x 10 ones
(reflect-padded to 16 x 12). The test's draw: fan-in uniform convs and
linears, qkv x2, tables in +-6, LayerNorms 1 +- 0.25 and +- 0.25,
conv_first's kernels less their 3x3 mean, the conv branch's 3x3 convs x12,
the gate's last 1x1 conv x8, the OCAB's proj x12, so that each of HAT's
parts shows in the output; inputs standard normal. The card test draws as
the benchmark cell does (`benchmark/drivers/hat_tiles.py`: qkv x3, the
HAB's proj x3, the OCAB's x20 and its table +-16, the conv branch x16),
sharper attention tuned for 256-token windows, which at this window's 16
tokens would round bf16 past the bound.

Tolerances: float32 at the repository's rtol 1e-4 / atol 1e-5; bfloat16 at
`BF16_REL`, a relative 2-norm error of 2e-2 a tile, SwinIR's bound: 8
significant bits (2^-9 = 2.0e-3 relative rounding) and ~45 roundings in
series a tile at this depth (two LN1 reads, the four linears, the
attention, the conv branch and the adds of each block), in quadrature
sqrt(45) * 2.0e-3 = 1.3e-2. The readings here: 1.04-1.09e-2; each
knock-out moves the reference by 0.12 or more (0.12-0.45).

The stream is carried `models.swinir.stream_width` wide, its pad zero: embed
60 at 64 and the conv branch's 20 channels at 24 here (180 at 184 and 60 at 64
at the published widths), so the small configuration runs the padded path.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from helpers import hat_reference as ref
from kmsr_tpu_torch import kernels
from kmsr_tpu_torch.io.ncio import NCFile, read_band_stack, write_band_stack
from kmsr_tpu_torch.models import hat
from kmsr_tpu_torch.models import swinir as sw
from kmsr_tpu_torch.models.sr import _conv, _pixel_shuffle_cl, precision, sr_forward
from kmsr_tpu_torch.pipeline import sr_infer
from kmsr_tpu_torch.utils import profiling
from kmsr_tpu_torch.utils.params_io import load_params, save_params

RTOL, ATOL = 1e-4, 1e-5
BF16_REL = 2e-2
SMALL = dict(embed_dim=60, depths=(2, 2), num_heads=(6, 6), window_size=4)
MAPS = [(16, 16), (14, 10)]
#: the draw's factors over fan-in uniform (module docstring), and the OCAB's
#: table bound: the small configuration's, and the benchmark cell's
#: (`benchmark/drivers/hat_tiles.py`), for 256-token windows
SMALL_DRAW = ({".qkv": 2.0, "overlap_attn.proj": 12.0, "conv_block.cab.0": 12.0,
               "conv_block.cab.2": 12.0, "attention.3": 8.0}, 6.0)
CELL_DRAW = ({".qkv": 3.0, "overlap_attn.proj": 20.0, "attn.proj": 3.0,
              "conv_block.cab.0": 16.0, "conv_block.cab.2": 16.0, "attention.3": 8.0}, 16.0)


def _cfg(**kw) -> hat.HATConfig:
    return hat.HATConfig(**{**SMALL, **kw})


def _kw(cfg: hat.HATConfig) -> dict:
    return dict(factor=cfg.factor, window_size=cfg.window_size, depths=cfg.depths,
                num_heads=cfg.num_heads, overlap_ratio=cfg.overlap_ratio,
                conv_scale=cfg.conv_scale, img_range=cfg.img_range)


def _draw(cfg: hat.HATConfig, seed: int, draw: tuple = SMALL_DRAW) -> dict:
    """The test's draw (module docstring) under the published names."""
    scales, ocab_table = draw
    gen = torch.Generator().manual_seed(seed)
    shapes = hat.param_shapes(cfg)
    out = {}
    for name, shape in shapes.items():
        module, kind = name.rsplit(".", 1)
        layer = module.rsplit(".", 1)[-1]
        u = torch.rand(shape, generator=gen) * 2 - 1
        if layer in ("norm", "norm1", "norm2"):
            out[name] = u / 4 + (1.0 if kind == "weight" else 0.0)
        elif kind == "relative_position_bias_table":
            out[name] = (ocab_table if "overlap_attn" in module else 6) * u
        else:
            scale = next((v for k, v in scales.items() if module.endswith(k)), 1.0)
            out[name] = u / math.sqrt(math.prod(shapes[module + ".weight"][1:])) * scale
    w = out["conv_first.weight"]
    out["conv_first.weight"] = w - w.mean(dim=(2, 3), keepdim=True)
    return out


def _ref(params, x, cfg, **kw):
    return ref.forward(params, x, **_kw(cfg), **kw)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The worst tile's ||a - b|| / ||b||."""
    return float(((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)).max())


@pytest.fixture(scope="module")
def cases():
    """{map: (cfg, params, x, reference output)}."""
    out = {}
    for k, hw in enumerate(MAPS):
        cfg = _cfg()
        params = _draw(cfg, seed=k)
        x = torch.from_numpy(np.random.default_rng(k).standard_normal((2, 5, *hw))
                             .astype(np.float32))
        out[hw] = (cfg, params, x, _ref(params, x, cfg))
    return out


@pytest.mark.parametrize("hw", MAPS)
def test_float32_matches_reference(cases, hw):
    cfg, params, x, want = cases[hw]
    got = hat.hat_forward(params, x, cfg, compute_dtype=torch.float32)
    assert got.shape == (2, 5, hw[0] * 4, hw[1] * 4) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", MAPS)
def test_bfloat16_within_bound(cases, hw):
    cfg, params, x, want = cases[hw]
    got = hat.hat_forward(params, x, cfg)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= BF16_REL
    # the stage's one entry routes by the configuration's type
    assert torch.equal(sr_forward(params, x, cfg), got)


@pytest.mark.parametrize("ws", [4, 8, 16])
def test_hab_index_is_swinirs(ws):
    np.testing.assert_array_equal(sw.relative_position_index(ws),
                                  ref.calculate_rpi_sa(ws).numpy())


@pytest.mark.parametrize("ws,ows", [(4, 6), (8, 12), (16, 24)])
def test_ocab_index_equals_the_published_one(ws, ows):
    """`calculate_rpi_oca` exactly, negative entries kept; wrapped onto the
    table's (ws + ows - 1)^2 rows it is a bijection (at HAT-SRx4's widths
    it runs from -880 to 640 onto 39^2 = 1,521 rows)."""
    got = hat.oca_relative_position_index(ws, ows)
    np.testing.assert_array_equal(got, ref.calculate_rpi_oca(ws, ows).numpy())
    rows = (ws + ows - 1) ** 2
    assert got.max() - got.min() + 1 == rows
    assert len(np.unique(got % rows)) == rows
    if ws == 16:
        assert (got.min(), got.max()) == (-880, 640)


def test_ocab_gather_is_the_unfold():
    """The OCAB's keys, gathered from the window order with a zero row, are
    nn.Unfold's overlapping windows of the map, padded keys zero."""
    h, w, ws, ows = 16, 12, 4, 6
    fwd, _ = sw._window_order(h, w, ws, 0, torch.device("cpu"))
    x = torch.randn(2, h * w, 3) + 5  # no token is zero
    rows = torch.cat([x.index_select(1, fwd), torch.zeros(2, 1, 3)], 1)
    got = rows.index_select(1, hat._oca_gather(h, w, ws, ows, torch.device("cpu")))
    want = torch.nn.functional.unfold(x.transpose(1, 2).reshape(2, 3, h, w), ows, stride=ws,
                                      padding=(ows - ws) // 2)
    want = want.view(2, 3, ows * ows, -1).permute(0, 3, 2, 1).reshape(2, -1, 3)
    assert torch.equal(got, want)


def _no_ocab_table(params):
    return {k: torch.zeros_like(v) if "overlap_attn.relative" in k else v
            for k, v in params.items()}


def _masked_overlap_attention(q, k, v, bias, fp8=False):
    """The OCAB's attention with its padded keys (exact zero vectors) masked
    out of the softmax instead."""
    pad = (k == 0).all(-1)[:, :, None, :]
    attn = (q @ k.transpose(-2, -1) + bias.unsqueeze(0)).masked_fill(pad, float("-inf"))
    return torch.softmax(attn, dim=-1) @ v


@pytest.mark.parametrize("knock", ["cab", "gate", "masked", "ocab_bias", "shift_mask"])
def test_each_knock_out_moves_the_reference_past_the_bf16_bound(cases, monkeypatch, knock):
    """Dropping the conv branch, holding its gate at 1, masking the OCAB's
    padded keys instead of keeping them as zero vectors, dropping the
    OCAB's bias or the shift mask each moves the reference's output by more
    than the bf16 bound, on every case of the test's draw."""
    for cfg, params, x, want in cases.values():
        with monkeypatch.context() as m:
            if knock == "cab":
                m.setattr(ref, "cab", lambda x_, p, n, fp8=False: torch.zeros_like(x_))
            elif knock == "gate":
                m.setattr(ref, "channel_attention", lambda y, p, n, fp8=False: y)
            elif knock == "masked":
                m.setattr(ref, "overlap_attention", _masked_overlap_attention)
            elif knock == "ocab_bias":
                params = _no_ocab_table(params)
            else:
                m.setattr(ref, "shift_mask", lambda h, w, ws, s: torch.zeros(
                    (h // ws) * (w // ws), ws * ws, ws * ws))
            assert _rel(_ref(params, x, cfg), want) > BF16_REL


def test_parameter_count_at_the_published_widths():
    """HAT-SRx4's published total, 20,772,507 at 3 bands (the paper's 20.8 M),
    and 20,776,901 at the port's 5."""
    e, hid, mid, sq, f = 180, 360, 60, 6, 64
    hab = (2 * 2 * e + 31 ** 2 * 6 + (3 * e * e + 3 * e) + (e * e + e) + (9 * e * mid + mid)
           + (9 * mid * e + e) + (e * sq + sq) + (sq * e + e) + 2 * hid * e + hid + e)
    ocab = 39 ** 2 * 6 + 2 * 2 * e + (3 * e * e + 3 * e) + (e * e + e) + 2 * hid * e + hid + e
    for c, total in ((3, 20_772_507), (5, 20_776_901)):
        count = ((9 * c * e + e) + 2 * e + 6 * (6 * hab + ocab + 9 * e * e + e) + 2 * e
                 + (9 * e * e + e) + (9 * e * f + f) + 2 * (9 * f * 4 * f + 4 * f)
                 + (9 * f * c + c))
        assert count == total
        shapes = hat.param_shapes(hat.HATConfig(in_ch=c))
        assert sum(math.prod(s) for s in shapes.values()) == total
    params = hat.init_hat(hat.HATConfig(), seed=0, device="cpu")
    assert list(params) == list(hat.param_shapes())
    assert params["layers.5.residual_group.overlap_attn.relative_position_bias_table"].shape \
        == (1521, 6)
    assert params["layers.0.residual_group.blocks.3.conv_block.cab.3.attention.1.weight"] \
        .shape == (6, 180, 1, 1)


def test_a_published_state_dict_loads_by_name(tmp_path):
    """A `.pth` as the published checkpoints hold it ({"params": state
    dict}, the derived buffers included) loads by name and gives the same
    forward; a missing or misshapen entry is refused."""
    cfg = _cfg()
    params = _draw(cfg, seed=9)
    state = {"relative_position_index_SA": ref.calculate_rpi_sa(4),
             "relative_position_index_OCA": ref.calculate_rpi_oca(4, 6), **params}
    torch.save({"params": state}, tmp_path / "x4.pth")
    got = hat.from_state_dict(torch.load(tmp_path / "x4.pth"), cfg)
    assert list(got) == list(hat.param_shapes(cfg))
    assert all(torch.equal(got[k], params[k]) for k in params)
    x = torch.randn(1, 5, 8, 8)
    torch.testing.assert_close(hat.hat_forward(got, x, cfg, torch.float32),
                               _ref(params, x, cfg), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="missing"):
        hat.from_state_dict({k: v for k, v in params.items() if k != "norm.weight"}, cfg)
    with pytest.raises(ValueError, match="shape"):
        hat.from_state_dict({**params, "conv_last.bias": torch.zeros(3)}, cfg)


def test_run_batches_and_the_cli_arch_hat(cases, tmp_path, capsys):
    """`run_batches` on two tiles equals the direct forward; the CLI's
    `--arch hat --factor 4` loads a saved `.npz` of published names (at the
    published widths) and writes the same predictions."""
    cfg, params, _, _ = cases[16, 16]
    rng = np.random.default_rng(3)
    items = [(rng.standard_normal((5, 16, 16)).astype(np.float32), None) for _ in range(2)]
    seen = []
    assert sr_infer.run_batches([(["a", "b"], items, [])], params, cfg,
                                lambda p, preds, m: seen.append((p, preds.copy(), m)),
                                device="cpu") == []
    x = torch.from_numpy(np.stack([lr for lr, _ in items]))
    assert [p for p, _, _ in seen] == [["a", "b"]] and seen[0][2] is None
    np.testing.assert_array_equal(seen[0][1], hat.hat_forward(params, x, cfg).numpy())

    full = hat.HATConfig()
    params = hat.init_hat(full, seed=4, device="cpu")
    save_params(str(tmp_path / "hat.npz"), params)
    (tmp_path / "pairs").mkdir()
    lrs = {}
    for n in ("p1", "p2"):
        lrs[n] = rng.normal(3, 1, (5, 16, 16)).astype(np.float32)
        write_band_stack(tmp_path / "pairs" / f"{n}.nc", "lr", lrs[n], mode="w")
        write_band_stack(tmp_path / "pairs" / f"{n}.nc", "hr",
                         rng.normal(3, 1, (5, 64, 64)).astype(np.float32), mode="a")
    assert sr_infer.main(["--input-dir", str(tmp_path / "pairs"), "--model",
                          str(tmp_path / "hat.npz"), "--output-dir", str(tmp_path / "out"),
                          "--arch", "hat", "--factor", "4", "--batch-size", "2",
                          "--device", "cpu"]) == 0
    assert "PSNR" in capsys.readouterr().out
    loaded = load_params(str(tmp_path / "hat.npz"), hat.init_hat(full, device="cpu"))
    assert all(torch.equal(loaded[k], params[k]) for k in params)
    want = hat.hat_forward(params, torch.from_numpy(np.stack([lrs["p1"], lrs["p2"]]))).numpy()
    for i, n in enumerate(("p1", "p2")):
        np.testing.assert_array_equal(read_band_stack(tmp_path / "out" / f"{n}_sr.nc", "sr"),
                                      want[i])
        with NCFile(tmp_path / "out" / f"{n}_sr.nc") as f:
            assert int(f.get_attrs("sr")["factor"]) == 4


def test_one_forward_records_its_spans(cases):
    cfg, params, x, _ = cases[16, 16]
    profiling.timing_report(reset=True)
    hat.hat_forward(params, x, cfg, item=7)
    rows = profiling.spans()
    profiling.timing_report(reset=True)
    by = {n: [s for s in rows if s.name == n]
          for n in ("hat.forward", "hat.rhag", "hat.ocab", "hat.upsample")}
    fw = by["hat.forward"]
    assert len(fw) == 1 and len(by["hat.rhag"]) == 2 and len(by["hat.ocab"]) == 2
    # 16 windows a map, 2 maps: 4 HABs' and 2 OCABs'; no row-norm kernel on the CPU;
    # the stream carried 64 wide for embed 60
    assert fw[0].item == 7 and fw[0].counts == {"tiles": 2, "windows": 2 * 16 * 4,
                                                "ocab_windows": 2 * 16 * 2, "norm_kernels": 0,
                                                "stream_width": 64}
    assert [s.item for s in by["hat.rhag"]] == [s.item for s in by["hat.ocab"]] == [0, 1]
    assert all(s.parent == fw[0].id for s in by["hat.rhag"] + by["hat.upsample"])
    assert [s.parent for s in by["hat.ocab"]] == [s.id for s in by["hat.rhag"]]


def test_pads_stay_zero_through_every_block(cases, monkeypatch):
    """The small configuration's stream (60 carried at 64) holds zeros past
    channel 60 after every row norm, HAB, OCAB and conv, and so does the
    conv branch's output before and after its gate."""
    cfg, params, x, _ = cases[16, 16]
    seen = []

    def check(name, t, c):
        seen.append(name)
        assert t.shape[-1] == 64 and not t[..., c:].any(), f"{name}: pad not zero"

    def wrap(name, fn):
        def checked(*args, **kw):
            out = fn(*args, **kw)
            for t in out if isinstance(out, tuple) else (out,):
                check(name, t, 60)
            return out
        return checked
    for name in ("norm_rows", "add_norm_rows", "_hab", "_ocab", "_stream"):
        monkeypatch.setattr(hat, name, wrap(name, getattr(hat, name)))
    monkeypatch.setattr(sw, "_stream", wrap("_stream", sw._stream))
    monkeypatch.setattr(sw, "norm_rows", wrap("trunk norm", sw.norm_rows))
    real_cab = hat._cab

    def cab(xn, s, hw):
        y, gate = real_cab(xn, s, hw)
        check("cab", y, 60)
        check("gated cab", y * gate, 60)
        mid = s["cab0"]["w"]
        assert mid.shape[-1] == 24 and not mid[..., 20:].any()  # the branch's pad
        return y, gate
    monkeypatch.setattr(hat, "_cab", cab)
    hat.hat_forward(params, x, cfg)
    # 4 HABs: 2 LN1 reads, f_new and LN2, the branch, gated, its stream, the HAB;
    # 2 OCABs: LN1, f_new and LN2, the OCAB; the trunk's streams and norms
    assert seen.count("_hab") == 4 and seen.count("_ocab") == 2 and seen.count("cab") == 4
    assert seen.count("norm_rows") == 4 * 2 + 2 and seen.count("trunk norm") == 2
    assert seen.count("add_norm_rows") == 2 * (4 + 2)
    assert seen.count("_stream") == 4 + 1 + 2  # the branch's, conv_first's, the groups' convs


def test_prepared_weights_are_padded_to_the_stream_width():
    """At the published widths the HAB's and OCAB's linears, the conv
    branch (184 -> 64 -> 184) and the gate's 1x1 convs ([6, 184], [184, 6])
    are padded with zeros; the norms keep 180."""
    cfg = hat.HATConfig()
    params = hat.init_hat(cfg, seed=3, device="cpu")
    wts = hat._prepare(params, cfg, torch.bfloat16, (16, 16))
    s = wts["layers.1.residual_group.blocks.2."]
    o = wts["layers.1.residual_group.overlap_attn."]
    for blk in (s, o):
        assert tuple(blk["qkv"][0].shape) == (576, 184) and blk["scale"] == 30 ** -0.5
        assert tuple(blk["proj"][0].shape) == (184, 192) and tuple(blk["proj"][1].shape) == (184,)
        assert tuple(blk["fc1"][0].shape) == (360, 184)
        assert tuple(blk["fc2"][0].shape) == (184, 360) and tuple(blk["fc2"][1].shape) == (184,)
        assert blk["norm1"][0].shape == (180,)
        for t in (blk["qkv"][0][:, 180:], blk["proj"][0][180:], blk["proj"][1][180:],
                  blk["fc1"][0][:, 180:], blk["fc2"][0][180:], blk["fc2"][1][180:]):
            assert not t.any()
    c0, c2 = s["cab0"], s["cab2"]
    assert tuple(c0["w"].shape) == (3, 3, 184, 64) and tuple(c2["w"].shape) == (3, 3, 64, 184)
    assert not c0["w"][:, :, 180:].any() and not c0["w"][..., 60:].any()
    assert not c0["b"][60:].any() and not c2["w"][:, :, 60:].any()
    assert not c2["w"][..., 180:].any() and not c2["b"][180:].any()
    (w1, b1), (w3, b3) = s["ca1"], s["ca3"]
    assert (tuple(w1.shape), tuple(w3.shape), tuple(b3.shape)) == ((6, 184), (184, 6), (184,))
    assert not w1[:, 180:].any() and not w3[180:].any() and not b3[180:].any()
    assert w1.dtype == w3.dtype == torch.float32


def _swinir_as_composed(params, x, cfg, dt=torch.bfloat16):
    """SwinIR's forward composed as it was before HAT shared its parts (the
    trunk, the window attention and the MLP written out in one function),
    from the same primitives: a twin that `swinir_forward` must equal bit
    for bit."""
    ws = cfg.window_size
    h0, w0 = x.shape[2:]
    ph, pw = -h0 % ws, -w0 % ws
    hw = (h0 + ph, w0 + pw)
    with precision(dt):
        wts = sw._prepare(params, cfg, dt, hw)
        x = torch.nn.functional.pad(x, (0, pw, 0, ph), mode="reflect") if ph or pw else x
        with precision(torch.float32):
            x = _conv(x.float().contiguous(memory_format=torch.channels_last),
                      wts["conv_first"], torch.float32).to(dt)
        f = sw.norm_rows(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1]).contiguous(),
                         *wts["patch_embed.norm"])
        bsz, _, e = f.shape
        for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            g = f
            for j in range(depth):
                s = wts[f"layers.{i}.residual_group.blocks.{j}."]
                fwd, inv = sw._window_order(*hw, ws, ws // 2 if j % 2 else 0, g.device)
                y = sw.norm_rows(g, *s["norm1"], fwd)
                wq, bq = s["qkv"]
                d = wq.shape[0] // (3 * heads)
                q, k, v = torch.nn.functional.linear(y, wq, bq).view(
                    -1, ws * ws, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
                bias = s["bias"]
                bias = (bias.expand(q.shape[0], -1, -1, -1) if bias.shape[0] == 1 else
                        bias.expand(bsz, *bias.shape).reshape(q.shape[0], *bias.shape[1:]))
                with torch.nn.attention.sdpa_kernel(sw._SDPA_BACKENDS):
                    a = torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, attn_mask=bias, scale=(cfg.embed_dim // heads) ** -0.5)
                a = torch.nn.functional.linear(
                    a.transpose(1, 2).reshape(bsz, hw[0] * hw[1], heads * d), *s["proj"])
                g, y = sw.add_norm_rows(g, a, inv, *s["norm2"])
                g = g + torch.nn.functional.linear(torch.nn.functional.gelu(
                    torch.nn.functional.linear(y, *s["fc1"])), *s["fc2"])
            m = _conv(g.view(bsz, *hw, e).permute(0, 3, 1, 2), wts[f"layers.{i}.conv"], dt)
            f = m.permute(0, 2, 3, 1).reshape(bsz, -1, e).contiguous() + f
        y = sw.norm_rows(f, *wts["norm"]).view(bsz, *hw, e).permute(0, 3, 1, 2)
        x = _conv(y, wts["conv_after_body"], dt) + x
        x = torch.nn.functional.leaky_relu(_conv(x, wts["conv_before_upsample.0"], dt), 0.01)
        for k in range(sw.upsample_stages(cfg.factor)):
            x = _pixel_shuffle_cl(_conv(x, wts[f"upsample.{2 * k}"], dt), 2)
        y = _conv(x, wts["conv_last"], dt)[:, :, :h0 * cfg.factor, :w0 * cfg.factor]
        return y.to(torch.float32, memory_format=torch.contiguous_format)


def _twin_case(embed: int, dt, hw) -> None:
    cfg = sw.SwinIRConfig(embed_dim=embed, depths=(2, 2), num_heads=(2, 2), window_size=4,
                          factor=2)
    gen = torch.Generator().manual_seed(5)
    params = {k: (torch.rand(s, generator=gen) * 2 - 1) * (
        6.0 if k.endswith("table") else 1.0 if len(s) == 1 else 2.0 / np.sqrt(np.prod(s[1:])))
        for k, s in sw.param_shapes(cfg).items()}
    x = torch.randn(2, 5, *hw, generator=gen)
    assert torch.equal(sw.swinir_forward(params, x, cfg, dt), _swinir_as_composed(params, x, cfg,
                                                                                   dt))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw", [(8, 8), (10, 6)])
def test_swinir_forward_is_bit_equal_to_its_own_composition(dt, hw):
    _twin_case(24, dt, hw)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw", [(8, 8), (10, 6)])
def test_padded_swinir_forward_is_bit_equal_to_its_own_composition(dt, hw):
    """Embed 20, carried at 24: the twin runs the same padded weights."""
    _twin_case(20, dt, hw)


# ------------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


#: the benchmark cell's limit on hat_rel_err (`benchmark/workloads/hat-tiles64.json`)
CELL_LIMIT = 0.015


@pytest.mark.cuda
def test_card_forward_at_the_published_widths(cuda):
    """HAT-SRx4 on 2 tiles of 5 x 64^2 in bfloat16 on the card, the cell's
    draw scaled as the module docstring says, against the plain float32
    reference within the cell's limit, its norms on the row-norm kernel:
    3 a HAB, 2 an OCAB and 2 more, 122 launches."""
    cfg = hat.HATConfig()
    params = {k: v.to(cuda) for k, v in _draw(cfg, 11, CELL_DRAW).items()}
    x = torch.from_numpy(np.random.default_rng(11).normal(30, 10, (2, 5, 64, 64))
                         .astype(np.float32)).to(cuda)
    want = _ref(params, x, cfg)
    before = kernels.LAUNCHES["swin_norm_rows"] + kernels.LAUNCHES["swin_add_norm_rows"]
    profiling.timing_report(reset=True)
    got = hat.hat_forward(params, x, cfg)
    torch.cuda.synchronize()
    fw = [s for s in profiling.spans() if s.name == "hat.forward"]
    launched = kernels.LAUNCHES["swin_norm_rows"] + kernels.LAUNCHES["swin_add_norm_rows"] - before
    assert launched == fw[-1].counts["norm_kernels"] == 6 * (6 * 3 + 2) + 2
    assert fw[-1].counts["stream_width"] == 184
    assert _rel(got, want) <= CELL_LIMIT
