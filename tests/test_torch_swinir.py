"""SwinIR (`kmsr_tpu_torch.models.swinir`) on the CPU against the plain
reference (`tests/helpers/swinir_reference.py`: float32, TF32 off, written
from the published modules), and its route through the SR stage
(`pipeline.sr_infer`): `run_batches`, the CLI's `--arch swinir`, the
`.npz` model files, a published-style state dict, the spans, and the
stages that refuse it.

A small configuration (embed 24, depths (2, 2), heads (2, 2) of dim 12,
padded to 16 for the fused attention, window 4, shift 2) at factors 2 and 8
on 8x8 maps and on 10x6 ones (reflect-padded to 12x8). The test's draw
makes the attention visible: convs and linears fan-in uniform (qkv twice
that), relative-position tables uniform in +-6, LayerNorms 1 +- 0.25 and
+- 0.25; inputs standard normal.

Tolerances: float32 at the repository's rtol 1e-4 / atol 1e-5; bfloat16 at
`BF16_REL`, a relative 2-norm error of 2e-2 a tile: bfloat16 keeps 8
significant bits (2^-9 = 2.0e-3 relative rounding), and the stream passes
~40 roundings in series at this depth (LN, gather, the four linears and
the attention, two adds an STL; the convs and shuffles), which add in
quadrature to sqrt(40) * 2.0e-3 = 1.3e-2. The readings here: 0.67-0.77e-2;
the knock-outs move the reference by 9.2-22.6e-2.

The residual stream is carried `models.swinir.stream_width` channels wide
(the smallest multiple of 8 at or above embed_dim), its pad zero: embed 24
is already a multiple of 8, so a second small configuration, embed 20
(heads of 10) carried at 24, runs the padded path against the reference
at the same tolerances, with the pad checked after every block.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from helpers import swinir_reference as ref
from kmsr_tpu_torch.io.ncio import NCFile, read_band_stack, write_band_stack
from kmsr_tpu_torch.models import swinir as sw
from kmsr_tpu_torch.models.sr import sr_forward
from kmsr_tpu_torch.pipeline import sr_infer, sr_scene
from kmsr_tpu_torch.train import sr as train_sr
from kmsr_tpu_torch.utils import profiling
from kmsr_tpu_torch.utils.params_io import load_params, save_params

RTOL, ATOL = 1e-4, 1e-5
BF16_REL = 2e-2
SMALL = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=4)
MAPS = [(8, 8), (10, 6)]


#: a small configuration whose stream is padded (20 -> 24)
PADDED = dict(SMALL, embed_dim=20)


def _cfg(factor: int, **kw) -> sw.SwinIRConfig:
    return sw.SwinIRConfig(factor=factor, **{**SMALL, **kw})


def _draw(cfg: sw.SwinIRConfig, seed: int) -> dict:
    """The test's draw (module docstring) under the published names."""
    gen = torch.Generator().manual_seed(seed)
    shapes = sw.param_shapes(cfg)
    out = {}
    for name, shape in shapes.items():
        module, kind = name.rsplit(".", 1)
        layer = module.rsplit(".", 1)[-1]
        u = torch.rand(shape, generator=gen) * 2 - 1
        if layer in ("norm", "norm1", "norm2"):
            out[name] = u / 4 + (1.0 if kind == "weight" else 0.0)
        elif kind == "relative_position_bias_table":
            out[name] = 6 * u
        else:
            fan_in = math.prod(shapes[module + ".weight"][1:])
            out[name] = u / math.sqrt(fan_in) * (2.0 if layer == "qkv" else 1.0)
    return out


def _ref(params, x, cfg):
    return ref.forward(params, x, factor=cfg.factor, window_size=cfg.window_size,
                       depths=cfg.depths, num_heads=cfg.num_heads, img_range=cfg.img_range)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The worst tile's ||a - b|| / ||b||."""
    return float(((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)).max())


@pytest.fixture(scope="module")
def cases():
    """{(factor, map): (cfg, params, x, reference output)}."""
    out = {}
    for k, (factor, hw) in enumerate((f, m) for f in (2, 8) for m in MAPS):
        cfg = _cfg(factor)
        params = _draw(cfg, seed=k)
        x = torch.from_numpy(np.random.default_rng(k).standard_normal((2, 5, *hw))
                             .astype(np.float32))
        out[factor, hw] = (cfg, params, x, _ref(params, x, cfg))
    return out


@pytest.mark.parametrize("factor", [2, 8])
@pytest.mark.parametrize("hw", MAPS)
def test_float32_matches_reference(cases, factor, hw):
    cfg, params, x, want = cases[factor, hw]
    got = sw.swinir_forward(params, x, cfg, compute_dtype=torch.float32)
    assert got.shape == (2, 5, hw[0] * factor, hw[1] * factor) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("factor", [2, 8])
@pytest.mark.parametrize("hw", MAPS)
def test_bfloat16_within_bound(cases, factor, hw):
    cfg, params, x, want = cases[factor, hw]
    got = sw.swinir_forward(params, x, cfg)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= BF16_REL


@pytest.mark.parametrize("ws,hw", [(4, (8, 8)), (4, (12, 8)), (8, (64, 64)), (8, (16, 24))])
def test_index_and_shift_mask_equal_the_reference(ws, hw):
    np.testing.assert_array_equal(sw.relative_position_index(ws),
                                  ref.relative_position_index(ws).numpy())
    np.testing.assert_array_equal(sw.shift_mask(*hw, ws, ws // 2),
                                  ref.shift_mask(*hw, ws, ws // 2).numpy())


def _no_table(params):
    return {k: torch.zeros_like(v) if k.endswith("relative_position_bias_table") else v
            for k, v in params.items()}


@pytest.mark.parametrize("knock", ["B_rel", "M", "roll"])
def test_each_knock_out_moves_the_reference_past_the_bf16_bound(cases, monkeypatch, knock):
    """Dropping the relative-position bias, the shift mask or the roll
    each moves the reference's output by more than the bf16 bound, on
    every case of the test's draw: the bf16 comparison would catch each."""
    for cfg, params, x, want in cases.values():
        with monkeypatch.context() as m:
            if knock == "B_rel":
                params = _no_table(params)
            elif knock == "M":
                m.setattr(ref, "shift_mask", lambda h, w, ws, s: torch.zeros(
                    (h // ws) * (w // ws), ws * ws, ws * ws))
            else:
                m.setattr(ref, "roll", lambda x_, s: x_)
            assert _rel(_ref(params, x, cfg), want) > BF16_REL


def test_run_batches_equals_the_direct_forward(cases):
    cfg, params, _, _ = cases[8, (8, 8)]
    rng = np.random.default_rng(3)
    items = [(rng.standard_normal((5, 8, 8)).astype(np.float32), None) for _ in range(5)]
    chunks = [(["a", "b", "c"], items[:3], []), (["d", "e"], items[3:], [])]
    seen = []
    assert sr_infer.run_batches(chunks, params, cfg,
                                lambda p, preds, m: seen.append((p, preds.copy(), m)),
                                device="cpu") == []
    assert [p for p, _, _ in seen] == [["a", "b", "c"], ["d", "e"]]
    for (paths, preds, mets), lo in zip(seen, (0, 3)):
        x = torch.from_numpy(np.stack([lr for lr, _ in items[lo:lo + len(paths)]]))
        assert mets is None
        np.testing.assert_array_equal(preds, sw.swinir_forward(params, x, cfg).numpy())
        # the stage's one entry routes by the configuration's type
        np.testing.assert_array_equal(preds, sr_forward(params, x, cfg).numpy())


def test_cli_arch_swinir_reads_a_saved_npz(tmp_path, capsys):
    """At the published widths (the CLI's SwinIR), 8x8 LR tiles, x8."""
    cfg = sw.SwinIRConfig()
    params = sw.init_swinir(cfg, seed=4, device="cpu")
    save_params(str(tmp_path / "swinir.npz"), params)
    rng = np.random.default_rng(8)
    (tmp_path / "pairs").mkdir()
    lrs = {}
    for n in ("p1", "p2"):
        lrs[n] = rng.normal(3, 1, (5, 8, 8)).astype(np.float32)
        write_band_stack(tmp_path / "pairs" / f"{n}.nc", "lr", lrs[n], mode="w")
        write_band_stack(tmp_path / "pairs" / f"{n}.nc", "hr",
                         rng.normal(3, 1, (5, 64, 64)).astype(np.float32), mode="a")
    assert sr_infer.main(["--input-dir", str(tmp_path / "pairs"), "--model",
                          str(tmp_path / "swinir.npz"), "--output-dir", str(tmp_path / "out"),
                          "--arch", "swinir", "--batch-size", "2", "--device", "cpu"]) == 0
    assert "PSNR" in capsys.readouterr().out
    loaded = load_params(str(tmp_path / "swinir.npz"), sw.init_swinir(cfg, device="cpu"))
    assert all(torch.equal(loaded[k], params[k]) for k in params)
    want = sw.swinir_forward(params, torch.from_numpy(np.stack([lrs["p1"], lrs["p2"]]))).numpy()
    for i, n in enumerate(("p1", "p2")):
        np.testing.assert_array_equal(read_band_stack(tmp_path / "out" / f"{n}_sr.nc", "sr"),
                                      want[i])
        with NCFile(tmp_path / "out" / f"{n}_sr.nc") as f:
            assert int(f.get_attrs("sr")["factor"]) == 8


def test_a_published_state_dict_loads_by_name(tmp_path):
    """A `.pth` as the published checkpoints hold it ({"params": state
    dict}, the derived buffers included) loads by name; a missing or
    misshapen entry is refused."""
    cfg = _cfg(8)
    params = _draw(cfg, seed=9)
    state = dict(params)
    for i, depth in enumerate(cfg.depths):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}."
            state[b + "attn.relative_position_index"] = ref.relative_position_index(4)
            if j % 2:
                state[b + "attn_mask"] = ref.shift_mask(8, 8, 4, 2)
    torch.save({"params": state}, tmp_path / "x8.pth")
    got = sw.from_state_dict(torch.load(tmp_path / "x8.pth"), cfg)
    assert list(got) == list(sw.param_shapes(cfg))
    assert all(torch.equal(got[k], params[k]) for k in params)
    x = torch.randn(1, 5, 8, 8)
    torch.testing.assert_close(sw.swinir_forward(got, x, cfg, torch.float32),
                               _ref(params, x, cfg), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="missing"):
        sw.from_state_dict({k: v for k, v in params.items() if k != "norm.weight"}, cfg)
    with pytest.raises(ValueError, match="shape"):
        sw.from_state_dict({**params, "conv_last.bias": torch.zeros(3)}, cfg)


def test_parameter_count_at_the_published_widths():
    e, c, f, hid = 180, 5, 64, 360
    stl = 2 * 2 * e + 225 * 6 + (3 * e * e + 3 * e) + (e * e + e) + 2 * (hid * e) + hid + e
    count = (9 * c * e + e) + 2 * e + 36 * stl + 6 * (9 * e * e + e) + 2 * e \
        + (9 * e * e + e) + (9 * e * f + f) + 3 * (9 * f * 4 * f + 4 * f) + (9 * f * c + c)
    assert count == 12_052_305
    params = sw.init_swinir(sw.SwinIRConfig(), seed=0, device="cpu")
    assert sum(t.numel() for t in params.values()) == count
    assert params["layers.5.residual_group.blocks.5.attn.qkv.weight"].shape == (540, 180)
    assert params["upsample.4.weight"].shape == (256, 64, 3, 3)


def test_one_forward_records_its_spans():
    cfg = sw.SwinIRConfig()
    params = sw.init_swinir(cfg, seed=1, device="cpu")
    profiling.timing_report(reset=True)
    sw.swinir_forward(params, torch.randn(2, 5, 16, 8), cfg, item=7)
    rows = profiling.spans()
    profiling.timing_report(reset=True)
    fw = [s for s in rows if s.name == "swinir.forward"]
    rstb = [s for s in rows if s.name == "swinir.rstb"]
    up = [s for s in rows if s.name == "swinir.upsample"]
    assert len(fw) == 1 and len(rstb) == 6 and len(up) == 1
    # norm_kernels: the row-norm kernel's launches in the forward, none on the CPU;
    # stream_width: the stream's padded width, 184 for the published 180
    assert fw[0].item == 7 and fw[0].counts == {"tiles": 2, "windows": 2 * 2 * 36,
                                                "norm_kernels": 0, "stream_width": 184}
    assert [s.item for s in rstb] == list(range(6))
    assert all(s.parent == fw[0].id for s in rstb + up)


def test_sr_scene_and_the_trainer_refuse_swinir(tmp_path):
    cfg = _cfg(8)
    with pytest.raises(ValueError, match="EDSR"):
        sr_scene.sr_scene({}, np.zeros((5, 16, 16), np.float32), cfg, device="cpu")
    with pytest.raises(ValueError, match="EDSR"):
        sr_scene.sr_scene_folder(str(tmp_path), "m.npz", str(tmp_path / "o"), cfg,
                                 device="cpu")
    tcfg = train_sr.SRTrainConfig(model=cfg, outdir=str(tmp_path))
    for call in (lambda: train_sr.make_sr_train_step(tcfg),
                 lambda: train_sr.init_sr_training(tcfg, "cpu"),
                 lambda: train_sr.train_sr((np.zeros((2, 5, 4, 4), np.float32),
                                            np.zeros((2, 5, 32, 32), np.float32)), tcfg,
                                           device="cpu")):
        with pytest.raises(ValueError, match="EDSR"):
            call()


@pytest.fixture(scope="module")
def padded_cases():
    """{map: (cfg, params, x, reference output)} at embed 20 (carried at 24), x2."""
    out = {}
    for k, hw in enumerate(MAPS):
        cfg = _cfg(2, embed_dim=PADDED["embed_dim"])
        params = _draw(cfg, seed=20 + k)
        x = torch.from_numpy(np.random.default_rng(20 + k).standard_normal((2, 5, *hw))
                             .astype(np.float32))
        out[hw] = (cfg, params, x, _ref(params, x, cfg))
    return out


def _pads_stay_zero(monkeypatch, module, names: tuple, c: int) -> list:
    """Wrap each function `names` of `module` so that every 3-d tensor it
    returns (alone or in a tuple) is checked to hold zeros past channel c;
    returns the list of the widths seen."""
    seen = []

    def wrap(fn):
        def checked(*args, **kw):
            out = fn(*args, **kw)
            for t in out if isinstance(out, tuple) else (out,):
                if t.dim() == 3:  # the stream [B, P, Cp]; the gate's [B, 1, Cp] too
                    seen.append(t.shape[-1])
                    assert not t[..., c:].any(), f"{fn.__name__}: pad not zero"
            return out
        return checked
    for name in names:
        monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    return seen


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", MAPS)
def test_padded_stream_matches_reference_with_its_pad_zero(padded_cases, monkeypatch, dt, hw):
    """embed 20 carried at 24: the output within the tolerances above, the
    stream's pad zero after every norm, every STL and every RSTB's conv, and
    the forward's span counting stream_width 24."""
    cfg, params, x, want = padded_cases[hw]
    assert sw.stream_width(cfg.embed_dim) == 24
    seen = _pads_stay_zero(monkeypatch, sw, ("norm_rows", "add_norm_rows", "_stl", "_stream"),
                           cfg.embed_dim)
    profiling.timing_report(reset=True)
    got = sw.swinir_forward(params, x, cfg, compute_dtype=dt)
    fw = [s for s in profiling.spans() if s.name == "swinir.forward"]
    profiling.timing_report(reset=True)
    # 4 STLs: LN1, f_new and LN2, the STL's output each; 2 RSTB convs; conv_first;
    # 2 plain norms
    assert seen == [24] * (4 * 4 + 2 + 1 + 2)
    assert fw[0].counts["stream_width"] == 24
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert _rel(got, want) <= BF16_REL


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_prepared_weights_are_padded_to_the_stream_width(dt):
    """At the published widths every weight that reads or writes the stream
    is padded from 180 to 184 with zeros (the heads still padded 30 -> 32);
    the norms keep 180; the pad bits are zero and the rest is the weight."""
    cfg = sw.SwinIRConfig()
    params = sw.init_swinir(cfg, seed=2, device="cpu")
    wts = sw._prepare(params, cfg, dt, (8, 8))
    s = wts["layers.2.residual_group.blocks.1."]
    (wq, bq), (wp, bp), (w1, b1), (w2, b2) = s["qkv"], s["proj"], s["fc1"], s["fc2"]
    assert (wq.shape, bq.shape, wp.shape, bp.shape) == ((576, 184), (576,), (184, 192), (184,))
    assert (w1.shape, b1.shape, w2.shape, b2.shape) == ((360, 184), (360,), (184, 360), (184,))
    assert s["norm1"][0].shape == s["norm2"][1].shape == (180,)
    assert s["scale"] == 30 ** -0.5
    for t in (wq[:, 180:], wp[180:], bp[180:], w1[:, 180:], w2[180:], b2[180:]):
        assert t.numel() and not t.any()
    p = params["layers.2.residual_group.blocks.1.mlp.fc2.weight"]
    assert torch.equal(w2[:180], p.to(dt))
    shapes = {k: tuple(wts[k]["w"].shape) for k in ("conv_first", "layers.3.conv",
                                                   "conv_after_body", "conv_before_upsample.0")}
    assert shapes == {"conv_first": (3, 3, 5, 184), "layers.3.conv": (3, 3, 184, 184),
                      "conv_after_body": (3, 3, 184, 184),
                      "conv_before_upsample.0": (3, 3, 184, 64)}
    for k in ("conv_first", "layers.3.conv", "conv_after_body"):
        assert not wts[k]["w"][..., 180:].any() and not wts[k]["b"][180:].any()
    for k in ("layers.3.conv", "conv_after_body", "conv_before_upsample.0"):
        assert not wts[k]["w"][:, :, 180:].any()


W = "layers.0.residual_group.blocks.1.attn.qkv.weight"


@pytest.mark.parametrize("change", ["none", "written in place", "replaced", "another dict",
                                    "inference tensors"])
def test_weights_are_prepared_once_a_parameter_set(cases, monkeypatch, change):
    """A second forward of the same parameter dict reuses the weights the
    first prepared (casts, head padding, B_rel + M); a weight written in
    place, a tensor replaced, another dict or inference tensors (no version
    counter) prepare them anew; every output equals that of a fresh copy of
    the parameters."""
    cfg, params, x, _ = cases[2, (8, 8)]
    if change == "inference tensors":
        with torch.inference_mode():
            params = {k: v.clone() for k, v in params.items()}
    else:
        params = {k: v.clone() for k, v in params.items()}
    calls = []
    real = sw._prepare
    monkeypatch.setattr(sw, "_prepare", lambda *a: calls.append(a) or real(*a))
    first = sw.swinir_forward(params, x, cfg)
    if change == "written in place":
        params[W].mul_(1.5)
    elif change == "replaced":
        params[W] = params[W] * 1.5
    elif change == "another dict":
        params = dict(params)
    got = sw.swinir_forward(params, x, cfg)
    assert len(calls) == (1 if change == "none" else 2)
    with torch.inference_mode(change == "inference tensors"):
        fresh = {k: v.clone() for k, v in params.items()}
    assert torch.equal(got, sw.swinir_forward(fresh, x, cfg))
    assert torch.equal(got, first) == (change in ("none", "another dict", "inference tensors"))
