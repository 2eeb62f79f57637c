"""Port parity: the SR CNN, PSNR/SSIM, the `.npz` model files and the
`sr_infer` stage (kmsr_tpu_torch vs kmsr_tpu) on the CPU.

Small widths (width 8-16, 1-2 blocks, factors 4/6/8) from seeded numpy
inputs, and the committed x8 model at its own widths. Both packages start
from the same weights (the JAX init, converted by `convert.sr_from_jax`).

Tolerances:
- float32 forward: rtol 1e-4, atol 1e-5 (the degrade family's);
- bfloat16 forward: the port's largest distance from JAX's bfloat16 output
  at most twice JAX's own bfloat16-vs-float32 distance (both round every
  conv to bfloat16, in different accumulation orders), and
  tests/test_sr.py's median relative check against float32;
- `_bilinear_matrix` bit for bit, `pixel_shuffle` exact,
  `bilinear_upsample`, PSNR and SSIM rtol 1e-5 (SSIM near 0 also atol
  1e-5: its float32 local variances cancel).
The card's counterparts (forward, scene and train step, card vs CPU) are
in tests/test_torch_sr_card.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu.io import GROUP_HR, GROUP_LR, read_band_stack, write_band_stack
from kmsr_tpu.io.ncio import NCFile
from kmsr_tpu.models import sr as jsr
from kmsr_tpu.ops import metrics as jmetrics
from kmsr_tpu.pipeline import sr_infer as jinfer
from kmsr_tpu.utils import params_io as jio
from kmsr_tpu_torch import convert
from kmsr_tpu_torch.models import sr as tsr
from kmsr_tpu_torch.ops import metrics as tmetrics
from kmsr_tpu_torch.pipeline import sr_infer as tinfer
from kmsr_tpu_torch.train.state import tree_leaves
from kmsr_tpu_torch.utils import params_io as tio

TOL = dict(rtol=1e-4, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "quality_run_r4", "work", "sr_run", "sr_model.npz")
#: the committed model's widths (configs/quality_x8.json's sr_train stage)
COMMITTED_CFG = dict(width=64, n_blocks=8, factor=8, upsampler="progressive")
#: progressive x4 / x8 and oneshot x6
CONFIGS = [dict(width=16, n_blocks=2, factor=8), dict(width=16, n_blocks=2, factor=4),
           dict(width=8, n_blocks=1, factor=6, upsampler="oneshot")]


def _cfgs(**kw):
    return jsr.SRConfig(**kw), tsr.SRConfig(**kw)


def _jax_params(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jsr.init_sr(jax.random.PRNGKey(seed), cfg))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module", params=range(len(CONFIGS)),
                ids=["progressive-x8", "progressive-x4", "oneshot-x6"])
def forward_case(request):
    """One config's weights, input and JAX's float32 and bfloat16 outputs."""
    jcfg, tcfg = _cfgs(**CONFIGS[request.param])
    params = _jax_params(jcfg)
    x = np.random.default_rng(request.param).normal(2.0, 1.0, (2, 5, 8, 8)).astype(np.float32)
    want = {dt: np.asarray(jsr.sr_forward(params, jnp.asarray(x), jcfg, compute_dtype=dt))
            for dt in (jnp.float32, jnp.bfloat16)}
    return tcfg, convert.sr_from_jax(params, "cpu"), x, want


# ----------------------------------------------------------------- helpers
def test_pixel_shuffle_matches_jax_exactly():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 20, 4, 3)).astype(np.float32)
    y = tsr.pixel_shuffle(_t(x), 2).numpy()
    np.testing.assert_array_equal(y, np.asarray(jsr.pixel_shuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(y, torch.nn.functional.pixel_shuffle(_t(x), 2).numpy())
    # tests/test_sr.py's element mapping: out[b,c,2i+r,2j+s] == x[b, c*4 + r*2 + s, i, j]
    assert y[0, 0, 0, 0] == x[0, 0, 0, 0]
    assert y[0, 0, 0, 1] == x[0, 1, 0, 0]
    assert y[0, 0, 1, 0] == x[0, 2, 0, 0]
    assert y[0, 1, 1, 1] == x[0, 7, 0, 0]
    # the channels_last shuffle the trunk runs: same values, channels_last out
    x8 = _t(rng.normal(size=(2, 5 * 64, 3, 4))).contiguous(memory_format=torch.channels_last)
    got = tsr._pixel_shuffle_cl(x8, 8)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.numpy(), tsr.pixel_shuffle(x8, 8).numpy())


@pytest.mark.parametrize("n_in,factor", [(8, 8), (32, 8), (7, 4), (5, 6), (1, 3)])
def test_bilinear_matrix_bit_for_bit(n_in, factor):
    got = tsr._bilinear_matrix(n_in, n_in * factor)
    want = jsr._bilinear_matrix(n_in, n_in * factor)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_bilinear_upsample_matches_jax():
    x = np.random.default_rng(1).normal(3, 1, (2, 5, 8, 12)).astype(np.float32)
    for factor in (4, 8):
        want = np.asarray(jsr.bilinear_upsample(jnp.asarray(x), factor))
        np.testing.assert_allclose(tsr.bilinear_upsample(_t(x), factor).numpy(), want,
                                   rtol=1e-5, atol=1e-6)


def test_init_sr_tree_matches_jax_and_refuses_non_pow2():
    for kw in CONFIGS + [COMMITTED_CFG]:
        jcfg, tcfg = _cfgs(**kw)
        got = tsr.init_sr(tcfg, seed=3, device="cpu")
        names = [n for n, _ in tio._named_leaves(got)]
        jparams = jax.eval_shape(lambda k: jsr.init_sr(k, jcfg), jax.random.PRNGKey(0))
        jleaves = jax.tree_util.tree_leaves_with_path(jparams)
        assert names == [jax.tree_util.keystr(p) for p, _ in jleaves]
        assert [tuple(t.shape) for _, t in tio._named_leaves(got)] == \
            [a.shape for _, a in jleaves]
        assert tsr.count_params(got) == jsr.count_params(jparams)
    # fan-in uniform bounds
    p = tsr.init_sr(tsr.SRConfig(width=16, n_blocks=1, factor=4), device="cpu")
    assert float(p["head"]["w"].abs().max()) <= 1 / np.sqrt(5 * 9)
    assert float(p["blocks"][0]["c1"]["w"].abs().max()) <= 1 / np.sqrt(16 * 9)
    with pytest.raises(ValueError, match="power-of-2"):
        tsr.init_sr(tsr.SRConfig(factor=6), device="cpu")
    tsr.init_sr(tsr.SRConfig(width=8, n_blocks=1, factor=6, upsampler="oneshot"), device="cpu")


# ----------------------------------------------------------------- forward
def test_sr_forward_float32_matches_jax(forward_case):
    cfg, params, x, want = forward_case
    got = tsr.sr_forward(params, _t(x), cfg, compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == want[jnp.float32].shape
    np.testing.assert_allclose(got.numpy(), want[jnp.float32], **TOL)


def test_sr_forward_bfloat16_within_bound(forward_case):
    cfg, params, x, want = forward_case
    got = tsr.sr_forward(params, _t(x), cfg).numpy()
    jax_own = float(np.abs(want[jnp.bfloat16] - want[jnp.float32]).max())
    assert jax_own > 0
    assert float(np.abs(got - want[jnp.bfloat16]).max()) <= 2 * jax_own
    # tests/test_sr.py:74's check, on the port's own float32 output
    y32 = tsr.sr_forward(params, _t(x), cfg, compute_dtype=torch.float32).numpy()
    assert np.median(np.abs(got - y32) / (np.abs(y32) + 1e-3)) < 0.05


def test_sr_forward_nchw_trunk_equals_channels_last(forward_case):
    cfg, params, x, _ = forward_case
    a = tsr.sr_forward(params, _t(x), cfg, compute_dtype=torch.float32)
    b = tsr.sr_forward(params, _t(x), cfg, compute_dtype=torch.float32, channels_last=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_committed_x8_model_matches_jax():
    """quality_run_r4/work/sr_run/sr_model.npz (937,684 parameters in 42
    arrays) through both packages' load_sr_model, one seeded 1x5x32x32
    float32 forward."""
    jcfg, tcfg = _cfgs(**COMMITTED_CFG)
    params = tinfer.load_sr_model(COMMITTED, tcfg, device="cpu")
    assert len(tree_leaves(params)) == 42 and tsr.count_params(params) == 937_684
    jparams = jinfer.load_sr_model(COMMITTED, jcfg)
    x = np.random.default_rng(7).normal(0.05, 0.02, (1, 5, 32, 32)).astype(np.float32)
    want = np.asarray(jsr.sr_forward(jparams, jnp.asarray(x), jcfg, compute_dtype=jnp.float32))
    got = tsr.sr_forward(params, _t(x), tcfg, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_npz_models_interchange_both_ways(tmp_path):
    jcfg, tcfg = _cfgs(**CONFIGS[0])
    # the port writes, JAX reads
    mine = tsr.init_sr(tcfg, seed=5, device="cpu")
    tio.save_params(str(tmp_path / "port.npz"), mine)
    loaded = jio.load_params(str(tmp_path / "port.npz"), _jax_params(jcfg))
    for (_, t), a in zip(tio._named_leaves(mine), jax.tree_util.tree_leaves(loaded)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    # JAX writes, the port reads (through load_sr_model)
    theirs = _jax_params(jcfg, seed=9)
    jio.save_params(str(tmp_path / "jax.npz"), theirs)
    got = tinfer.load_sr_model(str(tmp_path / "jax.npz"), tcfg, device="cpu")
    for (_, t), a in zip(tio._named_leaves(got), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_array_equal(t.numpy(), a)
    with pytest.raises(ValueError, match="shape mismatch"):
        tinfer.load_sr_model(str(tmp_path / "jax.npz"),
                             tsr.SRConfig(width=8, n_blocks=2, factor=8), device="cpu")


# ----------------------------------------------------------------- metrics
@pytest.mark.parametrize("noise,data_range", [(0.2, 1.0), (0.05, 3.7), (1.0, 0.5)])
def test_psnr_ssim_match_jax(noise, data_range):
    rng = np.random.default_rng(int(noise * 100))
    a = rng.normal(1.0, 0.5, (5, 40, 36)).astype(np.float32)
    b = (a + rng.normal(0, noise, a.shape)).astype(np.float32)
    for name in ("psnr", "ssim"):
        want = float(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b), data_range))
        got = getattr(tmetrics, name)(_t(a), _t(b), data_range)
        assert got.ndim == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_metrics_batched_equal_per_sample_and_identity():
    rng = np.random.default_rng(4)
    a = _t(rng.normal(1.0, 0.5, (3, 5, 24, 24)))
    b = a + _t(rng.normal(0, 0.1, a.shape))
    dr = torch.tensor([1.0, 2.5, 0.7])
    for fn in (tmetrics.psnr, tmetrics.ssim):
        batched = fn(a, b, dr)
        assert batched.shape == (3,)
        for i in range(3):
            np.testing.assert_allclose(float(batched[i]), float(fn(a[i], b[i], float(dr[i]))),
                                       rtol=1e-6)
    one = torch.ones(5, 32, 32)
    assert float(tmetrics.psnr(one, one, 1.0)) > 100
    assert float(tmetrics.ssim(one, one, 1.0)) == pytest.approx(1.0, abs=1e-5)


# ------------------------------------------------------------- sr_infer stage
def _write_pairs(d, rng, names, factor=4, hr_side=32, with_hr=True):
    d.mkdir(exist_ok=True)
    for n in names:
        hr = rng.normal(3, 1, size=(5, hr_side, hr_side)).astype(np.float32)
        s = hr_side // factor
        lr = hr.reshape(5, s, factor, s, factor).mean(axis=(2, 4))
        write_band_stack(d / f"{n}.nc", GROUP_LR, lr, mode="w")
        if with_hr:
            write_band_stack(d / f"{n}.nc", GROUP_HR, hr, mode="a")


def _summary(text, prefix):
    line = next(ln for ln in text.splitlines() if ln.startswith(prefix))
    return line.split("|")[-1].strip()


def test_sr_infer_cli_matches_jax_and_reads_a_jax_model(tmp_path, capsys):
    jcfg, _ = _cfgs(width=8, n_blocks=1, factor=4)
    jio.save_params(str(tmp_path / "sr_model.npz"), _jax_params(jcfg))
    rng = np.random.default_rng(3)
    _write_pairs(tmp_path / "pairs", rng, ["s1", "s2", "s3"])
    _write_pairs(tmp_path / "pairs", rng, ["s4"], with_hr=False)   # no reference
    _write_pairs(tmp_path / "pairs", rng, ["s5"], hr_side=48)      # another shape
    args = ["--input-dir", str(tmp_path / "pairs"), "--model", str(tmp_path / "sr_model.npz"),
            "--factor", "4", "--width", "8", "--n-blocks", "1", "--batch-size", "2"]
    assert jinfer.main(args + ["--output-dir", str(tmp_path / "jax")]) == 0
    jax_line = _summary(capsys.readouterr().out, "sr_infer:")
    assert tinfer.main(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    port_line = _summary(capsys.readouterr().out, "sr_infer:")
    assert port_line == jax_line  # PSNR to 2 decimals, SSIM to 4
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 5
    for n in names:
        want = read_band_stack(tmp_path / "jax" / n, "sr")
        got = read_band_stack(tmp_path / "port" / n, "sr")
        assert got.shape == want.shape
        lr = read_band_stack(tmp_path / "pairs" / n.replace("_sr", ""), GROUP_LR)
        y32 = np.asarray(jsr.sr_forward(_jax_params(jcfg), jnp.asarray(lr[None]), jcfg,
                                        compute_dtype=jnp.float32))[0]
        assert np.abs(got - want).max() <= 2 * np.abs(want - y32).max()
        with NCFile(tmp_path / "port" / n) as f:
            attrs = f.get_attrs("sr")
            assert f.has_group(GROUP_LR)
        assert attrs["model_file"] == "sr_model.npz" and int(attrs["factor"]) == 4


def test_run_batches_in_memory_groups_metrics_and_failures():
    """The device loop on in-memory stacks: one group per (lr, hr) shape,
    one-deep pipeline, metrics equal to psnr/ssim of the returned preds
    (data range nanmax - nanmin of each hr), a group whose hr does not
    match the output fails only its files."""
    _, tcfg = _cfgs(width=8, n_blocks=1, factor=4)
    params = tsr.init_sr(tcfg, seed=1, device="cpu")
    rng = np.random.default_rng(6)
    lr = lambda s: rng.normal(3, 1, (5, s, s)).astype(np.float32)  # noqa: E731
    hr = lambda s: rng.normal(3, 1, (5, s, s)).astype(np.float32)  # noqa: E731
    hr_nan = hr(32)
    hr_nan[:, :3, :3] = np.nan
    chunks = [
        (["a", "b", "c"], [(lr(8), hr(32)), (lr(8), hr_nan), (lr(6), None)], [("x", "bad")]),
        (["d", "e"], [(lr(8), hr(16)), (lr(8), hr(32))], []),
    ]
    seen = []
    fail = tinfer.run_batches(chunks, params, tcfg,
                              lambda p, preds, m: seen.append((p, preds, m)), device="cpu")
    assert [p for p, _, _ in seen] == [["a", "b"], ["c"], ["e"]]
    assert [f[0] for f in fail] == ["x", "d"] and "ValueError" in fail[1][1]
    items = dict(zip("abcde", chunks[0][1] + chunks[1][1]))
    for paths, preds, mets in seen:
        want = tsr.sr_forward(params, _t(np.stack([items[p][0] for p in paths])), tcfg)
        np.testing.assert_array_equal(preds, want.numpy())
        if paths == ["c"]:
            assert mets is None
            continue
        for i, p in enumerate(paths):
            h = items[p][1]
            dr = float(np.nanmax(h) - np.nanmin(h)) or 1.0
            # SSIM near 0 (an untrained model) keeps ~1e-6 absolute in float32
            np.testing.assert_allclose(mets[i], [float(jmetrics.psnr(preds[i], h, dr)),
                                                 float(jmetrics.ssim(preds[i], h, dr))],
                                       rtol=1e-5, atol=1e-5)
