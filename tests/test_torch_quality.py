"""Port parity: the SR quality scripts (scripts/torch_make_quality_scenes.py,
scripts/torch_quality_report.py, scripts/torch_native_lr_eval.py vs the
JAX package's scripts/make_quality_scenes.py, quality_report.py,
native_lr_eval.py), on the CPU at small sizes.

- The scene generator writes bit-equal scenes, native-LR scenes and
  gt_kernel.npy for one seed.
- Both reports on the same `.nc` pairs (5x64x64 radiance-like HR, x8, 10
  pairs, holdout 4) with a JAX `init_sr` model saved in JAX's `.npz`
  format: every holdout pair's SR and bilinear PSNR within 1e-4 dB and
  SSIM within 1e-5, the same chosen lam per prior and every lam's mean
  PSNR within 0.01 dB (the oracle's float32 CG drifts further from a
  float64 solve in the port than in JAX: ROADMAP.md section 3), the
  printed lines and the markdown equal but for the model row's label (and
  the reference's kernel trainer named without an absolute path); the
  plain route (`--config`'s kernel) and the per-scene `--kernel-root`
  route with `--gt-kernel`. JAX's numbers (and the arrays its metrics
  saw) are read by wrapping its metric and oracle functions, the port's
  from `evaluate`. SSIM at radiance scale subtracts E[x]^2 from E[x^2] in
  float32: JAX's SR SSIM lands ~2e-5 from a float64 SSIM of the same
  arrays, the port's within 1e-6 (ROADMAP.md section 3), so the SR SSIM
  is held within 1e-5 of the float64 SSIM of JAX's own predictions, and
  JAX's float32 value within 1e-4 of it.
- native_lr_eval on one 5x64x64 scene (LR 8x8, tiles of 4): bilinear
  PSNR within 1e-4 dB and SSIM within 1e-5 of the float64 SSIM of JAX's
  arrays, the bfloat16 SR within 0.01 dB / 1e-4.
"""
import contextlib
import csv
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from kmsr_tpu.models.sr import SRConfig as JSRConfig
from kmsr_tpu.models.sr import init_sr as jinit_sr
from kmsr_tpu.utils.params_io import save_params as jsave_params
from kmsr_tpu_torch.io.ncio import read_band_stack
from kmsr_tpu_torch.pipeline.make_train_data import save_training_sample

REPO = Path(__file__).resolve().parent.parent
PSNR_ABS, SSIM_ABS, LAM_PSNR_ABS = 1e-4, 1e-5, 0.01
WIDTH, BLOCKS, FACTOR = 8, 2, 8


def _script(name: str):
    """scripts/<name>.py as a module (the scripts dir on sys.path, as when
    the script runs)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(f"_test_{name}", REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(str(REPO / "scripts"))


def _run(fn, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn(*args) == 0
    return out.getvalue()


class _Recorder:
    """Wraps JAX's psnr / ssim (outside the oracle) and oracle_sweep."""

    def __init__(self, monkeypatch):
        from kmsr_tpu.analysis import oracle
        from kmsr_tpu.ops import metrics

        self.metrics, self.args, self.sweeps, self._muted = [], [], [], 0
        for mod, name in ((metrics, "psnr"), (metrics, "ssim")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name)))
        sweep = oracle.oracle_sweep

        def wrapped(*a, **k):
            self._muted += 1
            try:
                best, preds, per_lam = sweep(*a, **k)
            finally:
                self._muted -= 1
            self.sweeps.append((k.get("prior", "grad"), best, per_lam))
            return best, preds, per_lam

        monkeypatch.setattr(oracle, "oracle_sweep", wrapped)

    def _wrap(self, fn):
        def wrapped(*a, **k):
            v = fn(*a, **k)
            if not self._muted:
                self.metrics.append(float(v))
                self.args.append((np.asarray(a[0], np.float64), np.asarray(a[1], np.float64),
                                  float(a[2])))
            return v
        return wrapped


def _ssim64(a, b, dr):
    """JAX's SSIM formula (`kmsr_tpu/ops/metrics.py:43-67`) in float64."""
    import torch
    import torch.nn.functional as F

    c = a.shape[0]
    xs = torch.arange(11, dtype=torch.float64) - 5.0
    g = torch.exp(-(xs ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()
    win = torch.outer(g, g).expand(c, 1, 11, 11)

    def f(x):
        return F.conv2d(torch.from_numpy(x)[None], win, groups=c)[0]

    mu_a, mu_b = f(a), f(b)
    var_a, var_b, cov = f(a * a) - mu_a ** 2, f(b * b) - mu_b ** 2, f(a * b) - mu_a * mu_b
    c1, c2 = (0.01 * dr) ** 2, (0.03 * dr) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a ** 2 + mu_b ** 2 + c1)
                                                      * (var_a + var_b + c2))
    return float(s.mean())


# ----------------------------------------------------------------- scenes
def test_scene_generator_is_bit_equal(tmp_path):
    """Both generators at one seed: the same printed lines (paths aside),
    scenes, native-LR scenes and gt_kernel.npy, bit for bit."""
    outs = {}
    for label, name in (("jax", "make_quality_scenes"), ("port", "torch_make_quality_scenes")):
        root = tmp_path / label
        text = _run(_script(name).main, [str(root / "s"), "--n", "2", "--size", "64",
                                         "--seed", "7", "--lr-outdir", str(root / "lr")])
        outs[label] = (root, text.replace(str(root), "ROOT"))
    (rj, tj), (rt, tt) = outs["jax"], outs["port"]
    assert tj == tt and tj.count("ROOT/s/scene_") == 2
    np.testing.assert_array_equal(np.load(rt / "lr" / "gt_kernel.npy"),
                                  np.load(rj / "lr" / "gt_kernel.npy"))
    for sub in ("s", "lr"):
        names = sorted(p.name for p in (rj / sub).glob("scene_*.nc"))
        assert names == sorted(p.name for p in (rt / sub).glob("scene_*.nc")) and len(names) == 2
        for n in names:
            a, b = (read_band_stack(str(r / sub / n), "geophysical_data") for r in (rt, rj))
            np.testing.assert_array_equal(a, b)
            assert np.isnan(a).any()


# ----------------------------------------------------------------- report
def _sr_model(path: Path) -> None:
    cfg = JSRConfig(width=WIDTH, n_blocks=BLOCKS, factor=FACTOR)
    path.mkdir(parents=True, exist_ok=True)
    jsave_params(str(path / "sr_model.npz"), jinit_sr(jax.random.PRNGKey(0), cfg))
    with open(path / "training_log.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Iteration", "Loss", "Eval_PSNR", "Eval_SSIM"])
        w.writerow([50, 0.5, "", ""])
        w.writerow([100, 0.4, 30.5, 0.91])
        w.writerow([200, 0.3, 31.25, 0.925])


def _gauss(n=13, sigma=2.0, sx=1.0):
    c = n // 2
    yy, xx = np.mgrid[-c:c + 1, -c:c + 1]
    k = np.exp(-((xx / sx) ** 2 + yy ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """10 pairs of 2 scenes (smooth HR fields, LR = the blurred block mean
    plus noise), the noise pool beside the pairs, the SR model, a config
    naming a kernel, per-scene kernels and a ground-truth kernel."""
    root = tmp_path_factory.mktemp("quality")
    rng = np.random.default_rng(11)
    pairs = root / "work" / "train_pairs"
    pairs.mkdir(parents=True)
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    for i in range(10):
        scene = "sceneA" if i < 5 else "sceneB"
        base = np.array([70, 55, 35, 18, 3], np.float32)[:, None, None]
        phase = rng.uniform(0, 6.3, (5, 1, 1))
        hr = (base + 3 * np.sin(6 * xx + phase) * np.cos(4 * yy - phase)
              + rng.normal(0, 0.3, (5, 64, 64))).astype(np.float32)
        lr = (hr.reshape(5, 8, 8, 8, 8).mean(axis=(2, 4))
              + rng.normal(0, 0.05, (5, 8, 8))).astype(np.float32)
        save_training_sample(str(pairs / f"{scene}_{i // 2:03d}_{i % 2:03d}_train.nc"),
                             hr, lr, None)
    np.save(root / "work" / "noise_pool.npy",
            rng.normal(0, 0.05, (16, 5, 8, 8)).astype(np.float32))
    _sr_model(root / "work" / "sr_run")
    kernel = np.stack([_gauss()] * 5)
    np.save(root / "kernel.npy", kernel)
    (root / "quality_x8.json").write_text(json.dumps(
        {"trainer": "single", "kernel_file": str(root / "kernel.npy"), "stages": {}}))
    for s, sx in (("sceneA", 1.0), ("sceneB", 1.3)):
        (root / "fleet" / s).mkdir(parents=True)
        np.save(root / "fleet" / s / "kernel_per_band.npy", np.stack([_gauss(sx=sx)] * 5))
    np.save(root / "gt_kernel.npy", np.stack([_gauss(sigma=1.5)] * 5))
    return root


def _argv(root: Path, out: Path, route: str) -> list:
    argv = ["--pairs", str(root / "work" / "train_pairs"), "--sr", str(root / "work" / "sr_run"),
            "--holdout", "4", "--width", str(WIDTH), "--n-blocks", str(BLOCKS),
            "--config", str(root / "quality_x8.json"), "--out", str(out / "QUALITY.md"),
            "--oracle-iters", "30"]
    if route == "kernel_root":
        argv += ["--kernel-root", str(root / "fleet"), "--gt-kernel", str(root / "gt_kernel.npy")]
    return argv


@pytest.mark.parametrize("route", ["plain", "kernel_root"])
def test_quality_report_matches_jax(workdir, tmp_path, monkeypatch, route):
    jqr, tqr = _script("quality_report"), _script("torch_quality_report")
    for label in ("jax", "port"):
        (tmp_path / label).mkdir()  # the curve PNG goes beside the report
    rec = _Recorder(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["quality_report.py"] + _argv(workdir, tmp_path / "jax", route))
    text_j = _run(jqr.main)
    got = []
    evaluate = tqr.evaluate
    monkeypatch.setattr(tqr, "evaluate", lambda *a, **k: got.append(evaluate(*a, **k)) or got[-1])
    text_t = _run(tqr.main, _argv(workdir, tmp_path / "port", route) + ["--device", "cpu"])
    res = got[0]

    # SR and bilinear, pair by pair: JAX computed psnr, ssim of SR, then of bilinear
    want = np.asarray(rec.metrics[:16]).reshape(4, 4)
    np.testing.assert_allclose(res["rows"][:, [0, 2]], want[:, [0, 2]], rtol=0, atol=PSNR_ABS)
    np.testing.assert_allclose(res["rows"][:, 3], want[:, 3], rtol=0, atol=SSIM_ABS)
    sr_ssim64 = np.asarray([_ssim64(*rec.args[4 * i + 1]) for i in range(4)])
    np.testing.assert_allclose(res["rows"][:, 1], sr_ssim64, rtol=0, atol=SSIM_ABS)
    np.testing.assert_allclose(want[:, 1], sr_ssim64, rtol=0, atol=1e-4)
    assert res["n"] == 10
    # the oracle: the same lam, every lam's PSNR, the report's oracle rows
    assert [s[0] for s in rec.sweeps] == list(res["stats"]) == ["grad", "matched"]
    orc = np.asarray(rec.metrics[16:]).reshape(2, 4, 2).mean(axis=1)
    for k, (prior, best, per_lam) in enumerate(rec.sweeps):
        st = res["stats"][prior]
        assert st["lam"] == best, prior
        assert st["per_lam"].keys() == per_lam.keys()
        for lam, p in per_lam.items():
            assert abs(st["per_lam"][lam] - p) <= LAM_PSNR_ABS, (prior, lam)
        assert abs(st["p"] - orc[k, 0]) <= LAM_PSNR_ABS and abs(st["s"] - orc[k, 1]) <= 1e-4
    # printed lines and markdown: JAX's, but for paths and the model row's label
    assert text_t.replace(str(tmp_path / "port"), "OUT") == text_j.replace(
        str(tmp_path / "jax"), "OUT")
    md_j = (tmp_path / "jax" / "QUALITY.md").read_text()
    md_t = (tmp_path / "port" / "QUALITY.md").read_text()
    assert md_t.count("| kmsr_tpu_torch SR |") == 1
    # the reference's source path is named without the JAX report's absolute prefix
    md_j = re.sub(r"`\S*/(kernel_from_lr_gan)", r"the reference's `\1", md_j)
    assert md_t.replace("| kmsr_tpu_torch SR |", "| kmsr_tpu SR |") == md_j
    assert ("Kernel recovery" in md_t) == (route == "kernel_root")
    for label in ("jax", "port"):
        assert (tmp_path / label / "quality_curve.png").exists()


def test_report_evaluate_without_an_oracle():
    """`evaluate` on in-memory arrays (the card's route: no .nc), no kernel:
    the SR / bilinear rows only; a CUDA request without a card raises."""
    import torch

    from kmsr_tpu_torch.models.sr import SRConfig, init_sr

    tqr = _script("torch_quality_report")
    rng = np.random.default_rng(0)
    hr = rng.normal(5, 1, (6, 5, 32, 32)).astype(np.float32)
    lr = hr.reshape(6, 5, 4, 8, 4, 8).mean(axis=(3, 5))
    cfg = SRConfig(width=WIDTH, n_blocks=BLOCKS, factor=FACTOR)
    params = init_sr(cfg, device="cpu")
    res = tqr.evaluate(lr, hr, 4, params, cfg, device="cpu", chunk=3)
    assert res["rows"].shape == (4, 4) and res["stats"] is None and np.isfinite(res["rows"]).all()
    assert res["bl_p"] == pytest.approx(res["rows"][:, 2].mean())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tqr.evaluate(lr, hr, 4, params, cfg)


# --------------------------------------------------------- native_lr_eval
def test_native_lr_eval_matches_jax(tmp_path, monkeypatch):
    scenes = tmp_path / "scenes"
    _run(_script("torch_make_quality_scenes").main,
         [str(scenes / "hr"), "--n", "1", "--size", "64", "--seed", "5",
          "--lr-outdir", str(scenes / "lr")])
    _sr_model(tmp_path / "sr")
    argv = ["--lr-dir", str(scenes / "lr"), "--model", str(tmp_path / "sr" / "sr_model.npz"),
            "--width", str(WIDTH), "--n-blocks", str(BLOCKS), "--seed", "5", "--size", "64",
            "--tile", "4"]
    rec = _Recorder(monkeypatch)
    jne, tne = _script("native_lr_eval"), _script("torch_native_lr_eval")
    monkeypatch.setattr(sys, "argv", ["native_lr_eval.py"] + argv + [
        "--append", str(tmp_path / "jax.md")])
    text_j = _run(jne.main)
    got = []
    evaluate_scene = tne.evaluate_scene
    monkeypatch.setattr(tne, "evaluate_scene",
                        lambda *a, **k: got.append(evaluate_scene(*a, **k)) or got[-1])
    text_t = _run(tne.main, argv + ["--append", str(tmp_path / "port.md"), "--device", "cpu"])
    want = rec.metrics
    assert len(got) == 1 and len(want) == 4
    sr_p, sr_s, bl_p, bl_s, _ = got[0]
    assert abs(bl_p - want[2]) <= PSNR_ABS
    bl_ssim64 = _ssim64(*rec.args[3])  # JAX's bilinear arrays, its formula in float64
    assert abs(bl_s - bl_ssim64) <= SSIM_ABS and abs(want[3] - bl_ssim64) <= 1e-4
    assert abs(sr_p - want[0]) <= 0.01 and abs(sr_s - want[1]) <= 1e-4
    jl, tl = text_j.splitlines(), text_t.splitlines()
    assert len(jl) == len(tl) == 3 and tl[0].split(":")[0] == jl[0].split(":")[0]
    assert json.loads(tl[1]).keys() == json.loads(jl[1]).keys()
    md_j = (tmp_path / "jax.md").read_text().splitlines()
    md_t = (tmp_path / "port.md").read_text().splitlines()
    assert len(md_j) == len(md_t)
    assert [l for l in md_t if "kmsr_tpu_torch SR" in l]
    assert md_t[:12] == md_j[:12]
