"""Port parity: the fleet's refusals and its CLI (kmsr_tpu_torch vs
kmsr_tpu), on the CPU at tiny widths: JAX's refusal messages, the
scene-parallel run byte-equal to the plain one, and the CLI over each
patch source and format, the shipped config's flags against JAX's CLI.
"""
import os

import numpy as np
import pytest

from kmsr_tpu.data import sampler as jsampler
from kmsr_tpu.io import write_band_stack
from kmsr_tpu.train import fleet as jfleet
from kmsr_tpu_torch.data import sampler as tsampler
from kmsr_tpu_torch.pipeline import train_fleet_cli as tcli
from kmsr_tpu_torch.train import fleet as tfleet
from kmsr_tpu_torch.train import single_kernel as tsk
from tests.helpers.torch_fleet import (  # noqa: F401
    KERNEL_TOL, ROW_TOL, TOL, assert_runs_close as _assert_runs_close, cfg as _cfg,
    pools as _pools, rows as _rows, torch_state as _torch_state)


_REFUSALS = {  # (pools, lr side or None, cfg overrides, train_fleet kwargs)
    "no pools": (0, None, {}, {}),
    "K-multiple intervals": (1, None, dict(steps_per_call=3), {}),
    "names per pool": (1, None, {}, dict(scene_names=["a", "b"])),
    "unique names": (2, None, {}, dict(scene_names=["a", "a"])),
    "real_is_lr needs lr_pools": (1, None, dict(real_is_lr=True), {}),
    "lr_pools per scene": (2, 8, dict(real_is_lr=True), dict(scene_names=["a", "b"])),
    "lr side": (1, 16, dict(real_is_lr=True), {}),
    "lr_pools without real_is_lr": (1, 8, {}, {}),
    "scene_chunk divides": (3, None, {}, dict(scene_chunk=2)),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_refusals_match_jax(tmp_path, case):
    n, lr_side, over, kw = _REFUSALS[case]
    rng = np.random.default_rng(9)
    hr = rng.normal(5, 1, (6, 5, 32, 32)).astype(np.float32)
    lr = rng.normal(5, 1, (4, 5, lr_side, lr_side)).astype(np.float32) if lr_side else None
    msgs = []
    for pkg, m, smp, extra in (("jax", jfleet, jsampler, {}),
                               ("torch", tfleet, tsampler, {"device": "cpu"})):
        lr_pools = [smp.PatchPool(lr)] if lr is not None else None
        with pytest.raises(ValueError) as e:
            m.train_fleet([smp.PatchPool(hr)] * n, _cfg(pkg, tmp_path / pkg, **over),
                          progress=False, lr_pools=lr_pools, **kw, **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_scene_parallel_and_multi_process_are_refused(tmp_path, monkeypatch):
    """--scene-parallel runs (a plain process is a one-rank scene mesh) and
    writes every scene's artifacts as the run without it does, bit for
    bit; a multi-process launch without it is refused."""
    pool = tsampler.PatchPool(np.ones((2, 5, 32, 32), np.float32))
    _write_scenes(tmp_path / "root", np.random.default_rng(8), "npy")
    args = ["--patch-root", str(tmp_path / "root"), "--format", "npy", "--iters", "2",
            "--batch-size", "2", "--lr-crop-size", "8", "--log-every", "1",
            "--kernel-log-every", "2", "--fast-forward", "--device", "cpu"]
    assert tcli.main(args + ["--outdir", str(tmp_path / "sp"), "--scene-parallel"]) == 0
    assert tcli.main(args + ["--outdir", str(tmp_path / "one")]) == 0
    for scene in ("sceneA", "sceneB"):
        names = sorted(os.listdir(tmp_path / "one" / scene))
        assert sorted(os.listdir(tmp_path / "sp" / scene)) == names and len(names) == 5
        for name in names:
            assert ((tmp_path / "sp" / scene / name).read_bytes()
                    == (tmp_path / "one" / scene / name).read_bytes())
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="multi-process"):
        tcli.main(["--patch-root", str(tmp_path), "--outdir", str(tmp_path / "o"),
                   "--device", "cpu"])
    with pytest.raises(ValueError, match="multi-process"):
        tfleet.train_fleet([pool], _cfg("torch", tmp_path), device="cpu")


# ------------------------------------------------------------------------ CLI
def _write_scenes(root, rng, fmt, flat=False, names=("sceneA", "sceneB"), n=3, side=32,
                  group="denoised"):
    """n patches per scene, as per-scene subdirectories of root (or one
    flat dir of `<scene>_<gi>_<gj>` files); returns the dirs made."""
    dirs = []
    for name in names:
        d = root if flat else root / name
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            a = rng.normal(5, 1, (5, side, side)).astype(np.float32)
            stem = f"{name}_{i:03d}_000" if flat else f"p{i}"
            if fmt == "npy":
                np.save(d / f"{stem}.npy", a)
            else:
                write_band_stack(d / f"{stem}.nc", group, a, mode="w")
        dirs.append(str(d))
    return sorted(set(dirs))


def _artifacts(outdir, scene):
    d = os.path.join(outdir, scene)
    files = sorted(os.listdir(d))
    shapes = {f: np.load(os.path.join(d, f)).shape for f in files if f.endswith(".npy")}
    lines = open(os.path.join(d, "training_log.txt")).read().splitlines()
    return files, shapes, lines[0], len(lines)


@pytest.mark.parametrize("fmt", ["nc", "npy"])
@pytest.mark.parametrize("source", ["--patch-root", "--patch-dirs", "--patch-dir"])
def test_cli_sources_and_formats(tmp_path, source, fmt):
    """Each source (a root of scene dirs, explicit dirs, one flat dir
    regrouped by scene prefix) in each format: the JAX package's per-scene
    artifact names, header, row count and shapes."""
    rng = np.random.default_rng(10)
    dirs = _write_scenes(tmp_path / "in", rng, fmt, flat=source == "--patch-dir")
    src = {"--patch-root": [str(tmp_path / "in")], "--patch-dirs": dirs,
           "--patch-dir": dirs}[source]
    args = [source, *src, "--format", fmt, "--iters", "2", "--batch-size", "2",
            "--lr-crop-size", "8", "--log-every", "1", "--kernel-log-every", "2"]
    assert tcli.main(args + ["--outdir", str(tmp_path / "out"), "--device", "cpu"]) == 0
    for scene in ("sceneA", "sceneB"):
        files, shapes, header, n_lines = _artifacts(tmp_path / "out", scene)
        assert files == ["kernel_iter2.npy", "kernel_merged.npy", "kernel_per_band.npy",
                         "kernel_per_band_iter2.npy", "training_log.txt"]
        assert shapes["kernel_per_band.npy"] == (5, 13, 13)
        assert shapes["kernel_iter2.npy"] == (13, 13)
        assert header == tsk.LOG_HEADER.strip() and n_lines == 3


def test_cli_real_is_lr_matches_jax_artifacts(tmp_path):
    """The shipped config's flags (compose, real_is_lr from a native-LR
    dir, K = 2, fake noise auto, raw_sum_reg, d-border-crop, d-lr) through
    both CLIs on one flat input: the same files, header, row count and
    shapes; `fake_noise_sigma` equals JAX's inline estimate."""
    from kmsr_tpu.ops.sigma import estimate_sigma_np as j_sigma
    from kmsr_tpu.pipeline import train_fleet_cli as jcli

    rng = np.random.default_rng(11)
    dirs = _write_scenes(tmp_path / "in", rng, "nc", flat=True)
    _write_scenes(tmp_path / "lr", rng, "nc", flat=True, n=4, side=8,
                  group="geophysical_data")
    args = ["--patch-dir", dirs[0], "--format", "nc", "--real-is-lr",
            "--real-lr-dir", str(tmp_path / "lr"), "--fake-noise", "auto",
            "--raw-sum-reg", "0.1", "--d-border-crop", "1", "--d-lr", "2e-4",
            "--steps-per-call", "2", "--fast-forward", "--iters", "4",
            "--batch-size", "2", "--lr-crop-size", "8", "--log-every", "2",
            "--kernel-log-every", "2"]
    assert jcli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["--outdir", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    for scene in ("sceneA", "sceneB"):
        assert _artifacts(tmp_path / "torch", scene) == _artifacts(tmp_path / "jax", scene)

    lr_pools = [tsampler.PatchPool.from_files(
        sorted(str(p) for p in (tmp_path / "lr").glob(f"{s}_*.nc")), group="geophysical_data")
        for s in ("sceneA", "sceneB")]
    want = np.median([[np.median([j_sigma(p[b]) for p in pool.patches[:64]])
                       for b in range(5)] for pool in lr_pools], axis=0)
    np.testing.assert_array_equal(tcli.fake_noise_sigma(lr_pools), want)
