"""The port's host analysis tools against the JAX package's, on the same
files: inspect_nc's text, data_stats' JSON, viz_cli's printed lines (and
its figures), the visualize figures and RGB arrays, and make_train_data
with --vis-dir. The files are the kinds JAX's own tests write
(tests/test_pipeline.py, tests/test_checkpoint_viz.py)."""
import json
import os

import numpy as np
import pytest

from kmsr_tpu.analysis import visualize as jvis
from kmsr_tpu.analysis import viz_cli as jviz
from kmsr_tpu.pipeline import data_stats as jstats
from kmsr_tpu.pipeline import inspect_nc as jinspect
from kmsr_tpu.pipeline import make_train_data as jmake
from kmsr_tpu_torch.analysis import visualize as tvis
from kmsr_tpu_torch.analysis import viz_cli as tviz
from kmsr_tpu_torch.io import (GROUP_BLURRED, GROUP_DENOISED, GROUP_GEO, GROUP_HR,
                               GROUP_LR, NCFile, read_band_stack, write_band_stack)
from kmsr_tpu_torch.pipeline import data_stats as tstats
from kmsr_tpu_torch.pipeline import inspect_nc as tinspect
from kmsr_tpu_torch.pipeline import make_train_data as tmake

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X4_BANK = os.path.join(REPO, "quality_run_r4", "work_x4", "kernel_run")


def _both(capsys, jax_main, port_main, argv):
    """(JAX's stdout, the port's stdout) of one argv; each main returns 0."""
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert port_main(argv) == 0
    return want, capsys.readouterr().out


@pytest.fixture
def scene_nc(tmp_path, rng):
    """A scene file as tests/test_pipeline.py's `make_scene_file` writes
    it (geophysical bands, navigation lat/lon), plus root, group and
    variable attributes (bytes and numbers) and a NaN cell."""
    path = tmp_path / "scene.nc"
    scene = rng.uniform(0.5, 5.0, (5, 24, 20)).astype(np.float32)
    scene[4] = 1.0
    scene[0, 3, 4] = np.nan
    write_band_stack(path, GROUP_GEO, scene, mode="w")
    with NCFile(path, "a") as f:
        for k, v in (("latitude", np.linspace(30, 31, 480)), ("longitude", np.linspace(120, 121, 480))):
            f.create_variable("navigation_data", k, v.reshape(24, 20).astype(np.float32),
                              dims=("y", "x"))
        f.set_attrs({"source_file": "LC09_test", "grid_i": 3})
        f.set_attrs({"sensor": np.bytes_(b"OLI"), "scale": 0.5}, group=GROUP_GEO)
        f.h5["geophysical_data/L_TOA_490"].attrs["units"] = np.bytes_(b"W m-2 sr-1 um-1")
    return path


@pytest.mark.parametrize("flags", [[], ["--full"], ["--by-group"], ["--list-only"],
                                   ["--group", GROUP_GEO], ["--full", "--group", "navigation_data"]])
def test_inspect_nc_text_equals_jax(scene_nc, capsys, flags):
    want, got = _both(capsys, jinspect.main, tinspect.main, [str(scene_nc), *flags])
    assert got == want
    assert got.strip()


@pytest.mark.parametrize("fmt", ["npy", "nc"])
def test_data_stats_json_equals_jax(tmp_path, rng, capsys, fmt):
    stacks = rng.normal(3.0, 0.7, size=(4, 5, 16, 16)).astype(np.float32)
    stacks[0, 0, :2, :2] = np.nan
    for i, s in enumerate(stacks):
        if fmt == "npy":
            np.save(tmp_path / f"p{i}.npy", s)
        else:
            write_band_stack(tmp_path / f"p{i}.nc", GROUP_GEO, s, mode="w")
    want, got = _both(capsys, jstats.main, tstats.main,
                      ["--input-dir", str(tmp_path), "--format", fmt])
    assert got == want
    stats = json.loads(got)
    np.testing.assert_allclose(stats["L_TOA_443"]["mean"], np.nanmean(stacks[:, 0]), rtol=1e-5)


def test_patch_to_rgb_equals_jax(rng):
    stack = rng.uniform(0, 10, (5, 12, 10)).astype(np.float32)
    stack[3, 0, 0] = np.nan
    flat = stack.copy()
    flat[2] = 4.0          # vmax <= vmin
    flat[1] = np.nan       # no finite value
    for s in (stack, flat):
        for idx in ((3, 2, 1), (0, 4, 2)):
            got, want = tvis.patch_to_rgb(s, idx), jvis.patch_to_rgb(s, idx)
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_every_plot_writes_its_png(tmp_path, rng):
    hr = rng.uniform(1, 5, (5, 32, 32)).astype(np.float32)
    blurred = rng.uniform(1, 5, (5, 32, 32)).astype(np.float32)
    noisy = blurred + rng.normal(0, 0.1, blurred.shape).astype(np.float32)
    tvis.plot_train_sample(hr, blurred, noisy, str(tmp_path / "train.png"))
    tvis.plot_hr_vs_degraded(hr, blurred[:, ::4, ::4], str(tmp_path / "hvd.png"))
    tvis.plot_hr_vs_degraded(hr[:1], blurred[:1], str(tmp_path / "hvd1.png"),
                             band_names=("L_TOA_443",))
    tvis.plot_kernels(rng.uniform(0, 1, (5, 13, 13)), str(tmp_path / "k.png"), title="k")
    tvis.plot_kernels(rng.uniform(0, 1, (13, 13)), str(tmp_path / "k2.png"), annotate=True)
    tvis.plot_patch_rgb(hr, str(tmp_path / "rgb.png"), title="p")
    tvis.plot_denoise_comparison(hr[0], blurred[0], str(tmp_path / "dn.png"), "L_TOA_443")
    paths = tvis.plot_moe_bank(rng.uniform(0, 1, (7, 5, 13, 13)),
                               rng.uniform(0.1, 1, (7, 5)), str(tmp_path / "moe"))
    assert [os.path.basename(p) for p in paths] == [
        "moe_kernels_mean.png", "moe_sigmas.png", "moe_kernel_distances.png"]
    for name in ("train", "hvd", "hvd1", "k", "k2", "rgb", "dn"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0, name
    assert all(os.path.getsize(p) > 0 for p in paths)


def _viz_both(capsys, argv, outputs):
    """viz_cli argv through JAX, then the port into the same paths (after
    removing JAX's), each run's printed lines and output files."""
    assert jviz.main(argv) == 0
    want = capsys.readouterr().out
    for o in outputs:
        assert os.path.exists(o), o
        os.remove(o)
    assert tviz.main(argv) == 0
    got = capsys.readouterr().out
    for o in outputs:
        assert os.path.getsize(o) > 0, o
    return want, got


def test_viz_cli_kernels_and_rgb_equal_jax(tmp_path, rng, capsys):
    kdir = tmp_path / "kernels"
    kdir.mkdir()
    np.save(kdir / "kernel_per_band.npy", rng.uniform(0, 1, (5, 13, 13)))
    np.save(kdir / "kernel_merged.npy", rng.uniform(0, 1, (13, 13)))
    np.save(kdir / "not_a_kernel.npy", np.zeros(4))
    out = tmp_path / "kp"
    for extra in ([], ["--annotate"]):
        want, got = _viz_both(capsys, ["kernels", "--input-dir", str(kdir),
                                       "--output-dir", str(out), *extra],
                              [str(out / "kernel_per_band.png"), str(out / "kernel_merged.png")])
        assert got == want and got.count("->") == 2

    pdir = tmp_path / "patches"
    pdir.mkdir()
    for i in range(2):
        np.save(pdir / f"p{i}.npy", rng.uniform(0, 8, (5, 16, 16)).astype(np.float32))
    stack = rng.uniform(0.5, 5, (5, 16, 16)).astype(np.float32)
    stack[0, 0, 0] = np.nan
    write_band_stack(pdir / "one.nc", GROUP_GEO, stack, mode="w")
    vis = pdir / "visualizations"
    want, got = _viz_both(capsys, ["rgb", str(pdir)],
                          [str(vis / f"{n}_rgb.png") for n in ("one", "p0", "p1")])
    assert got == want
    want, got = _viz_both(capsys, ["rgb", str(pdir / "one.nc"), "--output-dir",
                                   str(tmp_path / "rgbo")], [str(tmp_path / "rgbo" / "one_rgb.png")])
    assert got == want


def test_viz_cli_moe_on_the_committed_x4_bank(tmp_path, capsys):
    """The sigma tables and the kernel-diversity line of the committed x4
    MoE bank, as JAX prints them."""
    out = tmp_path / "moe"
    want, got = _viz_both(capsys, ["moe", "--moe-dir", X4_BANK, "--output-dir", str(out)],
                          [str(out / n) for n in ("moe_kernels_mean.png", "moe_sigmas.png",
                                                  "moe_kernel_distances.png")])
    assert got == want
    assert "MoE bank: 10 kernels, 5 bands, 13x13" in got and "kernel diversity" in got


def test_viz_cli_patch_nir_and_hist_equal_jax(tmp_path, rng, capsys):
    f = tmp_path / "p.nc"
    stack = rng.uniform(0.5, 5, (5, 32, 32)).astype(np.float32)
    stack[4, :10] = 50.0  # bright NIR -> masked
    stack[1, 5, 5] = np.nan
    write_band_stack(f, GROUP_GEO, stack, mode="w")
    for argv, outs in (
        (["patch", str(f), "--band-index", "2", "--output", str(tmp_path / "p.png")],
         [str(tmp_path / "p.png")]),
        (["nir", str(f), "--threshold-max", "6.5", "--output", str(tmp_path / "n.png")],
         [str(tmp_path / "n.png")]),
    ):
        want, got = _viz_both(capsys, argv, outs)
        assert got == want
    assert "water" in got

    b = tmp_path / "b.nc"
    write_band_stack(b, GROUP_GEO, rng.normal(4, 1, (5, 24, 24)).astype(np.float32), mode="w")
    pair = tmp_path / "pair.nc"
    write_band_stack(pair, GROUP_HR, rng.normal(3, 1, (5, 24, 24)).astype(np.float32), mode="w")
    write_band_stack(pair, GROUP_LR, rng.normal(3, 1, (5, 3, 3)).astype(np.float32), mode="a")
    for argv in (["hist", str(f), "--file-b", str(b)],
                 ["hist", str(pair), "--group", "hr", "--group-b", "lr", "--density",
                  "--bins", "30", "--band", "L_TOA_555"]):
        out = str(tmp_path / "h.png")
        want, got = _viz_both(capsys, [*argv, "--output", out], [out])
        assert got == want and got.startswith("saved")


def _train_data_inputs(root, rng, n):
    """n files with a `denoised` 5x64x64 and a `blurred` 5x8x8 group and
    navigation lat/lon, and a [6, 5, 8, 8] noise pool."""
    indir = root / "blurred"
    indir.mkdir()
    for i in range(n):
        p = indir / f"patch_{i:03d}.nc"
        write_band_stack(p, GROUP_DENOISED, rng.uniform(1, 5, (5, 64, 64)).astype(np.float32),
                         mode="w")
        write_band_stack(p, GROUP_BLURRED, rng.uniform(1, 5, (5, 8, 8)).astype(np.float32),
                         mode="a")
        with NCFile(p, "a") as f:
            f.create_variable("navigation_data", "latitude",
                              np.full((64, 64), 30.0 + i, np.float32), dims=("y", "x"))
    pool = root / "pool.npy"
    np.save(pool, rng.normal(0, 0.1, (6, 5, 8, 8)).astype(np.float32))
    return indir, pool


@pytest.mark.parametrize("with_vis", [False, True])
def test_make_train_data_vis_dir_equals_jax(tmp_path, rng, monkeypatch, with_vis):
    """hr / lr bit-equal to JAX's run with the same seed, with and without
    --vis-dir (the QA draw comes first from the same generator, so it
    shifts every noise draw alike), and the same <base>_qa.png names; the
    cap on figures is cut from 30 to 3 in both packages to keep the run
    short."""
    assert tmake.MAX_VIS_SAMPLES == jmake.MAX_VIS_SAMPLES == 30
    monkeypatch.setattr(jmake, "MAX_VIS_SAMPLES", 3)
    monkeypatch.setattr(tmake, "MAX_VIS_SAMPLES", 3)
    indir, pool = _train_data_inputs(tmp_path, rng, 7)
    outs = {}
    for name, mod in (("jax", jmake), ("port", tmake)):
        argv = ["--input-dir", str(indir), "--noise-pool", str(pool), "--output-dir",
                str(tmp_path / name), "--hr-size", "64", "--lr-size", "8", "--seed", "7"]
        if with_vis:
            argv += ["--vis-dir", str(tmp_path / f"{name}_vis")]
        assert mod.main(argv) == 0
        outs[name] = sorted((tmp_path / name).glob("*_train.nc"))
    assert [p.name for p in outs["port"]] == [p.name for p in outs["jax"]]
    assert len(outs["port"]) == 7
    for got, want in zip(outs["port"], outs["jax"]):
        for group in (GROUP_HR, GROUP_LR):
            assert np.array_equal(read_band_stack(got, group), read_band_stack(want, group),
                                  equal_nan=True), (got.name, group)
        with NCFile(got) as g, NCFile(want) as w:
            assert np.array_equal(g.variable("navigation_data", "latitude"),
                                  w.variable("navigation_data", "latitude"))
    if with_vis:
        qa = {n: sorted(p.name for p in (tmp_path / f"{n}_vis").glob("*_qa.png"))
              for n in ("jax", "port")}
        assert qa["port"] == qa["jax"] and len(qa["port"]) == 3
        assert all((tmp_path / "port_vis" / n).stat().st_size > 0 for n in qa["port"])
