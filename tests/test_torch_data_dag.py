"""Port parity of the data DAG's front half: cut, noise pool, denoise CLI,
check_shapes, and the port's own chain through them.

Each stage of the port runs on the same tiny seeded `.nc` folder as its
JAX counterpart: the cutter's files, groups, attrs and arrays are
identical; the noise pool is bit-identical, metadata included; the denoise
CLI's torch path (`--device cpu`) is within rtol 1e-4 / atol 1e-5 of JAX's
numpy reference, with the same attrs and sigmas within 1e-3, and the
port's `--cpu-reference` equals JAX's exactly.
"""
import os

import numpy as np
import pytest
import torch

from kmsr_tpu.data import mask as jmask
from kmsr_tpu.data import noise_pool as jnoise
from kmsr_tpu.data import patches as jpatches
from kmsr_tpu.io import read_band_stack as j_read
from kmsr_tpu.pipeline import check_shapes as jcheck
from kmsr_tpu.pipeline import cut as jcut
from kmsr_tpu.pipeline import denoise_cli as jden
from kmsr_tpu.pipeline import noise_pool_cli as jpool
from kmsr_tpu_torch.data import mask as tmask
from kmsr_tpu_torch.data import noise_pool as tnoise
from kmsr_tpu_torch.data import patches as tpatches
from kmsr_tpu_torch.io import (
    BAND_NAMES,
    GROUP_DENOISED,
    GROUP_GEO,
    GROUP_LR,
    NCFile,
    read_band_stack,
    write_band_stack,
)
from kmsr_tpu_torch.pipeline import check_shapes as tcheck
from kmsr_tpu_torch.pipeline import cut as tcut
from kmsr_tpu_torch.pipeline import denoise_cli as tden
from kmsr_tpu_torch.pipeline import factory as tfactory
from kmsr_tpu_torch.pipeline import noise_pool_cli as tpool

TOL = dict(rtol=1e-4, atol=1e-5)


def _scene(path, rng, h=80, w=72):
    """A 5-band scene .nc with navigation rasters, a land strip (NIR out of
    the water thresholds) and an invalid pixel."""
    scene = rng.uniform(0.5, 5.0, (5, h, w)).astype(np.float32)
    scene[4] = rng.uniform(0.5, 1.5, (h, w))
    scene[4, :, -10:] = 100.0
    scene[0, 3, 3] = -9999.0
    write_band_stack(path, GROUP_GEO, scene, mode="w")
    with NCFile(path, "a") as f:
        for k, v in {"latitude": 30.0, "longitude": 120.0}.items():
            raster = (v + np.arange(h * w).reshape(h, w) / (h * w)).astype(np.float32)
            f.create_variable("navigation_data", k, raster, dims=("y", "x"))
    return scene


def _tree(path):
    """{group: (attrs, {var: array})} and the root attrs of one .nc file."""
    with NCFile(path, "r") as f:
        out = {"": (f.get_attrs(), {})}
        for g in f.groups:
            grp = f.group(g)
            out[g] = (f.get_attrs(group=g), {k: np.asarray(grp[k]) for k in grp})
    return out


def _assert_same_tree(a, b):
    assert sorted(a) == sorted(b)
    for g in a:
        assert a[g][0] == b[g][0], g
        assert sorted(a[g][1]) == sorted(b[g][1]), g
        for k in a[g][1]:
            np.testing.assert_array_equal(a[g][1][k], b[g][1][k])


@pytest.fixture
def scenes(tmp_path):
    d = tmp_path / "scenes"
    d.mkdir()
    rng = np.random.default_rng(11)
    for name in ("sceneA", "sceneB_2021_01"):
        _scene(d / f"{name}.nc", rng)
    return d


@pytest.mark.parametrize("fmt,group", [("nc", "geophysical_data"), ("nc", "hr"),
                                       ("npy", "geophysical_data")])
def test_cut_matches_jax(tmp_path, scenes, fmt, group):
    argv = ["--input-dir", str(scenes), "--patch-size", "32", "--stride-ratio", "0.5",
            "--format", fmt, "--group", group]
    assert jcut.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    assert tcut.main(argv + ["--output-dir", str(tmp_path / "t")]) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names and names == sorted(os.listdir(tmp_path / "t"))
    for n in names:
        if fmt == "npy":
            np.testing.assert_array_equal(np.load(tmp_path / "t" / n),
                                          np.load(tmp_path / "j" / n))
        else:
            _assert_same_tree(_tree(tmp_path / "t" / n), _tree(tmp_path / "j" / n))


def test_mask_gate_and_grid_match_jax():
    rng = np.random.default_rng(12)
    data = rng.uniform(0.5, 5.0, (5, 70, 66)).astype(np.float32)
    data[4, :20] = 100.0
    data[1, 40, 40] = -9999.0
    (tm, ts), (jm, js) = tmask.apply_water_mask(data), jmask.apply_water_mask(data)
    np.testing.assert_array_equal(tm, jm)
    assert (ts.total_valid, ts.water_pixels, ts.water_ratio) == \
        (js.total_valid, js.water_pixels, js.water_ratio)
    np.testing.assert_array_equal(tmask.invalid_to_nan(data), jmask.invalid_to_nan(data))
    for got, want in zip(tpatches.cut_scene(tm, 32, 16), jpatches.cut_scene(jm, 32, 16)):
        np.testing.assert_array_equal(got, want)
    patches = tpatches.cut_scene(tm, 32, 16)[0]
    for thr in (0.0, 0.1, 1.0):
        np.testing.assert_array_equal(tpatches.nan_ratio_gate(patches, thr),
                                      jpatches.nan_ratio_gate(patches, thr))
    cfg_t, cfg_j = tpatches.CutConfig(patch_size=32), jpatches.CutConfig(patch_size=32)
    kept_t, kept_j = (list(tpatches.iter_kept_patches(tm, cfg_t)),
                      list(jpatches.iter_kept_patches(jm, cfg_j)))
    assert [k[1:] for k in kept_t] == [k[1:] for k in kept_j]
    for a, b in zip(kept_t, kept_j):
        np.testing.assert_array_equal(a[0], b[0])
    files = ["/x/sceneA_000_001.nc", "/x/sceneA_001_000_denoised.nc",
             "/x/LC08_115035_20210317_002_003_train.nc", "/x/odd.nc",
             "/x/scene_2021_01_010_1000_denoised_train.nc"]
    assert [tpatches.scene_prefix(f) for f in files] == \
        [jpatches.scene_prefix(f) for f in files]
    assert tpatches.group_by_scene(files) == jpatches.group_by_scene(files)


def _denoised_folder(d, rng, n=3, hw=24, corrupt=False):
    d.mkdir()
    for i in range(n):
        raw = rng.normal(3.0, 0.3, (5, hw, hw)).astype(np.float32)
        write_band_stack(d / f"p{i}.nc", GROUP_GEO, raw, mode="w")
        write_band_stack(d / f"p{i}.nc", GROUP_DENOISED,
                         raw - rng.normal(0, 0.05, raw.shape).astype(np.float32), mode="a")
    if corrupt:
        (d / "p9_bad.nc").write_bytes(b"not an hdf5 file")
    return d


@pytest.mark.parametrize("corrupt", [False, True])
def test_noise_pool_cli_matches_jax(tmp_path, corrupt):
    d = _denoised_folder(tmp_path / "den", np.random.default_rng(13), corrupt=corrupt)
    argv = ["--input-dir", str(d), "--samples-per-file", "3", "--patch-size", "8",
            "--seed", "5"]
    rc_j = jpool.main(argv + ["--output-file", str(tmp_path / "j.npy"),
                              "--metadata-file", str(tmp_path / "jm.npy")])
    rc_t = tpool.main(argv + ["--output-file", str(tmp_path / "t.npy"),
                              "--metadata-file", str(tmp_path / "tm.npy")])
    assert rc_t == rc_j == (1 if corrupt else 0)
    pool_t, pool_j = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert pool_t.shape == (9, 5, 8, 8) and pool_t.dtype == np.float32
    np.testing.assert_array_equal(pool_t, pool_j)
    assert list(np.load(tmp_path / "tm.npy", allow_pickle=True)) == \
        list(np.load(tmp_path / "jm.npy", allow_pickle=True))
    assert tnoise.noise_pool_stats(pool_t) == jnoise.noise_pool_stats(pool_j)


def test_noise_crops_in_memory_equal_the_folder_build(tmp_path):
    """noise_crops on arrays draws what build_noise_pool draws from files."""
    d = _denoised_folder(tmp_path / "den", np.random.default_rng(14))
    res = tnoise.build_noise_pool(str(d), samples_per_file=2, crop_size=8, seed=3,
                                  verbose=False)
    rng = np.random.default_rng(3)
    crops = []
    for i in range(3):
        p = str(d / f"p{i}.nc")
        crops += tnoise.noise_crops(rng, read_band_stack(p, GROUP_GEO),
                                    read_band_stack(p, GROUP_DENOISED), 8, 2)
    np.testing.assert_array_equal(np.stack(crops).astype(np.float32), res.pool)
    assert not res.failures and len(res.metadata) == 6


def test_sample_noise_device():
    pool = torch.arange(7 * 2 * 3 * 3, dtype=torch.float32).reshape(7, 2, 3, 3)
    gen = torch.Generator().manual_seed(0)
    got = tnoise.sample_noise_device(gen, pool, 20)
    assert got.shape == (20, 2, 3, 3)
    idx = (got[:, 0, 0, 0] / 18).long()
    assert torch.equal(got, pool[idx])
    again = tnoise.sample_noise_device(torch.Generator().manual_seed(0), pool, 20)
    assert torch.equal(got, again)


def _patch_folder(d, rng, shapes):
    d.mkdir()
    for i, hw in enumerate(shapes):
        a = rng.normal(3.0, 0.3, (5, hw, hw)).astype(np.float32)
        if i == 1:
            a[2, 2:6, 3:9] = np.nan
        write_band_stack(d / f"p{i}.nc", GROUP_GEO, a, mode="w")
    return d


def _den_group(path):
    with NCFile(path, "r") as f:
        attrs = f.get_attrs(group=GROUP_DENOISED)
    return read_band_stack(path, GROUP_DENOISED), attrs


def test_denoise_cli_batch_matches_jax_cpu_reference(tmp_path, capsys):
    """Port `--batch --device cpu` (torch path, device_batch 2; the odd
    20x20 file takes the per-file path on the same device) vs JAX
    `--batch --cpu-reference`; the port's output reads back through the
    JAX package's io."""
    src = _patch_folder(tmp_path / "in", np.random.default_rng(15), (24, 24, 24, 20))
    jo, to = tmp_path / "j", tmp_path / "t"
    assert jden.main(["--batch", str(src), "--output", str(jo), "--cpu-reference"]) == 0
    report = tden.batch_denoise(str(src), str(to), device_batch=2, progress=False,
                                device="cpu")
    assert report.n_fail == 0 and report.n_ok == 4 and report.fallbacks == 1
    assert "1 per-file fallbacks" in capsys.readouterr().out
    assert tden.main(["--batch", str(src), "--output", str(tmp_path / "t2"),
                      "--device", "cpu"]) == 0
    names = sorted(os.listdir(jo))
    assert names == sorted(os.listdir(to)) == sorted(os.listdir(tmp_path / "t2"))
    assert names == [f"p{i}_denoised.nc" for i in range(4)]
    for n in names:
        (got, attrs), (want, want_attrs) = _den_group(to / n), _den_group(jo / n)
        np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert sorted(attrs) == sorted(want_attrs)
        for k, v in want_attrs.items():
            if isinstance(v, str):
                assert attrs[k] == v
            else:
                assert attrs[k] == pytest.approx(v, rel=1e-3), k
        assert {f"{b}_{x}" for b in BAND_NAMES for x in ("sigma", "h")} <= set(attrs)
        np.testing.assert_array_equal(j_read(to / n, GROUP_DENOISED), got)
        np.testing.assert_array_equal(j_read(to / n, GROUP_GEO), j_read(jo / n, GROUP_GEO))
        # chunks of 2 vs one of 3: the same images, swept in batches of another size
        np.testing.assert_allclose(_den_group(tmp_path / "t2" / n)[0], got,
                                   rtol=1e-6, atol=1e-6, equal_nan=True)


def test_denoise_cli_cpu_reference_equals_jax(tmp_path):
    src = _patch_folder(tmp_path / "in", np.random.default_rng(16), (20, 20))
    for mod, out in ((jden, "j"), (tden, "t")):
        assert mod.main(["--batch", str(src), "--output", str(tmp_path / out),
                         "--cpu-reference", "--h-factor", "1.0"]) == 0
        assert mod.main([str(src / "p1.nc"), "--output", str(tmp_path / f"{out}1"),
                         "--cpu-reference"]) == 0
    for a, b in (("t", "j"), ("t1", "j1")):
        for n in sorted(os.listdir(tmp_path / b)):
            _assert_same_tree(_tree(tmp_path / a / n), _tree(tmp_path / b / n))


def test_denoise_cli_compare_and_plot(tmp_path):
    src = _patch_folder(tmp_path / "in", np.random.default_rng(17), (16,))
    out = tmp_path / "out"
    assert tden.main([str(src / "p0.nc"), "--output", str(out), "--plot",
                      "--device", "cpu"]) == 0
    plots = sorted(os.listdir(out / "plots"))
    assert plots == sorted(f"p0_{b}_compare.png" for b in BAND_NAMES)
    png = tmp_path / "cmp.png"
    assert tden.main(["--compare", str(out / "p0_denoised.nc"), "--band", BAND_NAMES[1],
                      "--output", str(png)]) == 0
    assert png.stat().st_size > 0
    stats = tden.compare_denoised(str(out / "p0_denoised.nc"), BAND_NAMES[1],
                                  str(tmp_path / "cmp2.png"))
    assert stats["rmse"] > 0 and stats["sigma"] > 0 and stats["h"] == pytest.approx(
        1.8 * stats["sigma"])


def test_check_shapes_rc_matches_jax(tmp_path):
    good, bad = tmp_path / "good", tmp_path / "bad"
    good.mkdir()
    bad.mkdir()
    rng = np.random.default_rng(18)
    for i in range(2):
        write_band_stack(good / f"g{i}.nc", GROUP_LR, rng.normal(size=(5, 8, 8)), mode="w")
    write_band_stack(bad / "b0.nc", GROUP_LR, rng.normal(size=(5, 8, 8)), mode="w")
    write_band_stack(bad / "b1.nc", GROUP_LR, rng.normal(size=(5, 8, 6)), mode="w")
    write_band_stack(bad / "b2.nc", GROUP_GEO, rng.normal(size=(5, 8, 8)), mode="w")
    for d, args in ((good, ["--group", "lr", "--size", "8"]),
                    (bad, ["--group", "lr", "--size", "8"]),
                    (good, [])):
        argv = ["--input-dir", str(d), *args]
        assert tcheck.main(argv) == jcheck.main(argv)
    assert tcheck.main(["--input-dir", str(good), "--group", "lr", "--size", "8"]) == 0
    assert tcheck.main(["--input-dir", str(bad), "--group", "lr", "--size", "8"]) == 1
    assert tcheck.check_folder(str(bad), "lr", 8)["bad"] == \
        jcheck.check_folder(str(bad), "lr", 8)["bad"]


def test_port_chain_cut_denoise_pool_factory_check(tmp_path, scenes):
    """The default single-kernel DAG's data stages through the port's own
    CLIs, on the CPU: cut -> denoise -> noise_pool -> factory ->
    check_shapes, every rc 0."""
    patches, den, pairs = tmp_path / "patches", tmp_path / "den", tmp_path / "pairs"
    assert tcut.main(["--input-dir", str(scenes), "--output-dir", str(patches),
                      "--patch-size", "32"]) == 0
    n = len(os.listdir(patches))
    assert n >= 4
    assert tden.main(["--batch", str(patches), "--output", str(den), "--device", "cpu",
                      "--h-factor", "1.0"]) == 0
    assert len(os.listdir(den)) == n
    pool = tmp_path / "pool.npy"
    assert tpool.main(["--input-dir", str(den), "--output-file", str(pool),
                       "--patch-size", "4", "--samples-per-file", "2"]) == 0
    assert np.load(pool).shape == (2 * n, 5, 4, 4)
    k = np.random.default_rng(19).uniform(0.1, 1, (5, 13, 13)).astype(np.float32)
    np.save(tmp_path / "k.npy", k)
    assert tfactory.main(["--input-dir", str(den), "--kernel", str(tmp_path / "k.npy"),
                          "--noise-pool", str(pool), "--output-dir", str(pairs),
                          "--device", "cpu"]) == 0
    assert len(os.listdir(pairs)) == n
    assert tcheck.main(["--input-dir", str(pairs), "--group", "lr", "--size", "4"]) == 0
