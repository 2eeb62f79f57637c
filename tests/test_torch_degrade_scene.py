"""Port parity: the whole-scene degrade CLI, kmsr_tpu_torch vs kmsr_tpu.

Both packages' `pipeline.degrade_scene.main` on the same NaN-masked scene
`.nc` (the port with `--device cpu`, its plain path): the same output
file, groups, per-band attrs and NaN cells, and values within rtol 1e-4 /
atol 1e-5 (`tests/test_spatial.py`).
"""
import numpy as np
import pytest

from kmsr_tpu.io.ncio import NCFile as JNCFile
from kmsr_tpu.io.ncio import read_band_stack as j_read
from kmsr_tpu.io.ncio import write_band_stack as j_write
from kmsr_tpu.io.schema import GROUP_BLURRED, GROUP_GEO
from kmsr_tpu.pipeline.degrade_scene import main as j_main
from kmsr_tpu_torch.pipeline.degrade_scene import degrade_scene_file, main

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def scene_file(tmp_path, rng):
    scene = rng.normal(5, 2, size=(5, 144, 80)).astype(np.float32)
    scene[:, :16, :16] = np.nan   # two whole 8x8 cells each way: NaN out
    scene[:, 16:19, 40:70] = np.nan  # partly masked cells: finite out
    scene[2, 100:, 72:] = np.nan
    path = tmp_path / "scene.nc"
    j_write(str(path), GROUP_GEO, scene, mode="w")
    np.save(tmp_path / "k.npy", rng.uniform(0, 1, size=(13, 13)).astype(np.float32))
    return path, scene


def _attrs(path, group):
    with JNCFile(path, "r") as f:
        return sorted(f.groups), {k: v for k, v in f.get_attrs(group).items()
                                  if k != "history"}


def test_cli_matches_jax_cli(tmp_path, scene_file):
    path, scene = scene_file
    args = ["--input", str(path), "--kernel", str(tmp_path / "k.npy")]
    assert j_main(args + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert main(args + ["--output-dir", str(tmp_path / "port"),
                        "--device", "cpu"]) == 0
    want_path = tmp_path / "jax" / "scene_blurred.nc"
    got_path = tmp_path / "port" / "scene_blurred.nc"
    want = j_read(str(want_path), GROUP_BLURRED)
    got = j_read(str(got_path), GROUP_BLURRED)
    assert got.shape == want.shape == (5, 18, 10)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, :2, :2]).all() and np.isnan(got).sum() > 20
    np.testing.assert_allclose(got, want, **TOL)
    assert _attrs(got_path, GROUP_BLURRED) == _attrs(want_path, GROUP_BLURRED)
    np.testing.assert_array_equal(j_read(str(got_path), GROUP_GEO), scene)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_scene_file_without_nan_and_all_nan_band(rng, n_shards):
    """No NaN: a plain degrade; an all-NaN band comes out all NaN while
    the other bands stay finite (its fill is 0, as in JAX); 4 row slabs
    give the same result as one."""
    import torch

    scene = rng.normal(5, 2, size=(5, 256, 64)).astype(np.float32)
    k = torch.from_numpy(rng.uniform(0, 1, size=(5, 13, 13)).astype(np.float32))
    clean = degrade_scene_file(scene, k, 8)
    assert clean.shape == (5, 32, 8) and np.isfinite(clean).all()
    scene[1] = np.nan
    out = degrade_scene_file(scene, k, 8, n_shards=n_shards)
    assert np.isnan(out[1]).all()
    np.testing.assert_allclose(out[[0, 2, 3, 4]], clean[[0, 2, 3, 4]], **TOL)
