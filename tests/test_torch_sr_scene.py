"""Port parity: whole-scene SR through exact halo tiling
(`kmsr_tpu_torch.pipeline.sr_scene` vs `kmsr_tpu.pipeline.sr_scene`) on
the CPU.

The claim under test, as in tests/test_sr_scene.py: the tiled
reconstruction equals the untiled forward (float32, atol 2e-5 / rtol
1e-5: reduction-order noise), not a blend. Against JAX's `sr_scene` on
the same scene and weights: float32 at rtol 1e-4 / atol 1e-5, bfloat16
no further from JAX's bfloat16 than twice JAX's own bfloat16-vs-float32
distance; NaN cells identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu.io.ncio import NCFile, read_band_stack, write_band_stack
from kmsr_tpu.models import sr as jsr
from kmsr_tpu.pipeline import sr_scene as jscene
from kmsr_tpu.utils.params_io import save_params
from kmsr_tpu_torch import convert
from kmsr_tpu_torch.models import sr as tsr
from kmsr_tpu_torch.pipeline import sr_scene as tscene

KW = dict(width=8, n_blocks=2, factor=4)
JCFG, CFG = jsr.SRConfig(**KW), tsr.SRConfig(**KW)
TILED = dict(atol=2e-5, rtol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jsr.init_sr(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def sr_params(jax_params):
    return convert.sr_from_jax(jax_params, "cpu")


def _global(params, scene):
    """The untiled float32 forward of the band-mean-filled scene."""
    filled = tscene._band_filled(scene, np.isfinite(scene))
    return tsr.sr_forward(params, torch.from_numpy(filled)[None], CFG,
                          compute_dtype=torch.float32)[0].numpy()


def _tiled(params, scene, **kw):
    return tscene.sr_scene(params, scene, CFG, compute_dtype=torch.float32,
                           device="cpu", **kw)


@pytest.mark.parametrize("shape,tile,chunk", [
    ((5, 48, 80), 32, 3),     # 2x3 tiles, last chunk padded
    ((5, 50, 70), 32, 4),     # 50, 70 not multiples of 32: shifted last tiles
    ((5, 20, 24), 64, 32),    # scene smaller than the tile: one slab
])
def test_tiled_equals_untiled(sr_params, shape, tile, chunk):
    scene = np.random.default_rng(sum(shape)).normal(3, 1, shape).astype(np.float32)
    got = _tiled(sr_params, scene, tile=tile, chunk=chunk)
    assert got.shape == (5, shape[1] * 4, shape[2] * 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, _global(sr_params, scene), **TILED)


def test_insufficient_halo_breaks_exactness(sr_params):
    """The receptive-field bound matters: a halo of 1 must not reproduce
    the untiled forward (else the test above is vacuous)."""
    scene = np.random.default_rng(2).normal(3, 1, (5, 48, 48)).astype(np.float32)
    got = _tiled(sr_params, scene, tile=16, halo=1)
    assert not np.allclose(got, _global(sr_params, scene), atol=2e-5)
    assert tscene.receptive_halo(CFG) == 8 == jscene.receptive_halo(JCFG)


def test_nan_footprint_restored(sr_params):
    scene = np.random.default_rng(3).normal(3, 1, (5, 40, 40)).astype(np.float32)
    scene[:, 10:14, 20:22] = np.nan
    scene[2] = np.nan  # an all-NaN band: filled with 0 for the network
    got = _tiled(sr_params, scene, tile=32)
    f = CFG.factor
    assert np.isnan(got[:, 10 * f:14 * f, 20 * f:22 * f]).all() and np.isnan(got[2]).all()
    np.testing.assert_array_equal(np.isnan(got),
                                  np.isnan(scene).repeat(f, axis=1).repeat(f, axis=2))
    ok = ~np.isnan(got)
    np.testing.assert_allclose(got[ok], _global(sr_params, scene)[ok], **TILED)


@pytest.mark.parametrize("shape,tile,chunk", [((5, 50, 70), 32, 4), ((5, 40, 40), 16, 5)])
def test_matches_jax_sr_scene(jax_params, sr_params, shape, tile, chunk):
    scene = np.random.default_rng(shape[1]).normal(3, 1, shape).astype(np.float32)
    scene[:, 5:9, 30:33] = np.nan
    want = {dt: jscene.sr_scene(jax_params, scene, JCFG, tile=tile, chunk=chunk,
                                compute_dtype=dt) for dt in (jnp.float32, jnp.bfloat16)}
    got32 = _tiled(sr_params, scene, tile=tile, chunk=chunk)
    np.testing.assert_array_equal(np.isnan(got32), np.isnan(want[jnp.float32]))
    np.testing.assert_allclose(got32, want[jnp.float32], **TOL)
    got16 = tscene.sr_scene(sr_params, scene, CFG, tile=tile, chunk=chunk, device="cpu")
    np.testing.assert_array_equal(np.isnan(got16), np.isnan(want[jnp.bfloat16]))
    ok = ~np.isnan(got16)
    jax_own = np.abs(want[jnp.bfloat16] - want[jnp.float32])[ok].max()
    assert np.abs(got16 - want[jnp.bfloat16])[ok].max() <= 2 * jax_own


def test_sr_scene_cli_matches_jax(tmp_path, jax_params):
    rng = np.random.default_rng(5)
    for name in ("a", "b"):
        scene = rng.normal(3, 1, (5, 40, 36)).astype(np.float32)
        scene[:, :3, :4] = np.nan
        write_band_stack(str(tmp_path / f"{name}.nc"), "lr", scene, mode="w")
    save_params(str(tmp_path / "sr_model.npz"), jax_params)
    args = ["--input", str(tmp_path), "--model", str(tmp_path / "sr_model.npz"),
            "--factor", "4", "--width", "8", "--n-blocks", "2", "--tile", "16",
            "--chunk", "4"]
    assert jscene.main(args + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert tscene.main(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    for name in ("a.nc", "b.nc"):
        want = read_band_stack(str(tmp_path / "jax" / name), "sr")
        got = read_band_stack(str(tmp_path / "port" / name), "sr")
        assert got.shape == want.shape == (5, 160, 144)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        scene = read_band_stack(str(tmp_path / name), "lr")
        y32 = jscene.sr_scene(jax_params, scene, JCFG, tile=16, chunk=4,
                              compute_dtype=jnp.float32)
        ok = ~np.isnan(got)
        assert np.abs(got - want)[ok].max() <= 2 * np.abs(want - y32)[ok].max()
        with NCFile(str(tmp_path / "port" / name)) as f:
            attrs = f.get_attrs("sr")
            assert f.has_group("lr")
        assert attrs["source_group"] == "lr" and int(attrs["tile"]) == 16
        assert int(attrs["halo"]) == 8 and attrs["model"] == "sr_model.npz"
    # --data-parallel (a plain process is a one-rank mesh) writes the same
    assert tscene.main(args + ["--output-dir", str(tmp_path / "dp"), "--device", "cpu",
                               "--data-parallel"]) == 0
    for name in ("a.nc", "b.nc"):
        np.testing.assert_array_equal(read_band_stack(str(tmp_path / "dp" / name), "sr"),
                                      read_band_stack(str(tmp_path / "port" / name), "sr"))
