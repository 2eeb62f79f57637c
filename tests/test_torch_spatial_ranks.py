"""The whole scene across ranks, on the CPU: a 4-rank gloo world against
JAX's `degrade_scene_sharded` / `degrade_scene` on a 4-device CPU mesh.

Each rank holds one row slab and swaps its halo rows with its neighbours
(`parallel.spatial._rank_halo`, `dist.batch_isend_irecv`); the rows are
all-gathered. The cases (`tests/helpers/dp_jobs.SCENE_CASES`): the
small-kernel case of `tests/test_spatial.py` (k=5, f=4), the repo's 13x13
kernel at x8, the 'bands' local path, NaN cells (the same NaN footprint
as JAX's), and two uneven shapes through the shape-tolerant
`degrade_scene`. Tolerance rtol 1e-4 / atol 1e-5 (`tests/test_spatial.py`).
The same world runs the scene stage (`pipeline.degrade_scene.
process_scenes`) on a NaN-masked uneven `.nc` scene: each rank reads only
its slab, and rank 0's file equals the one-process stage's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from kmsr_tpu.parallel.spatial import degrade_scene as j_scene
from kmsr_tpu.parallel.spatial import degrade_scene_sharded as j_sharded
from kmsr_tpu_torch.io.ncio import read_band_stack, write_band_stack
from kmsr_tpu_torch.pipeline.degrade_scene import process_scenes
from tests.helpers import dp_jobs
from tests.helpers.dist_world import run_world

TOL = dict(rtol=1e-4, atol=1e-5)
WORLD = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(4)
    (tmp / "scenes").mkdir()
    scene = rng.normal(5, 1, (5, 75, 77)).astype(np.float32)
    scene[:, 40:60, 10:30] = np.nan
    scene[3] = np.nan  # a dead band
    write_band_stack(str(tmp / "scenes" / "s.nc"), "geophysical_data", scene, mode="w")
    np.save(tmp / "k.npy", rng.uniform(0, 1, (5, 13, 13)).astype(np.float32))
    return run_world(dp_jobs.scene_world, WORLD, tmp / "world", str(tmp)), tmp


def _jax(name, shape, k, f, impl, entry):
    scene, kernel = dp_jobs.scene_inputs(name, shape, k)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    fn = j_sharded if entry == "sharded" else j_scene
    # one jit: eager shard_map dispatch costs ~25 s a call on a CPU host
    run = jax.jit(lambda s, kk: fn(s, kk, mesh, factor=f, impl=impl))
    return np.asarray(run(jnp.asarray(scene), jnp.asarray(kernel)))


@pytest.mark.parametrize("case", dp_jobs.SCENE_CASES, ids=[c[0] for c in dp_jobs.SCENE_CASES])
def test_ranks_match_jax_mesh(world, case):
    ranks, _ = world
    want = _jax(*case)
    got = ranks[0][case[0]]
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if case[0] == "nan_cells":
        assert np.isnan(want).any() and not np.isnan(want).all()
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], **TOL)
    for r in range(1, WORLD):  # the rows are all-gathered: every rank has them
        np.testing.assert_array_equal(ranks[r][case[0]], got)


def test_scene_stage_over_ranks_matches_one_process(world):
    """process_scenes with one slab a rank on a 75x77 NaN-masked scene with
    a dead band (72 rows kept, padded to 96: the last rank's slab is edge
    rows only, and it adds the 3 rows past the last whole block to the
    band means): rank 0 writes the file once, equal to the one-process
    stage's, NaN cells identical."""
    ranks, tmp = world
    assert [r["stage"] for r in ranks] == [(1, 0)] * WORLD
    rep = process_scenes(str(tmp / "scenes"), str(tmp / "k.npy"), str(tmp / "one"),
                         device="cpu")
    assert rep.n_ok == 1
    got = read_band_stack(str(tmp / "out" / "s_blurred.nc"), "blurred")
    want = read_band_stack(str(tmp / "one" / "s_blurred.nc"), "blurred")
    assert got.shape == want.shape == (5, 9, 9)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[3]).all() and np.isnan(want).sum() > 9 * 9
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], **TOL)
