"""Port parity: kmsr_tpu_torch.parallel.spatial vs kmsr_tpu.parallel.spatial.

The port's `n_shards` row slabs (run one after another, each with the halo
rows its JAX shard would get) against JAX `degrade_scene_sharded` on a mesh
of n of the 8 virtual CPU devices, at a small span (k=5, f=4) so the
shard_map compiles stay cheap; the port runs its plain path on the CPU.
Tolerance rtol 1e-4 / atol 1e-5 (`tests/test_spatial.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kmsr_tpu.ops import degrade as j_degrade
from kmsr_tpu.parallel.spatial import degrade_scene_sharded as j_sharded
from kmsr_tpu_torch.parallel.spatial import degrade_scene, degrade_scene_sharded

TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_sharded(scene, kernel, n, factor, impl="fast"):
    """JAX `degrade_scene_sharded` on a mesh of n CPU devices, under one
    jit (eager shard_map dispatch costs ~25 s a call on a CPU host)."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    fn = jax.jit(lambda s, k: j_sharded(s, k, mesh, factor=factor, impl=impl))
    return np.asarray(fn(jnp.asarray(scene), jnp.asarray(kernel)))


# (2, 128, 32): 128/n >= 2*K (K = 8) for every n, JAX's 'fast' path;
# (2, 16, 32): 16/n < 16 for n = 2, 4, where JAX switches to 'bands'
# and the port's 'fast' path still takes the slabs as they are
@pytest.mark.parametrize("shape", [(2, 128, 32), (2, 16, 32)])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_matches_jax_mesh(rng, shape, n):
    scene = rng.normal(5, 2, shape).astype(np.float32)
    kernel = rng.uniform(0, 1, (shape[0], 5, 5)).astype(np.float32)
    want = _jax_sharded(scene, kernel, n, factor=4)
    got = degrade_scene_sharded(torch.from_numpy(scene), torch.from_numpy(kernel),
                                n_shards=n, factor=4)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_thin_slabs_stay_on_fast_path(rng, monkeypatch, n):
    """Slabs thinner than 2*K rows go through `degrade_rows_fast`, one
    call a slab: no shape-triggered switch to the 'bands' conv."""
    import kmsr_tpu_torch.parallel.spatial as S

    calls = []
    real = S.degrade_rows_fast
    monkeypatch.setattr(S, "degrade_rows_fast",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(S, "depthwise_conv2d", None)  # 'bands' would fail
    scene = torch.from_numpy(rng.normal(5, 2, (2, 16, 32)).astype(np.float32))
    kernel = torch.from_numpy(rng.uniform(0, 1, (2, 5, 5)).astype(np.float32))
    got = S.degrade_scene_sharded(scene, kernel, n_shards=n, factor=4)
    assert len(calls) == n
    want = np.asarray(j_degrade(jnp.asarray(scene.numpy()),
                                jnp.asarray(kernel.numpy()), factor=4))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bands_matches_jax_and_fast(rng):
    """impl='bands' (the extended-slab conv) on a shape the fast path
    would take, against JAX 'bands' and the port's own fast path."""
    scene = rng.normal(5, 2, (2, 64, 32)).astype(np.float32)
    kernel = rng.uniform(0, 1, (2, 5, 5)).astype(np.float32)
    want = _jax_sharded(scene, kernel, 2, factor=4, impl="bands")
    x, k = torch.from_numpy(scene), torch.from_numpy(kernel)
    got = degrade_scene_sharded(x, k, n_shards=2, factor=4, impl="bands")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        degrade_scene_sharded(x, k, n_shards=2, factor=4).numpy(), want, **TOL)


@pytest.mark.parametrize("n", [1, 4])
def test_degrade_scene_uneven_shape_matches_jax_degrade(rng, n):
    """H not a multiple of n_shards*factor (edge-row padding, n=4) and W
    with a sub-factor remainder (cropped): equal to JAX `ops.degrade` of
    the crop, as `tests/test_spatial.py` holds JAX's own wrapper."""
    scene = rng.normal(5, 2, size=(5, 158, 69)).astype(np.float32)
    kernel = rng.uniform(0, 1, size=(5, 5, 5)).astype(np.float32)
    want = np.asarray(j_degrade(jnp.asarray(scene[:, :156, :68]),
                                jnp.asarray(kernel), factor=4))
    got = degrade_scene(torch.from_numpy(scene), torch.from_numpy(kernel),
                        n_shards=n, factor=4)
    assert got.shape == (5, 39, 17)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_two_dim_kernel_and_tiles_alias(rng):
    """A rank-2 kernel broadcasts across bands; impl='tiles' is the
    removed JAX path's alias of 'fast'."""
    scene = torch.from_numpy(rng.normal(size=(3, 96, 32)).astype(np.float32))
    kernel = torch.from_numpy(rng.uniform(0, 1, (5, 5)).astype(np.float32))
    fast = degrade_scene_sharded(scene, kernel, n_shards=2, factor=4)
    tiles = degrade_scene_sharded(scene, kernel, n_shards=2, factor=4,
                                  impl="tiles")
    np.testing.assert_array_equal(tiles.numpy(), fast.numpy())
    want = np.asarray(j_degrade(jnp.asarray(scene.numpy()),
                                jnp.asarray(kernel.numpy()), factor=4))
    np.testing.assert_allclose(fast.numpy(), want, **TOL)


def test_shape_gate():
    k = torch.ones(13, 13)
    with pytest.raises(ValueError, match="n_shards\\*factor"):
        degrade_scene_sharded(torch.zeros(5, 100, 64), k, factor=8)
    with pytest.raises(ValueError, match="n_shards\\*factor"):
        degrade_scene_sharded(torch.zeros(5, 64, 64), k, n_shards=3, factor=8)
    with pytest.raises(ValueError, match="multiple of factor"):
        degrade_scene_sharded(torch.zeros(5, 64, 60), k, factor=8)
    with pytest.raises(ValueError, match="fast\\|bands"):
        degrade_scene_sharded(torch.zeros(5, 64, 64), k, factor=8, impl="xla")
    with pytest.raises(ValueError, match="n_shards must be"):
        degrade_scene_sharded(torch.zeros(5, 64, 64), k, n_shards=0, factor=8)
    with pytest.raises(ValueError, match="exceeds the 4-row slab"):
        # 4-row slabs: the 13x13 blur's 6-row halo is deeper
        degrade_scene_sharded(torch.zeros(2, 16, 32), k, n_shards=4, factor=4)
