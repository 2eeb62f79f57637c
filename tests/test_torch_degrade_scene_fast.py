"""Port parity: kmsr_tpu_torch.ops.degrade_scene_fast vs kmsr_tpu.ops.degrade_scene_fast.

On the CPU the port's `degrade_rows_fast` / `degrade_slab_fast` run their
plain PyTorch versions (the scene stencil kernel runs only on the card:
`tests/test_torch_kernels.py`, marked `cuda`). They are held against the
JAX functions' XLA path on the shapes of `tests/test_degrade_scene_fast.py`,
and once each against JAX's Pallas kernels in interpret mode (~10 s a
call on a CPU host). Tolerance rtol 1e-4 / atol 1e-5, that file's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu.ops import degrade_scene_fast as J
from kmsr_tpu.ops.degrade import compose_with_box, normalize_kernel
from kmsr_tpu_torch.ops import degrade_scene_fast as T

TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = [(5, 128, 96, 8, 13), (3, 64, 64, 4, 13), (2, 48, 80, 8, 7),
          (1, 36, 36, 3, 5)]


def _inputs(rng, c, h, w, f, k):
    """(scene, composed kernel) as numpy, composed by the JAX package."""
    scene = rng.normal(5, 2, (c, h, w)).astype(np.float32)
    kernel = rng.uniform(0, 1, (c, k, k)).astype(np.float32)
    comp = np.asarray(compose_with_box(normalize_kernel(jnp.asarray(kernel)), f))
    return scene, comp


def _edge_halos(scene, f, ksize):
    th, bh = J.halo_rows(f, ksize)
    return (np.repeat(scene[:, :1], max(th, 1), axis=1),
            np.repeat(scene[:, -1:], max(bh, 1), axis=1))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_geometry_helpers_match_jax():
    for f in range(1, 9):
        for k in range(1, 5 * f, 2):
            ksize = k + f - 1
            assert T._geometry(f, ksize) == J._geometry(f, ksize)
            assert T.slab_halo(f, ksize) == J.slab_halo(f, ksize)
            assert T.halo_rows(f, ksize) == J.halo_rows(f, ksize)
    # the pinned production contracts (tests/test_degrade_scene_fast.py)
    assert T.halo_rows(8, 20) == (6, 6) and T.slab_halo(8, 20) == (8, 8)
    assert T.halo_rows(4, 16) == (6, 6) and T.slab_halo(4, 16) == (8, 8)
    assert T.halo_rows(3, 7) == (2, 2)


@pytest.mark.parametrize("strategy", ["transpose", "slices"])
def test_phase_split_and_col_split_match_jax(rng, strategy):
    x = rng.normal(size=(2, 24, 16)).astype(np.float32)
    want = np.asarray(J.phase_split(jnp.asarray(x), 4, strategy))
    np.testing.assert_array_equal(
        T.phase_split(torch.from_numpy(x), 4, strategy).numpy(), want)
    np.testing.assert_array_equal(
        T.col_split(torch.from_numpy(x), 4).numpy(),
        np.asarray(J.col_split(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        T.extend_rows_edge(torch.from_numpy(x), 4, 16).numpy(),
        np.asarray(J.extend_rows_edge(jnp.asarray(x), 4, 16)))


def test_layout_helpers_raise_like_jax():
    with pytest.raises(ValueError, match="multiples of factor"):
        T.phase_split(torch.zeros(1, 30, 32), 4)
    with pytest.raises(ValueError, match="transpose"):
        T.phase_split(torch.zeros(1, 32, 32), 4, "bogus")
    with pytest.raises(ValueError, match="multiple of factor"):
        T.col_split(torch.zeros(1, 32, 30), 4)


@pytest.mark.parametrize("c,h,w,f,k", SHAPES)
def test_rows_fast_matches_jax_xla(rng, c, h, w, f, k):
    scene, comp = _inputs(rng, c, h, w, f, k)
    top, bot = _edge_halos(scene, f, comp.shape[-1])
    want = J.degrade_rows_fast(*map(jnp.asarray, (scene, comp)), f,
                               jnp.asarray(top), jnp.asarray(bot), impl="xla")
    x, cp, tt, bt = _t(scene, comp, top, bot)
    got = T.degrade_rows_fast(x, cp, f, tt, bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        T.degrade_rows_fast(x, cp, f, tt, bt, impl="plain").numpy(),
        T.degrade_rows_fast_ref(x, cp, f, tt, bt).numpy())


@pytest.mark.parametrize("c,h,w,f,k", SHAPES)
def test_slab_fast_matches_jax_xla(rng, c, h, w, f, k):
    scene, comp = _inputs(rng, c, h, w, f, k)
    x_ext = np.asarray(J.extend_rows_edge(jnp.asarray(scene), f, comp.shape[-1]))
    want = J.degrade_slab_fast(jnp.asarray(x_ext), jnp.asarray(comp), f,
                               impl="xla")
    xe, cp = _t(x_ext, comp)
    got = T.degrade_slab_fast(xe, cp, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        got.numpy(), T.degrade_slab_fast_ref(xe, cp, f).numpy())


def test_rows_fast_matches_jax_pallas_interpret(rng):
    """The `colsplit_raw` kernel's twin: JAX `_colsplit_raw_kernel` in
    Pallas interpret mode (with its strip convs for the edges)."""
    scene, comp = _inputs(rng, 1, 64, 64, 8, 13)
    top, bot = _edge_halos(scene, 8, comp.shape[-1])
    want = J.degrade_rows_fast(*map(jnp.asarray, (scene, comp)), 8,
                               jnp.asarray(top), jnp.asarray(bot),
                               impl="pallas", interpret=True)
    got = T.degrade_rows_fast(*_t(scene, comp), 8, *_t(top, bot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_slab_fast_matches_jax_pallas_interpret(rng):
    """The `colsplit` kernel's twin: JAX `_colsplit_kernel` in interpret
    mode on a halo-extended slab."""
    scene, comp = _inputs(rng, 1, 64, 64, 8, 13)
    x_ext = np.asarray(J.extend_rows_edge(jnp.asarray(scene), 8, comp.shape[-1]))
    want = J.degrade_slab_fast(jnp.asarray(x_ext), jnp.asarray(comp), 8,
                               impl="pallas", interpret=True)
    got = T.degrade_slab_fast(*_t(x_ext, comp), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("f,k", [(8, 13), (3, 5)])
def test_rows_fast_neighbor_halos_tile_exactly(rng, f, k):
    """Two raw slabs fed each other's real rows reassemble the whole
    slab's result (the sharded halo contract); (3, 5) is the case where
    shift != 0 and the ext map's TOP != half."""
    scene, comp = _inputs(rng, 2, 16 * f * 2, 96, f, k)
    ksize = comp.shape[-1]
    th, bh = T.halo_rows(f, ksize)
    top, bot = _edge_halos(scene, f, ksize)
    want = J.degrade_rows_fast(*map(jnp.asarray, (scene, comp)), f,
                               jnp.asarray(top), jnp.asarray(bot), impl="xla")
    x, cp, tt, bt = _t(scene, comp, top, bot)
    hs = x.shape[1] // 2
    lo, hi = x[:, :hs], x[:, hs:]
    got = torch.cat([
        T.degrade_rows_fast(lo, cp, f, tt, hi[:, :max(bh, 1)]),
        T.degrade_rows_fast(hi, cp, f, lo[:, hs - max(th, 1):], bt),
    ], dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        got.numpy(), T.degrade_rows_fast(x, cp, f, tt, bt).numpy())


def test_rows_fast_thin_slab(rng):
    """An 8-row f=8 slab (thinner than the blur's reach) matches JAX,
    which takes its XLA path for it."""
    scene, comp = _inputs(rng, 2, 8, 96, 8, 13)
    top, bot = _edge_halos(scene, 8, comp.shape[-1])
    want = J.degrade_rows_fast(*map(jnp.asarray, (scene, comp)), 8,
                               jnp.asarray(top), jnp.asarray(bot), impl="auto")
    got = T.degrade_rows_fast(*_t(scene, comp), 8, *_t(top, bot))
    assert got.shape == want.shape == (2, 1, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rows_fast_guards():
    comp = torch.rand(2, 20, 20)
    x = torch.zeros(2, 64, 64)
    halo = torch.zeros(2, 6, 64)
    with pytest.raises(ValueError, match="factor multiples"):
        T.degrade_rows_fast(torch.zeros(2, 60, 64), comp, 8, halo, halo)
    with pytest.raises(ValueError, match="halos too thin"):
        T.degrade_rows_fast(x, comp, 8, halo[:, :5], halo)
    with pytest.raises(ValueError, match="halos too thin"):
        T.degrade_rows_fast(x, comp, 8, halo, halo[:, :5])
    with pytest.raises(ValueError, match="too wide"):  # qmax > 2*nb
        T.degrade_rows_fast(x, torch.rand(2, 25, 25), 8,
                            torch.zeros(2, 10, 64), torch.zeros(2, 10, 64))
    with pytest.raises(ValueError, match="auto\\|cuda\\|plain"):
        T.degrade_rows_fast(x, comp, 8, halo, halo, impl="xla")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        T.degrade_rows_fast(x, comp, 8, halo, halo, impl="cuda")
    with pytest.raises(ValueError, match="comp must be"):
        T.degrade_rows_fast(x, torch.rand(3, 20, 20), 8, halo, halo)


def test_slab_fast_guards():
    comp = torch.rand(2, 20, 20)
    with pytest.raises(ValueError, match="halo contract"):
        T.degrade_slab_fast(torch.zeros(2, 70, 64), comp, 8)
    with pytest.raises(ValueError, match="halo contract"):
        T.degrade_slab_fast(torch.zeros(2, 80, 60), comp, 8)
    with pytest.raises(ValueError, match="too wide"):
        T.degrade_slab_fast(torch.zeros(2, 88, 64), torch.rand(2, 25, 25), 8)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        T.degrade_slab_fast(torch.zeros(2, 80, 64), comp, 8, impl="cuda")
