"""Port parity: fleet KernelGAN training against JAX's (kmsr_tpu_torch vs
kmsr_tpu), on the CPU at tiny widths (G mid_ch 8, D 8x2, HR 32, LR 8,
batch 4).

Every scene starts from JAX's `init_training(seed + s)` weights
(converted) and both packages draw the same numpy batches; the chain-mode
run also gets JAX's per-scene `jax.random` crops, injected into the port's
`random_crops` hook keyed by each scene's generator, and the K = 2 runs
JAX's device indices and fake-side noise too. Kernels and CSV rows agree
at rtol 1e-4 / atol 1e-5 over 4 iterations, the stacked fleet against
JAX's at the same `scene_chunk`. The per-scene equalities within the port
are in `test_torch_fleet_scenes.py`, the refusals and the CLI in
`test_torch_fleet_cli.py`.
"""
import numpy as np
import pytest

from kmsr_tpu.data import sampler as jsampler
from kmsr_tpu.models import generator as jg
from kmsr_tpu.train import fleet as jfleet
from kmsr_tpu.train import single_kernel as jsk
from kmsr_tpu_torch.data import sampler as tsampler
from kmsr_tpu_torch.models import generator as tg
from kmsr_tpu_torch.train import fleet as tfleet
from kmsr_tpu_torch.train import single_kernel as tsk
from tests.helpers.jax_draws import JaxDraws
from tests.helpers.torch_fleet import (  # noqa: F401
    KERNEL_TOL, ROW_TOL, TOL, assert_runs_close as _assert_runs_close, cfg as _cfg,
    pools as _pools, rows as _rows, torch_state as _torch_state)


# --------------------------------------------------------------- host helpers
def test_stack_pools_equals_jax():
    rng = np.random.default_rng(0)
    pools = [rng.normal(size=(n, 5, 8, 8)).astype(np.float32) for n in (3, 5, 1)]
    got = tfleet._stack_pools([tsampler.PatchPool(p) for p in pools])
    want = jfleet._stack_pools([jsampler.PatchPool(p) for p in pools])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == [3, 5, 1]
    msgs = []
    for m, s in ((tfleet, tsampler), (jfleet, jsampler)):
        with pytest.raises(ValueError) as e:
            m._stack_pools([s.PatchPool(pools[0]), s.PatchPool(pools[0][:, :, :4])])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("mode", ["chain", "compose"])
@pytest.mark.parametrize("batch,hr", [(16, 256), (16, 128), (4, 32)])
def test_scene_chunk_estimates_equal_jax(mode, batch, hr):
    tc = tsk.SingleKernelConfig(batch_size=batch, generator=tg.GeneratorConfig(forward_mode=mode))
    jc = jsk.SingleKernelConfig(batch_size=batch, generator=jg.GeneratorConfig(forward_mode=mode))
    assert tfleet._activation_bytes_per_scene(tc, hr) == jfleet._activation_bytes_per_scene(jc, hr)
    for s in (1, 3, 8):
        assert tfleet.pick_scene_chunk(tc, s, hr) == jfleet.pick_scene_chunk(jc, s, hr)


# ------------------------------------------------------------ fleet vs JAX
def _names(hr):
    return ["a", "b", "c", "d"][:len(hr)]


def _jax_fleet(tmp_path, hr, lr, scene_chunk=None, **kw):
    lr_pools = [jsampler.PatchPool(p) for p in lr] if kw.get("real_is_lr") else None
    return jfleet.train_fleet([jsampler.PatchPool(p) for p in hr],
                              _cfg("jax", tmp_path / "jax", seed=7, **kw),
                              scene_names=_names(hr), progress=False, lr_pools=lr_pools,
                              scene_chunk=scene_chunk)


def _port_fleet_from_jax_init(tmp_path, monkeypatch, hr, lr, on_init=None, scene_chunk=None,
                              out="torch", **kw):
    """The port's fleet with every scene started from JAX's init at seed
    7 + s; on_init(state, jax_key) sees each scene's state as it is made."""

    def init(cfg, device):
        js = jsk.init_training(_cfg("jax", "unused", seed=cfg.seed, **kw))
        st = _torch_state(js, cfg.seed)
        if on_init:
            on_init(st, js.rng)
        return st

    monkeypatch.setattr(tfleet, "init_training", init)
    lr_pools = [tsampler.PatchPool(p) for p in lr] if kw.get("real_is_lr") else None
    return tfleet.train_fleet([tsampler.PatchPool(p) for p in hr],
                              _cfg("torch", tmp_path / out, seed=7, **kw),
                              scene_names=_names(hr), progress=False, lr_pools=lr_pools,
                              device="cpu", scene_chunk=scene_chunk)


def test_fleet_real_is_lr_matches_jax(tmp_path, monkeypatch):
    """K = 1, real_is_lr, no fake noise: no device draws at all, the same
    host batches per scene (HR indices, then LR ones, from seed + s)."""
    hr, lr = _pools()
    want = _jax_fleet(tmp_path, hr, lr, real_is_lr=True)
    got = _port_fleet_from_jax_init(tmp_path, monkeypatch, hr, lr, real_is_lr=True)
    assert got["scene_names"] == want["scene_names"] == ["a", "b"]
    _assert_runs_close(got, want, TOL)


def test_fleet_chain_crops_match_jax(tmp_path, monkeypatch):
    """K = 1, chain mode, random real crops: JAX's per-scene crop draws go
    into the port's `random_crops` hook, keyed by each scene's generator."""
    hr, lr = _pools(seed=4)
    want = _jax_fleet(tmp_path, hr, lr)
    draws = {}
    monkeypatch.setattr(tsk, "random_crops",
                        lambda gen, src, crop: draws[id(gen)].random_crops(gen, src, crop))
    got = _port_fleet_from_jax_init(
        tmp_path, monkeypatch, hr, lr,
        on_init=lambda st, key: draws.__setitem__(id(st.rng), JaxDraws(key, 0)))
    assert len(draws) == 2
    _assert_runs_close(got, want, TOL)


#: the stacked cases against JAX: (K, mode, real_is_lr, fake-side noise)
_STACKED = {1: ("compose", True, None), 2: ("compose", False, (0.1, 0.2, 0.1, 0.3, 0.1))}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("k", [1, 2])
def test_stacked_fleet_matches_jax(tmp_path, monkeypatch, k, m):
    """4 scenes in stacked chunks of m against JAX's `train_fleet(...,
    scene_chunk=m)` from JAX's inits at the file's TOL: K = 1 real_is_lr
    (host batches, no draws), and K = 2 with fake-side noise, JAX's
    per-scene device indices, crops and noise injected into the port's
    hooks; both compose (the chain fleets above run stacked too, two scenes
    in one chunk in both packages). Then against the port's own fleet at
    scene_chunk=1 at JAX's fleet tolerances."""
    mode, real_is_lr, noise = _STACKED[k]
    hr, lr = _pools(seed=12, sizes=(6, 9, 5, 7), lr_sizes=(5, 7, 4, 6))
    kw = dict(steps_per_call=k, real_is_lr=real_is_lr, fake_noise_sigma=noise, mode=mode)
    want = _jax_fleet(tmp_path, hr, lr, scene_chunk=m, **kw)
    draws = {}

    def hook(name):
        return lambda gen, *a: getattr(draws[id(gen)], name)(gen, *a)

    monkeypatch.setattr(tfleet, "batch_indices", hook("batch_indices"))
    monkeypatch.setattr(tsk, "random_crops", hook("random_crops"))
    monkeypatch.setattr(tsk, "_normal", hook("standard_normal"))
    got = {}
    for chunk in (m, 1):
        draws.clear()
        got[chunk] = _port_fleet_from_jax_init(
            tmp_path, monkeypatch, hr, lr, scene_chunk=chunk, out=f"torch{chunk}",
            on_init=lambda st, key: draws.__setitem__(id(st.rng), JaxDraws(key, 2)), **kw)
    assert len(draws) == 4
    _assert_runs_close(got[m], want, TOL)
    _assert_runs_close(got[m], got[1], KERNEL_TOL, ROW_TOL)
