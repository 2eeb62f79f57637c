"""Port parity: fleet KernelGAN training and its CLI (kmsr_tpu_torch vs
kmsr_tpu), on the CPU at tiny widths (G mid_ch 8, D 8x2, HR 32, LR 8,
batch 4).

Against JAX, every scene starts from JAX's `init_training(seed + s)`
weights (converted) and both packages draw the same numpy batches; the
chain-mode run also gets JAX's per-scene `jax.random` crops, injected into
the port's `random_crops` hook keyed by each scene's generator, and the
K = 2 runs JAX's device indices and fake-side noise too. Kernels and CSV
rows agree at rtol 1e-4 / atol 1e-5 over 4 iterations, the stacked fleet
against JAX's at the same `scene_chunk`. Within the port, scene s of a
fleet at scene_chunk=1 equals the port's standalone run at seed + s bit
for bit (the same step on the same draws); a stacked chunk of m > 1
scenes equals it at JAX's fleet tolerances (`tests/test_train_fleet.py`:
kernels rtol 1e-5 / atol 1e-7, CSV rows rtol 1e-4 / atol 1e-6).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from kmsr_tpu.data import sampler as jsampler
from kmsr_tpu.io import write_band_stack
from kmsr_tpu.models import discriminator as jd
from kmsr_tpu.models import generator as jg
from kmsr_tpu.train import fleet as jfleet
from kmsr_tpu.train import single_kernel as jsk
from kmsr_tpu_torch import convert
from kmsr_tpu_torch.data import sampler as tsampler
from kmsr_tpu_torch.models import discriminator as td
from kmsr_tpu_torch.models import generator as tg
from kmsr_tpu_torch.pipeline import train_fleet_cli as tcli
from kmsr_tpu_torch.train import fleet as tfleet
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train import state as tstate
from tests.helpers.jax_draws import JaxDraws

TOL = dict(rtol=1e-4, atol=1e-5)
#: JAX's fleet tolerances across chunk widths (float32 reduction order)
KERNEL_TOL, ROW_TOL = dict(rtol=1e-5, atol=1e-7), dict(rtol=1e-4, atol=1e-6)


def _cfg(pkg, outdir, mode="chain", **kw):
    sk, gm, dm = (jsk, jg, jd) if pkg == "jax" else (tsk, tg, td)
    fields = dict(
        iters=4, hr_patch_size=32, lr_crop_size=8, batch_size=4, log_every=2,
        kernel_log_every=2, outdir=str(outdir), verbose=False,
        generator=gm.GeneratorConfig(mid_ch=8, forward_mode=mode),
        discriminator=dm.DiscriminatorConfig(base_ch=8, num_blocks=2))
    return sk.SingleKernelConfig(**{**fields, **kw})


def _pools(seed=3, sizes=(6, 9), lr_sizes=(5, 7)):
    """HR pools [n, 5, 32, 32] and native-LR pools [n, 5, 8, 8] per scene."""
    rng = np.random.default_rng(seed)
    hr = [rng.normal(5, 1, (n, 5, 32, 32)).astype(np.float32) for n in sizes]
    lr = [rng.normal(5, 2, (n, 5, 8, 8)).astype(np.float32) for n in lr_sizes]
    return hr, lr


def _torch_state(jax_state, seed):
    """The port's train state from a JAX one (weights and D state
    converted, fresh Adam moments, a generator seeded `seed`)."""
    js = jax.device_get(jax_state)
    g = convert.generator_from_jax(js.g_params, device="cpu")
    d, ds = convert.discriminator_from_jax(js.d_params, js.d_state, device="cpu")
    tx = tstate.make_gan_optimizers(4e-4)
    return tstate.init_gan_state(torch.Generator().manual_seed(seed), g, d, ds, tx, tx)


def _rows(path):
    lines = open(path, encoding="utf-8").read().splitlines()
    return lines[0], np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])


def _assert_runs_close(got, want, tol, row_tol=None):
    """Two fleet outputs: kernels, every scene's CSV rows (at row_tol, else
    tol) and file names."""
    np.testing.assert_allclose(got["kernel_per_band"], want["kernel_per_band"], **tol)
    np.testing.assert_allclose(got["kernel_merged"], want["kernel_merged"], **tol)
    for fg, fw in zip(got["log_files"], want["log_files"], strict=True):
        (hg, rg), (hw, rw) = _rows(fg), _rows(fw)
        assert hg == hw and rg.shape == rw.shape
        np.testing.assert_array_equal(rg[:, 0], rw[:, 0])
        np.testing.assert_allclose(rg, rw, **(row_tol or tol))
        assert sorted(os.listdir(os.path.dirname(fg))) == sorted(os.listdir(os.path.dirname(fw)))


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


# ------------------------------------------------------------ within the port
@pytest.mark.parametrize("k", [1, 2])
def test_fleet_scene_equals_standalone_run(tmp_path, k):
    """Scene s of a chain fleet at scene_chunk=1 equals the port's
    `train_single_kernel` at seed 7 + s on the same pool (the device pool;
    K = 2 with fake-side noise, so every draw comes from the scene's
    generator): kernels and CSV rows bit for bit."""
    hr, _ = _pools(seed=5)
    kw = dict(steps_per_call=k, **({"fake_noise_sigma": (0.1, 0.2, 0.1, 0.3, 0.1)}
                                   if k > 1 else {}))
    fleet = tfleet.train_fleet([tsampler.PatchPool(p) for p in hr],
                               _cfg("torch", tmp_path / "fleet", seed=7, **kw),
                               scene_names=["a", "b"], progress=False, device="cpu",
                               scene_chunk=1)
    for s, pool in enumerate(hr):
        one = tsk.train_single_kernel(
            tsampler.PatchPool(pool),
            _cfg("torch", tmp_path / f"one{s}", seed=7 + s, device_pool=True, **kw),
            progress=False, device="cpu")
        np.testing.assert_array_equal(fleet["kernel_per_band"][s], one["kernel_per_band"])
        assert open(fleet["log_files"][s]).read() == open(one["log_file"]).read()
        for name in ("kernel_iter2.npy", "kernel_per_band_iter4.npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "fleet" / "ab"[s] / name),
                                          np.load(tmp_path / f"one{s}" / name))


def test_stacked_fleet_scene_equals_standalone_run(tmp_path):
    """The same chain fleets stacked (2 scenes in one chunk, the automatic
    width here; K = 2 with fake-side noise): each scene equals its
    standalone run at JAX's fleet tolerances."""
    hr, _ = _pools(seed=5)
    kw = dict(steps_per_call=2, fake_noise_sigma=(0.1, 0.2, 0.1, 0.3, 0.1))
    cfg = _cfg("torch", tmp_path / "fleet", seed=7, **kw)
    assert tfleet.pick_scene_chunk(cfg, 2, 32) == 2
    fleet = tfleet.train_fleet([tsampler.PatchPool(p) for p in hr], cfg,
                               scene_names=["a", "b"], progress=False, device="cpu")
    for s, pool in enumerate(hr):
        one = tsk.train_single_kernel(
            tsampler.PatchPool(pool),
            _cfg("torch", tmp_path / f"one{s}", seed=7 + s, device_pool=True, **kw),
            progress=False, device="cpu")
        np.testing.assert_allclose(fleet["kernel_per_band"][s], one["kernel_per_band"],
                                   **KERNEL_TOL)
        (hf, rf), (ho, ro) = _rows(fleet["log_files"][s]), _rows(one["log_file"])
        assert hf == ho and rf.shape == ro.shape == (4, 5)
        np.testing.assert_allclose(rf, ro, **ROW_TOL)


def _real_is_lr_fleets(tmp_path, chunk):
    """K = 2 real_is_lr: a 2-scene fleet at scene_chunk `chunk` and two
    1-scene fleets at seeds 11 and 12: [(two's log, kernels), (one's)]."""
    hr, lr = _pools(seed=6, sizes=(4, 5), lr_sizes=(3, 6))
    kw = dict(real_is_lr=True, steps_per_call=2)
    two = tfleet.train_fleet([tsampler.PatchPool(p) for p in hr],
                             _cfg("torch", tmp_path / "two", seed=11, **kw),
                             scene_names=["a", "b"], progress=False, scene_chunk=chunk,
                             lr_pools=[tsampler.PatchPool(p) for p in lr], device="cpu")
    pairs = []
    for s in range(2):
        one = tfleet.train_fleet([tsampler.PatchPool(hr[s])],
                                 _cfg("torch", tmp_path / f"one{s}", seed=11 + s, **kw),
                                 scene_names=["only"], progress=False,
                                 lr_pools=[tsampler.PatchPool(lr[s])], device="cpu")
        pairs.append(((two["log_files"][s], two["kernel_per_band"][s]),
                      (one["log_files"][0], one["kernel_per_band"][0])))
    return pairs


def test_real_is_lr_chunked_fleet_equals_one_scene_fleets(tmp_path):
    """K = 2 with real_is_lr (no standalone twin: the standalone trainer
    samples an lr_pool on the host): a 2-scene fleet at scene_chunk=1
    equals two 1-scene fleets at seeds 11 and 12, kernels and CSV bit for
    bit."""
    for (log2, k2), (log1, k1) in _real_is_lr_fleets(tmp_path, chunk=1):
        np.testing.assert_array_equal(k2, k1)
        assert open(log2).read() == open(log1).read()


def test_stacked_real_is_lr_fleet_matches_one_scene_fleets(tmp_path):
    """The same 2-scene fleet stacked in one chunk: at JAX's fleet
    tolerances of the 1-scene fleets."""
    for (log2, k2), (log1, k1) in _real_is_lr_fleets(tmp_path, chunk=2):
        np.testing.assert_allclose(k2, k1, **KERNEL_TOL)
        np.testing.assert_allclose(_rows(log2)[1], _rows(log1)[1], **ROW_TOL)


def test_resume_equals_uninterrupted_fleet(tmp_path):
    """K = 2: a checkpoint at step 2 of 4, resumed, gives the rows and
    kernels of one uninterrupted run (every scene's generator state is in
    the checkpoint). K = 1 reseeds each scene's host stream at
    seed + s + 2, as JAX does: its resumed run is continuous (rows 1-4,
    every scene at step 4)."""
    hr, _ = _pools(seed=8, sizes=(4, 6))
    pools = [tsampler.PatchPool(p) for p in hr]
    kw = dict(steps_per_call=2, ckpt_every=2, fake_noise_sigma=(0.1,) * 5)
    full = tfleet.train_fleet(pools, _cfg("torch", tmp_path / "full", **kw),
                              progress=False, device="cpu")
    tfleet.train_fleet(pools, _cfg("torch", tmp_path / "cut", iters=2, **kw),
                       progress=False, device="cpu")
    assert tstate.latest_checkpoint_step(str(tmp_path / "cut" / "ckpt")) == 2
    resumed = tfleet.train_fleet(pools, _cfg("torch", tmp_path / "cut", resume=True, **kw),
                                 progress=False, device="cpu")
    assert [st.step for st in resumed["state"]] == [4, 4]
    np.testing.assert_array_equal(resumed["kernel_per_band"], full["kernel_per_band"])
    for a, b in zip(resumed["log_files"], full["log_files"]):
        assert open(a).read() == open(b).read()
    for a, b in zip(tstate.tree_leaves([st.d_params for st in resumed["state"]]),
                    tstate.tree_leaves([st.d_params for st in full["state"]])):
        assert torch.equal(a, b) and a.requires_grad

    kw1 = dict(ckpt_every=2)
    tfleet.train_fleet(pools, _cfg("torch", tmp_path / "k1", iters=2, **kw1),
                       progress=False, device="cpu")
    out = tfleet.train_fleet(pools, _cfg("torch", tmp_path / "k1", resume=True, **kw1),
                             progress=False, device="cpu")
    assert [st.step for st in out["state"]] == [4, 4]
    for f in out["log_files"]:
        header, rows = _rows(f)
        assert header == tsk.LOG_HEADER.strip()
        np.testing.assert_array_equal(rows[:, 0], [1, 2, 3, 4])
        assert np.isfinite(rows).all()


@pytest.mark.parametrize("resume_chunk", [1, 4])
def test_checkpoint_resumes_at_another_chunk_width(tmp_path, resume_chunk):
    """A checkpoint written by 4 scenes in chunks of 2 (one blob a scene)
    resumes at scene_chunk 1 and 4: every scene at step 4, kernels and
    rows at JAX's fleet tolerances of the uninterrupted run at 2."""
    hr, _ = _pools(seed=13, sizes=(4, 6, 5, 4))
    pools = [tsampler.PatchPool(p) for p in hr]
    kw = dict(steps_per_call=2, ckpt_every=2, fake_noise_sigma=(0.1,) * 5)
    full = tfleet.train_fleet(pools, _cfg("torch", tmp_path / "full", **kw), progress=False,
                              device="cpu", scene_chunk=2)
    tfleet.train_fleet(pools, _cfg("torch", tmp_path / "cut", iters=2, **kw), progress=False,
                       device="cpu", scene_chunk=2)
    resumed = tfleet.train_fleet(pools, _cfg("torch", tmp_path / "cut", resume=True, **kw),
                                 progress=False, device="cpu", scene_chunk=resume_chunk)
    assert [st.step for st in resumed["state"]] == [4] * 4
    _assert_runs_close(resumed, full, KERNEL_TOL, ROW_TOL)


def _scene_states(cfg, n):
    return [tsk.init_training(dataclasses.replace(cfg, seed=cfg.seed + s), "cpu")
            for s in range(n)]


@pytest.mark.parametrize("mode, learn", [("chain", False), ("compose", True)])
def test_one_scene_stacked_step_is_the_base_step(mode, learn):
    """`make_scenes_step` at m = 1 on a stacked state of one scene equals
    `make_base_step` on the plain state, bit for bit over 3 steps: every
    metric, every tensor of the state and the generator (random crops,
    fake-side noise, learnable sigma, raw_sum_reg)."""
    cfg = _cfg("torch", "unused", mode=mode, seed=3, raw_sum_reg=0.1,
               fake_noise_sigma=(0.1, 0.2, 0.1, 0.3, 0.1), fake_noise_learnable=learn)
    (plain,), (one,) = _scene_states(cfg, 1), _scene_states(cfg, 1)
    stacked = tfleet._stack_states([one])
    base, scenes = tsk.make_base_step(cfg), tsk.make_scenes_step(cfg, 1)
    rng = np.random.default_rng(0)
    for _ in range(3):
        hr = torch.from_numpy(rng.normal(5, 1, (4, 5, 32, 32)).astype(np.float32))
        plain, want = base(plain, hr, hr.flip(0))
        stacked, got = scenes(stacked, hr[None], hr.flip(0)[None])
        for k in tsk._CHUNK_KEYS:
            assert torch.equal(got[k][0], want[k]), k
    (back,) = tfleet._unstack_state(stacked)
    assert back.step == plain.step == 3
    for name in tfleet._TREES:
        a, b = getattr(back, name), getattr(plain, name)
        assert all(torch.equal(x, y) for x, y in zip(tstate.tree_leaves(a),
                                                     tstate.tree_leaves(b), strict=True))
    assert back.g_opt_state["count"] == plain.g_opt_state["count"] == 3
    assert torch.equal(back.rng.get_state(), plain.rng.get_state())
    assert all(p.requires_grad for p in tstate.tree_leaves(back.g_params))


def test_each_scene_is_clipped_by_its_own_norm():
    """ClippedAdam over 2 stacked scenes, the second's gradients 1e3x the
    first's: the first scene's update equals its solo step's bit for bit
    (a global norm would have clipped it too); the second's, clipped, and
    both norms equal their solo steps' to float32 rounding."""
    tx = tstate.make_gan_optimizers(4e-4)
    g = torch.Generator().manual_seed(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [[torch.randn(sh, generator=g) for sh in shapes] for _ in range(2)]
    stacked = [torch.stack(ps) for ps in zip(*params)]
    opt, solo_opt = tx.init(stacked), [tx.init(p) for p in params]
    for _ in range(2):
        grads = [torch.randn(sh, generator=g) for sh in shapes]  # norm ~4 < 20
        scene_grads = [grads, [1e3 * x for x in grads]]
        norms = tx.step(stacked, [torch.stack(gs) for gs in zip(*scene_grads)], opt, scenes=2)
        for s in range(2):
            solo = tx.step(params[s], scene_grads[s], solo_opt[s])
            torch.testing.assert_close(norms[s], solo, rtol=1e-6, atol=0)
            for a, b in zip(stacked, params[s]):
                if s == 0:
                    assert torch.equal(a[s], b)
                else:
                    torch.testing.assert_close(a[s], b, rtol=1e-6, atol=1e-9)
    assert float(norms[0]) < 20 < float(norms[1])


def test_folded_discriminator_is_each_scenes():
    """D over 3 scenes folded into the channels (groups = 3, per-scene
    spectral norm, BatchNorm on the folded channels) against each scene's
    own D at the file's TOL (float32 through 4 convs): score maps, u
    vectors and BatchNorm's running statistics (each scene's inputs at its
    own scale, so shared statistics would show)."""
    dcfg = td.DiscriminatorConfig(base_ch=8, num_blocks=2)
    nets = [td.init_discriminator(dcfg, seed=s, device="cpu") for s in range(3)]
    g = torch.Generator().manual_seed(1)
    xs = [torch.randn(4, 5, 12, 12, generator=g) * (1 + 3 * s) + s for s in range(3)]
    params = tstate.tree_unflatten(nets[0][0], [torch.stack(ls) for ls in zip(
        *(tstate.tree_leaves(p) for p, _ in nets))])
    state = tstate.tree_unflatten(nets[0][1], [torch.stack(ls) for ls in zip(
        *(tstate.tree_leaves(st) for _, st in nets))])
    for train in (True, False):
        out, new = td.discriminator_forward(params, state, torch.cat(xs, dim=1), train,
                                            scenes=3)
        assert out.shape == (4, 3, 12, 12)
        for s, (p, st) in enumerate(nets):
            want, want_st = td.discriminator_forward(p, st, xs[s], train)
            torch.testing.assert_close(out[:, s:s + 1], want, **TOL)
            for a, b in zip(tstate.tree_leaves(new), tstate.tree_leaves(want_st), strict=True):
                torch.testing.assert_close(a[s], b, **TOL)


def test_folded_batch_norm_statistics_are_per_scene():
    """`batch_norm` on 3 scenes' channels folded into one tensor normalizes
    each scene's channels by that scene's batch statistics and updates its
    running statistics alone."""
    g = torch.Generator().manual_seed(2)
    x = torch.cat([torch.randn(4, 8, 6, 6, generator=g) * (1 + 5 * s) - 2 * s
                   for s in range(3)], dim=1)
    scale, bias, mean, var = (torch.rand(3, 8, generator=g) + 0.5 for _ in range(4))
    y, new_mean, new_var = td.batch_norm(x, scale.flatten(), bias.flatten(), mean.flatten(),
                                         var.flatten(), train=True)
    for s in range(3):
        c = slice(8 * s, 8 * s + 8)
        ys, ms, vs = td.batch_norm(x[:, c], scale[s], bias[s], mean[s], var[s], train=True)
        torch.testing.assert_close(y[:, c], ys, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(new_mean[c], ms, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(new_var[c], vs, rtol=1e-6, atol=1e-7)


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
