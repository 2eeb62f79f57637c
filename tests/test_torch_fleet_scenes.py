"""Port: fleet KernelGAN training within the port, on the CPU at tiny
widths (G mid_ch 8, D 8x2, HR 32, LR 8, batch 4).

Scene s of a fleet at scene_chunk=1 equals the port's standalone run at
seed + s bit for bit (the same step on the same draws); a stacked chunk of
m > 1 scenes equals it at JAX's fleet tolerances
(`tests/test_train_fleet.py`: kernels rtol 1e-5 / atol 1e-7, CSV rows
rtol 1e-4 / atol 1e-6). Also resume, checkpoints across chunk widths, the
one-scene stacked step, per-scene clipping and the folded discriminator.
"""
import dataclasses

import numpy as np
import pytest
import torch

from kmsr_tpu_torch.data import sampler as tsampler
from kmsr_tpu_torch.models import discriminator as td
from kmsr_tpu_torch.train import fleet as tfleet
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train import state as tstate
from tests.helpers.torch_fleet import (  # noqa: F401
    KERNEL_TOL, ROW_TOL, TOL, assert_runs_close as _assert_runs_close, cfg as _cfg,
    pools as _pools, rows as _rows, torch_state as _torch_state)


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
