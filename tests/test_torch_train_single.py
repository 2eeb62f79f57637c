"""Port parity: single-kernel KernelGAN training, its optimizer, patch pools
and CLI (kmsr_tpu_torch vs kmsr_tpu), on the CPU at tiny widths (G mid_ch
8, D 8x2, HR 64, LR 8, batch 4).

Both packages start from the same weights (the JAX init, converted) and
see the same batches (numpy draws from one seed); draws the JAX step makes
with `jax.random` (fake-side noise) are injected into the port's step.
Tolerances are stated per test: one step agrees to float32 rounding; a
4-iteration run less tightly, since Adam's first steps map any resolved
gradient to +-lr, so rounding-level sign flips (biases ahead of a
BatchNorm have a true gradient of ~0) move a few weights by 2*lr.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kmsr_tpu import losses as jl
from kmsr_tpu.data import sampler as jsampler
from kmsr_tpu.io import write_band_stack
from kmsr_tpu.models import discriminator as jd
from kmsr_tpu.models import generator as jg
from kmsr_tpu.pipeline import train_single_kernel_cli as jcli
from kmsr_tpu.train import single_kernel as jsk
from kmsr_tpu.train import state as jstate
from kmsr_tpu_torch import convert
from kmsr_tpu_torch.data import sampler as tsampler
from kmsr_tpu_torch.models import discriminator as td
from kmsr_tpu_torch.models import generator as tg
from kmsr_tpu_torch.pipeline import train_single_kernel_cli as tcli
from kmsr_tpu_torch.runtime.loader import NativePatchLoader
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train import state as tstate

STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def _cfg(pkg, outdir, mode="chain", **kw):
    sk, gm, dm = (jsk, jg, jd) if pkg == "jax" else (tsk, tg, td)
    fields = dict(
        iters=4, hr_patch_size=64, lr_crop_size=8, batch_size=4, log_every=2,
        kernel_log_every=2, outdir=str(outdir), verbose=False,
        generator=gm.GeneratorConfig(mid_ch=8, forward_mode=mode),
        discriminator=dm.DiscriminatorConfig(base_ch=8, num_blocks=2))
    return sk.SingleKernelConfig(**{**fields, **kw})


@pytest.fixture(scope="module")
def pools():
    """(HR pool [8,5,64,64], native-LR pool [8,5,8,8]) as numpy arrays."""
    rng = np.random.default_rng(3)
    hr = jsampler.synthetic_pool(rng, n=8, size=64, blur_sigma=None).patches
    lr = rng.normal(5, 2, (8, 5, 8, 8)).astype(np.float32)
    return hr, lr


def _torch_state(jax_state, cfg):
    """The port's train state from a JAX one (weights and D state converted,
    fresh Adam moments, the device generator seeded from cfg.seed)."""
    js = jax.device_get(jax_state)
    g = convert.generator_from_jax(js.g_params, device="cpu")
    d, ds = convert.discriminator_from_jax(js.d_params, js.d_state, device="cpu")
    tx = tstate.make_gan_optimizers(cfg.lr_rate, grad_clip_norm=cfg.grad_clip_norm)
    return tstate.init_gan_state(torch.Generator().manual_seed(cfg.seed), g, d, ds, tx, tx)


def _assert_tree_close(got, want, **tol):
    """got: torch tree; want: the JAX pytree of the same layout."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _assert_tree_close(got[k], want[k], **tol)
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_close(g, w, **tol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _scaled_tol(want):
    """rtol 1e-4, atol 1e-5 of the tree's largest entry (a near-zero
    gradient's float32 rounding follows the scale of the others)."""
    scale = max(float(np.abs(np.asarray(w)).max()) for w in jax.tree_util.tree_leaves(want))
    return dict(rtol=1e-4, atol=1e-5 * scale)


# ------------------------------------------------------------------ optimizer
def test_optimizer_matches_optax():
    """The same gradients (global norm 50, 5, 30: clipped, not, clipped)
    through optax's clip_by_global_norm(20) + adam and through the port for
    3 updates: the same parameters, moments and count (rtol 1e-6)."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [rng.normal(size=(5,)).astype(np.float32)]}
    tx = jstate.make_gan_optimizers(4e-4)
    jp, js = params, tx.init(params)
    tp = {"a": torch.from_numpy(params["a"].copy()), "b": [torch.from_numpy(params["b"][0].copy())]}
    ttx = tstate.make_gan_optimizers(4e-4)
    ts = ttx.init(tp)
    for norm in (50.0, 5.0, 30.0):
        g = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        s = norm / float(optax.global_norm(g))
        g = jax.tree_util.tree_map(lambda x: (x * s).astype(np.float32), g)
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        g_norm = ttx.step(tp, [torch.from_numpy(g["a"]), torch.from_numpy(g["b"][0])], ts)
        assert float(g_norm) == pytest.approx(norm, rel=1e-5)
        _assert_tree_close(tp, jp, rtol=1e-6, atol=1e-9)
        adam = js[1][0]
        assert ts["count"] == int(adam.count)
        _assert_tree_close(ts["mu"], jax.tree_util.tree_leaves(adam.mu), rtol=1e-6, atol=1e-12)
        _assert_tree_close(ts["nu"], jax.tree_util.tree_leaves(adam.nu), rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------------ one step
def _jax_grads(cfg, state, new_state, hr, real, n1=None, n2=None):
    """The gradients of the JAX step's D and G losses
    (`kmsr_tpu/train/single_kernel.py:211-246`) at `state`, G's against the
    updated D of `new_state`: the JAX step returns no gradients."""
    bc = cfg.d_border_crop

    def trim(x):
        return x[..., bc:-bc, bc:-bc] if bc else x

    def fake_of(gp, n):
        f = jg.generator_forward(gp, hr, factor=cfg.generator.factor,
                                 forward_mode=cfg.generator.forward_mode)
        if n is None:
            return f
        if cfg.fake_noise_learnable:
            sig = jnp.clip(jnp.exp(gp["log_sigma"]), 1e-4, 4.0)
        else:
            sig = jnp.asarray(cfg.fake_noise_sigma, jnp.float32)
        return f + n * sig[None, :, None, None]

    fake = fake_of(state.g_params, n1)

    def d_loss(dp):
        pr, st = jd.discriminator_forward(dp, state.d_state, trim(real), train=True)
        pf, st = jd.discriminator_forward(dp, st, trim(jax.lax.stop_gradient(fake)), train=True)
        return jl.lsgan_d_loss(pr, pf), st

    d_grads, st = jax.grad(d_loss, has_aux=True)(state.d_params)

    def g_loss(gp):
        pf, _ = jd.discriminator_forward(new_state.d_params, st, trim(fake_of(gp, n2)), train=True)
        ks = jg.extract_kernels(gp, differentiable=cfg.differentiable_reg)
        total = jl.lsgan_g_loss(pf) + cfg.reg_weight * jl.per_band_kernel_regularization(
            ks, cfg.reg_weights)
        if cfg.raw_sum_reg:
            sums = jnp.sum(jg.extract_kernels_raw(gp), axis=(1, 2))
            total = total + cfg.raw_sum_reg * jnp.mean((sums - 1.0) ** 2)
        return total

    return d_grads, jax.grad(g_loss)(state.g_params)


def _compare_step(tmp_path, pools, monkeypatch, **kw):
    hr_pool, lr_pool = pools
    rng = np.random.default_rng(1)
    hr, real = hr_pool[rng.integers(0, 8, 4)], lr_pool[rng.integers(0, 8, 4)]
    cfg_j = _cfg("jax", tmp_path, real_is_lr=True, **kw)
    cfg_t = _cfg("torch", tmp_path, real_is_lr=True, **kw)
    state_j = jsk.init_training(cfg_j)
    state_t = _torch_state(state_j, cfg_t)
    noise = (None, None)
    if cfg_j.fake_noise_sigma is not None:  # the JAX step's draws, injected
        _, _, k1, k2 = jax.random.split(state_j.rng, 4)
        noise = tuple(np.asarray(jax.random.normal(k, (4, 5, 8, 8))) for k in (k1, k2))
        draws = iter(noise)
        monkeypatch.setattr(tsk, "_normal", lambda gen, like: torch.tensor(next(draws)))
    new_j, m_j = jax.jit(jsk.make_base_step(cfg_j))(state_j, hr, real)
    d_grads_j, g_grads_j = jax.jit(lambda *a: _jax_grads(cfg_j, *a))(
        state_j, new_j, hr, real, *noise)
    # the replication is JAX's own step: its gradients have the step's norms
    assert float(optax.global_norm(d_grads_j)) == pytest.approx(float(m_j["grad_norm_D"]), rel=1e-5)
    assert float(optax.global_norm(g_grads_j)) == pytest.approx(float(m_j["grad_norm_G"]), rel=1e-5)

    new_t, m_t = tsk.make_base_step(cfg_t)(state_t, torch.from_numpy(hr), torch.from_numpy(real))
    assert new_t.step == int(new_j.step) == 1
    for k in ("loss_D", "loss_G_adv", "loss_reg", "loss_reg_weighted",
              "grad_norm_D", "grad_norm_G"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), **STEP_TOL, err_msg=k)
    np.testing.assert_allclose(m_t["kernels"].numpy(), np.asarray(m_j["kernels"]),
                               rtol=1e-5, atol=1e-6)
    _assert_tree_close(m_t["grads_D"], d_grads_j, **_scaled_tol(d_grads_j))
    _assert_tree_close(m_t["grads_G"], g_grads_j, **_scaled_tol(g_grads_j))
    # u and the BN running stats after real -> fake -> the G step's fake
    _assert_tree_close(new_t.d_state, jax.device_get(new_j.d_state), rtol=1e-4, atol=1e-4)
    return m_t, g_grads_j


def test_base_step_matches_jax(tmp_path, pools, monkeypatch):
    """One step from the same weights on an injected batch (real_is_lr, no
    noise): losses, grad norms (STEP_TOL), kernels, the gradients before
    the update, and the new D state."""
    m_t, _ = _compare_step(tmp_path, pools, monkeypatch)
    assert set(m_t["grads_G"]) == {"layers"}


@pytest.mark.parametrize("learnable", [False, True])
def test_noise_crop_rawsum_step_matches_jax(tmp_path, pools, monkeypatch, learnable):
    """The same with fake-side noise (JAX's two draws injected), a 1-pixel
    D border crop and raw_sum_reg; learnable sigma adds log_sigma to G."""
    sig = (0.05, 0.1, 0.02, 0.08, 0.04)
    m_t, g_j = _compare_step(tmp_path, pools, monkeypatch, fake_noise_sigma=sig,
                             fake_noise_learnable=learnable, d_border_crop=1,
                             raw_sum_reg=0.1)
    assert ("log_sigma" in m_t["grads_G"]) == learnable == ("log_sigma" in g_j)


# ------------------------------------------------------------------ full runs
def test_four_iteration_run_matches_jax(tmp_path, pools, monkeypatch):
    """4 iterations with an lr_pool and real_is_lr in both packages, the
    port started from the JAX init: both draw the same numpy batches.
    CSV losses within rtol 1e-3 / atol 1e-4, kernels within atol 1e-5
    (Adam's sign-like first steps, see the module docstring)."""
    hr_pool, lr_pool = pools
    cfg_j = _cfg("jax", tmp_path / "jax", real_is_lr=True)
    cfg_t = _cfg("torch", tmp_path / "torch", real_is_lr=True)
    out_j = jsk.train_single_kernel(jsampler.PatchPool(hr_pool), cfg_j, progress=False,
                                    lr_pool=jsampler.PatchPool(lr_pool))
    start = _torch_state(jsk.init_training(cfg_j), cfg_t)
    monkeypatch.setattr(tsk, "init_training", lambda cfg, device: start)
    out_t = tsk.train_single_kernel(tsampler.PatchPool(hr_pool), cfg_t, progress=False,
                                    lr_pool=tsampler.PatchPool(lr_pool), device="cpu")
    rows_j = (tmp_path / "jax" / "training_log.txt").read_text().splitlines()
    rows_t = (tmp_path / "torch" / "training_log.txt").read_text().splitlines()
    assert rows_t[0] == rows_j[0] == tsk.LOG_HEADER.strip() and len(rows_t) == 5
    vals_j = np.array([[float(v) for v in r.split(",")] for r in rows_j[1:]])
    vals_t = np.array([[float(v) for v in r.split(",")] for r in rows_t[1:]])
    np.testing.assert_array_equal(vals_t[:, 0], [1, 2, 3, 4])
    np.testing.assert_allclose(vals_t, vals_j, rtol=1e-3, atol=1e-4)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    for name in ("kernel_per_band.npy", "kernel_merged.npy", "kernel_per_band_iter2.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "torch" / name),
                                   np.load(tmp_path / "jax" / name), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(out_t["kernel_per_band"], out_j["kernel_per_band"],
                               rtol=1e-3, atol=1e-5)


def test_device_pool_matches_upload_path(tmp_path, pools):
    """The device-resident pool gathers the same batches as the per-step
    upload (same host RNG stream): the same kernels (atol 1e-6)."""
    pool = tsampler.PatchPool(pools[0])
    outs = [tsk.train_single_kernel(
        pool, _cfg("torch", tmp_path / str(dp), iters=3, device_pool=dp),
        progress=False, device="cpu") for dp in (False, True)]
    np.testing.assert_allclose(outs[0]["kernel_per_band"], outs[1]["kernel_per_band"],
                               atol=1e-6)


def test_chunked_steps_write_every_row(tmp_path, pools):
    """steps_per_call=2: K steps per call, one CSV row per iteration,
    kernel artifacts at the chunk ends, normalized kernels."""
    cfg = _cfg("torch", tmp_path, device_pool=True, steps_per_call=2)
    out = tsk.train_single_kernel(tsampler.PatchPool(pools[0]), cfg, progress=False,
                                  device="cpu")
    assert out["state"].step == 4
    lines = (tmp_path / "training_log.txt").read_text().splitlines()
    assert [ln.split(",")[0] for ln in lines[1:]] == ["1", "2", "3", "4"]
    assert (tmp_path / "kernel_per_band_iter2.npy").exists()
    assert (tmp_path / "kernel_iter4.npy").exists()
    np.testing.assert_allclose(out["kernel_per_band"].sum(axis=(1, 2)), 1.0, rtol=1e-5)
    assert out["kernel_per_band"].shape == (5, 13, 13)


_REFUSALS = {  # config overrides, and whether to pass an lr_pool
    "K needs the device pool": (dict(steps_per_call=2, device_pool=False), False),
    "K-multiple intervals": (dict(steps_per_call=2, device_pool=True, log_every=3), False),
    "real_is_lr without lr_pool": (dict(real_is_lr=True), False),
    "lr_pool side": (dict(real_is_lr=True, lr_crop_size=4), True),
    "lr_pool on the device": (dict(device_pool=True), True),
    "learnable sigma without init": (dict(fake_noise_learnable=True), False),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_refusals_match_jax(tmp_path, pools, case):
    overrides, with_lr = _REFUSALS[case]
    msgs = []
    for pkg, sampler, sk, kw in (("jax", jsampler, jsk, {}),
                                 ("torch", tsampler, tsk, {"device": "cpu"})):
        lr_pool = sampler.PatchPool(pools[1]) if with_lr else None
        with pytest.raises(ValueError) as e:
            sk.train_single_kernel(sampler.PatchPool(pools[0]),
                                   _cfg(pkg, tmp_path / pkg, **overrides),
                                   progress=False, lr_pool=lr_pool, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_mesh_and_scan_checks_match_jax():
    cfg = _cfg("torch", "unused", steps_per_call=2, device_pool=True)
    msgs = []
    for check in (jstate.check_mesh_vs_scan, tstate.check_mesh_vs_scan):
        with pytest.raises(ValueError) as e:
            check(cfg, mesh=object())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    tstate.check_mesh_vs_scan(cfg, None)


def test_d_lr_rate_zero_behaves_like_unset(tmp_path, pools):
    """`cfg.d_lr_rate or cfg.lr_rate`: 0.0 means unset, as in JAX."""
    pool = tsampler.PatchPool(pools[0])
    runs = {}
    for d_lr in (None, 0.0, 1e-3):
        cfg = _cfg("torch", tmp_path / str(d_lr), iters=2, d_lr_rate=d_lr)
        runs[d_lr] = (tsk.train_single_kernel(pool, cfg, progress=False, device="cpu"),
                      (tmp_path / str(d_lr) / "training_log.txt").read_text())
    np.testing.assert_array_equal(runs[0.0][0]["kernel_per_band"],
                                  runs[None][0]["kernel_per_band"])
    assert runs[0.0][1] == runs[None][1] != runs[1e-3][1]


def test_resume_matches_uninterrupted_run(tmp_path, pools):
    """Checkpoint at step 2 of 4 and resume: the same rows and kernels as
    one uninterrupted run (K=2, so the batch indices come from the
    checkpointed device generator). A JAX orbax checkpoint directory is
    refused."""
    pool = tsampler.PatchPool(pools[0])
    kw = dict(device_pool=True, steps_per_call=2, ckpt_every=2)
    full = tsk.train_single_kernel(pool, _cfg("torch", tmp_path / "full", **kw),
                                   progress=False, device="cpu")
    tsk.train_single_kernel(pool, _cfg("torch", tmp_path / "cut", iters=2, **kw),
                            progress=False, device="cpu")
    assert tstate.latest_checkpoint_step(str(tmp_path / "cut" / "ckpt")) == 2
    resumed = tsk.train_single_kernel(
        pool, _cfg("torch", tmp_path / "cut", resume=True, **kw), progress=False,
        device="cpu")
    assert resumed["state"].step == 4
    np.testing.assert_array_equal(resumed["kernel_per_band"], full["kernel_per_band"])
    assert ((tmp_path / "cut" / "training_log.txt").read_text()
            == (tmp_path / "full" / "training_log.txt").read_text())
    for a, b in zip(tstate.tree_leaves(resumed["state"].d_params),
                    tstate.tree_leaves(full["state"].d_params)):
        assert torch.equal(a, b) and a.requires_grad
    os.makedirs(tmp_path / "cut" / "ckpt" / "step_6")
    with pytest.raises(ValueError, match="orbax"):
        tsk.train_single_kernel(pool, _cfg("torch", tmp_path / "cut", resume=True, iters=8,
                                           **kw), progress=False, device="cpu")


# ------------------------------------------------------------------------ CLI
def _write_patch_dir(path, rng, n=6, hw=64):
    path.mkdir()
    for i in range(n):
        write_band_stack(path / f"p{i}.nc", "denoised",
                         rng.normal(5, 2, (5, hw, hw)).astype(np.float32), mode="w")
    return str(path)


def _artifacts(outdir):
    rows = open(os.path.join(outdir, "training_log.txt")).read().splitlines()
    files = sorted(f for f in os.listdir(outdir) if f.endswith(".npy"))
    shapes = {f: np.load(os.path.join(outdir, f)).shape for f in files}
    return rows[0], len(rows), shapes


@pytest.mark.parametrize("source", ["patch-dir", "scene-file"])
def test_cli_writes_the_jax_artifacts(tmp_path, source):
    """Both CLIs on one tiny input (a .nc patch dir; or one NaN-holed scene
    in single-image mode, compose forward): the same files, header, row
    count and shapes (the weights differ: each package draws its own D)."""
    rng = np.random.default_rng(11)
    if source == "patch-dir":
        args = ["--patch-dir", _write_patch_dir(tmp_path / "patches", rng)]
    else:
        scene = rng.normal(5, 2, (5, 300, 300)).astype(np.float32)
        scene[:, :20, :20] = -9999.0
        write_band_stack(tmp_path / "scene.nc", "geophysical_data", scene, mode="w")
        args = ["--scene-file", str(tmp_path / "scene.nc"), "--group", "geophysical_data",
                "--scene-patches", "6", "--fast-forward"]
    args += ["--iters", "2", "--batch-size", "2", "--lr-crop-size", "8",
             "--log-every", "1", "--kernel-log-every", "2"]
    assert jcli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["--outdir", str(tmp_path / "torch"), "--device", "cpu",
                             "--trace", str(tmp_path / "trace")]) == 0
    got, want = _artifacts(tmp_path / "torch"), _artifacts(tmp_path / "jax")
    assert got == want and want[1] == 3
    assert got[2]["kernel_per_band.npy"] == (5, 13, 13)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_cli_refuses_data_parallel_and_real_is_lr_alone(tmp_path):
    """--data-parallel runs (a plain process is a one-rank mesh) and writes
    the run without it bit for bit; with the scan knobs it raises JAX's
    check_mesh_vs_scan text; --real-is-lr alone is refused."""
    args = ["--patch-dir", _write_patch_dir(tmp_path / "p", np.random.default_rng(3)),
            "--iters", "2", "--batch-size", "2", "--lr-crop-size", "8",
            "--log-every", "1", "--kernel-log-every", "2", "--fast-forward"]
    assert tcli.main(args + ["--outdir", str(tmp_path / "dp"), "--data-parallel",
                             "--device", "cpu"]) == 0
    assert tcli.main(args + ["--outdir", str(tmp_path / "one"), "--device", "cpu"]) == 0
    for name in ("training_log.txt", "kernel_per_band.npy", "kernel_merged.npy",
                 "kernel_per_band_iter2.npy"):
        assert (tmp_path / "dp" / name).read_bytes() == (tmp_path / "one" / name).read_bytes()
    msgs = []
    for m, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
        with pytest.raises(ValueError) as e:
            m.main(args + ["--outdir", str(tmp_path / "k"), "--data-parallel",
                           "--steps-per-call", "2"] + extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "incompatible with device_pool" in msgs[0]
    with pytest.raises(SystemExit, match="--real-is-lr requires --real-lr-dir"):
        tcli.main(["--patch-dir", str(tmp_path), "--outdir", str(tmp_path / "o"),
                   "--real-is-lr", "--device", "cpu"])
    with pytest.raises(SystemExit):  # the sources exclude each other
        tcli.build_parser().parse_args(["--patch-dir", "a", "--scene-file", "b",
                                        "--outdir", "o"])


# ------------------------------------------------------------------- samplers
def test_pools_and_samplers_equal_jax(tmp_path):
    """Every constructor and sampler returns JAX's arrays bit for bit from
    the same seed; NaN patches raise the same error."""
    rng = np.random.default_rng(12)
    nc_dir = _write_patch_dir(tmp_path / "nc", rng, n=4, hw=32)
    npy_dir = tmp_path / "npy"
    npy_dir.mkdir()
    for i in range(4):
        np.save(npy_dir / f"q{i}.npy", rng.normal(size=(5, 32, 32)).astype(np.float32))
    scene = rng.normal(5, 2, (5, 120, 140)).astype(np.float32)
    scene[:, 10:30, 50:70] = -9999.0
    write_band_stack(tmp_path / "scene.nc", "geophysical_data", scene, mode="w")
    mixed = [str(npy_dir / "q1.npy"), os.path.join(nc_dir, "p2.nc")]
    builds = [
        lambda m: m.PatchPool.from_nc_dir(nc_dir),
        lambda m: m.PatchPool.from_npy_dir(str(npy_dir)),
        lambda m: m.PatchPool.from_files(mixed),
        lambda m: m.PatchPool.from_scene(str(tmp_path / "scene.nc"), patch_size=32,
                                         n_patches=5, seed=3),
        lambda m: m.PatchPool.from_scene(str(tmp_path / "scene.nc"), patch_size=32,
                                         n_patches=5, seed=3, normalize=False),
        lambda m: m.synthetic_pool(np.random.default_rng(4), n=3, size=32),
        lambda m: m.synthetic_pool(np.random.default_rng(4), n=3, size=32, blur_sigma=None),
    ]
    for build in builds:
        jp, tp = build(jsampler), build(tsampler)
        np.testing.assert_array_equal(tp.patches, jp.patches)
        assert tp.sources == jp.sources and tp.shape == jp.shape and len(tp) == len(jp)
        for fn, args in (("sample", (3,)), ("sample_crops", (3, 8))):
            np.testing.assert_array_equal(getattr(tp, fn)(np.random.default_rng(5), *args),
                                          getattr(jp, fn)(np.random.default_rng(5), *args))
    img, mask = tsampler.load_scene_bands(str(tmp_path / "scene.nc"))
    j_img, j_mask = jsampler.load_scene_bands(str(tmp_path / "scene.nc"))
    np.testing.assert_array_equal(img, j_img)
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_array_equal(tsampler.gradient_weight_map(img, mask),
                                  jsampler.gradient_weight_map(img, mask))
    np.testing.assert_array_equal(
        tsampler.sample_scene_patches(np.random.default_rng(6), img, 24, 4, mask),
        jsampler.sample_scene_patches(np.random.default_rng(6), img, 24, 4, mask))
    bad = np.ones((2, 5, 8, 8), np.float32)
    bad[1, 2, 3, 4] = np.nan
    msgs = []
    for m in (jsampler, tsampler):
        with pytest.raises(m.NaNPatchError) as e:
            m.PatchPool(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_native_loader_gathers_npy_patches(tmp_path):
    """The loader's plain gather and prefetch / wait return the .npy files
    as np.load reads them; StreamingPatchPool samples what the in-memory
    pool of the same folder samples."""
    rng = np.random.default_rng(13)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"s{i}.npy"))
        np.save(paths[-1], rng.normal(size=(5, 16, 24)).astype(np.float32))
    loader = NativePatchLoader(paths, shape=(5, 16, 24))
    idx = np.array([4, 0, 0, 3])
    want = np.stack([np.load(paths[i]) for i in idx])
    np.testing.assert_array_equal(loader.gather(idx), want)
    loader.prefetch(idx[::-1])
    with pytest.raises(RuntimeError, match="in flight"):
        loader.prefetch(idx)
    np.testing.assert_array_equal(loader.wait(), want[::-1])
    with pytest.raises(IOError, match="out of range"):
        loader.gather(np.array([5]))
    loader.close()
    stream = tsampler.StreamingPatchPool(str(tmp_path), (5, 16, 24))
    mem = tsampler.PatchPool.from_npy_dir(str(tmp_path))
    assert stream.shape == mem.shape and len(stream) == 5
    np.testing.assert_array_equal(stream.sample(np.random.default_rng(1), 6),
                                  mem.sample(np.random.default_rng(1), 6))
    np.testing.assert_array_equal(stream.sample_crops(np.random.default_rng(2), 3, 8),
                                  jsampler.StreamingPatchPool(str(tmp_path), (5, 16, 24))
                                  .sample_crops(np.random.default_rng(2), 3, 8))
    stream.prefetch(np.random.default_rng(3), 2)
    np.testing.assert_array_equal(stream.wait(), mem.sample(np.random.default_rng(3), 2))
