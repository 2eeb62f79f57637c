"""Port parity: the dynamic (content-conditioned) degradation model
(kmsr_tpu_torch vs kmsr_tpu) on the CPU.

The forwards (encoder, scale split, the modulated chain, extraction with
and without content, the noise estimator), one train step, 4-iteration
runs and the CLI, at small widths (mid_ch 8, HR 32, x4, D 8x2, batch 4).
Both packages start from the same weights (the JAX init, converted) and
see the same batches; the JAX step's `jax.random` draws are injected into
the port's hooks (`tests/helpers/jax_draws.py`). Tolerance rtol 1e-4 /
atol 1e-5 unless a test says otherwise; gradients relative to their
tree's largest entry (`_scaled_tol`).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu.data import sampler as jsampler
from kmsr_tpu.io import write_band_stack
from kmsr_tpu.losses import (lsgan_d_loss, lsgan_g_loss, noise_reg_loss,
                             per_band_kernel_regularization)
from kmsr_tpu.models import discriminator as jd
from kmsr_tpu.models import dynamic as jdy
from kmsr_tpu.pipeline import train_dynamic_cli as jcli
from kmsr_tpu.train import dynamic as jtd
from kmsr_tpu.train import single_kernel as jsk
from kmsr_tpu_torch import convert
from kmsr_tpu_torch.data import sampler as tsampler
from kmsr_tpu_torch.models import discriminator as td
from kmsr_tpu_torch.models import dynamic as tdy
from kmsr_tpu_torch.pipeline import train_dynamic_cli as tcli
from kmsr_tpu_torch.train import dynamic as ttd
from kmsr_tpu_torch.train import state as tstate
from tests.helpers.jax_draws import JaxDraws
from tests.test_torch_moe import (_assert_adam_step_close, _assert_tree_close,
                                  _scaled_tol, _t)

TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(mid_ch=8, factor=4)


def _jax_model(seed=0, **kw):
    """JAX init, then the chain weights moved off their N(0, 0.01) init
    toward a mean-positive kernel (so extraction is not clip-dominated)."""
    cfg = jdy.DynamicConfig(**{**SMALL, **kw})
    params = jax.device_get(jdy.init_degradation_model(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    params["generator"]["layers"] = [
        np.asarray(w) + np.abs(rng.normal(0.05, 0.05, np.shape(w))).astype(np.float32)
        for w in params["generator"]["layers"]]
    return cfg, params


def _x(seed, b=3, hw=32):
    return np.random.default_rng(seed).normal(5, 2, (b, 5, hw, hw)).astype(np.float32)


# ------------------------------------------------------------- model pieces
def test_encoder_and_scales_match_jax():
    cfg, params = _jax_model(1)
    x = _x(2)
    raw_j = jdy.condition_encoder_forward(params["generator"]["encoder"], jnp.asarray(x), cfg)
    tp = convert.dynamic_from_jax(params, device="cpu")
    tcfg = tdy.DynamicConfig(**SMALL)
    raw_t = tdy.condition_encoder_forward(tp["generator"]["encoder"], _t(x), tcfg)
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), **TOL)
    sj, st = jdy.split_scales(raw_j, cfg), tdy.split_scales(raw_t, tcfg)
    _assert_tree_close(st, sj, **TOL)
    for layer, s in enumerate(tdy._layer_scales(raw_t, tcfg)):  # the chain's layout
        for band in range(5):
            np.testing.assert_allclose(s[:, band].numpy(), np.asarray(sj[band][layer]), **TOL)


@pytest.mark.parametrize("channels_last", [True, False])
def test_generator_forward_matches_jax(channels_last):
    """The modulated chains as one grouped conv (groups = B*C), in either
    memory format, against JAX's vmap over (sample, band)."""
    cfg, params = _jax_model(3)
    x = _x(4)
    want = jdy.dynamic_generator_forward(params["generator"], jnp.asarray(x), cfg)
    tp = convert.dynamic_from_jax(params, device="cpu")
    got = tdy.dynamic_generator_forward(tp["generator"], _t(x), tdy.DynamicConfig(**SMALL),
                                        channels_last=channels_last)
    assert tuple(got.shape) == want.shape == (3, 5, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_x,reduce_batch", [(False, True), (True, True), (True, False)])
def test_extract_kernels_matches_jax(with_x, reduce_batch):
    """x=None (unit scales) and per-sample content, with and without the
    batch mean; non-negative, bands sum to 1, detached by default."""
    cfg, params = _jax_model(5)
    x = _x(6) if with_x else None
    want = jdy.extract_dynamic_kernels(params["generator"],
                                       None if x is None else jnp.asarray(x), cfg,
                                       reduce_batch=reduce_batch)
    tp = convert.dynamic_from_jax(params, device="cpu")
    for p in tstate.tree_leaves(tp):
        p.requires_grad_(True)
    got = tdy.extract_dynamic_kernels(tp["generator"], None if x is None else _t(x),
                                      tdy.DynamicConfig(**SMALL), reduce_batch=reduce_batch)
    assert tuple(got.shape) == want.shape and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    assert float(got.min()) >= 0
    np.testing.assert_allclose(got.sum(dim=(-2, -1)).numpy(), 1.0, rtol=1e-5)
    diff = tdy.extract_dynamic_kernels(tp["generator"], None if x is None else _t(x),
                                       tdy.DynamicConfig(**SMALL), differentiable=True)
    assert diff.requires_grad


def test_noise_estimator_and_degradation_model_match_jax():
    """degradation_model_forward with JAX's noise draw injected; the
    sigma clip's gradient at its bounds (jnp.clip's: half at a tie)."""
    cfg, params = _jax_model(7)
    x = _x(8)
    key = jax.random.PRNGKey(9)
    clean, noisy, sigma = jdy.degradation_model_forward(params, key, jnp.asarray(x), cfg)
    noise = jax.random.normal(key, clean.shape)
    tp = convert.dynamic_from_jax(params, device="cpu")
    got = tdy.degradation_model_forward(tp, _t(x), tdy.DynamicConfig(**SMALL),
                                        noise=_t(noise))
    for g, w in zip(got, (clean, noisy, sigma)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # exp(0) == noise_max 1.0 exactly: a tie at the upper bound; then inside,
    # above and below the bounds
    ls = np.array([0.0, np.log(0.3), 2.0, -20.0, -1.0], np.float32)
    cfg1 = jdy.DynamicConfig(**SMALL, noise_max=1.0)

    def f(p):
        return jnp.sum(jdy.noise_sigma(p, cfg1) * jnp.arange(1.0, 6.0))

    gj = jax.grad(f)({"log_sigma": jnp.asarray(ls)})["log_sigma"]
    assert float(gj[0]) == 0.5  # jnp.clip splits the gradient at the tie
    lt = _t(ls).requires_grad_(True)
    (tdy.noise_sigma({"log_sigma": lt}, tdy.DynamicConfig(**SMALL, noise_max=1.0))
     * torch.arange(1.0, 6.0)).sum().backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------------ training
def _cfg(pkg, outdir, **kw):
    tr, dy, dm = (jtd, jdy, jd) if pkg == "jax" else (ttd, tdy, td)
    fields = dict(iters=4, batch_size=4, hr_patch_size=32, lr_crop_size=8, log_every=2,
                  kernel_log_every=2, outdir=str(outdir), verbose=False,
                  model=dy.DynamicConfig(**SMALL),
                  discriminator=dm.DiscriminatorConfig(base_ch=8, num_blocks=2),
                  device_pool=False)
    return tr.DynamicTrainConfig(**{**fields, **kw})


@pytest.fixture(scope="module")
def pool():
    return jsampler.synthetic_pool(np.random.default_rng(3), n=8, size=32).patches


def _torch_state(js, cfg):
    js = jax.device_get(js)
    g = convert.dynamic_from_jax(js.g_params, device="cpu")
    d, ds = convert.discriminator_from_jax(js.d_params, js.d_state, device="cpu")
    tx = tstate.make_gan_optimizers(cfg.lr_rate, grad_clip_norm=None)
    return tstate.init_gan_state(torch.Generator().manual_seed(cfg.seed), g, d, ds, tx, tx)


def _draws(monkeypatch, key):
    draws = JaxDraws(key, 1)
    draws.install(monkeypatch, tstate, ttd, tdy)
    return draws


def _jax_grads(cfg, state, new_state, hr, crop_src):
    """The gradients of the JAX step's D and G losses
    (`kmsr_tpu/train/dynamic.py:96-122`), G's against the updated D."""
    _, k_crop, k_noise = jax.random.split(state.rng, 3)
    real = jsk.random_crops(k_crop, crop_src, cfg.lr_crop_size)
    _, fake, _ = jdy.degradation_model_forward(state.g_params, k_noise, hr, cfg.model)

    def d_loss(dp):
        pr, st = jd.discriminator_forward(dp, state.d_state, real, train=True)
        pf, st = jd.discriminator_forward(dp, st, jax.lax.stop_gradient(fake), train=True)
        return lsgan_d_loss(pr, pf), st

    d_grads, st = jax.grad(d_loss, has_aux=True)(state.d_params)

    def g_loss(gp):
        _, f, sigma = jdy.degradation_model_forward(gp, k_noise, hr, cfg.model)
        pf, _ = jd.discriminator_forward(new_state.d_params, st, f, train=True)
        ks = jdy.extract_dynamic_kernels(gp["generator"], hr, cfg.model)
        return (lsgan_g_loss(pf) + per_band_kernel_regularization(ks, cfg.reg_weights,
                                                                  center_max=False)
                + cfg.noise_reg_weight * noise_reg_loss(sigma, jnp.asarray(cfg.target_sigma)))

    return d_grads, jax.grad(g_loss)(state.g_params)


def test_train_step_matches_jax(tmp_path, pool, monkeypatch):
    """One D + G step from the same weights with JAX's draws (ONE noise
    draw, shared by D and G): losses, sigma, kernels, gradients (the
    kernel regularizer detached: no gradient through extraction),
    updated parameters and D's state."""
    rng = np.random.default_rng(1)
    hr, crop = pool[rng.integers(0, 8, 4)], pool[rng.integers(0, 8, 4)]
    cfg_j, cfg_t = _cfg("jax", tmp_path), _cfg("torch", tmp_path)
    state_j = jtd.init_dynamic_training(cfg_j)
    state_t = _torch_state(state_j, cfg_t)
    draws = _draws(monkeypatch, state_j.rng)
    step_j, _ = jtd.make_dynamic_train_step(cfg_j)
    new_j, m_j = step_j(jax.tree_util.tree_map(jnp.copy, state_j), jnp.asarray(hr),
                        jnp.asarray(crop))
    d_grads_j, g_grads_j = jax.jit(lambda *a: _jax_grads(cfg_j, *a))(
        state_j, new_j, jnp.asarray(hr), jnp.asarray(crop))

    new_t, m_t = ttd.make_dynamic_base_step(cfg_t)(state_t, _t(hr), _t(crop))
    assert draws._fwd == [] and new_t.step == 1  # the one noise key was used, once
    for k in ("loss_D", "loss_G_adv", "loss_reg", "loss_noise_reg", "sigma", "kernels"):
        np.testing.assert_allclose(np.asarray(m_t[k]), np.asarray(m_j[k]), **TOL, err_msg=k)
    _assert_tree_close(m_t["grads_D"], d_grads_j, **_scaled_tol(d_grads_j))
    _assert_tree_close(m_t["grads_G"], g_grads_j, **_scaled_tol(g_grads_j))
    nj = jax.device_get(new_j)
    _assert_adam_step_close(new_t.g_params, nj.g_params, g_grads_j, cfg_t.lr_rate)
    _assert_adam_step_close(new_t.d_params, nj.d_params, d_grads_j, cfg_t.lr_rate)
    _assert_tree_close(new_t.d_state, nj.d_state, rtol=1e-4, atol=1e-4)


def test_kernel_regularizer_gives_no_gradient(tmp_path, pool, monkeypatch):
    """With every other term off, G's gradient is zero: the regularizer on
    the extracted kernels adds to the loss but is detached."""
    rng = np.random.default_rng(2)
    hr, crop = pool[rng.integers(0, 8, 4)], pool[rng.integers(0, 8, 4)]
    cfg = _cfg("torch", tmp_path, noise_reg_weight=0.0)
    state = ttd.init_dynamic_training(cfg, device="cpu")
    step = ttd.make_dynamic_base_step(cfg)
    monkeypatch.setattr(ttd, "lsgan_g_loss", lambda pred: 0.0 * pred.sum())
    _, m = step(state, _t(hr), _t(crop))
    assert float(m["loss_reg"]) > 0
    assert all(float(g.abs().max()) == 0 for g in tstate.tree_leaves(m["grads_G"]))


@pytest.mark.parametrize("mode", ["host", "chunk"])
def test_four_iteration_run_matches_jax(tmp_path, pool, monkeypatch, mode):
    """4 iterations of `train_dynamic` in both packages from the same init
    with JAX's draws: host batches (K=1), and the device pool with K=2
    (JAX's batch indices). CSV rows, the logged batch kernels and the
    final kernels within the tolerance (the kernels at atol 1e-6)."""
    kw = {"host": {}, "chunk": dict(device_pool=True, steps_per_call=2)}[mode]
    cfg_j, cfg_t = _cfg("jax", tmp_path / "jax", **kw), _cfg("torch", tmp_path / "torch", **kw)
    start_j = jtd.init_dynamic_training(cfg_j)
    out_j = jtd.train_dynamic(jsampler.PatchPool(pool), cfg_j, progress=False)
    start_t = _torch_state(start_j, cfg_t)
    monkeypatch.setattr(ttd, "init_dynamic_training", lambda cfg, device: start_t)
    _draws(monkeypatch, start_j.rng)
    out_t = ttd.train_dynamic(tsampler.PatchPool(pool), cfg_t, progress=False, device="cpu")
    rows_j = (tmp_path / "jax" / "training_log.txt").read_text().splitlines()
    rows_t = (tmp_path / "torch" / "training_log.txt").read_text().splitlines()
    assert rows_t[0] == rows_j[0] == ttd.DYN_LOG_HEADER.strip() and len(rows_t) == 5
    vals_j = np.array([[float(v) for v in r.split(",")] for r in rows_j[1:]])
    vals_t = np.array([[float(v) for v in r.split(",")] for r in rows_t[1:]])
    np.testing.assert_allclose(vals_t, vals_j, **TOL)
    for root in ("", "visuals", "final_results"):
        assert sorted(os.listdir(tmp_path / "torch" / root)) == \
            sorted(os.listdir(tmp_path / "jax" / root))
    for name in ("batch_kernels_iter2.npy", "batch_kernels_iter4.npy",
                 "final_results/kernel_per_band.npy", "final_results/kernel_merged.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "torch" / name),
                                   np.load(tmp_path / "jax" / name), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert out_t["kernel_per_band"].shape == (5, 13, 13)


def test_resume_and_bulk_extract(tmp_path, pool):
    """Resumed from step 2 of 4 (K=2): the same CSV and kernels as one
    uninterrupted run. bulk_extract_kernels writes one [C,13,13] kernel a
    pool entry (named by source stem, or by index), equal to JAX's on the
    same weights."""
    tp = tsampler.PatchPool(pool)
    kw = dict(device_pool=True, steps_per_call=2, ckpt_every=2)
    full = ttd.train_dynamic(tp, _cfg("torch", tmp_path / "full", **kw), progress=False,
                             device="cpu")
    ttd.train_dynamic(tp, _cfg("torch", tmp_path / "cut", iters=2, **kw), progress=False,
                      device="cpu")
    resumed = ttd.train_dynamic(tp, _cfg("torch", tmp_path / "cut", resume=True, **kw),
                                progress=False, device="cpu")
    assert resumed["state"].step == 4
    np.testing.assert_array_equal(resumed["kernel_per_band"], full["kernel_per_band"])
    assert ((tmp_path / "cut" / "training_log.txt").read_text()
            == (tmp_path / "full" / "training_log.txt").read_text())

    cfg, params = _jax_model(10)
    tparams = convert.dynamic_from_jax(params, device="cpu")
    srcs = [f"/data/scene_{i}.nc" for i in range(len(pool))]
    for sources, names in ((srcs, [f"kernel_scene_{i}.npy" for i in range(8)]),
                           (None, [f"kernel_{i:05d}.npy" for i in range(8)])):
        out = tmp_path / ("named" if sources else "indexed")
        jpaths = jtd.bulk_extract_kernels(params, jsampler.PatchPool(pool, sources=sources),
                                          str(out / "j"), cfg, batch_size=4)
        tpaths = ttd.bulk_extract_kernels(tparams, tsampler.PatchPool(pool, sources=sources),
                                          str(out / "t"), tdy.DynamicConfig(**SMALL),
                                          batch_size=4)
        assert [os.path.basename(p) for p in tpaths] == names == \
            [os.path.basename(p) for p in jpaths]
        for a, b in zip(tpaths, jpaths):
            np.testing.assert_allclose(np.load(a), np.load(b), rtol=1e-4, atol=1e-6)


# ----------------------------------------------------------------------- CLI
def _patch_dir(path, rng, n=6, hw=32, fmt="nc"):
    path.mkdir()
    for i in range(n):
        a = rng.normal(5, 2, (5, hw, hw)).astype(np.float32)
        if fmt == "nc":
            write_band_stack(path / f"p{i}.nc", "denoised", a, mode="w")
        else:
            np.save(path / f"p{i}.npy", a)
    return str(path)


def _listing(outdir):
    out = {}
    for root, _, files in os.walk(outdir):
        for f in files:
            p = os.path.join(root, f)
            rel = os.path.relpath(p, outdir)
            out[rel] = np.load(p).shape if f.endswith(".npy") else None
    return out


@pytest.mark.parametrize("fmt", ["nc", "npy"])
def test_cli_writes_the_jax_artifacts(tmp_path, fmt):
    """Both CLIs (default widths, x8; 32x32 patches) on one tiny folder with
    --bulk-extract and --target-sigma: the same files and shapes (the
    weights differ: each package draws its own init), the same CSV header
    and row count."""
    rng = np.random.default_rng(11)
    src = _patch_dir(tmp_path / "in", rng, fmt=fmt)
    args = ["--patch-dir", src, "--format", fmt, "--iters", "2", "--batch-size", "2",
            "--lr-crop-size", "8", "--bulk-extract",
            "--target-sigma", "0.1", "0.2", "0.3", "0.2", "0.1"]
    assert jcli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["--outdir", str(tmp_path / "torch"), "--device", "cpu",
                             "--trace", str(tmp_path / "trace")]) == 0
    got, want = _listing(tmp_path / "torch"), _listing(tmp_path / "jax")
    assert got == want
    assert got["final_results/kernel_per_band.npy"] == (5, 13, 13)
    assert sum(k.startswith("final_results/per_patch/") for k in got) == 6
    rows_t = (tmp_path / "torch" / "training_log.txt").read_text().splitlines()
    rows_j = (tmp_path / "jax" / "training_log.txt").read_text().splitlines()
    assert rows_t[0] == rows_j[0] and len(rows_t) == len(rows_j) == 3
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_cli_refuses_data_parallel(tmp_path):
    """--data-parallel runs (a plain process is a one-rank mesh): the same
    files as the run without it, bit for bit; with K > 1 it raises JAX's
    check_mesh_vs_scan text."""
    src = _patch_dir(tmp_path / "in", np.random.default_rng(12), fmt="npy")
    args = ["--patch-dir", src, "--format", "npy", "--iters", "2", "--batch-size", "2",
            "--lr-crop-size", "8", "--device", "cpu"]
    assert tcli.main(args + ["--outdir", str(tmp_path / "dp"), "--data-parallel"]) == 0
    assert tcli.main(args + ["--outdir", str(tmp_path / "one")]) == 0
    got = _listing(tmp_path / "dp")
    assert got == _listing(tmp_path / "one") and "final_results/kernel_per_band.npy" in got
    for rel, shape in got.items():
        if shape is not None or rel.endswith(".txt"):
            assert ((tmp_path / "dp" / rel).read_bytes()
                    == (tmp_path / "one" / rel).read_bytes()), rel
    with pytest.raises(ValueError, match="incompatible with device_pool / steps_per_call"):
        tcli.main(args + ["--outdir", str(tmp_path / "o"), "--data-parallel",
                          "--steps-per-call", "2"])
