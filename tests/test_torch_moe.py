"""Port parity: the MoE kernel bank (kmsr_tpu_torch vs kmsr_tpu) on the CPU.

`degrade_batch_kernels`, the selector and Gumbel-softmax, the MoE forward,
the `.npz` / `.pth` model files, one train step, 4-iteration runs, the
factory's and apply_kernel's `--moe` routes and the CLI, at small widths
(4 experts, HR 32, D 8x2, batch 4; the committed x4 model at its own
widths). Both packages start from the same weights (the JAX init,
converted) and see the same batches; the draws the JAX step makes with
`jax.random` are injected into the port's hooks (`tests/helpers/jax_draws.py`).
Tolerance rtol 1e-4 / atol 1e-5 unless a test says otherwise; gradients
relative to their tree's largest entry (`_scaled_tol`).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu.data import sampler as jsampler
from kmsr_tpu.io import read_band_stack, write_band_stack
from kmsr_tpu.losses import (load_balance_loss, lsgan_d_loss, lsgan_g_loss,
                             per_band_kernel_regularization)
from kmsr_tpu.models import discriminator as jd
from kmsr_tpu.models import moe as jm
from kmsr_tpu.ops.degrade import degrade_batch_kernels as j_batch_kernels
from kmsr_tpu.pipeline import apply_kernel as japply
from kmsr_tpu.pipeline import factory as jfactory
from kmsr_tpu.pipeline import train_moe_cli as jcli
from kmsr_tpu.train import moe as jmoe
from kmsr_tpu.train import single_kernel as jsk
from kmsr_tpu.utils import params_io as jio
from kmsr_tpu.utils import torch_import as jti
from kmsr_tpu_torch import convert
from kmsr_tpu_torch.data import sampler as tsampler
from kmsr_tpu_torch.models import discriminator as td
from kmsr_tpu_torch.models import moe as tm
from kmsr_tpu_torch.ops.degrade import degrade_batch_kernels as t_batch_kernels
from kmsr_tpu_torch.pipeline import apply_kernel as tapply
from kmsr_tpu_torch.pipeline import factory as tfactory
from kmsr_tpu_torch.pipeline import train_moe_cli as tcli
from kmsr_tpu_torch.train import moe as tmoe
from kmsr_tpu_torch.train import state as tstate
from kmsr_tpu_torch.utils import params_io as tio
from kmsr_tpu_torch.utils import torch_import as tti
from tests.helpers.jax_draws import JaxDraws

TOL = dict(rtol=1e-4, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "quality_run_r4", "work_x4", "kernel_run")
SMALL = dict(n_kernels=4, n_channels=5, kernel_size=13, factor=4)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


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
    """rtol 1e-4, atol 1e-5 of the tree's largest entry."""
    scale = max(float(np.abs(np.asarray(w)).max()) for w in jax.tree_util.tree_leaves(want))
    return dict(rtol=1e-4, atol=1e-5 * scale)


def _assert_adam_step_close(got, want, grads, lr):
    """Parameters after Adam's first step, update -lr * g / (|g| + eps): the
    tolerance TOL plus what a gradient error within `_scaled_tol` moves
    that update by, lr * min(2, tol_g / (|g| + eps)). A gradient near eps
    has a sign-like update whose rounding moves it by up to 2 * lr."""
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(grads))
    for g_t, w, g in zip(tstate.tree_leaves(got), jax.tree_util.tree_leaves(want),
                         jax.tree_util.tree_leaves(grads)):
        g = np.abs(np.asarray(g))
        w = np.asarray(w)
        bound = 1e-5 + 1e-4 * np.abs(w) + lr * np.minimum(
            2.0, (1e-5 * scale + 1e-4 * g) / (g + 1e-8))
        assert np.all(np.abs(g_t.detach().numpy() - w) <= bound)


def _jax_moe(seed=0, **kw):
    cfg = jm.MoEConfig(**{**SMALL, **kw})
    params, state = jm.init_moe(jax.random.PRNGKey(seed), cfg)
    # move the bank and selector off their init so the checks see real mixing
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.3, np.shape(a)).astype(np.float32), params)
    state = jax.tree_util.tree_map(
        lambda a: np.abs(np.asarray(a) + rng.normal(0, 0.2, np.shape(a))).astype(np.float32),
        state)
    return cfg, params, state


# ------------------------------------------------------- degrade_batch_kernels
_BATCH_KERNEL_CASES = [  # (factor, (H, W), decimate): odd sides only with the
    # ::f slice, since block_mean needs sides that are multiples of f
    (f, hw, dec) for f, hw in ((4, (32, 40)), (8, (64, 48))) for dec in (True, False)
] + [(4, (37, 29), True), (8, (45, 51), True)]


@pytest.mark.parametrize("padding", ["same", "replicate"])
@pytest.mark.parametrize("factor,hw,decimate", _BATCH_KERNEL_CASES)
def test_degrade_batch_kernels_matches_jax(padding, decimate, factor, hw):
    """Both paddings, both decimations, f=4 and f=8, and odd sizes."""
    rng = np.random.default_rng(factor + hw[0])
    img = rng.normal(5, 2, (3, 5, *hw)).astype(np.float32)
    k = rng.uniform(0, 1, (3, 5, 13, 13)).astype(np.float32)
    want = j_batch_kernels(jnp.asarray(img), jnp.asarray(k), factor=factor,
                                      decimate=decimate, padding=padding)
    got = t_batch_kernels(_t(img), _t(k), factor=factor, decimate=decimate,
                                     padding=padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_degrade_batch_kernels_stride_equals_slice_and_paddings_differ():
    """decimate=True (a stride-f conv) equals the ::f slice of the full
    SAME blur; the zero and replicate paddings differ on the rim only."""
    rng = np.random.default_rng(5)
    img = _t(rng.normal(5, 2, (2, 5, 37, 41)))
    k = _t(rng.uniform(0, 1, (2, 5, 13, 13)))
    full = t_batch_kernels(img, k, factor=1, decimate=True)
    np.testing.assert_allclose(t_batch_kernels(img, k, factor=4, decimate=True),
                               full[:, :, ::4, ::4], rtol=1e-6, atol=1e-6)
    same = t_batch_kernels(img, k, factor=1, decimate=True, padding="same")
    rep = t_batch_kernels(img, k, factor=1, decimate=True, padding="replicate")
    np.testing.assert_allclose(same[..., 6:-6, 6:-6], rep[..., 6:-6, 6:-6], rtol=1e-6)
    assert float((same[..., :6, :] - rep[..., :6, :]).abs().max()) > 1.0
    with pytest.raises(ValueError, match="same|replicate"):
        t_batch_kernels(img, k, padding="reflect")


# ------------------------------------------------------------- model pieces
@pytest.mark.parametrize("train", [True, False])
def test_selector_forward_matches_jax(train):
    """Logits and the new BN state (train: batch stats, the running var
    updated with the unbiased variance; eval: the running stats)."""
    cfg, params, state = _jax_moe(1)
    x = np.random.default_rng(2).normal(5, 2, (4, 5, 32, 32)).astype(np.float32)
    want, want_st = jm.selector_forward(params["selector"], state["selector"],
                                        jnp.asarray(x), train)
    tp, ts = convert.moe_from_jax(params, state, device="cpu")
    got, got_st = tm.selector_forward(tp["selector"], ts["selector"], _t(x), train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_tree_close(got_st, jax.device_get(want_st), **TOL)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_matches_jax(hard):
    """Soft and hard samples from injected uniforms, and the gradient
    (straight-through when hard) of a weighted sum of the sample."""
    key = jax.random.PRNGKey(3)
    logits = np.random.default_rng(3).normal(0, 2, (6, 5)).astype(np.float32)
    w = np.random.default_rng(4).normal(size=(6, 5)).astype(np.float32)
    u = jax.random.uniform(key, logits.shape, minval=1e-10, maxval=1.0)

    def f(lg):
        return jnp.sum(jm.gumbel_softmax(key, lg, 0.7, hard) * w)

    want = jm.gumbel_softmax(key, jnp.asarray(logits), 0.7, hard)
    want_g = jax.grad(f)(jnp.asarray(logits))
    lt = _t(logits).requires_grad_(True)
    got = tm.gumbel_softmax(lt, 0.7, hard, u=_t(u))
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), **_scaled_tol(want_g))
    if hard:
        y = got.detach().numpy()  # one-hot up to the straight-through rounding
        np.testing.assert_allclose(y, np.eye(5)[y.argmax(-1)], atol=1e-6)
    u_t = tm.gumbel_uniform(torch.Generator().manual_seed(0), (1000,), "cpu")
    assert float(u_t.min()) >= 1e-10 and float(u_t.max()) < 1.0


@pytest.mark.parametrize("train", [True, False])
def test_moe_forward_matches_jax(train):
    """Degraded batch, weights, kernels and the new state, with JAX's
    Gumbel uniforms and noise injected."""
    cfg, params, state = _jax_moe(4)
    x = np.random.default_rng(5).normal(5, 2, (4, 5, 32, 32)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    out, w, k, st = jm.moe_forward(params, state, key, jnp.asarray(x), temp=1.5,
                                   train=train, cfg=cfg)
    k_g, k_n = jax.random.split(key)
    u = jax.random.uniform(k_g, (4, cfg.n_kernels), minval=1e-10, maxval=1.0)
    noise = jax.random.normal(k_n, out.shape)
    tp, ts = convert.moe_from_jax(params, state, device="cpu")
    got = tm.moe_forward(tp, ts, _t(x), 1.5, train=train, cfg=tm.MoEConfig(**SMALL),
                         gumbel_u=_t(u), noise=_t(noise))
    for g, want in zip(got[:3], (out, w, k)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)
    _assert_tree_close(got[3], jax.device_get(st), **TOL)
    np.testing.assert_allclose(tm.effective_sigmas(tp).numpy(),
                               np.asarray(jm.effective_sigmas(params)), **TOL)


# --------------------------------------------------------------- model files
def test_committed_model_loads_and_selects_like_jax():
    """The committed x4 model (moe_model.npz + moe_state.npz) through both
    packages' factory loaders: the same tensors, eval mode, and on a seeded
    4x5x64x64 batch the same logits and experts."""
    jp, js, jeval = jfactory.load_moe_for_factory(COMMITTED)
    tp, ts, teval = tfactory.load_moe_for_factory(COMMITTED, device="cpu")
    assert jeval and teval
    _assert_tree_close(tp, jax.device_get(jp), rtol=0, atol=0)
    _assert_tree_close(ts, jax.device_get(js), rtol=0, atol=0)
    assert tuple(tp["kernel_bank"].shape) == (10, 5, 13, 13)
    x = np.random.default_rng(6).normal(5, 2, (4, 5, 64, 64)).astype(np.float32)
    want, _ = jm.selector_forward(jp["selector"], js["selector"], jnp.asarray(x), False)
    got = tfactory.moe_logits((tp, ts, teval), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


def test_npz_round_trip_both_ways(tmp_path):
    """The port writes, JAX's load_params reads; JAX's save_params writes,
    the port reads; the name_* entries are equal both ways and equal the
    committed file's."""
    _, params, state = _jax_moe(8)
    tp, ts = convert.moe_from_jax(params, state, device="cpu")
    tio.save_params(str(tmp_path / "t.npz"), tp)
    jio.save_params(str(tmp_path / "j.npz"), params)
    jio.save_params(str(tmp_path / "js.npz"), state)
    tio.save_params(str(tmp_path / "ts.npz"), ts)
    for a, b in (("t", "j"), ("ts", "js")):
        fa, fb = np.load(tmp_path / f"{a}.npz"), np.load(tmp_path / f"{b}.npz")
        assert sorted(fa.files) == sorted(fb.files)
        for name in fa.files:
            np.testing.assert_array_equal(fa[name], fb[name])
    committed = np.load(os.path.join(COMMITTED, "moe_model.npz"))
    mine = np.load(tmp_path / "t.npz")
    assert [str(mine[f"name_{i:04d}"]) for i in range(16)] == \
        [str(committed[f"name_{i:04d}"]) for i in range(16)]
    back_j = jio.load_params(str(tmp_path / "t.npz"), params)
    back_t = tio.load_params(str(tmp_path / "j.npz"), tp)
    _assert_tree_close(tp, back_j, rtol=0, atol=0)
    _assert_tree_close(back_t, params, rtol=0, atol=0)
    bad = dict(tp, kernel_bank=torch.zeros(3, 5, 13, 13))
    msgs = []
    for load, tmpl in ((jio.load_params, dict(params, kernel_bank=np.zeros((3, 5, 13, 13)))),
                       (tio.load_params, bad)):
        with pytest.raises(ValueError) as e:
            load(str(tmp_path / "t.npz"), tmpl)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _reference_pth(path, params, state):
    """A synthetic `moe_model.pth` in the reference's key layout."""
    sd = {"kernel_bank": _t(params["kernel_bank"]), "sigma_bank": _t(params["sigma_bank"]),
          "selector.classifier.weight": _t(params["selector"]["fc_w"]),
          "selector.classifier.bias": _t(params["selector"]["fc_b"])}
    for i, (conv_i, bn_i) in enumerate(((0, 1), (3, 4), (6, 7))):
        sd[f"selector.features.{conv_i}.weight"] = _t(params["selector"]["convs"][i]["w"])
        sd[f"selector.features.{conv_i}.bias"] = _t(params["selector"]["convs"][i]["b"])
        sd[f"selector.features.{bn_i}.weight"] = _t(params["selector"]["bn_scale"][i])
        sd[f"selector.features.{bn_i}.bias"] = _t(params["selector"]["bn_bias"][i])
        sd[f"selector.features.{bn_i}.running_mean"] = _t(state["selector"]["bn_mean"][i])
        sd[f"selector.features.{bn_i}.running_var"] = _t(state["selector"]["bn_var"][i])
        sd[f"selector.features.{bn_i}.num_batches_tracked"] = torch.tensor(5)
    torch.save(sd, path)


def test_reference_pth_loads_equally_and_bank_check_matches(tmp_path):
    _, params, state = _jax_moe(9)
    path = str(tmp_path / "moe_model.pth")
    _reference_pth(path, params, state)
    jp, js = jti.load_moe_torch_checkpoint(path, jm.MoEConfig(**SMALL))
    tp, ts = tti.load_moe_torch_checkpoint(path, tm.MoEConfig(**SMALL), device="cpu")
    _assert_tree_close(tp, jax.device_get(jp), rtol=0, atol=0)
    _assert_tree_close(ts, jax.device_get(js), rtol=0, atol=0)
    fp, fs, ev = tfactory.load_moe_for_factory(path, device="cpu")
    assert ev and tuple(fp["kernel_bank"].shape) == (4, 5, 13, 13)
    msgs = []
    for load, cfg, kw in ((jti.load_moe_torch_checkpoint, jm.MoEConfig(), {}),
                          (tti.load_moe_torch_checkpoint, tm.MoEConfig(), {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            load(path, cfg, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "[4,5]" in msgs[0]


# ------------------------------------------------------------------ training
def _cfg(pkg, outdir, **kw):
    tr, mm, dm = (jmoe, jm, jd) if pkg == "jax" else (tmoe, tm, td)
    fields = dict(iters=4, batch_size=4, hr_patch_size=32, lr_crop_size=8, log_every=1,
                  outdir=str(outdir), verbose=False, model=mm.MoEConfig(**SMALL),
                  discriminator=dm.DiscriminatorConfig(base_ch=8, num_blocks=2),
                  device_pool=False)
    return tr.MoETrainConfig(**{**fields, **kw})


@pytest.fixture(scope="module")
def pool():
    return jsampler.synthetic_pool(np.random.default_rng(3), n=8, size=32).patches


def _torch_state(js, cfg):
    js = jax.device_get(js)
    g, ms = convert.moe_from_jax(js.g_params, js.d_state["moe"], device="cpu")
    d, ds = convert.discriminator_from_jax(js.d_params, js.d_state["disc"], device="cpu")
    tx = tstate.make_gan_optimizers(cfg.lr_rate, grad_clip_norm=None)
    return tstate.init_gan_state(torch.Generator().manual_seed(cfg.seed), g, d,
                                 {"disc": ds, "moe": ms}, tx, tx)


def _draws(monkeypatch, key):
    draws = JaxDraws(key, 2)
    draws.install(monkeypatch, tstate, tmoe, tm)
    return draws


def _jax_grads(cfg, state, new_state, hr, crop_src, temp):
    """The gradients of the JAX step's D and G losses
    (`kmsr_tpu/train/moe.py:90-121`), G's against the updated D; also the
    losses, to hold the replica to the step."""
    _, k_crop, k_fwd1, k_fwd2 = jax.random.split(state.rng, 4)
    real = jsk.random_crops(k_crop, crop_src, cfg.lr_crop_size)
    mp, ms = state.g_params, state.d_state["moe"]
    fake = jax.lax.stop_gradient(jm.moe_forward(mp, ms, k_fwd1, hr, temp=temp,
                                                cfg=cfg.model)[0])

    def d_loss(dp):
        pr, st = jd.discriminator_forward(dp, state.d_state["disc"], real, train=True)
        pf, st = jd.discriminator_forward(dp, st, fake, train=True)
        return lsgan_d_loss(pr, pf), st

    (ld, st), d_grads = jax.value_and_grad(d_loss, has_aux=True)(state.d_params)

    def g_loss(p):
        f, w, k, _ = jm.moe_forward(p, ms, k_fwd2, hr, temp=temp, cfg=cfg.model)
        pf, _ = jd.discriminator_forward(new_state.d_params, st, f, train=True)
        reg = per_band_kernel_regularization(k.mean(axis=0), cfg.reg_weights,
                                             center_max=False)
        return lsgan_g_loss(pf) + reg + cfg.balance_weight * load_balance_loss(w)

    return ld, d_grads, jax.grad(g_loss)(mp)


@pytest.mark.parametrize("balance", [0.0, 0.5])
def test_train_step_matches_jax(tmp_path, pool, monkeypatch, balance):
    """One D + G step from the same weights with JAX's draws: losses,
    selection counts, gradients, updated parameters (selector, banks, D)
    and states (the G step's selector BN update, D's BN and u)."""
    rng = np.random.default_rng(1)
    hr, crop = pool[rng.integers(0, 8, 4)], pool[rng.integers(0, 8, 4)]
    cfg_j = _cfg("jax", tmp_path, balance_weight=balance)
    cfg_t = _cfg("torch", tmp_path, balance_weight=balance)
    state_j = jmoe.init_moe_training(cfg_j)
    state_t = _torch_state(state_j, cfg_t)
    _draws(monkeypatch, state_j.rng)
    step_j, _ = jmoe.make_moe_train_step(cfg_j)
    new_j, m_j = step_j(jax.tree_util.tree_map(jnp.copy, state_j), jnp.asarray(hr),
                        jnp.asarray(crop), jnp.float32(2.5))
    ld, d_grads_j, g_grads_j = jax.jit(lambda *a: _jax_grads(cfg_j, *a), static_argnums=())(
        state_j, new_j, jnp.asarray(hr), jnp.asarray(crop), jnp.float32(2.5))
    assert float(ld) == pytest.approx(float(m_j["loss_D"]), rel=1e-6)

    new_t, m_t = tmoe.make_moe_base_step(cfg_t)(state_t, _t(hr), _t(crop), np.float32(2.5))
    assert new_t.step == int(new_j.step) == 1
    for k in ("loss_D", "loss_G_adv", "loss_reg", "loss_balance"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), **TOL, err_msg=k)
    np.testing.assert_array_equal(m_t["selection"].numpy(), np.asarray(m_j["selection"]))
    assert float(m_t["selection"].sum()) == 4
    _assert_tree_close(m_t["grads_D"], d_grads_j, **_scaled_tol(d_grads_j))
    _assert_tree_close(m_t["grads_G"], g_grads_j, **_scaled_tol(g_grads_j))
    nj = jax.device_get(new_j)
    _assert_adam_step_close(new_t.g_params, nj.g_params, g_grads_j, cfg_t.lr_rate)
    _assert_adam_step_close(new_t.d_params, nj.d_params, d_grads_j, cfg_t.lr_rate)
    _assert_tree_close(new_t.d_state, nj.d_state, rtol=1e-4, atol=1e-4)


def test_d_step_bn_update_is_discarded(tmp_path, pool, monkeypatch):
    """The running stats after one step equal those of the G step's forward
    alone (momentum 0.1 applied once), not of two forwards."""
    rng = np.random.default_rng(2)
    hr, crop = pool[rng.integers(0, 8, 4)], pool[rng.integers(0, 8, 4)]
    cfg_j = _cfg("jax", tmp_path)
    cfg_t = _cfg("torch", tmp_path)
    state_j = jmoe.init_moe_training(cfg_j)
    state_t = _torch_state(state_j, cfg_t)
    _draws(monkeypatch, state_j.rng)
    _, once = tm.selector_forward(state_t.g_params["selector"],
                                  state_t.d_state["moe"]["selector"], _t(hr), train=True)
    new_t, _ = tmoe.make_moe_base_step(cfg_t)(state_t, _t(hr), _t(crop), 1.0)
    _assert_tree_close(new_t.d_state["moe"]["selector"],
                       jax.tree_util.tree_map(lambda t: t.numpy(), once), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["host", "chunk", "balance"])
def test_four_iteration_run_matches_jax(tmp_path, pool, monkeypatch, mode):
    """4 iterations of `train_moe` in both packages from the same init with
    JAX's draws: host batches (K=1); the device pool with K=2 chunks (the
    temperature schedule riding the chunk as per-step inputs, the batch
    indices JAX's); host batches with balance_weight 0.5. History (loss_D,
    selections) and every artifact (kernels, sigmas, moe_model.npz,
    moe_state.npz) within the tolerance, except the raw parameters
    (moe_model.npz), within 2 * lr * iters: an entry whose gradient is ~0
    (the selector's conv biases ahead of a BatchNorm, far kernel-bank
    entries) takes Adam steps of +-lr whose sign is rounding, in either
    package; what the parameters make (the effective kernels kernel_i.npy,
    the sigmas, the selections, loss_D) is held to the tolerance."""
    kw = {"host": {}, "chunk": dict(device_pool=True, steps_per_call=2, log_every=2),
          "balance": dict(balance_weight=0.5)}[mode]
    cfg_j = _cfg("jax", tmp_path / "jax", **kw)
    cfg_t = _cfg("torch", tmp_path / "torch", **kw)
    start_j = jmoe.init_moe_training(cfg_j)
    out_j = jmoe.train_moe(jsampler.PatchPool(pool), cfg_j, progress=False)
    start_t = _torch_state(start_j, cfg_t)
    monkeypatch.setattr(tmoe, "init_moe_training", lambda cfg, init_from, device: start_t)
    _draws(monkeypatch, start_j.rng)
    out_t = tmoe.train_moe(tsampler.PatchPool(pool), cfg_t, progress=False, device="cpu")
    assert len(out_t["history"]) == len(out_j["history"]) == (2 if mode == "chunk" else 4)
    for (it_t, d_t, sel_t), (it_j, d_j, sel_j) in zip(out_t["history"], out_j["history"]):
        assert it_t == it_j
        np.testing.assert_allclose(d_t, d_j, **TOL)
        np.testing.assert_array_equal(sel_t, sel_j)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names and len(names) == 2 * 4 + 2
    for name in names:
        a, b = np.load(tmp_path / "torch" / name), np.load(tmp_path / "jax" / name)
        if name.endswith(".npz"):
            assert a.files == b.files
            for f in a.files:
                if f.startswith("name_"):
                    assert a[f] == b[f]
                elif name == "moe_model.npz":
                    np.testing.assert_allclose(a[f], b[f], rtol=1e-4,
                                               atol=2 * cfg_t.lr_rate * cfg_t.iters,
                                               err_msg=f)
                else:
                    np.testing.assert_allclose(a[f], b[f], **TOL, err_msg=f"{name} {f}")
        else:
            np.testing.assert_allclose(a, b, **TOL, err_msg=name)


def test_init_from_npz_and_pth(tmp_path, pool):
    """--init-from an `.npz` written by the JAX package (+ its sibling
    moe_state.npz) and a reference `.pth`: the port's start state holds
    those weights and BN stats."""
    _, params, state = _jax_moe(11)
    d = tmp_path / "run"
    d.mkdir()
    jio.save_params(str(d / "moe_model.npz"), params)
    jio.save_params(str(d / "moe_state.npz"), state)
    _reference_pth(str(tmp_path / "moe_model.pth"), params, state)
    cfg = _cfg("torch", tmp_path / "o")
    for src in (str(d / "moe_model.npz"), str(tmp_path / "moe_model.pth")):
        st = tmoe.init_moe_training(cfg, init_from=src, device="cpu")
        _assert_tree_close(st.g_params, params, rtol=0, atol=0)
        _assert_tree_close(st.d_state["moe"], state, rtol=0, atol=0)
        assert all(p.requires_grad for p in tstate.tree_leaves(st.g_params))


def test_resume_and_refusals(tmp_path, pool):
    """Checkpoints at 2 and 4 of 4 (K=2); resumed from step 2, the run
    ends where the uninterrupted one did (the same weights, bit for bit:
    the temperature schedule spans `iters` either way). K without the
    device pool and non-multiple intervals are refused with JAX's
    messages."""
    tp = tsampler.PatchPool(pool)
    kw = dict(device_pool=True, steps_per_call=2, ckpt_every=2, log_every=2)
    full = tmoe.train_moe(tp, _cfg("torch", tmp_path / "full", **kw), progress=False,
                          device="cpu")
    os.remove(tmp_path / "full" / "ckpt" / "step_4")
    resumed = tmoe.train_moe(tp, _cfg("torch", tmp_path / "full", resume=True, **kw),
                             progress=False, device="cpu")
    assert resumed["state"].step == 4 and len(resumed["history"]) == 1
    for a, b in zip(tstate.tree_leaves(resumed["state"].g_params),
                    tstate.tree_leaves(full["state"].g_params)):
        assert torch.equal(a, b)
    for overrides in (dict(steps_per_call=2, device_pool=False),
                      dict(steps_per_call=2, device_pool=True, log_every=3)):
        msgs = []
        for pkg, sampler, kwargs in (("jax", jsampler, {}), ("torch", tsampler,
                                                            {"device": "cpu"})):
            mod = jmoe if pkg == "jax" else tmoe
            with pytest.raises(ValueError) as e:
                mod.train_moe(sampler.PatchPool(pool),
                              _cfg(pkg, tmp_path / pkg, **overrides), progress=False,
                              **kwargs)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------- factory / apply
def _patch_dir(path, rng, n=6, hw=32, fmt="nc"):
    """n patches, each band with its own contrast and offset (so the
    selector routes them to different experts)."""
    path.mkdir()
    for i in range(n):
        a = (rng.normal(0, 1, (5, hw, hw)) * rng.uniform(0.1, 10, (5, 1, 1))
             + rng.uniform(-10, 10, (5, 1, 1))).astype(np.float32)
        if fmt == "nc":
            write_band_stack(path / f"p{i}.nc", "denoised", a, mode="w")
        else:
            np.save(path / f"p{i}.npy", a)
    return str(path)


def _moe_dir(tmp_path, with_state=True):
    """A model dir (JAX's .npz files) whose selector spreads such patches
    over several experts: a scaled classifier without bias, and running
    stats settled on a calibration batch of them."""
    _, params, state = _jax_moe(12)
    params["selector"]["fc_w"] = params["selector"]["fc_w"] * 10
    params["selector"]["fc_b"] = params["selector"]["fc_b"] * 0
    rng = np.random.default_rng(99)
    calib = jnp.asarray((rng.normal(0, 1, (16, 5, 32, 32)) * rng.uniform(0.1, 10, (16, 5, 1, 1))
                         + rng.uniform(-10, 10, (16, 5, 1, 1))).astype(np.float32))
    sel = state["selector"]
    for _ in range(60):
        _, sel = jm.selector_forward(params["selector"], sel, calib, True)
    d = tmp_path / "kernel_run"
    d.mkdir()
    jio.save_params(str(d / "moe_model.npz"), params)
    if with_state:
        jio.save_params(str(d / "moe_state.npz"), {"selector": sel})
    return str(d)


def _expert_attr(path, group):
    import h5py

    with h5py.File(path, "r") as f:
        return int(f[group].attrs["moe_expert"])


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("fmt", ["nc", "npy"])
def test_factory_moe_matches_jax(tmp_path, fmt, with_state):
    """factory --moe (pool noise) at x4: lr within the tolerance of JAX's,
    equal moe_expert attributes, hr copied; eval mode (moe_state.npz
    beside the model) and batch-statistics mode (no state: the 6 files run
    as one batch of 4 and one of 2 in both packages)."""
    rng = np.random.default_rng(13)
    src = _patch_dir(tmp_path / "in", rng, fmt=fmt)
    pool_path = str(tmp_path / "pool.npy")
    np.save(pool_path, rng.normal(0, 0.1, (10, 5, 8, 8)).astype(np.float32))
    model = _moe_dir(tmp_path, with_state)
    kw = dict(factor=4, batch_size=4, seed=42, progress=False, moe_path=model)
    rj = jfactory.run_factory(src, None, pool_path, str(tmp_path / "j"), **kw)
    rt = tfactory.run_factory(src, None, pool_path, str(tmp_path / "t"), device="cpu", **kw)
    assert rj.n_ok == rt.n_ok == 6 and rt.n_fail == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    experts = set()
    for name in names:
        pj, pt = str(tmp_path / "j" / name), str(tmp_path / "t" / name)
        np.testing.assert_allclose(read_band_stack(pt, "lr"), read_band_stack(pj, "lr"), **TOL)
        np.testing.assert_array_equal(read_band_stack(pt, "hr"), read_band_stack(pj, "hr"))
        assert _expert_attr(pt, "lr") == _expert_attr(pj, "lr")
        experts.add(_expert_attr(pt, "lr"))
    assert len(experts) > 1  # the check sees more than one expert


def test_apply_kernel_moe_matches_jax_and_the_factory(tmp_path):
    """apply_kernel --moe: blurred groups within the tolerance of JAX's,
    equal moe_expert attributes; and equal to the factory's lr minus its
    pool noise."""
    rng = np.random.default_rng(14)
    src = _patch_dir(tmp_path / "in", rng)
    model = _moe_dir(tmp_path)
    kw = dict(factor=4, batch_size=4, progress=False, moe_path=model)
    rj = japply.apply_kernel_to_folder(src, None, str(tmp_path / "j"), **kw)
    rt = tapply.apply_kernel_to_folder(src, None, str(tmp_path / "t"), device="cpu", **kw)
    assert rj.n_ok == rt.n_ok == 6
    pool_path = str(tmp_path / "pool.npy")
    pool = rng.normal(0, 0.1, (10, 5, 8, 8)).astype(np.float32)
    np.save(pool_path, pool)
    tfactory.run_factory(src, None, pool_path, str(tmp_path / "f"), device="cpu", **kw)
    files = sorted(os.path.join(src, f) for f in os.listdir(src))
    idx = np.random.default_rng(42).integers(0, 10, size=len(files))
    for i, name in enumerate(sorted(os.listdir(tmp_path / "t"))):
        pj, pt = str(tmp_path / "j" / name), str(tmp_path / "t" / name)
        got = read_band_stack(pt, "blurred")
        np.testing.assert_allclose(got, read_band_stack(pj, "blurred"), **TOL)
        assert _expert_attr(pt, "blurred") == _expert_attr(pj, "blurred")
        lr = read_band_stack(str(tmp_path / "f" / f"p{i}_train.nc"), "lr")
        np.testing.assert_allclose(lr - pool[idx[i]], got, rtol=1e-5, atol=1e-5)


def test_factory_moe_sigma_noise(tmp_path):
    """--moe-noise sigma: reproducible for one seed, different for another;
    lr minus the noise-free blur is noise whose per-band std matches
    softplus(sigma_bank) of each patch's expert."""
    rng = np.random.default_rng(15)
    src = _patch_dir(tmp_path / "in", rng, n=8, hw=64)
    pool_path = str(tmp_path / "pool.npy")
    np.save(pool_path, np.zeros((4, 5, 16, 16), np.float32))
    model = _moe_dir(tmp_path)
    kw = dict(factor=4, batch_size=4, progress=False, moe_path=model, moe_noise="sigma",
              device="cpu")
    for out, seed in (("a", 42), ("b", 42), ("c", 7)):
        tfactory.run_factory(src, None, pool_path, str(tmp_path / out), seed=seed, **kw)
    tapply.apply_kernel_to_folder(src, None, str(tmp_path / "clean"), factor=4,
                                  progress=False, moe_path=model, device="cpu")
    params, _, _ = tfactory.load_moe_for_factory(model, device="cpu")
    sig = tm.effective_sigmas(params).numpy()
    resid = []
    for i in range(8):
        name = f"p{i}_train.nc"
        a = read_band_stack(str(tmp_path / "a" / name), "lr")
        np.testing.assert_array_equal(a, read_band_stack(str(tmp_path / "b" / name), "lr"))
        assert not np.array_equal(a, read_band_stack(str(tmp_path / "c" / name), "lr"))
        clean_path = str(tmp_path / "clean" / f"p{i}_blurred.nc")
        e = _expert_attr(clean_path, "blurred")
        assert e == _expert_attr(str(tmp_path / "a" / name), "lr")
        resid.append((a - read_band_stack(clean_path, "blurred")) / sig[e][:, None, None])
    z = np.stack(resid)  # standardized noise, 8 x 5 x 16 x 16
    assert abs(z.std() - 1) < 0.05 and abs(z.mean()) < 0.05
    assert np.all(np.abs(z.std(axis=(0, 2, 3)) - 1) < 0.1)


def test_factory_and_apply_refusals(tmp_path):
    """Exactly one source; --kernel-root is taken: a scene with no kernel
    under the root fails all of its files (rc 1), as in JAX."""
    for fn in (lambda **kw: tfactory.run_factory("d", None, "p", str(tmp_path / "o"), **kw),
               lambda **kw: tapply.apply_kernel_to_folder("d", None, str(tmp_path / "o"),
                                                          **kw)):
        with pytest.raises(ValueError, match="exactly one"):
            fn(device="cpu")
        with pytest.raises(ValueError, match="exactly one"):
            fn(device="cpu", moe_path="m", kernel_root="r")
    src = tmp_path / "in"
    src.mkdir()
    write_band_stack(src / "sceneA_000_000.nc", "denoised",
                     np.ones((5, 16, 16), np.float32), mode="w")
    (tmp_path / "root").mkdir()
    rep = tfactory.run_factory(str(src), None, "p", str(tmp_path / "o"), device="cpu",
                               kernel_root=str(tmp_path / "root"), progress=False)
    assert rep.n_ok == 0 and rep.n_fail == 1 and "no kernel for scene 'sceneA'" in rep.failed[0][1]
    assert tfactory.main(["--input-dir", str(src), "--kernel-root", str(tmp_path / "root"),
                          "--noise-pool", "p", "--output-dir", str(tmp_path / "o"),
                          "--device", "cpu"]) == 1
    assert tapply.main(["--input-dir", str(src), "--kernel-root", str(tmp_path / "root"),
                        "--output-dir", str(tmp_path / "o"), "--device", "cpu"]) == 1
    with pytest.raises(SystemExit):  # the sources exclude each other
        tapply.build_parser().parse_args(["--input-dir", "d", "--kernel", "k",
                                          "--moe", "m", "--output-dir", "o"])


# ----------------------------------------------------------------------- CLI
@pytest.mark.parametrize("fmt", ["nc", "npy"])
def test_cli_writes_the_jax_artifacts(tmp_path, fmt):
    """Both CLIs on one tiny patch folder: the same artifact names and
    shapes (the weights differ: each package draws its own init); the
    port's moe_model.npz loads in JAX's factory loader."""
    rng = np.random.default_rng(16)
    src = _patch_dir(tmp_path / "in", rng, n=6, hw=32, fmt=fmt)
    args = ["--patch-dir", src, "--format", fmt, "--iters", "2", "--batch-size", "2",
            "--n-kernels", "3"]
    assert jcli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["--outdir", str(tmp_path / "torch"), "--device", "cpu",
                             "--trace", str(tmp_path / "trace")]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names and len(names) == 8
    for name in names:
        a, b = np.load(tmp_path / "torch" / name), np.load(tmp_path / "jax" / name)
        if name.endswith(".npz"):
            assert a.files == b.files
            assert all(a[f].shape == b[f].shape for f in a.files)
        else:
            assert a.shape == b.shape
    k0 = np.load(tmp_path / "torch" / "kernel_0.npy")
    np.testing.assert_allclose(k0.sum(axis=(1, 2)), 1.0, rtol=1e-5)
    jp, _, ev = jfactory.load_moe_for_factory(str(tmp_path / "torch"))
    assert ev and jp["kernel_bank"].shape == (3, 5, 13, 13)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_cli_refuses_data_parallel(tmp_path):
    """--data-parallel runs (a plain process is a one-rank mesh): the same
    artifacts as the run without it, bit for bit; with K > 1 it raises
    JAX's check_mesh_vs_scan text."""
    src = _patch_dir(tmp_path / "in", np.random.default_rng(17), n=6, hw=32, fmt="npy")
    args = ["--patch-dir", src, "--format", "npy", "--iters", "2", "--batch-size", "2",
            "--n-kernels", "3", "--device", "cpu"]
    assert tcli.main(args + ["--outdir", str(tmp_path / "dp"), "--data-parallel"]) == 0
    assert tcli.main(args + ["--outdir", str(tmp_path / "one")]) == 0
    names = sorted(os.listdir(tmp_path / "one"))
    assert sorted(os.listdir(tmp_path / "dp")) == names and len(names) == 8
    for name in names:
        a, b = np.load(tmp_path / "dp" / name), np.load(tmp_path / "one" / name)
        if name.endswith(".npz"):  # zip members carry their write time
            assert a.files == b.files
            assert all(np.array_equal(a[f], b[f]) for f in a.files)
        else:
            assert (tmp_path / "dp" / name).read_bytes() == (tmp_path / "one" / name).read_bytes()
    with pytest.raises(ValueError, match="incompatible with device_pool / steps_per_call"):
        tcli.main(args + ["--outdir", str(tmp_path / "o"), "--data-parallel",
                          "--steps-per-call", "2"])
