"""Port parity: KernelGAN's kernel algebra, generator, discriminator,
losses and kernel metrics (kmsr_tpu_torch vs kmsr_tpu).

The same seeded numpy inputs and weights (converted from the JAX pytrees
with `convert.generator_from_jax` / `discriminator_from_jax`) go through
both packages on the CPU, values and gradients alike. Tolerances: values
rtol 1e-5 / atol 1e-6 for the linear generator and kernel algebra (float32
convs summed in another order), rtol 1e-4 / atol 1e-5 for the
discriminator (batch statistics and the power iteration amplify the
rounding); gradients rtol 1e-4 and atol 1e-4 (generator), 1e-5 (losses)
or 1e-5 of the largest entry (discriminator); exact for the numpy
metrics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu import losses as jl
from kmsr_tpu.analysis.kernel_metrics import _bilinear_resize as j_resize
from kmsr_tpu.analysis.kernel_metrics import ascii_kernel as j_ascii
from kmsr_tpu.analysis.kernel_metrics import kernel_delta_l2 as j_delta
from kmsr_tpu.analysis.kernel_metrics import kernel_metrics as j_metrics
from kmsr_tpu.models import discriminator as jd
from kmsr_tpu.models import generator as jg
from kmsr_tpu.ops import kernel_algebra as jka
from kmsr_tpu_torch import convert
from kmsr_tpu_torch import losses as tl
from kmsr_tpu_torch.analysis.kernel_metrics import _bilinear_resize as t_resize
from kmsr_tpu_torch.analysis.kernel_metrics import ascii_kernel as t_ascii
from kmsr_tpu_torch.analysis.kernel_metrics import kernel_delta_l2 as t_delta
from kmsr_tpu_torch.analysis.kernel_metrics import kernel_metrics as t_metrics
from kmsr_tpu_torch.models import discriminator as td
from kmsr_tpu_torch.models import generator as tg
from kmsr_tpu_torch.ops import kernel_algebra as tka
from kmsr_tpu_torch.train.state import tree_leaves, tree_unflatten

TOL = dict(rtol=1e-5, atol=1e-6)
D_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return x.detach().numpy()


def _trainable(tree):
    for p in tree_leaves(tree):
        p.requires_grad_(True)
    return tree


def _assert_trees_close(got, want, **tol):
    """got: torch tree; want: JAX / numpy pytree of the same layout (JAX
    orders dict leaves by key, so walk the two together)."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _assert_trees_close(got[k], want[k], **tol)
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_close(g, w, **tol)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), **tol)


# ------------------------------------------------------------ kernel algebra
def test_compose_pair_chain_and_full_conv_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(3, 4, 5, 5)).astype(np.float32)
    b = rng.normal(size=(2, 3, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tka.compose_pair(_t(b), _t(a))),
                               np.asarray(jka.compose_pair(b, a)), **TOL)
    chain = [rng.normal(0, 0.3, size=s).astype(np.float32)
             for s in ((6, 1, 7, 7), (6, 6, 5, 5), (6, 6, 3, 3), (1, 6, 1, 1))]
    np.testing.assert_allclose(_np(tka.compose_chain([_t(w) for w in chain])),
                               np.asarray(jka.compose_chain(chain)), **TOL)
    np.testing.assert_allclose(_np(tka.effective_kernel([_t(w) for w in chain])),
                               np.asarray(jka.effective_kernel(chain)), **TOL)
    k1, k2 = rng.normal(size=(5, 5)), rng.normal(size=(3, 4))
    np.testing.assert_allclose(_np(tka.full_conv2d(_t(k1), _t(k2))),
                               np.asarray(jka.full_conv2d(k1.astype(np.float32),
                                                          k2.astype(np.float32))), **TOL)
    # the band axis: G chains in one grouped conv == each chain alone
    banded = [np.stack([w * (1 + 0.1 * g) for g in range(3)]) for w in chain]
    got = _np(tka.compose_chain([_t(w) for w in banded]))
    for g in range(3):
        want = np.asarray(jka.compose_chain([w[g] for w in banded]))
        np.testing.assert_allclose(got[g], want, **TOL)


# ----------------------------------------------------------------- generator
@pytest.mark.parametrize("mid_ch", [32, 8])
def test_generator_init_equals_jax(mid_ch):
    cfg = tg.GeneratorConfig(mid_ch=mid_ch)
    jcfg = jg.GeneratorConfig(mid_ch=mid_ch)
    assert cfg.layer_channels == jcfg.layer_channels
    assert cfg.effective_kernel_size == jcfg.effective_kernel_size == 13
    got = tg.init_generator(cfg, device="cpu")
    want = jg.init_generator(jcfg)
    for g, w in zip(got["layers"], want["layers"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-7)
    np.testing.assert_allclose(_np(tg.gaussian_kernel(7, 2.0)),
                               np.asarray(jg.gaussian_kernel(7, 2.0)), rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def g_weights():
    """JAX init (mid_ch 8) perturbed off the Gaussian/identity structure."""
    rng = np.random.default_rng(2)
    params = jax.device_get(jg.init_generator(jg.GeneratorConfig(mid_ch=8)))
    return {"layers": [np.asarray(w + rng.normal(0, 0.05, w.shape), np.float32)
                       for w in params["layers"]]}


@pytest.mark.parametrize("mode", ["chain", "compose"])
def test_generator_forward_and_grads_match_jax(g_weights, mode):
    rng = np.random.default_rng(3)
    x = rng.normal(5, 2, (2, 5, 64, 64)).astype(np.float32)
    r = rng.normal(size=(2, 5, 8, 8)).astype(np.float32)

    def j_obj(p):
        return jnp.sum(jg.generator_forward(p, x, forward_mode=mode) * r)

    want_y = jg.generator_forward(g_weights, x, forward_mode=mode)
    want_g = jax.grad(j_obj)(g_weights)
    p = _trainable(convert.generator_from_jax(g_weights, device="cpu"))
    y = tg.generator_forward(p, _t(x), forward_mode=mode)
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **TOL)
    grads = torch.autograd.grad((y * _t(r)).sum(), p["layers"])
    for g, w in zip(grads, want_g["layers"]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_extract_kernels_match_jax(g_weights):
    p = convert.generator_from_jax(g_weights, device="cpu")
    for fn in ("raw_effective_kernels", "extract_kernels_raw", "extract_kernels",
               "extract_merged_kernel"):
        got, want = getattr(tg, fn)(p), getattr(jg, fn)(g_weights)
        assert tuple(got.shape) == want.shape, fn
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL, err_msg=fn)
    np.testing.assert_allclose(_np(tg.extract_kernels(p)).sum((1, 2)), 1.0, rtol=1e-5)
    assert tg.generator_weight_stats(p) == jg.generator_weight_stats(g_weights)


def test_extraction_stop_gradient_quirk(g_weights):
    """The regularizer gives G no gradient unless differentiable=True (the
    JAX stop_gradient); with it, the gradient is JAX's."""
    def j_reg(params, differentiable):
        return jl.per_band_kernel_regularization(
            jg.extract_kernels(params, differentiable=differentiable))

    p = _trainable(convert.generator_from_jax(g_weights, device="cpu"))
    quirk = tl.per_band_kernel_regularization(tg.extract_kernels(p))
    assert not quirk.requires_grad
    for w in jax.tree_util.tree_leaves(jax.grad(j_reg)(g_weights, False)):
        assert not np.asarray(w).any()
    np.testing.assert_allclose(_np(quirk), np.asarray(j_reg(g_weights, False)), **TOL)
    reg = tl.per_band_kernel_regularization(tg.extract_kernels(p, differentiable=True))
    grads = torch.autograd.grad(reg, p["layers"])
    want = jax.grad(j_reg)(g_weights, True)["layers"]
    for g, w in zip(grads, want):
        assert np.abs(_np(g)).max() > 0
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- discriminator
@pytest.fixture(scope="module")
def d_weights():
    params, state = jd.init_discriminator(
        jax.random.PRNGKey(1), jd.DiscriminatorConfig(base_ch=16, num_blocks=2))
    params, state = jax.device_get((params, state))
    rng = np.random.default_rng(4)
    # BN affine away from identity so scale / bias gradients differ per channel
    params["bn_scale"] = [np.asarray(1 + rng.normal(0, 0.1, s.shape), np.float32)
                          for s in params["bn_scale"]]
    params["bn_bias"] = [np.asarray(rng.normal(0, 0.1, s.shape), np.float32)
                         for s in params["bn_bias"]]
    return params, state


def _d_inputs():
    rng = np.random.default_rng(5)
    return (rng.normal(5, 2, (4, 5, 12, 12)).astype(np.float32),
            rng.normal(4, 1, (4, 5, 12, 12)).astype(np.float32))


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_forward_and_state_match_jax(d_weights, train):
    """Real then fake, the D step's order: scores, and the u / BN state
    threaded through both forwards."""
    real, fake = _d_inputs()
    jp, js = d_weights
    want_r, js1 = jd.discriminator_forward(jp, js, real, train=train)
    want_f, js2 = jd.discriminator_forward(jp, js1, fake, train=train)
    p, s = convert.discriminator_from_jax(jp, js, device="cpu")
    got_r, s1 = td.discriminator_forward(p, s, _t(real), train=train)
    got_f, s2 = td.discriminator_forward(p, s1, _t(fake), train=train)
    assert tuple(got_r.shape) == (4, 1, 12, 12)
    np.testing.assert_allclose(_np(got_r), np.asarray(want_r), **D_TOL)
    np.testing.assert_allclose(_np(got_f), np.asarray(want_f), **D_TOL)
    _assert_trees_close(s2, js2, **D_TOL)
    if train:  # u moved and the running stats took the batch statistics
        assert not np.allclose(_np(s2["u"][0]), js["u"][0])
        assert not np.allclose(_np(s2["bn_var"][0]), js["bn_var"][0])


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_weight_gradients_match_jax(d_weights, train):
    """d sum(D(x)) / d every D parameter: in train mode sigma is
    differentiated through the power iteration, which a no-grad iteration
    (torch.nn.utils.spectral_norm's) would miss."""
    real, _ = _d_inputs()
    jp, js = d_weights

    def j_obj(params):
        return jnp.sum(jd.discriminator_forward(params, js, real, train=train)[0])

    want = jax.grad(j_obj)(jp)
    p, s = convert.discriminator_from_jax(jp, js, device="cpu")
    leaves = tree_leaves(_trainable(p))
    grads = torch.autograd.grad(td.discriminator_forward(p, s, _t(real), train=train)[0].sum(),
                                leaves)
    assert len(grads) == len(jax.tree_util.tree_leaves(want)) == 12
    # a conv bias before BN has a true gradient of ~0, whose float32
    # rounding (in JAX 5-40x larger than here against a float64 run)
    # follows the scale of the largest gradient entry
    scale = max(float(np.abs(w).max()) for w in jax.tree_util.tree_leaves(want))
    _assert_trees_close(tree_unflatten(p, grads), want, rtol=1e-4, atol=1e-5 * scale)


# -------------------------------------------------------------------- losses
def _kernels():
    rng = np.random.default_rng(6)
    pos = rng.uniform(0.01, 1, (13, 13))
    mixed = rng.normal(0, 1, (13, 13))
    mixed[3:6, 2:9] = 0.0  # exact zeros: the sqrt's zero-gradient case
    gauss = np.asarray(jg.gaussian_kernel(13, 2.0))
    off = np.roll(gauss, (2, -3), axis=(0, 1))
    tie = np.zeros((13, 13))
    tie[6, 6] = tie[2, 3] = 1.0  # tied maxima
    return [k.astype(np.float32) for k in (pos, mixed, gauss, off, tie)]


@pytest.mark.parametrize("idx", range(5))
@pytest.mark.parametrize("center_max", [True, False])
def test_kernel_regularization_and_grad_match_jax(idx, center_max):
    k = _kernels()[idx]
    weights = dict(alpha=0.5, beta=0.5, gamma=5.0, delta=1.0, epsilon=3.0)

    def j_reg(kk):
        return jl.kernel_regularization(kk, center_max=center_max, **weights)

    kt = _t(k).requires_grad_(True)
    got = tl.kernel_regularization(kt, center_max=center_max, **weights)
    np.testing.assert_allclose(_np(got), np.asarray(j_reg(k)), **TOL)
    (g,) = torch.autograd.grad(got, kt)
    assert np.isfinite(_np(g)).all()
    np.testing.assert_allclose(_np(g), np.asarray(jax.grad(j_reg)(k)), rtol=1e-5, atol=1e-5)


def test_band_losses_and_grads_match_jax():
    rng = np.random.default_rng(7)
    ks = np.stack(_kernels()[:4])
    pr, pf = (rng.normal(size=(3, 1, 6, 6)).astype(np.float32) for _ in range(2))
    sigma = rng.uniform(0, 0.1, 5).astype(np.float32)
    route = jax.nn.softmax(rng.normal(size=(8, 4)).astype(np.float32), axis=-1)
    route = np.asarray(route)
    cases = [  # (torch fn, jax fn, args)
        (tl.lsgan_d_loss, jl.lsgan_d_loss, (pr, pf)),
        (tl.lsgan_g_loss, jl.lsgan_g_loss, (pf,)),
        (tl.per_band_kernel_regularization, jl.per_band_kernel_regularization, (ks,)),
        (lambda k: tl.per_band_kernel_regularization(k, {"gamma": 1.0}, center_max=False),
         lambda k: jl.per_band_kernel_regularization(k, {"gamma": 1.0}, center_max=False),
         (ks,)),
        (tl.noise_reg_loss, jl.noise_reg_loss, (sigma,)),
        (lambda s: tl.noise_reg_loss(s, 0.05, mode="l1"),
         lambda s: jl.noise_reg_loss(s, 0.05, mode="l1"), (sigma,)),
        (tl.load_balance_loss, jl.load_balance_loss, (route,)),
    ]
    for tfn, jfn, args in cases:
        targs = [_t(a).requires_grad_(True) for a in args]
        got = tfn(*targs)
        np.testing.assert_allclose(_np(got), np.asarray(jfn(*args)), **TOL)
        grads = torch.autograd.grad(got, targs)
        want = jax.grad(jfn, argnums=tuple(range(len(args))))(*args)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_kernel_metrics_ascii_and_delta_equal_jax():
    for k in _kernels():
        assert t_metrics(k) == j_metrics(k)
        assert t_ascii(k) == j_ascii(k)
        assert t_ascii(k, size=7) == j_ascii(k, size=7)
        np.testing.assert_array_equal(t_resize(k, 5, 9), j_resize(k, 5, 9))
    a, b = _kernels()[:2]
    assert t_delta(a, b) == j_delta(a, b)
    assert t_delta(a, None) == 0.0


def test_entry_forward_matches_jax(g_weights, d_weights):
    """`__graft_entry__.entry()`'s forward (G, then D with train=False) at
    small widths, on the same weights."""
    x = np.random.default_rng(8).normal(5, 2, (2, 5, 96, 96)).astype(np.float32)
    jp, js = d_weights
    want_fake = jg.generator_forward(g_weights, x)
    want_score, _ = jd.discriminator_forward(jp, js, want_fake, train=False)
    gp = convert.generator_from_jax(g_weights, device="cpu")
    p, s = convert.discriminator_from_jax(jp, js, device="cpu")
    fake = tg.generator_forward(gp, _t(x))
    score, _ = td.discriminator_forward(p, s, fake, train=False)
    assert tuple(fake.shape) == (2, 5, 12, 12) and tuple(score.shape) == (2, 1, 12, 12)
    np.testing.assert_allclose(_np(fake), np.asarray(want_fake), **TOL)
    np.testing.assert_allclose(_np(score), np.asarray(want_score), **D_TOL)
