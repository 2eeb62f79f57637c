"""Port parity for the wide-span degrade kernels: v1, v2, v4 and the
baked-halo presplit (v3ps) of `kmsr_tpu_torch.ops.degrade_fused` against
`kmsr_tpu.ops.degrade_pallas` in Pallas interpret mode.

On the CPU the port runs each kernel's plain PyTorch version (the CUDA
kernels run on the card: `tests/test_torch_kernels.py`, marked `cuda`).
Same numpy-seeded inputs to both; tolerance rtol 1e-4 / atol 1e-5, and
v1 == v2 at 1e-6 (`tests/test_degrade_pallas.py`). The JAX calls cost
0.5-3 s each in interpret mode, so shapes stay tiny and the JAX outputs
of the main cases are computed once per module.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu.ops.degrade import degrade_strided as j_degrade_strided
from kmsr_tpu.ops.degrade_pallas import (
    _bf16_terms, degrade_pallas, degrade_pallas_chwb, degrade_pallas_presplit,
    phase_split_chwb as j_split,
)
from kmsr_tpu_torch.ops.degrade_fused import (
    bf16_terms, col_halo, degrade_fused, degrade_fused_chwb,
    degrade_fused_chwb_ref, degrade_fused_presplit, degrade_fused_presplit_ref,
    degrade_fused_ref, phase_split_chwb, select_version,
)

TOL = dict(rtol=1e-4, atol=1e-5)
C, B = 3, 128  # JAX's lane tile: B = 128 needs no batch padding there


def _inputs(seed, h, factor, ksize=13, c=C, b=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(5, 2, (c, h, h, b)).astype(np.float32)
    kernel = rng.uniform(0.1, 1, (c, ksize, ksize)).astype(np.float32)
    noise = rng.normal(0, 0.1, (c, h // factor, h // factor, b)).astype(np.float32)
    return x, kernel, noise


def _jax_chwb(x, kernel, noise, factor, version):
    return np.asarray(degrade_pallas_chwb(
        jnp.asarray(x), jnp.asarray(kernel),
        noise=None if noise is None else jnp.asarray(noise),
        factor=factor, interpret=True, version=version))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def wide():
    """f=2 (span 14 > 10) at 16x16: inputs and JAX's v1/v2/v4 outputs,
    with and without noise."""
    x, kernel, noise = _inputs(1, 16, 2)
    want = {(v, n): _jax_chwb(x, kernel, noise if n else None, 2, v)
            for v in (1, 2, 4) for n in (False, True)}
    return x, kernel, noise, want


@pytest.mark.parametrize("version", [1, 2, 4])
@pytest.mark.parametrize("with_noise", [False, True])
def test_versions_match_jax_interpret(wide, version, with_noise):
    x, kernel, noise, want = wide
    got = degrade_fused_chwb(_t(x), _t(kernel), _t(noise) if with_noise else None,
                             factor=2, version=version)
    assert got.dtype == torch.float32 and got.shape == (C, 8, 8, B)
    np.testing.assert_allclose(got.numpy(), want[version, with_noise], **TOL)


def test_v1_equals_v2(wide):
    """v1 (per-row-phase partials) == v2 at 1e-6, as JAX's own pair, and
    both within tolerance of the XLA conv (odd kernel: same function)."""
    x, kernel, noise, want = wide
    o1 = degrade_fused_chwb(_t(x), _t(kernel), _t(noise), factor=2, version=1)
    o2 = degrade_fused_chwb(_t(x), _t(kernel), _t(noise), factor=2, version=2)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want[1, True], want[2, True], rtol=1e-6, atol=1e-6)
    conv = np.asarray(j_degrade_strided(jnp.asarray(np.transpose(x, (3, 0, 1, 2))),
                                        jnp.asarray(kernel), factor=2))
    np.testing.assert_allclose(o2.numpy(), np.transpose(conv, (1, 2, 3, 0)) + noise,
                               **TOL)


@pytest.mark.parametrize("with_noise", [False, True])
def test_v3ps_matches_jax_interpret(with_noise):
    """Baked-halo presplit at f=4 (span 16, m=2 halo rows), 8x8."""
    x, kernel, noise = _inputs(2, 8, 4, c=1)
    noise = noise if with_noise else None
    m = col_halo(16, 4)
    assert m == 2
    xp = np.asarray(j_split(jnp.asarray(x), factor=4, halo=True, halo_rows=m))
    np.testing.assert_array_equal(
        phase_split_chwb(_t(x), 4, halo=True, halo_rows=m).numpy(), xp)
    want = np.asarray(degrade_pallas_presplit(
        jnp.asarray(xp), jnp.asarray(kernel),
        noise=None if noise is None else jnp.asarray(noise), factor=4,
        interpret=True, baked_halo=True, halo_rows=m))
    got = degrade_fused_presplit(_t(xp), _t(kernel), _t(noise), factor=4,
                                 baked_halo=True, halo_rows=m)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("factor,h", [(8, 16), (4, 16), (2, 12)])
def test_v3ps_equals_v3_and_v3psn_bitwise(factor, h):
    """The baked-halo layout holds the clamped rows v3psn rebuilds, and the
    tap order is v3's, so the three agree bit for bit (JAX `:367`)."""
    x, kernel, noise = _inputs(3, h, factor, ksize=5 if factor == 2 else 13, b=4)
    tx, tk, tn = _t(x), _t(kernel), _t(noise)
    want = degrade_fused_chwb(tx, tk, tn, factor=factor, version=3)
    m = col_halo(tk.shape[-1] + factor - 1, factor)
    baked = degrade_fused_presplit(
        phase_split_chwb(tx, factor, halo=True, halo_rows=m), tk, tn,
        factor=factor, baked_halo=True)
    free = degrade_fused_presplit(phase_split_chwb(tx, factor), tk, tn,
                                  factor=factor)
    assert torch.equal(baked, want) and torch.equal(free, want)
    assert torch.equal(baked, degrade_fused_presplit_ref(
        phase_split_chwb(tx, factor, halo=True, halo_rows=m), tk, tn,
        factor=factor, baked_halo=True))


def test_bf16_storage_v4_matches_jax():
    """bf16-stored x: one x term (three products) on both sides."""
    x, kernel, noise = _inputs(4, 16, 2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(degrade_pallas_chwb(xb, jnp.asarray(kernel),
                                          noise=jnp.asarray(noise), factor=2,
                                          interpret=True))  # auto: v4
    txb = _t(x).bfloat16()
    assert select_version(14, 2, 16, 16, torch.bfloat16, None) == 4
    got = degrade_fused_chwb(txb, _t(kernel), _t(noise), factor=2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # v1 and v2 on bf16 storage equal the f32 path on the rounded input
    for v in (1, 2):
        np.testing.assert_array_equal(
            degrade_fused_chwb(txb, _t(kernel), _t(noise), factor=2, version=v).numpy(),
            degrade_fused_chwb(txb.float(), _t(kernel), _t(noise), factor=2,
                               version=v).numpy())


@pytest.mark.parametrize("h,version", [(16, 4), (24, 2)])  # out_w 8 -> v4; 12 -> v2
def test_auto_route_nchw_matches_degrade_pallas(h, version):
    """degrade_fused (NCHW, any batch) vs degrade_pallas (which transposes,
    pads the batch to 128 and auto-selects) at f=2, span 14."""
    x, kernel, noise = _inputs(5, h, 2, b=3)
    img = np.ascontiguousarray(np.transpose(x, (3, 0, 1, 2)))
    n = np.ascontiguousarray(np.transpose(noise, (3, 0, 1, 2)))
    assert select_version(14, 2, h, h, torch.float32, None) == version
    want = np.asarray(degrade_pallas(jnp.asarray(img), jnp.asarray(kernel),
                                     noise=jnp.asarray(n), factor=2, interpret=True))
    got = degrade_fused(_t(img), _t(kernel), _t(n), factor=2)
    assert got.shape == (3, C, h // 2, h // 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, degrade_fused_ref(_t(img), _t(kernel), _t(n), factor=2))


@pytest.fixture(scope="module")
def even():
    """A 12x12 blur (even side): v1/v2 offset taps by k//2 = 6, v3/v4 by
    (K-f)//2 = 5 at f=2, so the JAX versions disagree with one another."""
    x, kernel, noise = _inputs(6, 16, 2, ksize=12, c=2)
    return x, kernel, noise


@pytest.mark.parametrize("version", [1, 2, 4, None])
def test_even_kernel_matches_each_jax_version(even, version):
    x, kernel, noise = even
    want = _jax_chwb(x, kernel, noise, 2, version)
    got = degrade_fused_chwb(_t(x), _t(kernel), _t(noise), factor=2, version=version)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if version in (None, 4):  # auto picked v4, which sits far from v2 here
        v2 = degrade_fused_chwb(_t(x), _t(kernel), _t(noise), factor=2, version=2)
        assert np.abs(got.numpy() - v2.numpy()).max() > 0.05


def test_even_kernel_v3_matches_jax():
    x, kernel, noise = _inputs(7, 8, 4, ksize=12, c=1)
    want = _jax_chwb(x, kernel, noise, 4, 3)
    got = degrade_fused_chwb(_t(x), _t(kernel), _t(noise), factor=4)  # auto: v3
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_terms_match_jax():
    a = np.random.default_rng(8).normal(0, 3, (4, 300)).astype(np.float32)
    got = bf16_terms(torch.from_numpy(a), 3)
    want = _bf16_terms(jnp.asarray(a), 3)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))
    # the first two terms are exact truncations, the sum within 2^-22 rel
    total = sum(t.double() for t in got).numpy()
    np.testing.assert_allclose(total, a, rtol=2.0 ** -22, atol=0)


def _raises_both(match, jax_call, port_call):
    with pytest.raises(ValueError, match=match):
        jax_call()
    with pytest.raises(ValueError, match=match):
        port_call()


def test_value_error_guards_match_jax():
    rng = np.random.default_rng(9)
    k = rng.uniform(0.1, 1, (2, 13, 13)).astype(np.float32)
    x = rng.normal(size=(2, 24, 24, 128)).astype(np.float32)  # out_w 12 at f=2
    _raises_both("v4 needs",
                 lambda: degrade_pallas_chwb(jnp.asarray(x), jnp.asarray(k),
                                             factor=2, interpret=True, version=4),
                 lambda: degrade_fused_chwb(_t(x), _t(k), factor=2, version=4))
    _raises_both("v4 needs",
                 lambda: degrade_pallas_chwb(jnp.asarray(x[:, :, :20]), jnp.asarray(k),
                                             factor=2, interpret=True, version=4),
                 lambda: degrade_fused_chwb(_t(x[:, :, :20]), _t(k), factor=2,
                                            version=4))  # w % 8 != 0
    # w = 24 at f=3 suits v4 in float32, but bf16 storage needs w % 16 == 0
    assert select_version(15, 3, 24, 24, torch.float32, 4) == 4
    _raises_both("v4 needs",
                 lambda: degrade_pallas_chwb(jnp.asarray(x).astype(jnp.bfloat16),
                                             jnp.asarray(k), factor=3,
                                             interpret=True, version=4),
                 lambda: degrade_fused_chwb(_t(x).bfloat16(), _t(k), factor=3,
                                            version=4))
    _raises_both("version must be",
                 lambda: degrade_pallas_chwb(jnp.asarray(x), jnp.asarray(k),
                                             factor=2, interpret=True, version=5),
                 lambda: degrade_fused_chwb(_t(x), _t(k), factor=2, version=5))

    xs = rng.normal(size=(2, 8, 16, 128)).astype(np.float32)  # f=8 halo-free split
    jxp = j_split(jnp.asarray(xs), factor=8, halo=True, halo_rows=2)
    _raises_both("halo_rows=2",
                 lambda: degrade_pallas_presplit(jxp, jnp.asarray(k), factor=8,
                                                 interpret=True, baked_halo=True,
                                                 halo_rows=2),
                 lambda: degrade_fused_presplit(_t(np.asarray(jxp)), _t(k), factor=8,
                                                baked_halo=True, halo_rows=2))
    # two row-blocks per phase, but span 16 at f=4 needs 2 halo rows a side
    thin = rng.normal(size=(2, 4, 4, 16, 128)).astype(np.float32)
    _raises_both("no image rows remain",
                 lambda: degrade_pallas_presplit(jnp.asarray(thin), jnp.asarray(k),
                                                 factor=4, interpret=True,
                                                 baked_halo=True),
                 lambda: degrade_fused_presplit(_t(thin), _t(k), factor=4,
                                                baked_halo=True))


def test_selection_ignores_the_batch():
    """v4_ok depends on h, w, f and the storage dtype only (JAX pads the
    batch before it); any batch runs, NCHW and CHWB agree."""
    x, kernel, noise = _inputs(10, 16, 2, b=5)
    for b in (1, 5):
        assert select_version(14, 2, 16, 16, torch.float32, None) == 4
        tx, tn = _t(x[..., :b]), _t(noise[..., :b])
        chwb = degrade_fused_chwb(tx, _t(kernel), tn, factor=2)
        nchw = degrade_fused(tx.permute(3, 0, 1, 2).contiguous(), _t(kernel),
                             tn.permute(3, 0, 1, 2).contiguous(), factor=2)
        assert torch.equal(nchw.permute(1, 2, 3, 0), chwb)
        assert torch.equal(chwb, degrade_fused_chwb_ref(tx, _t(kernel), tn, factor=2))
