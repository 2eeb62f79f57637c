"""Port parity: kmsr_tpu_torch.ops.degrade_fused vs kmsr_tpu.ops.degrade_pallas.

On the CPU the port's entry points run their plain PyTorch versions (the
CUDA kernel runs only on the card: `tests/test_torch_kernels.py`, marked
`cuda`). The JAX kernels run in Pallas interpret mode, 3-12 s a
call on a CPU host, so each kernel is held against its JAX twin in
interpret mode once per factor (16x16, B=128, with noise); the other
cases compare against the JAX `degrade_strided` (the XLA conv), which
computes the same function. Tolerance rtol 1e-4 / atol 1e-5
(`tests/test_degrade_pallas.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmsr_tpu.ops.degrade import degrade_strided as j_degrade_strided
from kmsr_tpu.ops.degrade_pallas import (
    degrade_pallas_chwb, degrade_pallas_presplit, phase_split_chwb as j_split,
)
from kmsr_tpu_torch.ops.degrade_fused import (
    degrade_fused, degrade_fused_chwb, degrade_fused_chwb_ref,
    degrade_fused_presplit, degrade_fused_presplit_ref, degrade_fused_ref,
    phase_split_chwb,
)

TOL = dict(rtol=1e-4, atol=1e-5)


def _chwb_inputs(rng, factor, ksize, b=128, h=16, c=5):
    x = rng.normal(5, 2, (c, h, h, b)).astype(np.float32)
    kernel = rng.uniform(0, 1, (c, ksize, ksize)).astype(np.float32)
    noise = rng.normal(0, 0.1, (c, h // factor, h // factor, b)).astype(np.float32)
    return x, kernel, noise


def _want_chwb(x, kernel, noise, factor):
    """JAX XLA-conv oracle in the CHWB layout."""
    img = jnp.asarray(np.transpose(x, (3, 0, 1, 2)))
    out = np.asarray(j_degrade_strided(img, jnp.asarray(kernel), factor=factor))
    out = np.transpose(out, (1, 2, 3, 0))
    return out if noise is None else out + noise


@pytest.mark.parametrize("factor", [8, 4])  # m=1 (span 20); m=2 (span 16)
def test_chwb_matches_jax_v3_interpret(rng, factor):
    x, kernel, noise = _chwb_inputs(rng, factor, 13)
    want = np.asarray(degrade_pallas_chwb(
        jnp.asarray(x), jnp.asarray(kernel), noise=jnp.asarray(noise),
        factor=factor, interpret=True, version=3))
    got = degrade_fused_chwb(torch.from_numpy(x), torch.from_numpy(kernel),
                             torch.from_numpy(noise), factor=factor)
    assert got.shape == want.shape == (5, 16 // factor, 16 // factor, 128)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("factor", [8, 4])
def test_presplit_matches_jax_v3psn_interpret(rng, factor):
    x, kernel, noise = _chwb_inputs(rng, factor, 13)
    xp = np.array(j_split(jnp.asarray(x), factor=factor, halo=False))
    want = np.asarray(degrade_pallas_presplit(
        jnp.asarray(xp), jnp.asarray(kernel), noise=jnp.asarray(noise),
        factor=factor, interpret=True, baked_halo=False))
    got = degrade_fused_presplit(torch.from_numpy(xp), torch.from_numpy(kernel),
                                 torch.from_numpy(noise), factor=factor)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("factor,ksize", [(8, 13), (4, 13), (8, 5), (4, 5)])
@pytest.mark.parametrize("with_noise", [False, True])
def test_all_layouts_match_jax_conv(rng, factor, ksize, with_noise):
    """NCHW, CHWB and presplit entry points vs the JAX XLA conv (+ noise),
    at a batch that is not a multiple of 128 (no lane padding here)."""
    x, kernel, noise = _chwb_inputs(rng, factor, ksize, b=3, h=32)
    noise = noise if with_noise else None
    want = _want_chwb(x, kernel, noise, factor)
    tx, tk = torch.from_numpy(x), torch.from_numpy(kernel)
    tn = None if noise is None else torch.from_numpy(noise)
    got = degrade_fused_chwb(tx, tk, tn, factor=factor)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = degrade_fused_presplit(phase_split_chwb(tx, factor), tk, tn, factor=factor)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    img = tx.permute(3, 0, 1, 2).contiguous()
    n_nchw = None if tn is None else tn.permute(3, 0, 1, 2).contiguous()
    got = degrade_fused(img, tk, n_nchw, factor=factor)
    np.testing.assert_allclose(got.permute(1, 2, 3, 0).numpy(), want, **TOL)


def test_phase_split_matches_jax(rng):
    x = rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(j_split(jnp.asarray(x), factor=4, halo=False))
    got = phase_split_chwb(torch.from_numpy(x), factor=4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_refs_are_the_cpu_path(rng):
    """On CPU tensors each entry point IS its plain version (bit-equal)."""
    x, kernel, noise = _chwb_inputs(rng, 8, 13, b=4)
    tx, tk, tn = map(torch.from_numpy, (x, kernel, noise))
    assert torch.equal(degrade_fused_chwb(tx, tk, tn), degrade_fused_chwb_ref(tx, tk, tn))
    xp = phase_split_chwb(tx, 8)
    assert torch.equal(degrade_fused_presplit(xp, tk, tn),
                       degrade_fused_presplit_ref(xp, tk, tn))
    img = tx.permute(3, 0, 1, 2).contiguous()
    assert torch.equal(degrade_fused(img, tk), degrade_fused_ref(img, tk))
    # [C, H, W] input and a [kh, kw] kernel broadcast to every band
    one = degrade_fused(img[0], tk[0])
    assert one.shape == (5, 2, 2)
    assert torch.equal(one, degrade_fused(img[:1], tk[0].expand(5, 13, 13))[0])


def test_bf16_input_storage(rng):
    """bf16-stored input is accepted (upcast, f32 accumulate and output).
    Its quantization error exceeds the parity budget — close, but not
    parity-grade (the contract of `test_degrade_pallas.py`'s bf16 test) —
    and equals the f32 path on the bf16-rounded input exactly."""
    x = rng.normal(5, 2, (2, 16, 16, 128)).astype(np.float32)
    k = torch.from_numpy(rng.uniform(0, 1, (2, 5, 5)).astype(np.float32))
    tx = torch.from_numpy(x)
    f32 = degrade_fused_chwb(tx, k, factor=4).numpy()
    b16 = degrade_fused_chwb(tx.bfloat16(), k, factor=4)
    assert b16.dtype == torch.float32
    b16 = b16.numpy()
    rel = np.sqrt(np.mean((b16 - f32) ** 2)) / np.std(f32)
    assert rel < 0.02, rel
    assert not np.allclose(b16, f32, atol=1e-5)
    np.testing.assert_array_equal(
        b16, degrade_fused_chwb(tx.bfloat16().float(), k, factor=4).numpy())
    xp = phase_split_chwb(tx.bfloat16(), 4)
    np.testing.assert_array_equal(
        degrade_fused_presplit(xp, k, factor=4).numpy(), b16)


def _raises_both(exc, match, jax_call, port_call):
    with pytest.raises(exc, match=match):
        jax_call()
    with pytest.raises(exc, match=match):
        port_call()


def test_value_error_guards_match_jax(rng):
    x = rng.normal(size=(5, 20, 16, 128)).astype(np.float32)  # H % 8 != 0
    k = rng.uniform(0, 1, (5, 13, 13)).astype(np.float32)
    jx, tx, jk, tk = jnp.asarray(x), torch.from_numpy(x), jnp.asarray(k), torch.from_numpy(k)
    _raises_both(ValueError, "multiples of factor",
                 lambda: degrade_pallas_chwb(jx, jk, factor=8, interpret=True),
                 lambda: degrade_fused_chwb(tx, tk, factor=8))
    x16 = x[:, :16]
    jx, tx = jnp.asarray(x16), torch.from_numpy(np.ascontiguousarray(x16))
    kr = rng.uniform(0, 1, (5, 13, 11)).astype(np.float32)
    _raises_both(ValueError, "square",
                 lambda: degrade_pallas_chwb(jx, jnp.asarray(kr), factor=8, interpret=True),
                 lambda: degrade_fused_chwb(tx, torch.from_numpy(kr), factor=8))
    # span 14 > 5*2 with v3 requested explicitly
    _raises_both(ValueError, "span",
                 lambda: degrade_pallas_chwb(jx, jk, factor=2, interpret=True, version=3),
                 lambda: degrade_fused_chwb(tx, tk, factor=2, version=3))

    xp = rng.normal(size=(5, 2, 8, 16, 128)).astype(np.float32)
    jxp, txp = jnp.asarray(xp), torch.from_numpy(xp)
    _raises_both(ValueError, "span",
                 lambda: degrade_pallas_presplit(jxp, jk, factor=2, interpret=True,
                                                 baked_halo=False),
                 lambda: degrade_fused_presplit(txp, tk, factor=2))
    _raises_both(ValueError, "phase dim",
                 lambda: degrade_pallas_presplit(jxp, jk, factor=4, interpret=True,
                                                 baked_halo=False),
                 lambda: degrade_fused_presplit(txp, tk, factor=4))
    k5 = rng.uniform(0, 1, (5, 5, 5)).astype(np.float32)
    _raises_both(ValueError, "halo-free",
                 lambda: degrade_pallas_presplit(jxp, jnp.asarray(k5), factor=2,
                                                 interpret=True, baked_halo=False,
                                                 halo_rows=1),
                 lambda: degrade_fused_presplit(txp, torch.from_numpy(k5), factor=2,
                                                halo_rows=1))


def test_every_version_runs_and_agrees_with_jax_conv(rng):
    """Every version (1, 2, 4 and auto), a span above 5*factor and
    baked_halo=True run and agree with the JAX XLA conv (odd kernel: every
    version computes the same function); a version outside 1..4 raises."""
    x, kernel, noise = _chwb_inputs(rng, 2, 13, b=3, h=16)
    want = _want_chwb(x, kernel, noise, 2)
    tx, tk, tn = map(torch.from_numpy, (x, kernel, noise))
    for version in (1, 2, 4, None):
        got = degrade_fused_chwb(tx, tk, tn, factor=2, version=version)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = degrade_fused(tx.permute(3, 0, 1, 2), tk, tn.permute(3, 0, 1, 2), factor=2)
    np.testing.assert_allclose(got.permute(1, 2, 3, 0).numpy(), want, **TOL)
    with pytest.raises(ValueError, match="version"):
        degrade_fused_chwb(tx, tk, factor=8, version=5)
    want8 = _want_chwb(x, kernel, None, 8)
    got = degrade_fused_presplit(phase_split_chwb(tx, 8, halo=True), tk, factor=8,
                                 baked_halo=True)
    np.testing.assert_allclose(got.numpy(), want8, **TOL)


def test_composition_is_reused_until_the_kernel_changes(rng):
    """`_composed` hands back its last result for the same, unchanged
    kernel tensor, and composes anew (equal to JAX's composition) after an
    in-place change, at another factor, or for an inference tensor."""
    from kmsr_tpu.ops.degrade import compose_with_box as j_compose
    from kmsr_tpu.ops.degrade import normalize_kernel as j_normalize
    from kmsr_tpu_torch.ops.degrade_fused import _composed

    k = torch.from_numpy(rng.uniform(0.1, 1, (3, 13, 13)).astype(np.float32))
    cpu = torch.device("cpu")

    def want(kernel, factor):
        return np.asarray(j_compose(j_normalize(jnp.asarray(kernel.numpy())), factor))

    first = _composed(k, 2, 3, cpu)
    assert _composed(k, 2, 3, cpu) is first
    np.testing.assert_allclose(first.numpy(), want(k, 2), rtol=1e-6, atol=1e-7)
    k.mul_(2).add_(torch.eye(13))
    again = _composed(k, 2, 3, cpu)
    assert again is not first
    np.testing.assert_allclose(again.numpy(), want(k, 2), rtol=1e-6, atol=1e-7)
    assert _composed(k, 4, 3, cpu).shape == (3, 16, 16)
    assert _composed(k.clone(), 2, 3, cpu) is not again
    with torch.inference_mode():
        ki = k.clone()
    got = _composed(ki, 2, 3, cpu)
    assert _composed(ki, 2, 3, cpu) is not got
    torch.testing.assert_close(got, again, rtol=0, atol=0)
