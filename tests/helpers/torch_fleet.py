"""Shared setup of the port's fleet tests (`tests/test_torch_fleet_*.py`):
tiny widths (G mid_ch 8, D 8x2, HR 32, LR 8, batch 4), seeded pools, the
JAX-init conversion and the run comparison at the files' tolerances."""
import os

import jax
import numpy as np
import torch

from kmsr_tpu.models import discriminator as jd
from kmsr_tpu.models import generator as jg
from kmsr_tpu.train import single_kernel as jsk
from kmsr_tpu_torch import convert
from kmsr_tpu_torch.models import discriminator as td
from kmsr_tpu_torch.models import generator as tg
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train import state as tstate

TOL = dict(rtol=1e-4, atol=1e-5)
#: JAX's fleet tolerances across chunk widths (float32 reduction order)
KERNEL_TOL, ROW_TOL = dict(rtol=1e-5, atol=1e-7), dict(rtol=1e-4, atol=1e-6)


def cfg(pkg, outdir, mode="chain", **kw):
    sk, gm, dm = (jsk, jg, jd) if pkg == "jax" else (tsk, tg, td)
    fields = dict(
        iters=4, hr_patch_size=32, lr_crop_size=8, batch_size=4, log_every=2,
        kernel_log_every=2, outdir=str(outdir), verbose=False,
        generator=gm.GeneratorConfig(mid_ch=8, forward_mode=mode),
        discriminator=dm.DiscriminatorConfig(base_ch=8, num_blocks=2))
    return sk.SingleKernelConfig(**{**fields, **kw})


def pools(seed=3, sizes=(6, 9), lr_sizes=(5, 7)):
    """HR pools [n, 5, 32, 32] and native-LR pools [n, 5, 8, 8] per scene."""
    rng = np.random.default_rng(seed)
    hr = [rng.normal(5, 1, (n, 5, 32, 32)).astype(np.float32) for n in sizes]
    lr = [rng.normal(5, 2, (n, 5, 8, 8)).astype(np.float32) for n in lr_sizes]
    return hr, lr


def torch_state(jax_state, seed):
    """The port's train state from a JAX one (weights and D state
    converted, fresh Adam moments, a generator seeded `seed`)."""
    js = jax.device_get(jax_state)
    g = convert.generator_from_jax(js.g_params, device="cpu")
    d, ds = convert.discriminator_from_jax(js.d_params, js.d_state, device="cpu")
    tx = tstate.make_gan_optimizers(4e-4)
    return tstate.init_gan_state(torch.Generator().manual_seed(seed), g, d, ds, tx, tx)


def rows(path):
    lines = open(path, encoding="utf-8").read().splitlines()
    return lines[0], np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])


def assert_runs_close(got, want, tol, row_tol=None):
    """Two fleet outputs: kernels, every scene's CSV rows (at row_tol, else
    tol) and file names."""
    np.testing.assert_allclose(got["kernel_per_band"], want["kernel_per_band"], **tol)
    np.testing.assert_allclose(got["kernel_merged"], want["kernel_merged"], **tol)
    for fg, fw in zip(got["log_files"], want["log_files"], strict=True):
        (hg, rg), (hw, rw) = rows(fg), rows(fw)
        assert hg == hw and rg.shape == rw.shape
        np.testing.assert_array_equal(rg[:, 0], rw[:, 0])
        np.testing.assert_allclose(rg, rw, **(row_tol or tol))
        assert sorted(os.listdir(os.path.dirname(fg))) == sorted(os.listdir(os.path.dirname(fw)))

