"""Training on the card is reproducible by default, as JAX's is on the TPU.

Every trainer of the port (single-kernel, fleet, MoE, dynamic, SR) runs its
step loop under `device.deterministic(dev)`: on a CUDA device, PyTorch's
deterministic algorithms with cuDNN's deterministic flag, benchmark off;
on the CPU, nothing. The training CLIs and `run_all` set
CUBLAS_WORKSPACE_CONFIG (which those algorithms need for cuBLAS) unless
the caller already did. On the CPU the tests make the trainers enter the
CUDA branch (the flags are process-wide, the ops run on the CPU): every
step runs with the flags on, and the flags found before are restored.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kmsr_tpu_torch import device as tdevice
from kmsr_tpu_torch.data.sampler import PatchPool, synthetic_pool
from kmsr_tpu_torch.models import discriminator as td
from kmsr_tpu_torch.models import dynamic as tdy
from kmsr_tpu_torch.models import generator as tg
from kmsr_tpu_torch.models import moe as tm
from kmsr_tpu_torch.models import sr as tsr
from kmsr_tpu_torch.pipeline import (run_all, train_dynamic_cli, train_fleet_cli,
                                     train_moe_cli, train_single_kernel_cli, train_sr_cli)
from kmsr_tpu_torch.train import dynamic as tdyn
from kmsr_tpu_torch.train import fleet as tfleet
from kmsr_tpu_torch.train import moe as tmoe
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train import sr as ttsr

# a card test in this process may be the first to use cuBLAS
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", tdevice.CUBLAS_WORKSPACE_CONFIG)


def _flags():
    return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())


@pytest.fixture
def odd_flags():
    """Flags unlike both the defaults and the context's, restored after."""
    saved = _flags()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield _flags()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
    torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


ON = (True, False, True, False)


def test_deterministic_sets_and_restores_the_flags(odd_flags):
    with tdevice.deterministic(torch.device("cuda")):
        assert _flags() == ON
    assert _flags() == odd_flags
    with pytest.raises(ZeroDivisionError):
        with tdevice.deterministic("cuda"):
            1 / 0
    assert _flags() == odd_flags


def test_deterministic_does_nothing_on_the_cpu(odd_flags):
    with tdevice.deterministic("cpu"):
        assert _flags() == odd_flags
    assert _flags() == odd_flags


def _small_kernelgan(tmp_path, **kw):
    return tsk.SingleKernelConfig(
        iters=4, hr_patch_size=32, lr_crop_size=8, batch_size=4, log_every=2,
        kernel_log_every=2, outdir=str(tmp_path / "out"), verbose=False,
        generator=tg.GeneratorConfig(mid_ch=8), device_pool=False,
        discriminator=td.DiscriminatorConfig(base_ch=8, num_blocks=2), **kw)


def _pool(n=8, size=32):
    return synthetic_pool(np.random.default_rng(3), n=n, size=size)


def _run_single(tmp_path):
    tsk.train_single_kernel(_pool(), _small_kernelgan(tmp_path), progress=False, device="cpu")


def _run_fleet(tmp_path):
    tfleet.train_fleet([_pool(6), _pool(7)], _small_kernelgan(tmp_path), progress=False,
                       device="cpu")


def _run_moe(tmp_path):
    cfg = tmoe.MoETrainConfig(
        iters=4, batch_size=4, hr_patch_size=32, lr_crop_size=8, log_every=1,
        outdir=str(tmp_path / "out"), verbose=False, device_pool=False,
        model=tm.MoEConfig(n_kernels=4, n_channels=5, kernel_size=13, factor=4),
        discriminator=td.DiscriminatorConfig(base_ch=8, num_blocks=2))
    tmoe.train_moe(_pool(), cfg, progress=False, device="cpu")


def _run_dynamic(tmp_path):
    cfg = tdyn.DynamicTrainConfig(
        iters=4, batch_size=4, hr_patch_size=32, lr_crop_size=8, log_every=2,
        kernel_log_every=2, outdir=str(tmp_path / "out"), verbose=False, device_pool=False,
        model=tdy.DynamicConfig(mid_ch=8, factor=4),
        discriminator=td.DiscriminatorConfig(base_ch=8, num_blocks=2))
    tdyn.train_dynamic(_pool(), cfg, progress=False, device="cpu")


def _run_sr(tmp_path):
    rng = np.random.default_rng(0)
    hr = rng.normal(3.0, 1.0, (12, 5, 16, 16)).astype(np.float32)
    lr = hr.reshape(12, 5, 4, 4, 4, 4).mean(axis=(3, 5))
    cfg = ttsr.SRTrainConfig(model=tsr.SRConfig(width=8, n_blocks=1, factor=4),
                             outdir=str(tmp_path / "out"), iters=4, batch_size=2,
                             log_every=1, eval_every=2, compute_dtype="float32")
    ttsr.train_sr((lr, hr), cfg, progress=False, device="cpu")


# trainer -> (its module, the step factory it calls, a small CPU run)
TRAINERS = {
    "single_kernel": (tsk, "make_train_step", _run_single),
    "fleet": (tfleet, "make_fleet_step", _run_fleet),
    "moe": (tmoe, "make_moe_train_step", _run_moe),
    "dynamic": (tdyn, "make_dynamic_train_step", _run_dynamic),
    "sr": (ttsr, "make_sr_train_step", _run_sr),
}


@pytest.mark.parametrize("name", list(TRAINERS))
def test_trainer_steps_run_deterministic_and_restore_the_flags(name, tmp_path, monkeypatch,
                                                               odd_flags):
    mod, factory_name, run = TRAINERS[name]
    entered, seen = [], []
    real = tdevice.deterministic

    def as_on_the_card(dev):
        entered.append(torch.device(dev).type)
        return real("cuda")

    factory = getattr(mod, factory_name)

    def spying_factory(*a, **kw):
        out = factory(*a, **kw)
        step = out[0] if isinstance(out, tuple) else out

        def spy(*sa, **skw):
            seen.append(_flags())
            return step(*sa, **skw)

        return (spy, *out[1:]) if isinstance(out, tuple) else spy

    monkeypatch.setattr(mod, "deterministic", as_on_the_card)
    monkeypatch.setattr(mod, factory_name, spying_factory)
    run(tmp_path)
    assert entered == ["cpu"]
    assert len(seen) >= 2 and all(f == ON for f in seen), seen
    assert _flags() == odd_flags


@pytest.mark.parametrize("k, input_grad", [(7, False), (1, True), (1, False), (5, True)])
@pytest.mark.parametrize("seg", [4096, 37])
def test_chain_conv_gradients_equal_a_float64_conv(k, input_grad, seg, monkeypatch):
    """`ops.kernel_algebra.chain_conv` (the chains' layers: GEMM weight
    gradients for the first and the 1x1 layers) against F.conv2d's
    autograd in float64: forward and every gradient to float32 rounding,
    with batches past a chunk (_WGRAD_CHUNK) and, at seg=37, the pixels
    cut into many zero-padded GEMM segments."""
    from kmsr_tpu_torch.ops import kernel_algebra as ka

    monkeypatch.setattr(ka, "_WGRAD_SEG", seg)
    g = torch.Generator().manual_seed(k + seg)
    cin, cout = (5, 40) if not input_grad and k > 1 else (40, 40)
    x = torch.randn(ka._WGRAD_CHUNK + 2, cin, 12 + k, 9 + k, generator=g)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(input_grad)
    w = torch.randn(cout, cin // 5, k, k, generator=g, requires_grad=True)
    y = ka.chain_conv(x, w, 5)
    gy = torch.randn(y.shape, generator=g)
    ins = (x, w) if input_grad else (w,)
    got = torch.autograd.grad((y * gy).sum(), ins)
    x64 = x.detach().double().requires_grad_(input_grad)
    w64 = w.detach().double().requires_grad_(True)
    y64 = F.conv2d(x64, w64, groups=5)
    want = torch.autograd.grad((y64 * gy.double()).sum(), (x64, w64) if input_grad else (w64,))
    torch.testing.assert_close(y.double(), y64, rtol=1e-5, atol=1e-5 * float(y64.detach().abs().max()))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


CLIS = {
    "train_single_kernel_cli": train_single_kernel_cli.main,
    "train_fleet_cli": train_fleet_cli.main,
    "train_moe_cli": train_moe_cli.main,
    "train_dynamic_cli": train_dynamic_cli.main,
    "train_sr_cli": train_sr_cli.main,
    "run_all": run_all.main,
}


@pytest.mark.parametrize("name", list(CLIS))
@pytest.mark.parametrize("preset", [None, ":16:8"])
def test_training_clis_set_cublas_workspace_config_only_when_unset(name, preset, monkeypatch,
                                                                   capsys):
    if preset is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", preset)
    with pytest.raises(SystemExit) as e:  # --help: the setting comes first
        CLIS[name](["--help"])
    assert e.value.code == 0 and "usage" in capsys.readouterr().out
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == (preset or ":4096:8")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (determinism of cuDNN / cuBLAS on the card)")
    return torch.device("cuda")


def _card_fleet_and_twins(cuda, tmp_path, scene_chunk, **kw):
    """A 2-scene chain-mode fleet (K = 1, host draws; 6 iterations at the
    default widths on 64x64 patches unless `kw` says otherwise) at
    `scene_chunk` through the public call, no wrapper, and each scene's
    standalone `train_single_kernel` at seed + s: [(fleet scene dir, twin
    dir)]."""
    cfg = tsk.SingleKernelConfig(**{**dict(
        iters=6, hr_patch_size=64, lr_crop_size=16, batch_size=4, log_every=3,
        kernel_log_every=3, verbose=False, outdir=str(tmp_path / "fleet")), **kw})
    pools = [PatchPool(synthetic_pool(np.random.default_rng(10 + s), n=16,
                                      size=cfg.hr_patch_size).patches) for s in range(2)]
    out = tfleet.train_fleet(pools, cfg, progress=False, device=cuda, scene_chunk=scene_chunk)
    dirs = []
    for s, name in enumerate(out["scene_names"]):
        one = dataclasses.replace(cfg, seed=cfg.seed + s, outdir=str(tmp_path / f"one{s}"))
        tsk.train_single_kernel(pools[s], one, progress=False, device=cuda)
        dirs.append((tmp_path / "fleet" / name, tmp_path / f"one{s}"))
    return dirs


@pytest.mark.cuda
def test_chain_fleet_scenes_equal_their_standalone_runs_on_the_card(cuda, tmp_path):
    """At scene_chunk=1 each scene of a 2-scene chain fleet is bit-equal to
    its standalone run at seed + s (JAX's fleet contract)."""
    for fleet_dir, one_dir in _card_fleet_and_twins(cuda, tmp_path, scene_chunk=1):
        for f in ("kernel_per_band.npy", "kernel_per_band_iter3.npy"):
            assert np.array_equal(np.load(fleet_dir / f), np.load(one_dir / f)), (fleet_dir, f)
        rows = [open(d / "training_log.txt").read() for d in (fleet_dir, one_dir)]
        assert rows[0] == rows[1]


@pytest.mark.cuda
def test_stacked_chain_fleet_scenes_match_their_standalone_runs_on_the_card(cuda, tmp_path):
    """A 2-scene chain fleet stacked (both scenes in one step call) at the
    CPU fleet tests' widths and JAX's fleet test's length (G mid_ch 8, D
    8x2, 32x32 patches, 4 iterations): each scene within JAX's fleet
    tolerances of its standalone run (kernels rtol 1e-5 / atol 1e-7, CSV
    rows rtol 1e-4 / atol 1e-6). At full width the trajectories part after
    a step or two, as JAX's own fleet's do across chunk widths
    (chip_smoke.py phase 13)."""
    tiny = dict(iters=4, log_every=2, kernel_log_every=2, hr_patch_size=32, lr_crop_size=8,
                generator=tg.GeneratorConfig(mid_ch=8),
                discriminator=td.DiscriminatorConfig(base_ch=8, num_blocks=2))
    for fleet_dir, one_dir in _card_fleet_and_twins(cuda, tmp_path, scene_chunk=2, **tiny):
        for f in ("kernel_per_band.npy", "kernel_per_band_iter2.npy"):
            np.testing.assert_allclose(np.load(fleet_dir / f), np.load(one_dir / f),
                                       rtol=1e-5, atol=1e-7)
        rows = [np.loadtxt(d / "training_log.txt", delimiter=",", skiprows=1)
                for d in (fleet_dir, one_dir)]
        np.testing.assert_allclose(rows[0], rows[1], rtol=1e-4, atol=1e-6)
