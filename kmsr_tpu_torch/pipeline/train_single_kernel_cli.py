"""Stage: single-kernel KernelGAN training (CLI).

Counterpart of `kmsr_tpu.pipeline.train_single_kernel_cli`, with the same
flags and artifacts, plus `--device` (cuda by default; a run without a card
raises unless `--device cpu`).

Usage:
    python -m kmsr_tpu_torch.pipeline.train_single_kernel_cli \
        --patch-dir PATCHES --outdir OUT [--iters 10000] [--batch-size 16] \
        [--lr 4e-4] [--reg-weight 0.002] [--group denoised] [--seed 0]

    # KernelGAN single-image mode (gradient-weighted draws from one scene):
    python -m kmsr_tpu_torch.pipeline.train_single_kernel_cli \
        --scene-file SCENE.nc --group geophysical_data --outdir OUT

    # data-parallel over the host's cards, one process per card:
    torchrun --nproc_per_node=N -m kmsr_tpu_torch.pipeline.train_single_kernel_cli \
        --patch-dir PATCHES --outdir OUT --data-parallel

Checkpoints (`--ckpt-every`, `--resume`) are this package's torch.save
files; the JAX package's orbax checkpoints cannot be resumed here, nor the
other way round.
"""
from __future__ import annotations

import argparse

from ..data.sampler import PatchPool
from ..device import resolve_device, set_cublas_workspace_config
from ..io.schema import GROUP_DENOISED
from ..models.generator import GeneratorConfig
from ..parallel.mesh import launch_mesh
from ..train.single_kernel import SingleKernelConfig, train_single_kernel
from .common import maybe_trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train single-kernel KernelGAN")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--patch-dir")
    src.add_argument("--scene-file",
                     help="KernelGAN single-image mode: train from ONE whole "
                          "scene via gradient-weighted NaN-avoiding patch "
                          "draws")
    p.add_argument("--scene-patches", type=int, default=512,
                   help="pool size drawn from --scene-file")
    p.add_argument("--scene-raw", action="store_true",
                   help="keep radiance units instead of the scene sampler's "
                        "[0,1] percentile stretch")
    p.add_argument("--outdir", required=True)
    p.add_argument("--group", default=GROUP_DENOISED)
    p.add_argument("--iters", type=int, default=10_000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr-crop-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--reg-weight", type=float, default=0.002)
    p.add_argument("--grad-clip", type=float, default=20.0)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--kernel-log-every", type=int, default=100)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in OUTDIR/ckpt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--fast-forward", action="store_true",
        help="run G as ONE depthwise conv with the composed kernel "
             "(~230x fewer FLOPs; identical away from a 6px border rim)",
    )
    p.add_argument(
        "--steps-per-call", type=int, default=1,
        help="K>1 runs K train steps per call on a device-resident pool "
             "with the batch indices drawn on the device; iters and the "
             "*_every intervals must be multiples of K",
    )
    p.add_argument("--differentiable-reg", action="store_true",
                   help="corrected gradient path through kernel extraction "
                        "(the reference's regularizer has no G-gradient)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the batch over all devices: one process per "
                        "card under torchrun (a plain process is one rank)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the run")
    p.add_argument("--real-lr-dir", default=None,
                   help="separate pool for the real-LR side (crops are "
                        "taken from it instead of from --patch-dir)")
    p.add_argument("--real-is-lr", action="store_true",
                   help="use --real-lr-dir patches AS-IS as native LR "
                        "(no cropping); they must be lr-crop-size sized")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    # the trainer runs its steps under deterministic algorithms on the
    # card, whose cuBLAS calls need this before cuBLAS's first use
    set_cublas_workspace_config()
    a = build_parser().parse_args(argv)
    if a.real_is_lr and not a.real_lr_dir:
        raise SystemExit("--real-is-lr requires --real-lr-dir")
    dev = resolve_device(a.device)
    if a.scene_file:
        pool = PatchPool.from_scene(
            a.scene_file, group=a.group, n_patches=a.scene_patches,
            seed=a.seed, normalize=not a.scene_raw,
        )
    else:
        # a data-parallel run's ranks all draw from the whole pool
        pool = PatchPool.from_nc_dir(a.patch_dir, group=a.group,
                                     host_shard=not a.data_parallel)
    cfg = SingleKernelConfig(
        iters=a.iters,
        batch_size=a.batch_size,
        lr_crop_size=a.lr_crop_size,
        lr_rate=a.lr,
        reg_weight=a.reg_weight,
        grad_clip_norm=a.grad_clip,
        log_every=a.log_every,
        kernel_log_every=a.kernel_log_every,
        ckpt_every=a.ckpt_every,
        resume=a.resume,
        outdir=a.outdir,
        seed=a.seed,
        differentiable_reg=a.differentiable_reg,
        steps_per_call=a.steps_per_call,
        real_is_lr=a.real_is_lr,
        generator=GeneratorConfig(
            forward_mode="compose" if a.fast_forward else "chain"
        ),
    )
    lr_pool = (
        PatchPool.from_nc_dir(a.real_lr_dir, group=a.group,
                              host_shard=not a.data_parallel)
        if a.real_lr_dir else None
    )
    with launch_mesh(a.data_parallel, "data", dev) as mesh, maybe_trace(a.trace):
        out = train_single_kernel(pool, cfg, lr_pool=lr_pool, device=dev, mesh=mesh)
    print(
        f"saved kernel_per_band.npy {out['kernel_per_band'].shape}, "
        f"kernel_merged.npy sum={out['kernel_merged'].sum():.6f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
