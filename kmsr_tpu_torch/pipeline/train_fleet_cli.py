"""Stage: fleet KernelGAN training — all scenes' kernels in one run (CLI).

Counterpart of `kmsr_tpu.pipeline.train_fleet_cli`, with the same flags
and per-scene artifacts (`training_log.txt`, kernel .npy dumps under
OUTDIR/<scene>/), plus `--device` (cuda by default; a run without a card
raises unless `--device cpu`). The reference runs `single_kernel/train.py`
once per scene; `train.fleet` stacks the scenes and advances a chunk of
`--scene-chunk` scenes with each step call (all of them in compose mode).

Usage:
    # one subdirectory of patches per scene
    python -m kmsr_tpu_torch.pipeline.train_fleet_cli \
        --patch-root PATCHES_ROOT --outdir OUT [--iters 10000] ...

    # or explicit per-scene dirs, or one flat dir regrouped by scene prefix
    python -m kmsr_tpu_torch.pipeline.train_fleet_cli \
        --patch-dirs sceneA/ sceneB/ --outdir OUT [--device cpu]

    # scenes over the host's cards, one process per card (S must divide N)
    torchrun --nproc_per_node=N -m kmsr_tpu_torch.pipeline.train_fleet_cli \
        --patch-root PATCHES_ROOT --outdir OUT --scene-parallel

`--scene-parallel` splits the scenes over the ranks in contiguous blocks
with no collectives (`train.fleet`); every rank reads every scene's pool
and writes only its own scenes' directories. A multi-process launch
without it is refused. Checkpoints are this package's torch.save files.
"""
from __future__ import annotations

import argparse
import os
from typing import Sequence

import numpy as np

from ..data.patches import group_by_scene
from ..data.sampler import PatchPool, list_patch_files
from ..device import resolve_device, set_cublas_workspace_config
from ..io.schema import GROUP_DENOISED
from ..models.generator import GeneratorConfig
from ..ops.sigma import estimate_sigma_np
from ..parallel.mesh import launch_mesh
from ..train.fleet import _world_size, train_fleet
from ..train.single_kernel import SingleKernelConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train one KernelGAN per scene, all simultaneously"
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--patch-root",
                     help="directory with one patch subdirectory per scene")
    src.add_argument("--patch-dirs", nargs="+",
                     help="explicit per-scene patch directories")
    src.add_argument("--patch-dir",
                     help="ONE flat patch directory (cutter/denoise output); "
                          "files regroup into scenes by name prefix")
    p.add_argument("--outdir", required=True)
    p.add_argument("--group", default=GROUP_DENOISED)
    p.add_argument("--format", choices=("nc", "npy"), default="nc",
                   help="patch file format inside each scene dir")
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
                   help="resume the whole fleet from OUTDIR/ckpt")
    p.add_argument("--seed", type=int, default=0,
                   help="scene s trains with seed SEED+s")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="K>1: K steps a scene per call on its device pool, "
                        "the indices drawn on the device (logging/ckpt "
                        "intervals must be K-multiples)")
    p.add_argument("--fast-forward", action="store_true",
                   help="run G as ONE composed depthwise conv")
    p.add_argument("--differentiable-reg", action="store_true")
    p.add_argument("--scene-parallel", action="store_true",
                   help="shard the scene axis over all devices: one process "
                        "per card under torchrun (zero collectives; scenes "
                        "must divide the ranks)")
    p.add_argument("--scene-chunk", type=int, default=0,
                   help="scenes each stacked step call advances, the chunks "
                        "run one after another (must divide the scene count "
                        "per rank; 0 = auto: every scene in compose mode, "
                        "the largest divisor keeping chain-mode residuals "
                        "under ~6 GiB); 1 = each scene's standalone step, "
                        "bit for bit")
    p.add_argument("--real-is-lr", action="store_true",
                   help="the D's real side is GENUINE native-LR patches "
                        "(per-scene pools from --real-lr-dir) instead of "
                        "crops of the HR patches")
    p.add_argument("--real-lr-dir", default=None,
                   help="flat directory of native-LR patch .nc files at "
                        "lr-crop-size; files regroup into scenes by name "
                        "prefix, which must cover every HR scene")
    p.add_argument("--real-lr-group", default="geophysical_data",
                   help="NetCDF group of the native-LR patches (raw "
                        "sensor radiance, not denoised)")
    p.add_argument("--raw-sum-reg", type=float, default=0.0,
                   help="weight of the un-clamped composed-kernel "
                        "band-sum-to-1 penalty (0 = reference behavior)")
    p.add_argument("--d-border-crop", type=int, default=0,
                   help="crop N px off every side of both D inputs "
                        "(0 = reference behavior)")
    p.add_argument("--d-lr", type=float, default=None,
                   help="D's Adam lr (default: tied to --lr)")
    p.add_argument("--fake-noise", default="off",
                   help="'off' (reference behavior), 'learn' (a learnable "
                        "per-band sigma initialized from the wavelet-MAD "
                        "estimate of the LR pools), 'auto' (that estimate, "
                        "fixed: N(0, sigma) added to the FAKE side), or 5 "
                        "comma-separated sigmas")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def fake_noise_sigma(lr_pools: Sequence[PatchPool]) -> tuple:
    """`--fake-noise auto`'s per-band sigma: the median over scenes of each
    scene's median over its first 64 LR patches of `estimate_sigma_np` per
    band (the denoise stage's wavelet-MAD estimator)."""
    sigs = []
    for pool in lr_pools:
        pats = np.asarray(pool.patches[:64])  # [N, C, h, w]
        sigs.append([
            np.median([estimate_sigma_np(p[b]) for p in pats])
            for b in range(pats.shape[1])
        ])
    return tuple(np.median(np.asarray(sigs), axis=0))


def main(argv=None) -> int:
    # the trainer runs its steps under deterministic algorithms on the
    # card, whose cuBLAS calls need this before cuBLAS's first use
    set_cublas_workspace_config()
    a = build_parser().parse_args(argv)
    if _world_size() > 1 and not a.scene_parallel:
        # every process would train every scene and race the per-scene
        # artifact writes
        raise SystemExit(
            "train_fleet_cli in a multi-process launch needs --scene-parallel "
            "(scenes split over the ranks)"
        )
    dev = resolve_device(a.device)
    if a.patch_dir:
        pattern = "*.npy" if a.format == "npy" else "*.nc"
        groups = group_by_scene(
            list_patch_files(a.patch_dir, pattern, host_shard=False)
        )
        names = list(groups)
        pools = [
            PatchPool.from_files(fs, group=a.group) for fs in groups.values()
        ]
    else:
        if a.patch_root:
            dirs = sorted(
                os.path.join(a.patch_root, d)
                for d in os.listdir(a.patch_root)
                if os.path.isdir(os.path.join(a.patch_root, d))
            )
            if not dirs:
                raise SystemExit(f"no scene subdirectories in {a.patch_root}")
        else:
            dirs = a.patch_dirs
        names = [os.path.basename(os.path.normpath(d)) for d in dirs]
        if a.format == "npy":
            pools = [PatchPool.from_npy_dir(d, host_shard=False) for d in dirs]
        else:
            pools = [PatchPool.from_nc_dir(d, group=a.group, host_shard=False)
                     for d in dirs]
    lr_pools = None
    if a.real_is_lr:
        if not a.real_lr_dir:
            raise SystemExit("--real-is-lr needs --real-lr-dir")
        lr_groups = group_by_scene(
            list_patch_files(a.real_lr_dir, "*.nc", host_shard=False)
        )
        missing = [n for n in names if n not in lr_groups]
        if missing:
            raise SystemExit(
                f"--real-lr-dir {a.real_lr_dir} has no patches for "
                f"scenes {missing} (found: {sorted(lr_groups)})"
            )
        lr_pools = [
            PatchPool.from_files(lr_groups[n], group=a.real_lr_group)
            for n in names
        ]
    elif a.real_lr_dir:
        raise SystemExit("--real-lr-dir given without --real-is-lr")
    sigma = None
    learnable = False
    if a.fake_noise in ("auto", "learn"):
        if lr_pools is None:
            raise SystemExit("--fake-noise auto needs --real-is-lr "
                             "(sigma is estimated from the LR pool)")
        sigma = fake_noise_sigma(lr_pools)
        learnable = a.fake_noise == "learn"
        print("fleet: fake-side noise sigma (wavelet-MAD of the LR "
              "pools): " + ", ".join(f"{s:.3f}" for s in sigma)
              + (" [learnable init]" if learnable else ""))
    elif a.fake_noise != "off":
        sigma = tuple(float(x) for x in a.fake_noise.split(","))
    cfg = SingleKernelConfig(
        iters=a.iters,
        batch_size=a.batch_size,
        lr_crop_size=a.lr_crop_size,
        real_is_lr=a.real_is_lr,
        fake_noise_sigma=sigma,
        fake_noise_learnable=learnable,
        raw_sum_reg=a.raw_sum_reg,
        d_border_crop=a.d_border_crop,
        d_lr_rate=a.d_lr,
        lr_rate=a.lr,
        reg_weight=a.reg_weight,
        grad_clip_norm=a.grad_clip,
        log_every=a.log_every,
        kernel_log_every=a.kernel_log_every,
        ckpt_every=a.ckpt_every,
        resume=a.resume,
        outdir=a.outdir,
        seed=a.seed,
        steps_per_call=a.steps_per_call,
        differentiable_reg=a.differentiable_reg,
        generator=GeneratorConfig(
            forward_mode="compose" if a.fast_forward else "chain"
        ),
    )
    with launch_mesh(a.scene_parallel, "scene", dev) as mesh:
        out = train_fleet(pools, cfg, scene_names=names, mesh=mesh,
                          scene_chunk=a.scene_chunk or None, lr_pools=lr_pools,
                          device=dev)
    print(f"fleet done: {len(out['scene_names'])} scenes -> {a.outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
