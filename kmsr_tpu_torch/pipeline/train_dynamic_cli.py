"""Stage: dynamic degradation-model training (CLI).

Counterpart of `kmsr_tpu.pipeline.train_dynamic_cli`, with the same flags
and artifacts, plus `--device` (cuda by default; a run without a card
raises unless `--device cpu`). `--trace DIR` writes a torch.profiler trace.

Usage:
    python -m kmsr_tpu_torch.pipeline.train_dynamic_cli --patch-dir DIR \
        --outdir OUT [--format npy|nc] [--iters 3000] [--batch-size 8] \
        [--steps-per-call 10] [--bulk-extract]
"""
from __future__ import annotations

import argparse
import os

from ..data.sampler import PatchPool
from ..device import resolve_device
from ..io.schema import GROUP_DENOISED
from ..train.dynamic import (
    TARGET_SIGMA,
    DynamicTrainConfig,
    bulk_extract_kernels,
    train_dynamic,
)
from .common import maybe_trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train dynamic degradation model")
    p.add_argument("--patch-dir", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--format", choices=["npy", "nc"], default="npy")
    p.add_argument("--group", default=GROUP_DENOISED)
    p.add_argument("--iters", type=int, default=3000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--noise-reg-weight", type=float, default=20.0)
    p.add_argument("--target-sigma", type=float, nargs=5, default=list(TARGET_SIGMA))
    p.add_argument("--lr-crop-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="K>1 runs K train steps per call on a device-resident "
                        "pool with the batch indices drawn on the device")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in OUTDIR/ckpt")
    p.add_argument("--bulk-extract", action="store_true",
                   help="after training, extract a per-patch kernel for every file")
    p.add_argument("--data-parallel", action="store_true",
                   help="not ported yet (ROADMAP.md queue 1 item 7): refused")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the run")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.data_parallel:
        raise SystemExit(
            "--data-parallel is not ported: data-parallel dynamic-model training "
            "over several cards is ROADMAP.md queue 1 item 7 (torch.distributed); "
            "drop the flag to train on one device")
    dev = resolve_device(a.device)
    if a.format == "npy":
        pool = PatchPool.from_npy_dir(a.patch_dir)
    else:
        pool = PatchPool.from_nc_dir(a.patch_dir, group=a.group)
    cfg = DynamicTrainConfig(
        iters=a.iters,
        batch_size=a.batch_size,
        lr_rate=a.lr,
        noise_reg_weight=a.noise_reg_weight,
        target_sigma=tuple(a.target_sigma),
        lr_crop_size=a.lr_crop_size,
        outdir=a.outdir,
        steps_per_call=a.steps_per_call,
        ckpt_every=a.ckpt_every,
        resume=a.resume,
        seed=a.seed,
    )
    with maybe_trace(a.trace):
        out = train_dynamic(pool, cfg, device=dev)
    print(f"final kernels: {out['kernel_per_band'].shape} -> {a.outdir}/final_results")
    if a.bulk_extract:
        paths = bulk_extract_kernels(
            out["state"].g_params, pool,
            os.path.join(a.outdir, "final_results", "per_patch"), cfg.model,
        )
        print(f"bulk-extracted {len(paths)} per-patch kernels")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
