"""Stage: SR model training from data-factory pairs (CLI).

Counterpart of `kmsr_tpu.pipeline.train_sr_cli`, with the same flags plus
`--device` (cuda by default; a run without a card raises unless `--device
cpu`). `--trace DIR` writes a torch.profiler trace. `--data-parallel`
splits each batch over the ranks of a torchrun launch (one process per
card; every rank loads all pairs). Checkpoints (`--ckpt-every`,
`--resume`) are this package's torch.save files; `sr_model.npz` is the
JAX package's layout, and either package reads it.

Usage:
    python -m kmsr_tpu_torch.pipeline.train_sr_cli --train-dir PAIRS --outdir OUT \
        [--iters 20000] [--batch-size 32] [--width 64] [--n-blocks 8] [--factor 8] \
        [--device cuda|cpu]
    torchrun --nproc_per_node=N -m kmsr_tpu_torch.pipeline.train_sr_cli \
        --train-dir PAIRS --outdir OUT --data-parallel
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.sampler import list_patch_files
from ..device import resolve_device, set_cublas_workspace_config
from ..io.ncio import read_band_stack
from ..io.schema import GROUP_HR, GROUP_LR
from ..models.sr import SRConfig
from ..parallel.mesh import launch_mesh
from ..train.sr import SRTrainConfig, train_sr
from .common import maybe_trace


def load_pairs(train_dir: str, host_shard: bool = True) -> tuple[np.ndarray, np.ndarray]:
    files = list_patch_files(train_dir, "*.nc", host_shard=host_shard)
    lrs, hrs = [], []
    for f in files:
        hrs.append(read_band_stack(f, GROUP_HR))
        lrs.append(read_band_stack(f, GROUP_LR))
    return np.stack(lrs), np.stack(hrs)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train SR CNN on hr/lr pairs")
    p.add_argument("--train-dir", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--iters", type=int, default=20_000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--n-blocks", type=int, default=8)
    p.add_argument("--factor", type=int, default=8)
    p.add_argument(
        "--upsampler", choices=["progressive", "oneshot"], default="progressive",
        help="progressive: x2 shuffle stages (quality); oneshot: single LR-space shuffle (speed)",
    )
    p.add_argument("--f32", action="store_true", help="train in f32 instead of bf16")
    p.add_argument("--holdout", type=int, default=0,
                   help="pairs held out (tail of the sorted file list) for "
                        "true validation PSNR/SSIM; 0 = eval on train samples")
    p.add_argument("--eval-every", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="checkpoint interval (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in OUTDIR/ckpt")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the batch over all devices: one process per "
                        "card under torchrun (a plain process is one rank)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the run")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    # the trainer runs its steps under deterministic algorithms on the
    # card, whose cuBLAS calls need this before cuBLAS's first use
    set_cublas_workspace_config()
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    # a data-parallel run's ranks all draw from every pair
    lr_all, hr_all = load_pairs(a.train_dir, host_shard=not a.data_parallel)
    print(f"loaded {lr_all.shape[0]} pairs: lr {lr_all.shape[1:]}, hr {hr_all.shape[1:]}")
    cfg = SRTrainConfig(
        iters=a.iters,
        batch_size=a.batch_size,
        lr_rate=a.lr,
        model=SRConfig(
            width=a.width, n_blocks=a.n_blocks, factor=a.factor, upsampler=a.upsampler
        ),
        compute_dtype="float32" if a.f32 else "bfloat16",
        ckpt_every=a.ckpt_every,
        resume=a.resume,
        outdir=a.outdir,
        seed=a.seed,
        holdout=a.holdout,
        eval_every=a.eval_every,
        log_every=a.log_every,
    )
    with launch_mesh(a.data_parallel, "data", dev) as mesh, maybe_trace(a.trace):
        out = train_sr((lr_all, hr_all), cfg, mesh=mesh, device=dev)
    if out.get("final_eval"):
        ev = out["final_eval"]
        print(f"final eval: psnr={ev['psnr']:.2f} ssim={ev['ssim']:.4f}")
    print(f"model saved: {out['model_path']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
