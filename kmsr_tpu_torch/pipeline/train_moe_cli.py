"""Stage: MoE kernel-bank training (CLI).

Counterpart of `kmsr_tpu.pipeline.train_moe_cli`, with the same flags and
artifacts, plus `--device` (cuda by default; a run without a card raises
unless `--device cpu`). `--trace DIR` writes a torch.profiler trace.

Usage:
    python -m kmsr_tpu_torch.pipeline.train_moe_cli --patch-dir DIR --outdir OUT \
        [--format npy|nc] [--iters 5000] [--n-kernels 10] [--factor 4] \
        [--steps-per-call 20] [--init-from moe_model.npz|moe_model.pth]

Checkpoints (`--ckpt-every`, `--resume`) are this package's torch.save
files; the artifacts (`kernel_i.npy`, `sigma_i.npy`, `moe_model.npz`,
`moe_state.npz`) are the JAX package's, and either package reads them.
"""
from __future__ import annotations

import argparse

from ..data.sampler import PatchPool
from ..device import resolve_device, set_cublas_workspace_config
from ..io.schema import GROUP_DENOISED
from ..models.moe import MoEConfig
from ..parallel.mesh import launch_mesh
from ..train.moe import MoETrainConfig, train_moe
from .common import maybe_trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train MoE kernel bank")
    p.add_argument("--patch-dir", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--format", choices=["npy", "nc"], default="npy")
    p.add_argument("--group", default=GROUP_DENOISED)
    p.add_argument("--iters", type=int, default=5000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n-kernels", type=int, default=10)
    p.add_argument("--kernel-size", type=int, default=13)
    p.add_argument("--factor", type=int, default=4)
    p.add_argument("--temp-start", type=float, default=5.0)
    p.add_argument("--temp-end", type=float, default=0.5)
    p.add_argument("--lr-crop-size", type=int, default=None,
                   help="real-LR crop size (default: patch size / factor)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="K>1 runs K train steps per call on a device-resident "
                        "pool with the batch indices drawn on the device")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in OUTDIR/ckpt")
    p.add_argument("--init-from", default=None,
                   help="warm-start selector+banks from a checkpoint: the "
                        "reference's torch moe_model.pth or a moe_model.npz")
    p.add_argument("--balance-weight", type=float, default=0.0,
                   help="weight of the Switch-style load-balance aux loss "
                        "(0 = the reference's objective)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the batch over all devices: one process per "
                        "card under torchrun (a plain process is one rank)")
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
    # a data-parallel run's ranks all draw from the whole pool
    if a.format == "npy":
        pool = PatchPool.from_npy_dir(a.patch_dir, host_shard=not a.data_parallel)
    else:
        pool = PatchPool.from_nc_dir(a.patch_dir, group=a.group,
                                     host_shard=not a.data_parallel)
    cfg = MoETrainConfig(
        iters=a.iters,
        batch_size=a.batch_size,
        lr_rate=a.lr,
        temp_start=a.temp_start,
        temp_end=a.temp_end,
        lr_crop_size=a.lr_crop_size or pool.shape[-1] // a.factor,
        model=MoEConfig(n_kernels=a.n_kernels, kernel_size=a.kernel_size,
                        factor=a.factor),
        balance_weight=a.balance_weight,
        outdir=a.outdir,
        steps_per_call=a.steps_per_call,
        ckpt_every=a.ckpt_every,
        resume=a.resume,
        seed=a.seed,
    )
    with launch_mesh(a.data_parallel, "data", dev) as mesh, maybe_trace(a.trace):
        out = train_moe(pool, cfg, init_from=a.init_from, device=dev, mesh=mesh)
    print(f"saved {len(out['artifacts'])} MoE artifacts -> {a.outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
