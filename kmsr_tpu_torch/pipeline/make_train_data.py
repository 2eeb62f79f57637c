"""Stage: assemble SR training pairs (hr, lr) with noise-pool injection.

Counterpart of `kmsr_tpu.pipeline.make_train_data` (host-only: numpy and
the port's HDF5 codec). Contract parity with
`E_make_train_data.py:187-299`: for each input
file, hr = `denoised` group (C,256,256), lr = `blurred` group (C,32,32) +
one random noise-pool sample; strict shape gates; per-sample output .nc
with `hr`/`lr`/`navigation_data` groups (zlib); seeded RNG;
success/failure accounting; optional QA comparison figures
(`<base>_qa.png`, `analysis.visualize.plot_train_sample`) for up to 30
random samples, drawn from the seeded generator before any noise draw, as
JAX draws them (so `--vis-dir` shifts every file's noise stream in both
packages alike).

Usage:
    python -m kmsr_tpu_torch.pipeline.make_train_data --input-dir BLURRED \
        --noise-pool pool.npy --output-dir OUT [--vis-dir VIS] [--seed 42]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.noise_pool import add_noise_np, load_noise_pool
from ..data.sampler import list_patch_files
from ..io.ncio import NCFile, read_band_stack, read_nav, write_bands
from ..io.schema import GROUP_BLURRED, GROUP_DENOISED, GROUP_HR, GROUP_LR
from .common import RunReport, run_per_file

MAX_VIS_SAMPLES = 30


def save_training_sample(
    output_path: str,
    hr: np.ndarray,
    lr: np.ndarray,
    nav: dict | None,
    lr_attrs: dict | None = None,
) -> None:
    """One `<name>_train.nc`: the hr and lr groups and the nav rasters,
    written through one handle (the JAX package opens the file three
    times; the contents are the same)."""
    with NCFile(output_path, "w") as f:
        write_bands(f, GROUP_HR, hr, dims=("y_hr", "x_hr"))
        write_bands(f, GROUP_LR, lr, dims=("y_lr", "x_lr"), group_attrs=lr_attrs)
        for name, arr in (nav or {}).items():
            if arr is not None and arr.size:
                dims = tuple(f"{name}_dim_{j}" for j in range(arr.ndim))
                f.create_variable("navigation_data", name, arr, dims=dims)


def process_files(
    input_dir: str,
    noise_pool_path: str,
    output_dir: str,
    vis_dir: str | None = None,
    seed: int = 42,
    hr_group: str = GROUP_DENOISED,
    lr_group: str = GROUP_BLURRED,
    hr_size: int = 256,
    lr_size: int = 32,
    progress: bool = True,
) -> RunReport:
    rng = np.random.default_rng(seed)
    pool = load_noise_pool(noise_pool_path)
    files = list_patch_files(input_dir, "*.nc")
    os.makedirs(output_dir, exist_ok=True)
    vis_files = set()
    if vis_dir:
        os.makedirs(vis_dir, exist_ok=True)
        n_vis = min(MAX_VIS_SAMPLES, len(files))
        vis_files = {files[i] for i in rng.choice(len(files), size=n_vis, replace=False)}

    def one(path):
        hr = read_band_stack(path, hr_group)
        blurred = read_band_stack(path, lr_group)
        c = hr.shape[0]
        # strict shape gates (`E_make_train_data.py:238-246`)
        if hr.shape != (c, hr_size, hr_size):
            raise ValueError(f"hr shape {hr.shape} != ({c},{hr_size},{hr_size})")
        if blurred.shape != (c, lr_size, lr_size):
            raise ValueError(f"blurred shape {blurred.shape} != ({c},{lr_size},{lr_size})")
        lr = add_noise_np(rng, blurred, pool)
        nav = read_nav(path)
        base = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(output_dir, f"{base}_train.nc")
        save_training_sample(out_path, hr, lr, nav or None)
        if path in vis_files:
            from ..analysis.visualize import plot_train_sample

            plot_train_sample(hr, blurred, lr, os.path.join(vis_dir, f"{base}_qa.png"))

    report = run_per_file(files, one, desc="making train data", progress=progress)
    print(f"make_train_data: {report.summary()} -> {output_dir}")
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Assemble hr/lr training pairs")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--noise-pool", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--vis-dir", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--hr-group", default=GROUP_DENOISED)
    p.add_argument("--lr-group", default=GROUP_BLURRED)
    p.add_argument("--hr-size", type=int, default=256)
    p.add_argument("--lr-size", type=int, default=32)
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    report = process_files(
        a.input_dir,
        a.noise_pool,
        a.output_dir,
        vis_dir=a.vis_dir,
        seed=a.seed,
        hr_group=a.hr_group,
        lr_group=a.lr_group,
        hr_size=a.hr_size,
        lr_size=a.lr_size,
    )
    return 0 if report.n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
