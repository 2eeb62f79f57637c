"""Visualization CLIs covering the reference's standalone viz scripts.

Counterpart of `kmsr_tpu.analysis.viz_cli` (host numpy, the port's `.nc`
codec and matplotlib, imported at first use; the same flags, defaults and
printed lines).

Sub-commands:
  kernels     render every .npy kernel in a dir to PNG
              (parity: `visualize_all_kernels.py`)
  moe         MoE bank figures + sigma tables
              (parity: `visualize_moe_kernels.py`, `show_noise.py`)
  patch       quick patch viewer: stats + band PNG
              (parity: `denoise/vis_patches.py`)
  nir         NIR water-mask overview figure for a scene
              (parity: `A_00_patch_cutter_universal.py:263-316`)
  rgb         RGB (660/555/490) quicklook PNG per patch, file or folder
              (parity: `visualize_all_patches.py`)
  hist        band-distribution comparison histogram — two files of the
              same group (sensor-vs-sensor, count mode with 0.0001/99.99
              percentile shared bins) or two groups of one file (hr-vs-lr,
              density mode with 1/99 clip)
              (parity: `output/single_kernel/data_generation_method_compare/
              compare_490_hist.py:36-75`, `compare_490_hr_lr.py:31-73`)

Usage:
    python -m kmsr_tpu_torch.analysis.viz_cli kernels --input-dir K --output-dir OUT
    python -m kmsr_tpu_torch.analysis.viz_cli moe --moe-dir moe_kernels --output-dir OUT
    python -m kmsr_tpu_torch.analysis.viz_cli patch FILE --group denoised --output p.png
    python -m kmsr_tpu_torch.analysis.viz_cli nir FILE --output nir.png
    python -m kmsr_tpu_torch.analysis.viz_cli hist A.nc --file-b B.nc --band L_TOA_490
    python -m kmsr_tpu_torch.analysis.viz_cli hist PAIR.nc --group hr --group-b lr --density
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..io.ncio import read_band_stack
from ..io.schema import BAND_NAMES, GROUP_GEO, NIR_BAND_INDEX
from .visualize import _plt


def cmd_kernels(a) -> int:
    from .visualize import plot_kernels

    files = sorted(glob.glob(os.path.join(a.input_dir, "*.npy")))
    if not files:
        print(f"no .npy kernels in {a.input_dir}")
        return 1
    os.makedirs(a.output_dir, exist_ok=True)
    for f in files:
        k = np.load(f)
        if k.ndim not in (2, 3):
            continue
        out = os.path.join(
            a.output_dir, os.path.basename(f).replace(".npy", ".png")
        )
        plot_kernels(k, out, title=os.path.basename(f), annotate=a.annotate)
        print(f"{os.path.basename(f)}: shape={k.shape} sum={k.sum():.4f} -> {out}")
    return 0


def cmd_rgb(a) -> int:
    from .visualize import plot_patch_rgb

    targets = (
        sorted(
            glob.glob(os.path.join(a.path, "*.npy"))
            + glob.glob(os.path.join(a.path, "*.nc"))
        )
        if os.path.isdir(a.path)
        else [a.path]
    )
    if not targets:
        print(f"no .npy/.nc patches in {a.path}")
        return 1
    out_dir = a.output_dir or (
        os.path.join(a.path, "visualizations")
        if os.path.isdir(a.path)
        else os.path.dirname(a.path) or "."
    )
    os.makedirs(out_dir, exist_ok=True)
    for f in targets:
        stack = (
            np.load(f) if f.endswith(".npy") else read_band_stack(f, a.group)
        )
        base = os.path.basename(f)
        out = os.path.join(out_dir, os.path.splitext(base)[0] + "_rgb.png")
        plot_patch_rgb(stack, out, title=base)
        print(f"{base}: shape={stack.shape} -> {out}")
    return 0


def cmd_moe(a) -> int:
    from .visualize import plot_moe_bank

    kernels, sigmas = [], []
    i = 0
    while os.path.exists(os.path.join(a.moe_dir, f"kernel_{i}.npy")):
        kernels.append(np.load(os.path.join(a.moe_dir, f"kernel_{i}.npy")))
        sigmas.append(np.load(os.path.join(a.moe_dir, f"sigma_{i}.npy")))
        i += 1
    if not kernels:
        print(f"no kernel_*.npy in {a.moe_dir}")
        return 1
    ks = np.stack(kernels)
    ss = np.stack(sigmas)
    # sigma tables (show_noise.py parity)
    print(f"MoE bank: {ks.shape[0]} kernels, {ks.shape[1]} bands, "
          f"{ks.shape[2]}x{ks.shape[3]}")
    header = "kernel | " + " | ".join(f"{b.split('_')[-1]:>7s}" for b in BAND_NAMES)
    print(header)
    print("-" * len(header))
    for k_idx in range(ss.shape[0]):
        row = " | ".join(f"{v:7.4f}" for v in ss[k_idx])
        print(f"K{k_idx:<5d} | {row}")
    print(f"mean sigma per kernel: {ss.mean(axis=1).round(4)}")
    print(f"mean sigma per band:   {ss.mean(axis=0).round(4)}")
    flat = ks.reshape(ks.shape[0], -1)
    dist = np.linalg.norm(flat[:, None] - flat[None, :], axis=-1)
    print(f"kernel diversity: mean pairwise L2 = {dist[np.triu_indices(len(ks), 1)].mean():.4f}")
    paths = plot_moe_bank(ks, ss, a.output_dir)
    print("figures:", ", ".join(paths))
    return 0


def cmd_patch(a) -> int:
    plt = _plt()
    stack = read_band_stack(a.file, a.group)
    for i, b in enumerate(BAND_NAMES):
        band = stack[i]
        print(
            f"{b}: shape={band.shape} min={np.nanmin(band):.4f} "
            f"max={np.nanmax(band):.4f} mean={np.nanmean(band):.4f} "
            f"nan={np.isnan(band).mean() * 100:.1f}%"
        )
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(stack[a.band_index], cmap="viridis")
    ax.set_title(f"{os.path.basename(a.file)} [{a.group}] {BAND_NAMES[a.band_index]}")
    fig.colorbar(im, ax=ax)
    fig.savefig(a.output, dpi=120, bbox_inches="tight")
    print(f"-> {a.output}")
    return 0


def cmd_nir(a) -> int:
    from ..data.mask import apply_water_mask

    plt = _plt()
    stack = read_band_stack(a.file, a.group)
    nir = stack[NIR_BAND_INDEX]
    masked, stats = apply_water_mask(stack, a.threshold_min, a.threshold_max)
    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    vmin, vmax = np.nanpercentile(nir, 2), np.nanpercentile(nir, 98)
    im = axes[0].imshow(nir, cmap="viridis", vmin=vmin, vmax=vmax)
    axes[0].set_title("NIR 865 nm (raw)")
    fig.colorbar(im, ax=axes[0], fraction=0.046)
    im = axes[1].imshow(masked[NIR_BAND_INDEX], cmap="viridis", vmin=vmin, vmax=vmax)
    axes[1].set_title(
        f"water mask [{a.threshold_min:g}, {a.threshold_max:g}] "
        f"({stats.water_ratio:.1f}% water)"
    )
    fig.colorbar(im, ax=axes[1], fraction=0.046)
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(a.output, dpi=150, bbox_inches="tight")
    print(
        f"valid={stats.total_valid:,} water={stats.water_pixels:,} "
        f"({stats.water_ratio:.2f}%) -> {a.output}"
    )
    return 0


def cmd_hist(a) -> int:
    plt = _plt()
    file_b = a.file_b or a.file
    group_b = a.group_b or a.group
    va = read_band_stack(a.file, a.group, band_names=[a.band]).ravel()
    vb = read_band_stack(file_b, group_b, band_names=[a.band]).ravel()
    va, vb = va[np.isfinite(va)], vb[np.isfinite(vb)]
    both = np.concatenate([va, vb])
    lo_p, hi_p = (1.0, 99.0) if a.density else (0.0001, 99.99)
    lo, hi = np.nanpercentile(both, [lo_p, hi_p])
    lo = max(lo, 0.0)
    edges = np.linspace(lo, hi, a.bins + 1)
    label_a = a.label_a or (a.group if a.group != group_b else os.path.basename(a.file))
    label_b = a.label_b or (group_b if a.group != group_b else os.path.basename(file_b))
    fig, ax = plt.subplots(figsize=(6, 4.8))
    ax.hist(va[(va >= lo) & (va <= hi)], bins=edges, alpha=0.6,
            label=label_a, density=a.density)
    ax.hist(vb[(vb >= lo) & (vb <= hi)], bins=edges, alpha=0.6,
            label=label_b, density=a.density)
    ax.set_title(f"Histogram — {a.band}")
    ax.set_xlabel("Value")
    ax.set_ylabel("Density" if a.density else "Count")
    ax.set_xlim(lo, hi)
    ax.legend()
    fig.tight_layout()
    fig.savefig(a.output, dpi=200)
    plt.close(fig)
    print(f"saved {a.output} ({label_a}: {va.size} px, {label_b}: {vb.size} px)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="KMSR visualization tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    pk = sub.add_parser("kernels")
    pk.add_argument("--input-dir", required=True)
    pk.add_argument("--output-dir", required=True)
    pk.add_argument("--annotate", action="store_true",
                    help="write per-cell values into kernels <= 15x15 "
                         "(parity: visualize_kernels.py)")

    pr = sub.add_parser("rgb")
    pr.add_argument("path", help="one patch file or a dir of .npy/.nc patches")
    pr.add_argument("--group", default=GROUP_GEO,
                    help="NetCDF group for .nc inputs")
    pr.add_argument("--output-dir", default=None,
                    help="default: <dir>/visualizations (parity: "
                         "visualize_all_patches.py)")

    pm = sub.add_parser("moe")
    pm.add_argument("--moe-dir", required=True)
    pm.add_argument("--output-dir", required=True)

    pp = sub.add_parser("patch")
    pp.add_argument("file")
    pp.add_argument("--group", default=GROUP_GEO)
    pp.add_argument("--band-index", type=int, default=0)
    pp.add_argument("--output", default="patch.png")

    pn = sub.add_parser("nir")
    pn.add_argument("file")
    pn.add_argument("--group", default=GROUP_GEO)
    pn.add_argument("--threshold-min", type=float, default=1e-6)
    pn.add_argument("--threshold-max", type=float, default=7.0)
    pn.add_argument("--output", default="nir_overview.png")

    ph = sub.add_parser("hist")
    ph.add_argument("file")
    ph.add_argument("--file-b", default=None, help="second file (default: same file)")
    ph.add_argument("--group", default=GROUP_GEO)
    ph.add_argument("--group-b", default=None, help="second group (default: same group)")
    ph.add_argument("--band", default=BAND_NAMES[1])  # L_TOA_490, as the reference
    ph.add_argument("--bins", type=int, default=90)
    ph.add_argument("--density", action="store_true",
                    help="density histograms + 1/99 clip (hr-vs-lr mode)")
    ph.add_argument("--label-a", default=None)
    ph.add_argument("--label-b", default=None)
    ph.add_argument("--output", default="hist_compare.png")

    a = p.parse_args(argv)
    return {
        "kernels": cmd_kernels, "moe": cmd_moe, "patch": cmd_patch,
        "nir": cmd_nir, "hist": cmd_hist, "rgb": cmd_rgb,
    }[a.cmd](a)


if __name__ == "__main__":
    raise SystemExit(main())
