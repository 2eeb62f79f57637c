"""Host-side visualization artifacts (matplotlib, Agg backend).

The port's copy of `kmsr_tpu.analysis.visualize`, the reference's
golden-eye QA dumps: HR/blur/noise/noisy 4-row train-sample figures
(`E_make_train_data.py:120-184`), HR-vs-degraded comparisons
(`C_30...py:216-261`), kernel grids (`visualize_all_kernels.py`), RGB
quicklooks (`visualize_all_patches.py`), the denoise comparison
(`denoise/compare_denoised.py:13-142`) and MoE bank summaries
(`visualize_moe_kernels.py`, `show_noise.py`). matplotlib is imported
when a figure is drawn, not with the module.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..io.schema import BAND_NAMES


def _plt():
    """matplotlib.pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _stretch(img: np.ndarray, lo: float = 2, hi: float = 98):
    vmin = np.nanpercentile(img, lo)
    vmax = np.nanpercentile(img, hi)
    return vmin, vmax


def plot_train_sample(
    hr: np.ndarray,
    blurred: np.ndarray,
    lr_noisy: np.ndarray,
    out_path: str,
    band_names: Sequence[str] = BAND_NAMES,
) -> None:
    """4-row QA figure: HR / blurred / injected noise / blurred+noise."""
    plt = _plt()
    n = len(band_names)
    noise = lr_noisy - blurred
    fig, axes = plt.subplots(4, n, figsize=(3 * n, 12))
    rows = [
        ("HR", hr),
        ("Blurred", blurred),
        ("Noise", noise),
        ("Blurred+Noise", lr_noisy),
    ]
    for r, (title, data) in enumerate(rows):
        for c in range(n):
            ax = axes[r, c]
            if title == "Noise":
                lim = max(float(np.nanstd(data[c])) * 3, 1e-6)
                im = ax.imshow(data[c], cmap="coolwarm", vmin=-lim, vmax=lim)
            else:
                vmin, vmax = _stretch(hr[c])
                im = ax.imshow(data[c], cmap="viridis", vmin=vmin, vmax=vmax)
            if r == 0:
                ax.set_title(band_names[c], fontsize=9)
            if c == 0:
                ax.set_ylabel(title, fontsize=10)
            ax.set_xticks([])
            ax.set_yticks([])
            fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_hr_vs_degraded(
    hr: np.ndarray,
    degraded: np.ndarray,
    out_path: str,
    band_names: Sequence[str] = BAND_NAMES,
) -> None:
    """2-row HR vs blurred/downsampled comparison with shared color range."""
    plt = _plt()
    n = min(hr.shape[0], len(band_names))
    fig, axes = plt.subplots(2, n, figsize=(4 * n, 8))
    if n == 1:
        axes = axes.reshape(2, 1)
    for c in range(n):
        vmin = min(np.nanmin(hr[c]), np.nanmin(degraded[c]))
        vmax = max(np.nanmax(hr[c]), np.nanmax(degraded[c]))
        for r, (title, data) in enumerate([("HR", hr), ("Degraded", degraded)]):
            ax = axes[r, c]
            im = ax.imshow(data[c], cmap="viridis", vmin=vmin, vmax=vmax,
                           interpolation="nearest")
            ax.set_title(f"{title} {band_names[c]}\n{data[c].shape}", fontsize=9)
            ax.axis("off")
            fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_kernels(
    kernels: np.ndarray, out_path: str, title: str = "", annotate: bool = False
) -> None:
    """Per-band kernel grid + merged mean (parity: visualize_all_kernels).

    annotate=True writes each cell's value into the figure for kernels up
    to 15x15 (parity: `visualize_kernels.py:51-57`).
    """
    plt = _plt()
    kernels = np.asarray(kernels)
    if kernels.ndim == 2:
        kernels = kernels[None]
    n = kernels.shape[0]
    fig, axes = plt.subplots(1, n + 1, figsize=(2.4 * (n + 1), 2.6))
    if n + 1 == 1:
        axes = [axes]

    def _annotate(ax, k):
        if not annotate or k.shape[0] > 15 or k.shape[1] > 15:
            return
        thresh = k.max() * 0.5
        for i in range(k.shape[0]):
            for j in range(k.shape[1]):
                ax.text(
                    j, i, f"{k[i, j]:.3f}", ha="center", va="center",
                    fontsize=4, color="white" if k[i, j] > thresh else "black",
                )

    for i in range(n):
        im = axes[i].imshow(kernels[i], cmap="viridis")
        axes[i].set_title(f"Band {i}", fontsize=9)
        axes[i].axis("off")
        fig.colorbar(im, ax=axes[i], fraction=0.046)
        _annotate(axes[i], kernels[i])
    merged = kernels.mean(axis=0)
    im = axes[n].imshow(merged, cmap="viridis")
    axes[n].set_title("Merged", fontsize=9)
    axes[n].axis("off")
    fig.colorbar(im, ax=axes[n], fraction=0.046)
    _annotate(axes[n], merged)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def patch_to_rgb(
    stack: np.ndarray, rgb_indices: tuple[int, int, int] = (3, 2, 1)
) -> np.ndarray:
    """[C,H,W] band stack -> [H,W,3] display RGB with per-channel 1-99
    percentile stretch (parity: `visualize_all_patches.py:12-45` — uses
    bands 660/555/490 as R/G/B)."""
    chans = []
    for idx in rgb_indices:
        band = np.asarray(stack[idx], np.float32)
        finite = band[np.isfinite(band)]
        if finite.size:
            vmin, vmax = np.percentile(finite, [1, 99])
        else:
            vmin, vmax = 0.0, 1.0
        if vmax <= vmin:
            vmax = vmin + 1e-6
        chans.append(np.clip((band - vmin) / (vmax - vmin), 0.0, 1.0))
    return np.nan_to_num(np.stack(chans, axis=-1), nan=0.0)


def plot_patch_rgb(
    stack: np.ndarray,
    out_path: str,
    title: str = "",
    rgb_indices: tuple[int, int, int] = (3, 2, 1),
) -> None:
    """RGB quicklook PNG for one patch (parity: visualize_all_patches.py)."""
    plt = _plt()
    rgb = patch_to_rgb(stack, rgb_indices)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(rgb)
    ax.axis("off")
    if title:
        ax.set_title(title)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_denoise_comparison(
    original: np.ndarray,
    denoised: np.ndarray,
    out_path: str,
    band_name: str = "",
) -> dict:
    """3-panel original/denoised/residual figure + RMSE. Returns
    {'rmse', 'std_res'}."""
    plt = _plt()
    residual = original - denoised
    valid = ~np.isnan(residual)
    res = residual[valid]
    rmse = float(np.sqrt(np.mean(res**2))) if res.size else 0.0
    std_res = float(np.std(res)) if res.size else 0.0
    vmin, vmax = _stretch(original)
    fig = plt.figure(figsize=(18, 6))
    fig.suptitle(f"Denoising: {band_name} (RMSE {rmse:.4f})")
    for i, (title, img, cmap, vr) in enumerate(
        [
            ("Original (noisy)", original, "viridis", (vmin, vmax)),
            ("Denoised", denoised, "viridis", (vmin, vmax)),
            ("Residual", residual, "coolwarm", (-3 * std_res, 3 * std_res)),
        ]
    ):
        ax = fig.add_subplot(1, 3, i + 1)
        im = ax.imshow(img, cmap=cmap, vmin=vr[0], vmax=vr[1])
        ax.set_title(title)
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return {"rmse": rmse, "std_res": std_res}


def plot_moe_bank(
    kernels: np.ndarray, sigmas: np.ndarray, out_dir: str
) -> list[str]:
    """MoE bank summary figures: mean-kernel grid, sigma heatmap/bars, and
    pairwise kernel L2-distance matrix (parity: visualize_moe_kernels.py,
    show_noise.py)."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    n_k = kernels.shape[0]

    # 1. mean kernel per expert
    cols = min(5, n_k)
    rows = (n_k + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(2.4 * cols, 2.6 * rows))
    axes = np.atleast_2d(axes)
    for i in range(rows * cols):
        ax = axes[i // cols, i % cols]
        if i < n_k:
            im = ax.imshow(kernels[i].mean(axis=0), cmap="viridis")
            ax.set_title(f"K{i}", fontsize=9)
            fig.colorbar(im, ax=ax, fraction=0.046)
        ax.axis("off")
    p = os.path.join(out_dir, "moe_kernels_mean.png")
    fig.tight_layout()
    fig.savefig(p, dpi=120)
    plt.close(fig)
    paths.append(p)

    # 2. sigma heatmap + per-kernel bars
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))
    im = ax1.imshow(sigmas, cmap="magma", aspect="auto")
    ax1.set_xlabel("band")
    ax1.set_ylabel("expert")
    ax1.set_title("sigma bank")
    fig.colorbar(im, ax=ax1)
    ax2.bar(np.arange(n_k), sigmas.mean(axis=1))
    ax2.set_xlabel("expert")
    ax2.set_title("mean sigma per expert")
    p = os.path.join(out_dir, "moe_sigmas.png")
    fig.tight_layout()
    fig.savefig(p, dpi=120)
    plt.close(fig)
    paths.append(p)

    # 3. pairwise kernel distance matrix
    flat = kernels.reshape(n_k, -1)
    dist = np.linalg.norm(flat[:, None] - flat[None, :], axis=-1)
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(dist, cmap="viridis")
    ax.set_title("pairwise kernel L2 distance")
    fig.colorbar(im, ax=ax)
    p = os.path.join(out_dir, "moe_kernel_distances.png")
    fig.tight_layout()
    fig.savefig(p, dpi=120)
    plt.close(fig)
    paths.append(p)
    return paths
