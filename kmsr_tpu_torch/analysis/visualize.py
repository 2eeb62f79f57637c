"""Host-side visualization artifacts (matplotlib, Agg backend).

The port's copy of the denoise figure of `kmsr_tpu.analysis.visualize`:
`plot_denoise_comparison` (parity: `denoise/compare_denoised.py:13-142`).
matplotlib is imported when a figure is drawn, not with the module.
"""
from __future__ import annotations

import numpy as np


def _stretch(img: np.ndarray, lo: float = 2, hi: float = 98):
    vmin = np.nanpercentile(img, lo)
    vmax = np.nanpercentile(img, hi)
    return vmin, vmax


def plot_denoise_comparison(
    original: np.ndarray,
    denoised: np.ndarray,
    out_path: str,
    band_name: str = "",
) -> dict:
    """3-panel original/denoised/residual figure + RMSE. Returns
    {'rmse', 'std_res'}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

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
