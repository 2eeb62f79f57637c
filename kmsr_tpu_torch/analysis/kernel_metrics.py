"""Kernel monitoring: physical metrics + ASCII rendering.

The port's own copy of `kmsr_tpu.analysis.kernel_metrics` (numpy only):
the training loop's kernel statistics and ASCII renderer.
"""
from __future__ import annotations

import numpy as np

ASCII_CHARS = " .:-=+*#%@"


def kernel_metrics(k: np.ndarray) -> dict:
    """Statistics of a 2-D blur kernel for training monitoring.

    Returns shape string, sum, max, min, std, sparsity (fraction of
    elements above 5% of the max) and centroid offset from the geometric
    center.
    """
    k = np.asarray(k, dtype=np.float64)
    kh, kw = k.shape
    thresh = k.max() * 0.05
    sparsity = float((k > thresh).mean())
    yy, xx = np.meshgrid(np.arange(kh), np.arange(kw), indexing="ij")
    mass = k + 1e-12
    cy = float((yy * mass).sum() / mass.sum())
    cx = float((xx * mass).sum() / mass.sum())
    c_y, c_x = (kh - 1) / 2.0, (kw - 1) / 2.0
    return {
        "k_shape": f"{kh}x{kw}",
        "k_sum": float(k.sum()),
        "k_max": float(k.max()),
        "k_min": float(k.min()),
        "k_std": float(k.std()),
        "sparsity": sparsity,
        "center_offset": float(np.hypot(cy - c_y, cx - c_x)),
    }


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """align_corners=False bilinear resize (numpy, tiny inputs)."""
    in_h, in_w = img.shape
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (
        a * (1 - wy) * (1 - wx)
        + b * (1 - wy) * wx
        + c * wy * (1 - wx)
        + d * wy * wx
    )


def ascii_kernel(k: np.ndarray, size: int = 11) -> str:
    """Render a kernel as a size x size ASCII intensity block."""
    k2 = _bilinear_resize(np.asarray(k, np.float64), size, size)
    mx = k2.max() + 1e-12
    lines = []
    for row in k2:
        lines.append(
            "".join(
                ASCII_CHARS[min(int(v / mx * (len(ASCII_CHARS) - 1)), len(ASCII_CHARS) - 1)]
                for v in row
            )
        )
    return "\n".join(lines)


def kernel_delta_l2(k: np.ndarray, prev: np.ndarray | None) -> float:
    """L2 change between consecutive kernel snapshots."""
    if prev is None:
        return 0.0
    return float(np.linalg.norm(np.asarray(k) - np.asarray(prev)))
