"""Generate realistic multi-scene Landsat-like inputs for the SR quality run.

The PyTorch port's copy of `scripts/make_quality_scenes.py`: the same
generator, flags and printed lines, writing through `kmsr_tpu_torch.io`;
for one seed its scenes, native-LR scenes and gt_kernel.npy are bit-equal
to that script's. numpy only (and h5py to write the `.nc` files).

The reference's data model (SURVEY.md section 0): 5-band TOA radiance
scenes (`L_TOA_443/490/555/660/865`, W m^-2 sr^-1 um^-1), water pixels
passing the NIR-865 mask window [1e-6, 7.0]
(`A_00_patch_cutter_universal.py:89-123`), invalid pixels NaN. This
generator produces statistically Landsat-like ocean scenes:

- large-scale radiance gradients + power-law (k^-3) mesoscale eddy
  fields shared across bands with band-dependent mixing (ocean color
  structure is spectrally correlated),
- sharp chlorophyll-front filaments (thresholded second field), so the
  SR task has real high-frequency content,
- band-dependent base radiance [70, 55, 35, 18, 3] (NIR dark over
  water -> mask passes) and sensor noise with the per-band sigmas the
  reference measured and regularizes toward: [0.55, 0.72, 0.83, 0.63,
  0.19] (`muti_kernel/train.py:212`),
- a few NaN cloud holes per scene (mask/NaN-gate paths exercised).

Usage: python scripts/torch_make_quality_scenes.py OUTDIR [--n 8] [--size 896]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

BANDS = ["L_TOA_443", "L_TOA_490", "L_TOA_555", "L_TOA_660", "L_TOA_865"]
BASE = np.array([70.0, 55.0, 35.0, 18.0, 3.0], np.float32)
NOISE_SIGMA = np.array([0.55, 0.72, 0.83, 0.63, 0.19], np.float32)
# how strongly each band expresses the two structure fields (blue/green
# bands carry chlorophyll signal; NIR nearly flat over water)
MIX_EDDY = np.array([4.0, 3.5, 2.5, 1.2, 0.15], np.float32)
MIX_FRONT = np.array([2.5, 2.8, 2.0, 0.9, 0.1], np.float32)


def powerlaw_field(rng: np.random.Generator, n: int, slope: float = 3.0) -> np.ndarray:
    """Isotropic random field with a k^-slope power spectrum, unit std."""
    kx = np.fft.fftfreq(n)[None, :]
    ky = np.fft.fftfreq(n)[:, None]
    k = np.sqrt(kx * kx + ky * ky)
    k[0, 0] = 1.0
    amp = k ** (-slope / 2.0)
    amp[0, 0] = 0.0
    phase = rng.uniform(0, 2 * np.pi, (n, n))
    f = np.fft.ifft2(amp * np.exp(1j * phase)).real
    return ((f - f.mean()) / f.std()).astype(np.float32)


def gt_lr_kernel(n: int = 13) -> np.ndarray:
    """Ground-truth LR-sensor PSF: per-band rotated anisotropic Gaussian.

    The synthetic 'GOCI-like' sensor's blur, applied on the HR grid
    before x8 block-mean decimation — exactly the operator family the
    KernelGAN's generator can represent (13x13 effective kernel + 3
    stacked 2x2 avg-pools), so the fleet's learned kernels can be
    compared against this array directly (kernel-recovery evidence in
    docs/QUALITY_real_lr.md). [5, n, n], each band sums to 1.
    """
    c = n // 2
    yy, xx = np.meshgrid(np.arange(n) - c, np.arange(n) - c, indexing="ij")
    theta = np.deg2rad(25.0)
    xr = np.cos(theta) * xx + np.sin(theta) * yy
    yr = -np.sin(theta) * xx + np.cos(theta) * yy
    ks = []
    for b in range(5):
        sx = 1.15 + 0.08 * b   # along-scan MTF degrades toward NIR
        sy = 1.85 - 0.05 * b
        k = np.exp(-0.5 * ((xr / sx) ** 2 + (yr / sy) ** 2))
        ks.append(k / k.sum())
    return np.stack(ks).astype(np.float32)


def make_lr_scene(
    clean: np.ndarray, nan_mask: np.ndarray, kernel: np.ndarray,
    rng: np.random.Generator, factor: int = 8,
) -> np.ndarray:
    """Native-LR counterpart of a clean HR scene: GT-PSF blur (replicate
    pad) -> x`factor` block mean -> + LR sensor noise (the reference's
    measured per-band sigmas) -> decimated NaN mask (block-any)."""
    nb, size, _ = clean.shape
    n = kernel.shape[-1]
    r = n // 2
    pad = np.pad(clean, ((0, 0), (r, r), (r, r)), mode="edge")
    blurred = np.zeros_like(clean)
    for dy in range(n):
        for dx in range(n):
            blurred += kernel[:, dy, dx, None, None] * pad[
                :, dy : dy + size, dx : dx + size
            ]
    s = size // factor
    lr = blurred[:, : s * factor, : s * factor].reshape(
        nb, s, factor, s, factor
    ).mean(axis=(2, 4))
    lr += rng.normal(0, 1, lr.shape) * NOISE_SIGMA[:, None, None]
    lr = lr.astype(np.float32)
    lr[4] = np.clip(lr[4], 0.05, 6.8)  # NIR inside the water-mask window
    hole = nan_mask[: s * factor, : s * factor].reshape(
        s, factor, s, factor
    ).any(axis=(1, 3))
    lr[:, hole] = np.nan
    return lr


def make_scene(
    rng: np.random.Generator, size: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (scene, clean, nan_mask): the HR-sensor scene (noise +
    NaN holes applied), the pre-noise clean field the LR-sensor path
    degrades (same ocean, different sensor), and the cloud-hole mask.
    RNG draw order is unchanged vs earlier rounds, so seeded HR scenes
    are bit-identical whether or not LR counterparts are generated."""
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij"
    )
    grad = (0.6 * xx + 0.4 * yy * yy).astype(np.float32)  # large-scale trend
    eddy = powerlaw_field(rng, size, 3.0)
    front_base = powerlaw_field(rng, size, 2.5)
    # filaments: steep tanh of a second field -> sharp O(pixel) fronts
    front = np.tanh(6.0 * front_base).astype(np.float32)

    scene = np.empty((5, size, size), np.float32)
    clean_all = np.empty((5, size, size), np.float32)
    for b in range(5):
        clean = (
            BASE[b]
            + 3.0 * BASE[b] / 70.0 * grad
            + MIX_EDDY[b] * eddy
            + MIX_FRONT[b] * front
        )
        clean_all[b] = clean
        scene[b] = clean + rng.normal(0, NOISE_SIGMA[b], (size, size))
    # NIR must stay inside the water-mask window (0, 7.0)
    scene[4] = np.clip(scene[4], 0.05, 6.8)

    # cloud holes: 2-4 random NaN blobs
    nan_mask = np.zeros((size, size), bool)
    for _ in range(rng.integers(2, 5)):
        cy, cx = rng.integers(0, size, 2)
        r = int(rng.integers(size // 32, size // 12))
        dist = (yy - yy[cy, cx]) ** 2 + (xx - xx[cy, cx]) ** 2
        nan_mask |= dist < (2.0 * r / size) ** 2
    scene[:, nan_mask] = np.nan
    return scene, clean_all, nan_mask


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("outdir")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--size", type=int, default=896)
    p.add_argument("--seed", type=int, default=20260819)
    p.add_argument("--lr-outdir", default=None,
                   help="also write each scene's native-LR counterpart "
                        "(GOCI-like: GT anisotropic-PSF blur -> x factor "
                        "block mean -> LR sensor noise) here, plus the "
                        "ground-truth kernel as gt_kernel.npy")
    p.add_argument("--lr-factor", type=int, default=8)
    a = p.parse_args(argv)

    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from kmsr_tpu_torch.io import write_band_stack
    from kmsr_tpu_torch.io.schema import GROUP_GEO

    os.makedirs(a.outdir, exist_ok=True)
    kernel = None
    if a.lr_outdir:
        os.makedirs(a.lr_outdir, exist_ok=True)
        kernel = gt_lr_kernel()
        np.save(os.path.join(a.lr_outdir, "gt_kernel.npy"), kernel)
    rng = np.random.default_rng(a.seed)
    for i in range(a.n):
        scene, clean, nan_mask = make_scene(rng, a.size)
        path = os.path.join(a.outdir, f"scene_{i:02d}.nc")
        write_band_stack(path, GROUP_GEO, scene, mode="w")
        nan_pct = 100.0 * np.isnan(scene[0]).mean()
        print(f"{path}: {scene.shape} nan={nan_pct:.1f}% "
              f"nir[{np.nanmin(scene[4]):.2f},{np.nanmax(scene[4]):.2f}]")
        if a.lr_outdir:
            # separate seeded stream: the HR stream stays bit-identical
            # to rounds that generated no LR counterparts
            rng_lr = np.random.default_rng([a.seed, i, 1])
            lr = make_lr_scene(clean, nan_mask, kernel, rng_lr,
                               factor=a.lr_factor)
            lr_path = os.path.join(a.lr_outdir, f"scene_{i:02d}.nc")
            write_band_stack(lr_path, GROUP_GEO, lr, mode="w")
            print(f"  {lr_path}: {lr.shape} "
                  f"nan={100.0 * np.isnan(lr[0]).mean():.1f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
