"""Empirical noise pool: residuals between raw and denoised imagery.

The port's copy of `kmsr_tpu.data.noise_pool`. Parity with
`D_build_noise_pool.py:56-132`: per file noise = geophysical_data -
denoised, `samples_per_file` random crop_size^2 crops, stacked into an
[N, 5, cs, cs] float32 pool saved as .npy with a metadata sidecar, seeded,
with per-band noise statistics reported. Building is host numpy drawing
the same `default_rng(seed)` stream in the same order as the JAX package,
so one folder gives a bit-identical pool and metadata in either package.
Injection parity with `E_make_train_data.py:65-74` (add one random pool
entry), and the pool contract [N, C, h, w] float32 that
`make_train_data.py:60-62` enforces.

`noise_crops` is the per-file body on arrays (noise = raw - denoised, then
the crops), so a pool can be built from in-memory stacks without files;
`sample_noise_device` draws pool entries from a device-resident pool with
a `torch.Generator` (a different stream from JAX's `jax.random` by
design, as the port's other device draws are).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..io.ncio import read_band_stack
from ..io.schema import BAND_NAMES, GROUP_DENOISED, GROUP_GEO
from .sampler import list_patch_files


@dataclasses.dataclass
class NoisePoolResult:
    pool: np.ndarray           # [N, C, cs, cs]
    metadata: list
    failures: list


def validate_noise_pool(pool: np.ndarray) -> np.ndarray:
    """The pool as float32, after checking it is [N, C, h, w] with N >= 1."""
    pool = np.asarray(pool, np.float32)
    if pool.ndim != 4:
        raise ValueError(f"noise pool must be [N,C,h,w], got {pool.shape}")
    if pool.shape[0] < 1:
        raise ValueError("noise pool is empty")
    return pool


def load_noise_pool(path: str) -> np.ndarray:
    """Load and validate a noise pool `.npy` ([N, C, h, w])."""
    return validate_noise_pool(np.load(path))


def random_crops_np(
    rng: np.random.Generator, data: np.ndarray, crop: int, n: int
) -> list[np.ndarray]:
    _, h, w = data.shape
    if h < crop or w < crop:
        raise ValueError(f"image {h}x{w} smaller than crop {crop}")
    out = []
    for _ in range(n):
        top = rng.integers(0, h - crop + 1)
        left = rng.integers(0, w - crop + 1)
        out.append(data[:, top : top + crop, left : left + crop])
    return out


def noise_crops(
    rng: np.random.Generator, raw: np.ndarray, den: np.ndarray, crop: int, n: int
) -> list[np.ndarray]:
    """One file's pool entries: `n` random crop^2 crops of raw - den."""
    return random_crops_np(rng, raw - den, crop, n)


def build_noise_pool(
    input_dir: str,
    output_file: Optional[str] = None,
    metadata_file: Optional[str] = None,
    samples_per_file: int = 1,
    crop_size: int = 32,
    seed: int = 42,
    raw_group: str = GROUP_GEO,
    denoised_group: str = GROUP_DENOISED,
    band_names: Sequence[str] = BAND_NAMES,
    verbose: bool = True,
) -> NoisePoolResult:
    """Build the noise pool from a folder of denoised patch files."""
    rng = np.random.default_rng(seed)
    files = list_patch_files(input_dir, "*.nc")
    crops: list[np.ndarray] = []
    metadata: list = []
    failures: list = []
    for path in files:
        try:
            raw = read_band_stack(path, raw_group, band_names)
            den = read_band_stack(path, denoised_group, band_names)
            for i, c in enumerate(noise_crops(rng, raw, den, crop_size, samples_per_file)):
                crops.append(c)
                metadata.append(
                    {
                        "source_file": os.path.basename(path),
                        "patch_id": i,
                        "patch_size": crop_size,
                    }
                )
        except Exception as e:  # per-file failure isolation (reference parity)
            failures.append((path, str(e)))
            continue
    if not crops:
        raise RuntimeError(f"no noise crops extracted from {input_dir}")
    pool = np.stack(crops, axis=0).astype(np.float32)
    if output_file:
        os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
        np.save(output_file, pool)
    if metadata_file:
        os.makedirs(os.path.dirname(metadata_file) or ".", exist_ok=True)
        np.save(metadata_file, np.array(metadata, dtype=object), allow_pickle=True)
    if verbose:
        print(f"noise pool: {pool.shape} from {len(files)} files, {len(failures)} failures")
        for i, b in enumerate(band_names):
            bn = pool[:, i]
            print(
                f"  {b:12s}: mean={np.nanmean(bn):+.6f} std={np.nanstd(bn):.6f} "
                f"min={np.nanmin(bn):+.6f} max={np.nanmax(bn):+.6f}"
            )
    return NoisePoolResult(pool=pool, metadata=metadata, failures=failures)


def noise_pool_stats(pool: np.ndarray, band_names: Sequence[str] = BAND_NAMES) -> dict:
    return {
        b: {
            "mean": float(np.nanmean(pool[:, i])),
            "std": float(np.nanstd(pool[:, i])),
            "min": float(np.nanmin(pool[:, i])),
            "max": float(np.nanmax(pool[:, i])),
        }
        for i, b in enumerate(band_names)
    }


def add_noise_np(
    rng: np.random.Generator, blurred: np.ndarray, pool: np.ndarray
) -> np.ndarray:
    """lr = blurred + one random pool entry (`E_make_train_data.py:65-74`)."""
    idx = rng.integers(0, pool.shape[0])
    return blurred + pool[idx]


def sample_noise_device(
    gen: torch.Generator, pool: torch.Tensor, batch: int
) -> torch.Tensor:
    """Draw `batch` noise crops from a device-resident pool [N, C, h, w]
    (gen lives on the pool's device)."""
    idx = torch.randint(0, pool.shape[0], (batch,), generator=gen, device=pool.device)
    return pool.index_select(0, idx)
