"""Host-side patch pools, batch samplers and patch file listing.

The port's own copy of `kmsr_tpu.data.sampler` (numpy only): a
`PatchPool` loads a folder ONCE into a contiguous float32 array
[N, C, H, W] and sampling a batch is pure indexing; NaN patches raise, as
the reference's loader asserts. With the same `np.random.Generator` every
sampler here returns the JAX package's arrays bit for bit.
`StreamingPatchPool` reads `.npy` patches through the native threaded
loader instead (`runtime.loader`).
"""
from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np

from ..io.ncio import read_band_stack
from ..io.schema import BAND_NAMES, GROUP_DENOISED, GROUP_GEO


class NaNPatchError(ValueError):
    """A training patch contains NaN — it should have been filtered at
    patch-cut time (reference parity: hard error, not silent skip)."""


def list_patch_files(
    patch_dir: str, pattern: str = "*.nc", host_shard: bool = True
) -> list[str]:
    """Sorted file list; under a multi-process launch each rank gets its
    own deterministic strided shard (`parallel.multihost.host_shard`;
    identity for a single process), so every file-in/file-out stage scales
    across processes with no flag."""
    files = sorted(glob.glob(os.path.join(patch_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no {pattern} files in {patch_dir}")
    if host_shard:
        from ..parallel import multihost

        if multihost.world_size() > 1:
            files = multihost.host_shard(files)
            if not files:
                raise FileNotFoundError(
                    f"rank {multihost.rank()}'s shard of {patch_dir} is empty"
                )
    return files


class PatchPool:
    """An in-memory pool of [C, H, W] patches with batch sampling."""

    def __init__(
        self,
        patches: np.ndarray,
        sources: Optional[Sequence[str]] = None,
        allow_nan: bool = False,
    ):
        patches = np.ascontiguousarray(patches, dtype=np.float32)
        if patches.ndim != 4:
            raise ValueError(f"expected [N,C,H,W], got {patches.shape}")
        nan_mask = (
            np.zeros(patches.shape[0], bool)
            if allow_nan
            else np.isnan(patches).reshape(patches.shape[0], -1).any(axis=1)
        )
        if nan_mask.any():
            idx = int(np.argmax(nan_mask))
            src = sources[idx] if sources else f"patch {idx}"
            count = int(np.isnan(patches[idx]).sum())
            raise NaNPatchError(
                f"{src} contains {count} NaN pixels "
                f"({count / patches[idx].size * 100:.2f}%); patches with NaN "
                "must be filtered at the patch-cutting stage."
            )
        self.patches = patches
        self.sources = list(sources) if sources else None

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_nc_dir(
        cls,
        patch_dir: str,
        group: str = GROUP_DENOISED,
        band_names: Sequence[str] = BAND_NAMES,
        allow_nan: bool = False,
        host_shard: bool = True,
    ) -> "PatchPool":
        """The pool of a folder's `.nc` patches: this rank's shard of them,
        or every file with host_shard=False (a data-parallel trainer's
        ranks all draw from the whole pool)."""
        files = list_patch_files(patch_dir, "*.nc", host_shard=host_shard)
        stacks = [read_band_stack(f, group, band_names) for f in files]
        return cls(np.stack(stacks, axis=0), sources=files, allow_nan=allow_nan)

    @classmethod
    def from_scene(
        cls,
        nc_path: str,
        group: str = GROUP_GEO,
        patch_size: int = 256,
        n_patches: int = 512,
        seed: int = 0,
        normalize: bool = True,
    ) -> "PatchPool":
        """KernelGAN single-image mode: build a pool by drawing
        gradient-weighted, fully-valid patches from ONE whole scene
        (parity: `trash/data_single_GOCI.py` — the reference samples fresh
        patches every iteration; a pre-drawn pool of n_patches >> batch
        keeps the same content distribution while letting the pool live in
        HBM for the scan-chunked trainer).

        normalize=False keeps radiance units (the main train path's
        convention) instead of the reference sampler's [0,1] stretch.
        """
        if normalize:
            scene, mask = load_scene_bands(nc_path, group)
        else:
            scene = read_band_stack(nc_path, group)
            mask = np.isfinite(scene).all(axis=0)
            scene = np.nan_to_num(scene, nan=0.0)
        rng = np.random.default_rng(seed)
        patches = sample_scene_patches(
            rng, scene, patch_size, n_patches, valid_mask=mask
        )
        return cls(patches, sources=[f"{nc_path}[{group}]"] * n_patches)

    @classmethod
    def from_npy_dir(cls, patch_dir: str, allow_nan: bool = False,
                     host_shard: bool = True) -> "PatchPool":
        """`from_nc_dir` for a folder of `.npy` patches."""
        files = list_patch_files(patch_dir, "*.npy", host_shard=host_shard)
        stacks = [np.load(f).astype(np.float32) for f in files]
        return cls(np.stack(stacks, axis=0), sources=files, allow_nan=allow_nan)

    @classmethod
    def from_files(
        cls,
        files: Sequence[str],
        group: str = GROUP_DENOISED,
        band_names: Sequence[str] = BAND_NAMES,
        allow_nan: bool = False,
    ) -> "PatchPool":
        """Pool from an explicit file list (mixed use: per-scene subsets of
        a flat patch dir). Format is per-file by extension (.npy / .nc)."""
        if not files:
            raise ValueError("from_files needs at least one file")
        stacks = [
            np.load(f).astype(np.float32)
            if f.endswith(".npy")
            else read_band_stack(f, group, band_names)
            for f in files
        ]
        return cls(np.stack(stacks, axis=0), sources=list(files),
                   allow_nan=allow_nan)

    # -- sampling -----------------------------------------------------------
    def __len__(self) -> int:
        return self.patches.shape[0]

    @property
    def shape(self) -> tuple:
        return self.patches.shape

    def sample(self, rng: np.random.Generator, batch_size: int) -> np.ndarray:
        """Random batch of full patches [B, C, H, W] (with replacement,
        like the reference's randint file choice)."""
        idx = rng.integers(0, len(self), size=batch_size)
        return self.patches[idx]

    def sample_crops(
        self, rng: np.random.Generator, batch_size: int, crop: int
    ) -> np.ndarray:
        """Random batch of random crops [B, C, crop, crop]."""
        _, c, h, w = self.patches.shape
        if h < crop or w < crop:
            raise ValueError(f"patch {h}x{w} smaller than crop {crop}")
        idx = rng.integers(0, len(self), size=batch_size)
        ys = rng.integers(0, h - crop + 1, size=batch_size)
        xs = rng.integers(0, w - crop + 1, size=batch_size)
        out = np.empty((batch_size, c, crop, crop), np.float32)
        for i, (j, y, x) in enumerate(zip(idx, ys, xs)):
            out[i] = self.patches[j, :, y : y + crop, x : x + crop]
        return out


class StreamingPatchPool:
    """PatchPool-compatible sampler backed by the native threaded loader
    (`runtime.loader.NativePatchLoader`) — for datasets too large to hold
    in memory. Same `sample`/`sample_crops` API as `PatchPool`.
    """

    def __init__(self, patch_dir: str, shape: tuple[int, int, int]):
        from ..runtime.loader import NativePatchLoader

        self.files = list_patch_files(patch_dir, "*.npy")
        self._loader = NativePatchLoader(self.files, shape=shape)
        self.shape_single = tuple(shape)
        self.sources = self.files

    def __len__(self) -> int:
        return len(self.files)

    @property
    def shape(self) -> tuple:
        return (len(self.files), *self.shape_single)

    def sample(self, rng: np.random.Generator, batch_size: int) -> np.ndarray:
        idx = rng.integers(0, len(self), size=batch_size).astype(np.int64)
        return self._loader.gather(idx)

    def sample_crops(
        self, rng: np.random.Generator, batch_size: int, crop: int
    ) -> np.ndarray:
        full = self.sample(rng, batch_size)
        _, h, w = self.shape_single
        ys = rng.integers(0, h - crop + 1, size=batch_size)
        xs = rng.integers(0, w - crop + 1, size=batch_size)
        out = np.empty((batch_size, self.shape_single[0], crop, crop), np.float32)
        for i, (y, x) in enumerate(zip(ys, xs)):
            out[i] = full[i, :, y : y + crop, x : x + crop]
        return out

    def prefetch(self, rng: np.random.Generator, batch_size: int) -> None:
        idx = rng.integers(0, len(self), size=batch_size).astype(np.int64)
        self._loader.prefetch(idx)

    def wait(self) -> np.ndarray:
        return self._loader.wait()


def gradient_weight_map(
    img: np.ndarray,
    valid_mask: Optional[np.ndarray] = None,
    eps: float = 1e-6,
) -> np.ndarray:
    """Gradient-magnitude sampling-probability map over a scene.

    Parity: `trash/data_single_GOCI.py:69-105` (KernelGAN-style
    gradient-weighted patch sampling) — high-gradient regions get higher
    sampling probability; invalid (NaN) regions get zero.

    img: [C, H, W]; valid_mask: [H, W] bool. Returns [H, W] probabilities
    summing to 1.
    """
    # the reference's loader fills invalid pixels with 0 before gradients
    # (`trash/data_single_GOCI.py:60`); mirror that so holes don't NaN-poison
    # neighbouring weights (hole-adjacent windows are excluded separately)
    img = np.nan_to_num(np.asarray(img, np.float32), nan=0.0)
    gx = np.pad(np.diff(img, axis=2), ((0, 0), (0, 0), (0, 1)))
    gy = np.pad(np.diff(img, axis=1), ((0, 0), (0, 1), (0, 0)))
    p = np.sqrt(gx**2 + gy**2 + eps).mean(axis=0)
    if valid_mask is not None:
        p = p * valid_mask.astype(np.float32)
    p = p - p.min()
    s = p.sum()
    if s <= 0:
        if valid_mask is not None and valid_mask.any():
            p = valid_mask.astype(np.float32)
            return p / p.sum()
        return np.full(p.shape, 1.0 / p.size, np.float32)
    return p / s


def _valid_window_map(valid_mask: np.ndarray, patch_size: int) -> np.ndarray:
    """[H-ps+1, W-ps+1] bool: True where the patch_size window anchored at
    that top-left corner contains only valid pixels. Computed with an
    integral image — O(HW) instead of the reference's per-patch
    rejection-resampling loop (`trash/data_single_GOCI.py:147-166`)."""
    ii = np.pad(
        valid_mask.astype(np.int64).cumsum(axis=0).cumsum(axis=1),
        ((1, 0), (1, 0)),
    )
    ps = patch_size
    win = ii[ps:, ps:] - ii[:-ps, ps:] - ii[ps:, :-ps] + ii[:-ps, :-ps]
    return win == ps * ps


def sample_scene_patches(
    rng: np.random.Generator,
    img: np.ndarray,
    patch_size: int,
    batch_size: int,
    valid_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Gradient-weighted random patches from one whole scene, guaranteed
    all-valid (parity: `trash/data_single_GOCI.py:108-170`).

    The reference samples a center then rejects/resamples up to 1000 times
    if the patch touches an invalid pixel; here the set of fully-valid
    windows is precomputed once (integral image) so every draw succeeds —
    same distribution restricted to valid windows, no retry loop.

    img: [C, H, W]; returns [B, C, patch_size, patch_size].
    """
    img = np.asarray(img, np.float32)
    c, h, w = img.shape
    if h < patch_size or w < patch_size:
        raise ValueError(f"scene {h}x{w} smaller than patch {patch_size}")
    if valid_mask is None:
        valid_mask = np.isfinite(img).all(axis=0)
    weights = gradient_weight_map(img, valid_mask)
    ok = _valid_window_map(valid_mask, patch_size)
    pad = patch_size // 2
    # weight of a window = gradient weight at its center pixel, matching the
    # reference's center-pixel multinomial draw
    center_w = weights[pad : pad + ok.shape[0], pad : pad + ok.shape[1]]
    grid = np.where(ok, center_w, 0.0).ravel().astype(np.float64)
    s = grid.sum()
    if s <= 0:
        raise ValueError(
            "no fully-valid patch positions to sample from — check that the "
            f"valid region is at least {patch_size}x{patch_size}"
        )
    idx = rng.choice(grid.size, size=batch_size, replace=True, p=grid / s)
    ys, xs = np.divmod(idx, ok.shape[1])
    out = np.empty((batch_size, c, patch_size, patch_size), np.float32)
    for i, (y, x) in enumerate(zip(ys, xs)):
        out[i] = img[:, y : y + patch_size, x : x + patch_size]
    return out


def load_scene_bands(
    nc_path: str,
    group: str = GROUP_GEO,
    band_names: Sequence[str] = BAND_NAMES,
    lo_percentile: float = 0.01,
    hi_percentile: float = 99.99,
) -> tuple[np.ndarray, np.ndarray]:
    """Whole-scene loader with per-band percentile normalization to [0, 1]
    (parity: `trash/data_single_GOCI.py:13-66`). Returns
    (image [C,H,W] float32 in [0,1], valid_mask [H,W] bool)."""
    stack = read_band_stack(nc_path, group, band_names)
    valid = np.isfinite(stack).all(axis=0)
    out = np.zeros_like(stack, np.float32)
    for ci in range(stack.shape[0]):
        vals = stack[ci][valid]
        if vals.size:
            vmin, vmax = np.percentile(vals, [lo_percentile, hi_percentile])
            if vmax <= vmin:
                vmax = vmin + 1.0
            out[ci] = np.clip((stack[ci] - vmin) / (vmax - vmin), 0.0, 1.0)
    out[:, ~valid] = 0.0
    return out, valid


def synthetic_pool(
    rng: np.random.Generator,
    n: int = 32,
    c: int = 5,
    size: int = 256,
    blur_sigma: float | None = 1.5,
) -> PatchPool:
    """Synthetic Landsat-like patches for tests/benchmarks: smooth random
    fields with positive radiance-scale values."""
    base = rng.normal(5.0, 2.0, size=(n, c, size, size)).astype(np.float32)
    if blur_sigma:
        # cheap separable smoothing to give images spatial structure
        k = int(3 * blur_sigma) | 1
        xs = np.arange(k) - k // 2
        g = np.exp(-(xs**2) / (2 * blur_sigma**2)).astype(np.float32)
        g /= g.sum()
        base = np.apply_along_axis(
            lambda m: np.convolve(m, g, mode="same"), 2, base
        )
        base = np.apply_along_axis(
            lambda m: np.convolve(m, g, mode="same"), 3, base
        )
    return PatchPool(base.astype(np.float32))
