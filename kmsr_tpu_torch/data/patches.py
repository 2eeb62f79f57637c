"""Unified patch cutter — the port's copy of `kmsr_tpu.data.patches`
(host numpy), one parameterized implementation replacing the
reference's three near-duplicate cutters (`A_00_patch_cutter_universal.py`,
`A_00Landsat_patches.py` writing to the `hr` group, and
`A_01GOCI_patch_folder.py` writing raw `.npy`).

Cutting itself is a zero-copy `sliding_window_view` + vectorized NaN-ratio
gate (the reference loops the grid in Python); the scene is cut in one
shot. Output format is a parameter: grouped `.nc` files (group name
configurable: `geophysical_data` or `hr`) or `.npy` arrays.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np

from ..io.ncio import NCFile, write_bands
from ..io.schema import BAND_NAMES, GROUP_GEO, PatchProvenance
from .mask import THRESHOLD_MAX, THRESHOLD_MIN, apply_water_mask

PATCH_SIZE = 256
STRIDE_RATIO = 0.5
NAN_THRESHOLD = 0.0


@dataclasses.dataclass(frozen=True)
class CutConfig:
    patch_size: int = PATCH_SIZE
    stride_ratio: float = STRIDE_RATIO
    nan_threshold: float = NAN_THRESHOLD
    threshold_min: float = THRESHOLD_MIN
    threshold_max: float = THRESHOLD_MAX
    apply_mask: bool = True
    output_format: str = "nc"    # "nc" | "npy"
    group: str = GROUP_GEO       # "geophysical_data" | "hr"

    @property
    def stride(self) -> int:
        return int(self.patch_size * self.stride_ratio)


@dataclasses.dataclass
class CutResult:
    total_patches: int
    kept_patches: int
    files: list


def cut_scene(
    data: np.ndarray, patch_size: int, stride: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cut [C, H, W] into the overlapping patch grid.

    Returns (patches [N, C, ps, ps] (a view when possible), grid_ij [N, 2],
    offsets_hw [N, 2]).
    """
    c, h, w = data.shape
    if h < patch_size or w < patch_size:
        return (
            np.empty((0, c, patch_size, patch_size), data.dtype),
            np.empty((0, 2), np.int64),
            np.empty((0, 2), np.int64),
        )
    windows = np.lib.stride_tricks.sliding_window_view(
        data, (patch_size, patch_size), axis=(1, 2)
    )  # [C, H-ps+1, W-ps+1, ps, ps]
    grid = windows[:, ::stride, ::stride]  # [C, hp, wp, ps, ps]
    _, hp, wp, _, _ = grid.shape
    patches = np.moveaxis(grid, 0, 2).reshape(hp * wp, c, patch_size, patch_size)
    ii, jj = np.meshgrid(np.arange(hp), np.arange(wp), indexing="ij")
    grid_ij = np.stack([ii.ravel(), jj.ravel()], axis=1)
    offsets = grid_ij * stride
    return patches, grid_ij, offsets


def nan_ratio_gate(patches: np.ndarray, nan_threshold: float) -> np.ndarray:
    """Boolean keep-mask: NaN fraction per patch must be <= threshold."""
    n = patches.shape[0]
    ratios = np.isnan(patches.reshape(n, -1)).mean(axis=1)
    return ratios <= nan_threshold


def iter_kept_patches(
    data: np.ndarray, cfg: CutConfig
) -> Iterator[tuple[np.ndarray, int, int, int, int]]:
    """Yield (patch, grid_i, grid_j, h_off, w_off) for patches passing the
    NaN gate."""
    patches, grid_ij, offsets = cut_scene(data, cfg.patch_size, cfg.stride)
    keep = nan_ratio_gate(patches, cfg.nan_threshold)
    for p, (gi, gj), (ho, wo), k in zip(patches, grid_ij, offsets, keep):
        if k:
            yield np.ascontiguousarray(p), int(gi), int(gj), int(ho), int(wo)


def cut_to_files(
    data: np.ndarray,
    output_dir: str,
    prefix: str,
    cfg: CutConfig = CutConfig(),
    nav: Optional[dict] = None,
    source_file: str = "unknown",
) -> CutResult:
    """Mask + cut a [C, H, W] scene and write kept patches to disk.

    nc format: per-patch grouped file with provenance attrs and cropped
    navigation rasters (parity: `save_patch_as_nc`,
    `A_00_patch_cutter_universal.py:200-260`). npy format: raw float32
    [C, ps, ps] (parity: `A_01GOCI_patch_folder.py:67-71`).
    """
    os.makedirs(output_dir, exist_ok=True)
    if cfg.apply_mask:
        data, _ = apply_water_mask(data, cfg.threshold_min, cfg.threshold_max)
    patches, grid_ij, offsets = cut_scene(data, cfg.patch_size, cfg.stride)
    keep = nan_ratio_gate(patches, cfg.nan_threshold)
    files = []
    for p, (gi, gj), (ho, wo), k in zip(patches, grid_ij, offsets, keep):
        if not k:
            continue
        if cfg.output_format == "npy":
            path = os.path.join(output_dir, f"{prefix}_{gi:03d}_{gj:03d}.npy")
            np.save(path, np.ascontiguousarray(p, np.float32))
        else:
            path = os.path.join(output_dir, f"{prefix}_{gi:03d}_{gj:03d}.nc")
            with NCFile(path, "w") as f:  # one write of the whole patch file
                write_bands(f, cfg.group, p)
                f.set_attrs(
                    PatchProvenance(
                        source_file=source_file,
                        grid_i=int(gi),
                        grid_j=int(gj),
                        h_offset=int(ho),
                        w_offset=int(wo),
                        patch_size=cfg.patch_size,
                    ).as_attrs()
                )
                if nav:
                    for name, raster in nav.items():
                        if raster.ndim == 2:
                            crop = raster[
                                ho : ho + cfg.patch_size, wo : wo + cfg.patch_size
                            ]
                            f.create_variable(
                                "navigation_data", name, crop, dims=("y", "x")
                            )
        files.append(path)
    return CutResult(
        total_patches=int(len(keep)), kept_patches=int(keep.sum()), files=files
    )


# -- scene grouping ----------------------------------------------------------
#
# Every stage derives its output names from the cutter's
# `<scene>_<gi:03d>_<gj:03d>` stems by appending tags (`_denoised`,
# `_blurred`, `_train`), so the originating scene of any patch file is
# recoverable from its name alone. The per-scene trainer/factory routes
# (reference workflow: one kernel PER scene — `single_kernel/train.py`
# is run once per scene) use this to regroup flat patch folders.

_STAGE_TAGS_RE = None
_GRID_RE = None


def scene_prefix(path: str) -> str:
    """Originating scene name of a patch-stage file path.

    Strips known stage tags from the end of the stem, then the cutter's
    trailing `_<gi:03d>_<gj:03d>` grid indices (3 digits each, 4 only if
    a grid index exceeds 999 — patch grids never reach 10,000 rows).
    Longer numeric tails are NOT grid indices and survive: a scene name's
    own `_2021_01` (too short) or a Landsat `_115035_20210317`
    pathrow+date tail (too long) stays part of the scene. A stem with no
    grid indices (not produced by the cutter) is returned tag-stripped,
    whole.
    """
    global _STAGE_TAGS_RE, _GRID_RE
    import re

    if _STAGE_TAGS_RE is None:
        _STAGE_TAGS_RE = re.compile(r"(_denoised|_blurred|_train)+$")
        _GRID_RE = re.compile(r"_\d{3,4}_\d{3,4}$")
    stem = os.path.splitext(os.path.basename(path))[0]
    stem = _STAGE_TAGS_RE.sub("", stem)
    return _GRID_RE.sub("", stem)


def group_by_scene(files) -> dict:
    """Sorted file list -> {scene_name: [files]} (insertion-ordered by
    first appearance, which is sorted order for a sorted input)."""
    groups: dict[str, list[str]] = {}
    for f in files:
        groups.setdefault(scene_prefix(f), []).append(f)
    return groups
