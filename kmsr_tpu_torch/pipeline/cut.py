"""Stage: universal patch cutter (folder runner + CLI).

The port's copy of `kmsr_tpu.pipeline.cut`: the same flags, file names,
groups, attrs and arrays. It does no device work, so it takes no
`--device`.

File contract parity with `A_00_patch_cutter_universal.py:319-431` /
`A_00Landsat_patches.py` / `A_01GOCI_patch_folder.py`, unified behind one
CLI: read each scene .nc (geophysical_data + navigation_data), NIR water
mask, grid-cut with overlap, NaN gate, write per-patch .nc (group
`geophysical_data` or `hr`) or .npy.

Usage:
    python -m kmsr_tpu_torch.pipeline.cut --input-dir SCENES --output-dir PATCHES \
        [--patch-size 256] [--stride-ratio 0.5] [--nan-threshold 0.0] \
        [--threshold-min 1e-6] [--threshold-max 7.0] [--format nc|npy] \
        [--group geophysical_data|hr]
"""
from __future__ import annotations

import argparse
import os

from ..data.patches import CutConfig, cut_to_files
from ..data.sampler import list_patch_files
from ..io.ncio import read_band_stack, read_nav
from ..io.schema import GROUP_GEO
from .common import RunReport, run_per_file


def process_scene(nc_path: str, output_dir: str, cfg: CutConfig) -> int:
    data = read_band_stack(nc_path, GROUP_GEO, fill_to_nan=True)
    nav = read_nav(nc_path)
    prefix = os.path.splitext(os.path.basename(nc_path))[0]
    result = cut_to_files(
        data,
        output_dir,
        prefix,
        cfg,
        nav=nav or None,
        source_file=os.path.basename(nc_path),
    )
    return result.kept_patches


def process_folder(
    input_dir: str, output_dir: str, cfg: CutConfig = CutConfig(), progress: bool = True
) -> RunReport:
    files = list_patch_files(input_dir, "*.nc")
    counts = {}

    def one(path):
        counts[path] = process_scene(path, output_dir, cfg)

    report = run_per_file(files, one, desc="cutting", progress=progress)
    total = sum(counts.values())
    print(f"cut: {report.summary()}; kept {total} patches -> {output_dir}")
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Universal patch cutter")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--patch-size", type=int, default=256)
    p.add_argument("--stride-ratio", type=float, default=0.5)
    p.add_argument("--nan-threshold", type=float, default=0.0)
    p.add_argument("--threshold-min", type=float, default=1e-6)
    p.add_argument("--threshold-max", type=float, default=7.0)
    p.add_argument("--no-mask", action="store_true", help="skip the NIR water mask")
    p.add_argument("--format", choices=["nc", "npy"], default="nc")
    p.add_argument("--group", default="geophysical_data", choices=["geophysical_data", "hr"])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = CutConfig(
        patch_size=args.patch_size,
        stride_ratio=args.stride_ratio,
        nan_threshold=args.nan_threshold,
        threshold_min=args.threshold_min,
        threshold_max=args.threshold_max,
        apply_mask=not args.no_mask,
        output_format=args.format,
        group=args.group,
    )
    report = process_folder(args.input_dir, args.output_dir, cfg)
    return 0 if report.n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
