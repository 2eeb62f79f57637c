"""Stage: Landsat TOA calibration over scene directories (CLI).

The port's copy of `kmsr_tpu.pipeline.calibrate_landsat` (host numpy, no
device).

Batch driver parity with `A_00Landsat_cal_rad.py:195-209`: glob LC08/LC09
scene directories under a root and calibrate each.

Usage:
    python -m kmsr_tpu_torch.pipeline.calibrate_landsat --root DIR --out-dir OUT \
        [--bands 1 2 3 4 5] [--mode rad|ref]
"""
from __future__ import annotations

import argparse
import glob
import os

from ..io.landsat import calc_landsat_toa
from .common import run_per_file


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Landsat C2 L1 -> TOA NetCDF")
    p.add_argument("--root", required=True,
                   help="one scene dir, or a parent containing LC0[89]* dirs")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--bands", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    p.add_argument("--mode", choices=["rad", "ref"], default="rad")
    a = p.parse_args(argv)

    scene_dirs = [d for d in glob.glob(os.path.join(a.root, "LC0[89]*")) if os.path.isdir(d)]
    if not scene_dirs:
        scene_dirs = [a.root]
    print(f"found {len(scene_dirs)} Landsat scene dir(s)")

    def one(scene):
        out = calc_landsat_toa(scene, a.bands, mode=a.mode, out_dir=a.out_dir)
        print(f"  {os.path.basename(scene)} -> {out}")

    report = run_per_file(scene_dirs, one, desc="calibrating")
    print(f"calibrate_landsat: {report.summary()}")
    return 0 if report.n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
