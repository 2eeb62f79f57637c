"""Stage: per-band radiance statistics over a patch folder.

Counterpart of `kmsr_tpu.pipeline.data_stats` (host numpy over the port's
`data.sampler.PatchPool`; the JSON it prints is the same). Parity with
`data_mean_std.py:5-62`: used to derive per-band target noise sigmas for
the dynamic degradation model's regularizer.

Usage:
    python -m kmsr_tpu_torch.pipeline.data_stats --input-dir DIR \\
        [--format npy|nc] [--group geophysical_data]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.sampler import PatchPool
from ..io.schema import BAND_NAMES, GROUP_GEO


def analyze_radiance_stats(pool: PatchPool) -> dict:
    stats = {}
    for i, b in enumerate(BAND_NAMES):
        band = pool.patches[:, i]
        stats[b] = {
            "mean": float(np.nanmean(band)),
            "std": float(np.nanstd(band)),
            "min": float(np.nanmin(band)),
            "max": float(np.nanmax(band)),
        }
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Per-band radiance mean/std")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--format", choices=["npy", "nc"], default="npy")
    p.add_argument("--group", default=GROUP_GEO)
    a = p.parse_args(argv)
    if a.format == "npy":
        pool = PatchPool.from_npy_dir(a.input_dir, allow_nan=True)
    else:
        pool = PatchPool.from_nc_dir(a.input_dir, group=a.group, allow_nan=True)
    stats = analyze_radiance_stats(pool)
    print(json.dumps(stats, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
