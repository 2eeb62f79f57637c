"""Stage: build the empirical noise pool (CLI).

The port's copy of `kmsr_tpu.pipeline.noise_pool_cli`: the same flags
(parity with `D_build_noise_pool.py:135-158`), the same pool and
metadata, and rc 1 when any file failed. Host numpy only, so it takes no
`--device`.

Usage:
    python -m kmsr_tpu_torch.pipeline.noise_pool_cli --input-dir DENOISED \
        --output-file pool.npy [--metadata-file meta.npy] \
        [--samples-per-file 1] [--patch-size 32] [--seed 42]
"""
from __future__ import annotations

import argparse

from ..data.noise_pool import build_noise_pool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Build empirical noise pool")
    p.add_argument("--input-dir", required=True, help="denoised patch dir")
    p.add_argument("--output-file", required=True)
    p.add_argument("--metadata-file", default=None)
    p.add_argument("--samples-per-file", type=int, default=1)
    p.add_argument("--patch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=42)
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    result = build_noise_pool(
        a.input_dir,
        output_file=a.output_file,
        metadata_file=a.metadata_file,
        samples_per_file=a.samples_per_file,
        crop_size=a.patch_size,
        seed=a.seed,
    )
    return 0 if not result.failures else 1


if __name__ == "__main__":
    raise SystemExit(main())
