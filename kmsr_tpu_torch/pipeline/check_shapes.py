"""Stage: dataset validation gate — every file must carry a complete,
correctly-shaped degraded group. The port's copy of
`kmsr_tpu.pipeline.check_shapes`, with the same flags and rc.

Parity with `check_blurred_shapes.py:20-74`: each .nc must have the target
group, all 5 bands present, each exactly size x size; prints a pass/fail
summary and exits nonzero on any failure.

Usage:
    python -m kmsr_tpu_torch.pipeline.check_shapes --input-dir DIR \
        [--group blurred] [--size 32]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.sampler import list_patch_files
from ..io.ncio import NCFile
from ..io.schema import BAND_NAMES, GROUP_BLURRED


def check_file(path: str, group: str, size: int) -> list[str]:
    """Return a list of problems (empty = OK)."""
    problems = []
    with NCFile(path, "r") as f:
        if not f.has_group(group):
            return [f"missing group '{group}'"]
        grp = f.group(group)
        for b in BAND_NAMES:
            if b not in grp:
                problems.append(f"missing band {b}")
                continue
            shape = tuple(np.asarray(grp[b]).shape)
            if shape != (size, size):
                problems.append(f"{b}: shape {shape} != ({size},{size})")
    return problems


def check_folder(input_dir: str, group: str = GROUP_BLURRED, size: int = 32) -> dict:
    files = list_patch_files(input_dir, "*.nc")
    ok, bad = [], {}
    for path in files:
        try:
            problems = check_file(path, group, size)
        except Exception as e:
            problems = [f"unreadable: {e}"]
        if problems:
            bad[path] = problems
        else:
            ok.append(path)
    print(f"check_shapes[{group}/{size}x{size}]: {len(ok)} pass, {len(bad)} fail")
    for path, problems in bad.items():
        print(f"  FAIL {path}: {'; '.join(problems)}")
    return {"ok": ok, "bad": bad}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Validate degraded-group shapes")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--group", default=GROUP_BLURRED)
    p.add_argument("--size", type=int, default=32)
    a = p.parse_args(argv)
    result = check_folder(a.input_dir, a.group, a.size)
    return 0 if not result["bad"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
