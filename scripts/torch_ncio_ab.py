#!/usr/bin/env python3
"""Time the port's `.nc` writes through one handle against the same files
written the JAX package's way (several handles), in alternation.

Two write patterns, each on seeded data at the factory's width:
  * a factory sample `<name>_train.nc` (hr 5x256^2, lr 5x32^2, lat/lon
    256^2): `make_train_data.save_training_sample` (one handle) against
    `write_band_stack("w")` + `write_band_stack("a")` + `NCFile("a")` for
    the nav rasters, the three opens JAX's `save_training_sample` makes;
  * an append-a-group stage's output (denoise, sr_infer, apply_kernel,
    degrade_scene, sr_scene): `ncio.copied` + `write_bands` (one write)
    against `copy_file_with_groups` + `write_band_stack(mode="a")`.
The port's codec writes a whole file on every close ("a" rewrites it:
h5py appends in place), so each extra handle costs a rewrite of the file.
Also times reading a sample back (hr, lr, nav). Prints one JSON line.

    python3 scripts/torch_ncio_ab.py [--files 16] [--rounds 3]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kmsr_tpu_torch.io.ncio import (  # noqa: E402
    NCFile, copied, copy_file_with_groups, read_band_stack, read_nav,
    write_band_stack, write_bands,
)
from kmsr_tpu_torch.pipeline.make_train_data import save_training_sample  # noqa: E402


def three_handles(path, hr, lr, nav):
    """The JAX package's save_training_sample: three opens of one file."""
    write_band_stack(path, "hr", hr, dims=("y_hr", "x_hr"), mode="w")
    write_band_stack(path, "lr", lr, dims=("y_lr", "x_lr"), mode="a")
    with NCFile(path, "a") as f:
        for name, arr in nav.items():
            dims = tuple(f"{name}_dim_{j}" for j in range(arr.ndim))
            f.create_variable("navigation_data", name, arr, dims=dims)


def copy_then_append(src, dst, stack):
    copy_file_with_groups(src, dst)
    write_band_stack(dst, "denoised", stack, mode="a")


def one_copy(src, dst, stack):
    with copied(src, dst) as f:
        write_bands(f, "denoised", stack)


def timed(fn, n: int) -> float:
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    return (time.perf_counter() - t0) / n * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--files", type=int, default=16)
    p.add_argument("--rounds", type=int, default=3)
    a = p.parse_args(argv)
    rng = np.random.default_rng(0)
    hr = rng.uniform(0.5, 5.0, (a.files, 5, 256, 256)).astype(np.float32)
    lr = rng.normal(5.0, 1.0, (a.files, 5, 32, 32)).astype(np.float32)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32) / 256
    nav = {"latitude": 30 + yy, "longitude": 120 + xx}
    tmp = tempfile.mkdtemp(prefix="kmsr_ncio_ab_")
    try:
        src = os.path.join(tmp, "patch.nc")
        with NCFile(src, "w") as f:
            write_bands(f, "geophysical_data", hr[0])
            for name, arr in nav.items():
                f.create_variable("navigation_data", name, arr, dims=("y", "x"))

        def path(kind, i):
            return os.path.join(tmp, f"{kind}_{i}.nc")

        rows = {k: [] for k in ("sample_one_handle", "sample_three_handles",
                                "append_copied", "append_copy_then_a", "sample_read")}
        for _ in range(a.rounds):  # alternate: one, three, three, one
            for kind in ("one", "three", "three", "one"):
                if kind == "one":
                    rows["sample_one_handle"].append(timed(
                        lambda i: save_training_sample(path("s1", i), hr[i], lr[i], nav), a.files))
                    rows["append_copied"].append(timed(
                        lambda i: one_copy(src, path("c1", i), hr[i]), a.files))
                else:
                    rows["sample_three_handles"].append(timed(
                        lambda i: three_handles(path("s3", i), hr[i], lr[i], nav), a.files))
                    rows["append_copy_then_a"].append(timed(
                        lambda i: copy_then_append(src, path("c3", i), hr[i]), a.files))
            rows["sample_read"].append(timed(
                lambda i: (read_band_stack(path("s1", i), "hr"),
                           read_band_stack(path("s1", i), "lr"), read_nav(path("s1", i))),
                a.files))
        payload = (hr[0].nbytes + lr[0].nbytes + 2 * nav["latitude"].nbytes) / 1e6
        out = {k: {"median_ms": float(np.median(v)), "runs_ms": v} for k, v in rows.items()}
        out["sample_payload_mb"] = payload
        out["sample_file_mb"] = os.path.getsize(path("s1", 0)) / 1e6
        out["write_mb_s"] = payload / out["sample_one_handle"]["median_ms"] * 1e3
        out["read_mb_s"] = payload / out["sample_read"]["median_ms"] * 1e3
        out["files"], out["rounds"] = a.files, a.rounds
        print(json.dumps({"ncio_ab": out}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
