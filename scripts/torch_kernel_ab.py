#!/usr/bin/env python3
"""Device times of the v3 and scene stencil kernels of one checkout of the
port, at the x8 shape and at x4.

Run on a machine with one NVIDIA GPU, once per checkout to compare, in
alternating order (for example parent, change, change, parent):

    python3 scripts/torch_kernel_ab.py --repo DIR --label parent

It imports `kmsr_tpu_torch` from DIR (default: the checkout holding this
script) and times, with the profiler's device time (`cuda_device_ms`),
each public entry point on seeded inputs: `degrade_fused` (NCHW),
`degrade_fused_chwb` and `degrade_fused_presplit` at B=128, C=5, 256x256
float32 with noise, and `degrade_rows_fast` on a 5x8192x8192 float32 scene
with edge halos, each at f=8 and f=4 with a 13x13 blur (K=20 and K=16).
Prints one line each and a JSON line of them all, beside the card's
nvidia-smi name and power limit. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from kmsr_tpu_torch.ops.degrade import compose_with_box, normalize_kernel
    from kmsr_tpu_torch.ops.degrade_fused import (
        degrade_fused, degrade_fused_chwb, degrade_fused_presplit, phase_split_chwb,
    )
    from kmsr_tpu_torch.ops.degrade_scene_fast import degrade_rows_fast, halo_rows
    from kmsr_tpu_torch.utils.profiling import cuda_device_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, c, hw, k = 128, 5, 256, 13
    img = torch.randn(c, hw, hw, b, generator=gen, device=dev) * 2 + 5
    kernel = torch.rand(c, k, k, generator=gen, device=dev) * 0.9 + 0.1
    scene = torch.randn(c, 8192, 8192, generator=gen, device=dev) * 2 + 5
    times = {}
    for f in (8, 4):
        noise = torch.randn(c, hw // f, hw // f, b, generator=gen, device=dev) * 0.1
        nchw, n_nchw = img.permute(3, 0, 1, 2).contiguous(), noise.permute(3, 0, 1, 2).contiguous()
        split = phase_split_chwb(img, f).contiguous()
        comp = compose_with_box(normalize_kernel(kernel), f).contiguous()
        th, bh = halo_rows(f, comp.shape[-1])
        top, bot = scene[:, :1].expand(-1, th, -1), scene[:, -1:].expand(-1, bh, -1)
        for name, fn in (
            ("v3 nchw", lambda: degrade_fused(nchw, kernel, n_nchw, factor=f)),
            ("v3 chwb", lambda: degrade_fused_chwb(img, kernel, noise, factor=f)),
            ("v3psn presplit", lambda: degrade_fused_presplit(split, kernel, noise,
                                                              factor=f)),
            ("colsplit_raw scene", lambda: degrade_rows_fast(scene, comp, f, top, bot)),
        ):
            d = cuda_device_ms(fn)
            # the stencil kernel's own time (the entry point may launch others)
            ms = max(d["kernels"].values())
            times[f"{name} f={f}"] = ms
            print(f"[{args.label}] {name} f={f} K={k + f - 1}: {ms:.4f} ms "
                  f"(all kernels {d['device_ms']:.4f} ms)", flush=True)
    print(json.dumps({"label": args.label, "repo": args.repo, "card": smi,
                      "device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
