#!/usr/bin/env python3
"""Time the whole-scene path of one checkout of the port, stage by stage.

Run on a machine with one NVIDIA GPU, once per checkout to compare, in
alternating order (for example parent, change, change, parent):

    python3 scripts/torch_scene_ab.py --repo DIR --label parent --runs 5

It imports `kmsr_tpu_torch` from DIR (default: the checkout holding this
script), makes the seeded 5x8192x8192 float32 host scene `chip_smoke.py`
degrades (NaN cells included), calls `degrade_scene_file(scene, kernel, 8,
n_shards=1)` once untimed (kernel build, warm-up) and then `--runs` times,
and prints for each run its wall, Mpix/s and stage times (`scene.h2d`,
`scene.kernel`, `scene.d2h`), then one JSON line of them all, beside the
card's nvidia-smi name and power limit. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_scene_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from kmsr_tpu_torch.pipeline.degrade_scene import degrade_scene_file
    from kmsr_tpu_torch.utils.profiling import timing_report

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    c, hw, k, factor = 5, 8192, 13, 8
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    scene = (torch.randn(c, hw, hw, generator=gen, device=dev) * 2 + 5).cpu().numpy()
    scene[:, :64, :64] = float("nan")
    scene[:, 64:67, 1000:2000] = float("nan")
    scene[1:3, -45:, -70:] = float("nan")
    kernel = (torch.rand(c, k, k, generator=gen, device=dev) * 0.9 + 0.1)
    degrade_scene_file(scene, kernel, factor, n_shards=1)
    runs = []
    for _ in range(args.runs):
        timing_report(reset=True)
        t0 = time.perf_counter()
        degrade_scene_file(scene, kernel, factor, n_shards=1)
        wall = time.perf_counter() - t0
        stages = {s: v["total_s"] for s, v in timing_report(reset=True).items()}
        runs.append({"wall_s": wall, "mpix_per_s": hw * hw / 1e6 / wall,
                     **stages})
        print(f"[{args.label}] wall {wall:.4f} s = {hw * hw / 1e6 / wall:.1f} "
              f"Mpix/s; h2d {stages.get('scene.h2d', 0):.4f} s, kernel "
              f"{stages.get('scene.kernel', 0):.4f} s, d2h "
              f"{stages.get('scene.d2h', 0):.4f} s", flush=True)
    print(json.dumps({"label": args.label, "repo": args.repo, "card": smi,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
