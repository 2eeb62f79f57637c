#!/usr/bin/env python3
"""One fleet iteration stacked and at one scene a step call, on one CUDA card.

    python3 scripts/torch_fleet_ab.py [--scenes 2] [--modes chain,compose]

For each generator forward mode (chain: the fleet CLI's default; compose:
--fast-forward) this builds S scenes' train states at the default widths
(batch 16, 5x256x256 HR, 32-patch pools of N(5, 1), random real crops,
K = 1 host draws) and times `train.fleet.make_fleet_advance` with every
scene in one stacked chunk (scene_chunk S) and with one scene a chunk
(scene_chunk 1), under the deterministic algorithms the trainers use:
scene-iterations/s (median of 5 synchronized windows of 5 iterations after
one warm-up iteration), the profiler's device ms and kernel launches an
iteration of all S scenes, and peak device memory. Prints the card's
`nvidia-smi` name and power limit, then one JSON line. Needs a card; exits
2 without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

WINDOWS, WINDOW_ITERS, POOL_N = 5, 5, 32


def time_fleet(cfg, pools: list, scene_chunk: int, dev) -> dict:
    import numpy as np
    import torch

    from kmsr_tpu_torch.device import deterministic
    from kmsr_tpu_torch.train import fleet
    from kmsr_tpu_torch.utils.profiling import cuda_device_ms

    s_n = len(pools)
    states = [fleet.init_training(dataclasses.replace(cfg, seed=s), dev) for s in range(s_n)]
    pool, crop, sizes, crop_sizes = fleet.device_pools(pools, None, dev)
    chunks = [fleet._stack_states(states[c:c + scene_chunk]) for c in range(0, s_n, scene_chunk)]
    rngs = [np.random.default_rng(s) for s in range(s_n)]
    advance = fleet.make_fleet_advance(cfg, chunks, pool, crop, sizes, crop_sizes, rngs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with deterministic(dev):
        advance()
        walls = []
        for _ in range(WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(WINDOW_ITERS):
                advance()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / WINDOW_ITERS)
        traced = cuda_device_ms(advance, runs=WINDOW_ITERS, warmup=0)
    wall = sorted(walls)[WINDOWS // 2]
    return {"scenes": s_n, "scene_chunk": scene_chunk, "scene_iters_per_s": s_n / wall,
            "wall_ms_per_iter": wall * 1e3, "wall_ms_per_iter_windows": [w * 1e3 for w in walls],
            "device_ms_per_iter": traced["device_ms"],
            "kernels_per_iter": sum(traced["launches"].values()),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--modes", default="chain,compose")
    a = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_fleet_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from kmsr_tpu_torch.data.sampler import PatchPool
    from kmsr_tpu_torch.models import GeneratorConfig
    from kmsr_tpu_torch.train import SingleKernelConfig

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(0)
    pools = [PatchPool(rng.normal(5, 1, (POOL_N, 5, 256, 256)).astype(np.float32))
             for _ in range(a.scenes)]
    res = {"card": torch.cuda.get_device_name(0)}
    for mode in a.modes.split(","):
        cfg = SingleKernelConfig(verbose=False, generator=GeneratorConfig(forward_mode=mode))
        runs = {f"scene_chunk={m}": time_fleet(cfg, pools, m, dev) for m in (a.scenes, 1)}
        stacked, one = runs[f"scene_chunk={a.scenes}"], runs["scene_chunk=1"]
        runs["stacked_over_chunk_1"] = one["wall_ms_per_iter"] / stacked["wall_ms_per_iter"]
        res[mode] = runs
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
