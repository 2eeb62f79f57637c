#!/usr/bin/env python3
"""Where the banded v4 kernel's time goes, on one NVIDIA GPU.

Builds stripped-down copies of `kmsr_tpu_torch/kernels/degrade_dense.cu`
(the stencil-matrix window's generation, the x staging or the tensor-core
product left out) and times each with torch.profiler (CUPTI kernel
durations) at the x2 factory's 48x48 shape: B=128, C=5, f=2, 13x13 blur,
NCHW, with noise. The copies compute nothing useful; only their times are
read. Run from the repository root on a machine with a card:

    python3 scripts/torch_dense_breakdown.py

Prints one line per variant, the card's nvidia-smi line and one JSON line
{"dense_breakdown_us": {...}}.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: each cut: (anchor line in the source, what it skips)
CUTS = {
    "SKIP_STAGING": "  auto load_stage = [&](int buf, int q0, int bt0) {\n",
    "SKIP_WINDOW": "  auto build_window = [&](int k0) {\n",
    "SKIP_PRODUCT": "        const T* s = sX + (ks % kStages) * S::SIZE;\n",
}
VARIANTS = {
    "full": (),
    "no window generation": ("SKIP_WINDOW",),
    "no x staging": ("SKIP_STAGING",),
    "no product": ("SKIP_PRODUCT",),
    "staging only": ("SKIP_WINDOW", "SKIP_PRODUCT"),
    "none (launch, epilogue)": ("SKIP_WINDOW", "SKIP_PRODUCT", "SKIP_STAGING"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.ops import degrade_fused as df

    src = open(kernels._DIR / "degrade_dense.cu").read()
    for macro, anchor in CUTS.items():
        assert src.count(anchor) == 1, f"anchor for {macro} not found"
        skip = "continue" if macro == "SKIP_PRODUCT" else "return"
        src = src.replace(anchor, f"{anchor}#ifdef {macro}\n    {skip};\n#endif\n")
    build = kernels._BUILD_DIR / "breakdown"
    build.mkdir(parents=True, exist_ok=True)
    (build / "dense.cu").write_text(src)

    def compile_one(item):
        name, macros = item
        so = build / f"dense_{len(macros)}_{'_'.join(macros) or 'full'}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *(f"-D{m}" for m in macros),
               "-o", str(so), str(build / "dense.cu")]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr[-3000:]}")
        return name, so

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(compile_one, VARIANTS.items()))

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    b, c, hw, f, k = 128, 5, 48, 2, 13
    img = (torch.randn(b, c, hw, hw, generator=gen) * 2 + 5).to(dev)
    kernel = (torch.rand(c, k, k, generator=gen) * 0.9 + 0.1).to(dev)
    noise = (torch.randn(b, c, hw // f, hw // f, generator=gen) * 0.1).to(dev)
    comp = df._composed(kernel, f, c, dev)
    out = torch.empty_like(noise)
    ksize = comp.shape[-1]
    tn, tiles, max_band = kernels._dense_plan(ksize, f, hw, hw, dev)
    kd, m = hw * hw, (hw // f) ** 2
    result = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        kernels._bind("degrade_dense", lib)

        def launch():
            rc = kernels._call(
                dev, lib.kmsr_degrade_dense, img.data_ptr(), 0, comp.data_ptr(),
                tiles.data_ptr(), tiles.shape[0], max_band, tn, noise.data_ptr(),
                out.data_ptr(), c, hw, hw, b, f, ksize, kd, 1, c * kd, m, 1, c * m)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        for _ in range(5):
            launch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(30):
                launch()
            torch.cuda.synchronize()
        us = [getattr(e, "device_time_total", 0) / e.count
              for e in prof.key_averages() if "degrade_band" in e.key]
        result[name] = us[0]
        print(f"[breakdown] {name}: {us[0]:.2f} us a launch (profiler, 30 launches)",
              flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"dense_breakdown_us": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
