#!/usr/bin/env python3
"""Time the ring-staged v3 and scene stencil kernels under other tile plans
and without their compile-time instantiation.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/torch_stencil_sweep.py

For each kernel at its main path's shape (v3: B=128, C=5, 256x256 f32, f=8,
13x13 blur, with noise, on the CHWB, presplit and NCHW maps; scene: RAW
5x8192x8192 f32, f=8, edge halos) it launches the kernel's C ABI directly:

* with every (ti, tj) of a small grid (`kernels.stencil_tiles` /
  `kernels.scene_tiles` given ti and tj), each output checked bit for bit
  against the default plan's;
* at the default plan, from the default library (f=8, K=20 runs its
  compile-time instantiation) and from one built with
  KMSR_RING_SPECIALIZE=0 (the same shape through the run-time walk),
  alternated compile-time, run-time, run-time, compile-time, three times,
  the outputs checked bit for bit.

It prints the profiler's device time of each (`cuda_device_ms`), beside
the card's nvidia-smi name and power limit. Exits non-zero without a card
or on a mismatch.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_stencil_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.kernels import _call
    from kmsr_tpu_torch.ops.degrade import compose_with_box, normalize_kernel
    from kmsr_tpu_torch.ops.degrade_fused import phase_split_chwb
    from kmsr_tpu_torch.ops.degrade_scene_fast import halo_rows
    from kmsr_tpu_torch.utils.profiling import cuda_device_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    variants = [(name, defines) for name in ("degrade_stencil", "scene_stencil")
                for defines in ((), ("KMSR_RING_SPECIALIZE=0",))]
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc each
        paths = list(pool.map(lambda v: kernels.build(*v), variants))
    libs = {}
    for (name, defines), path in zip(variants, paths):
        lib = ctypes.CDLL(str(path))
        kernels._bind(name, lib)
        libs[name, "run-time" if defines else "compile-time"] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, c, hw, f, k = 128, 5, 256, 8, 13
    kside = k + f - 1
    comp = compose_with_box(normalize_kernel(
        torch.rand(c, k, k, generator=gen, device=dev) + 0.1), f).contiguous()
    img = torch.randn(c, hw, hw, b, generator=gen, device=dev)
    noise = torch.randn(c, hw // f, hw // f, b, generator=gen, device=dev)
    bad = 0

    def measure(label, run, out, want, default):
        """Run once, check `out` against `want` (or take it as the
        reference), print the device time; returns (want, ms)."""
        nonlocal bad
        run()
        want = out.clone() if want is None else want
        same = bool(torch.equal(out, want))
        bad += not same
        ms = cuda_device_ms(run)["device_ms"]
        print(f"{label}: {ms:.4f} ms{' (default)' if default else ''}; "
              f"bit-equal {same}", flush=True)
        return want, ms

    def ab(label, make_run, out, want):
        """The default plan from both libraries, alternated."""
        times = {"compile-time": [], "run-time": []}
        for which in ("compile-time", "run-time", "run-time", "compile-time") * 3:
            _, ms = measure(f"{label} {which} instantiation", make_run(which),
                            out, want, False)
            times[which].append(ms)
        med = {w: statistics.median(t) for w, t in times.items()}
        print(f"{label} A/B: compile-time median {med['compile-time']:.4f} ms "
              f"(range {min(times['compile-time']):.4f}-"
              f"{max(times['compile-time']):.4f}), run-time median "
              f"{med['run-time']:.4f} ms (range {min(times['run-time']):.4f}-"
              f"{max(times['run-time']):.4f}); run-time / compile-time "
              f"{med['run-time'] / med['compile-time']:.3f}", flush=True)

    inputs = {"chwb": (img, noise),
              "presplit": (phase_split_chwb(img, f).contiguous(), noise),
              "nchw": (img.permute(3, 0, 1, 2).contiguous(),
                       noise.permute(3, 0, 1, 2).contiguous())}
    for layout, (x, n) in inputs.items():
        default = kernels.stencil_tiles(layout, kside, f, hw, hw, b)
        tjs = (32,) if layout == "nchw" else (2, 4, 8)
        out = torch.empty_like(n)

        def make_run(which, p=default, x=x, n=n, out=out, layout=layout):
            lib = libs["degrade_stencil", which]

            def run():
                rc = _call(dev, lib.kmsr_degrade_stencil, x.data_ptr(), 0,
                           kernels.LAYOUTS[layout], comp.data_ptr(), n.data_ptr(),
                           out.data_ptr(), c, hw, hw, b, f, kside,
                           (kside - f) // 2, 0, *p)
                if rc:
                    raise RuntimeError(f"{layout} plan {p}: launch failed ({rc})")
            return run

        want = None
        grid = [kernels.stencil_tiles(layout, kside, f, hw, hw, b, ti=ti, tj=tj)
                for ti in (4, 8, 16, 32) for tj in tjs]
        plans = [default] + [p for p in grid if p != default]
        for p in plans:
            want, _ = measure(f"v3 {layout} (ti, tj, cols, row)={p}",
                              make_run("compile-time", p), out, want, p == default)
        ab(f"v3 {layout}", make_run, out, want)
    del img, noise, inputs

    hs = w = 8192
    x = torch.randn(c, hs, w, generator=gen, device=dev)
    th, bh = halo_rows(f, kside)
    top, bot = x[:, :1].expand(-1, th, -1), x[:, -1:].expand(-1, bh, -1)
    default = kernels.scene_tiles(kside, f, hs, w)
    out = torch.empty(c, hs // f, w // f, device=dev)

    def make_run(which, p=default):
        lib = libs["scene_stencil", which]

        def run():
            rc = _call(dev, lib.kmsr_scene_stencil, 1, x.data_ptr(), x.stride(0),
                       x.stride(1), hs, top.data_ptr(), top.stride(0),
                       top.stride(1), th, bot.data_ptr(), bot.stride(0),
                       bot.stride(1), bh, comp.data_ptr(), out.data_ptr(), c, hs,
                       w, 0, f, kside, *p)
            if rc:
                raise RuntimeError(f"scene plan {p}: launch failed ({rc})")
        return run

    want = None
    grid = [kernels.scene_tiles(kside, f, hs, w, ti=ti, tj=tj)
            for ti in (8, 16, 32, 64) for tj in (64, 128, 256)]
    plans = [default] + [p for p in grid if p != default]
    for p in plans:
        want, _ = measure(f"scene raw (ti, tj, cols, row)={p}",
                          make_run("compile-time", p), out, want, p == default)
    ab("scene raw", make_run, out, want)
    print(smi.stdout.strip(), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
