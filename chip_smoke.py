#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`kmsr_tpu_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

It needs one CUDA device, nvcc (CUDA_HOME or /usr/local/cuda) and g++,
and exits non-zero without them. Phases, one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels (nvcc, sm_90a, one process per source) and the
   native patch loader (g++) from this checkout's sources, in parallel;
3. kernels: every instantiation of the fused degrade stencil (NCHW and
   CHWB for the v3 kernel, halo-free presplit for v3psn; with and without
   noise; f=8 span 20 and f=4 span 16; float32, plus bfloat16 storage at
   f=8) against its plain PyTorch version on the card at the factory's
   full width (B=128, C=5, 256x256, 13x13 blur), bit for bit in float32
   (`bit_equal`) and within rtol 1e-4 / atol 1e-5 in bfloat16; and
   against the grouped strided F.conv2d route (TF32 off) at the tolerance;
   then the wide-span kernels the same way, with and without noise,
   float32 and bfloat16 storage: v1 (CHWB) and v2 (CHWB; NCHW where
   auto-selection picks it) at f=2 (span 14) and f=8, the baked-halo
   presplit v3ps at f=8 (m=1) and f=4 (m=2), all at 256x256 and bit-equal
   to their plain versions; and the dense v4 kernel (tensor cores; CHWB,
   and NCHW where auto-selection picks it) at f=2 on 32x32 and 48x48 and
   at f=8 on 64x64 (CHWB), within the tolerance; every NCHW case must
   launch the kernel named;
4. scene-kernels: both instantiations of the scene stencil (raw rows +
   halos, `colsplit_raw`; halo-extended slab, `colsplit`) against their
   plain versions and the F.pad + grouped strided F.conv2d route at the
   scene path's full width (5x8192x8192, f=8, 13x13 blur, K=20) and at
   5x2048x2048, f=4 (K=16); the raw one with edge halos and as two slabs
   fed each other's real rows; each bit for bit (`bit_equal`);
5. factory: the factory's device path over 256 synthetic 5x256x256 .npy
   patches (two full batches of 128) with a seeded [64, 5, 32, 32] noise
   pool, through both routes — `factory_batches` (.npy input: native split
   loader -> presplit kernel) and `natural_batches` (the .nc route's
   device code: NCHW stack -> v3 kernel; fed .npy here because the card's
   machine has no h5py to read .nc files); then both at x2 (span 14 > 10,
   where the .npy route goes natural too): the same patches with a
   [64, 5, 128, 128] pool (the v2 kernel) and 256 5x48x48 patches with a
   [64, 5, 24, 24] pool (the dense v4 kernel). Launch counts are set to 0
   before each route and read after it (one launch of the route's kernel
   per batch, no other degrade kernel); every lr is checked against the
   plain degrade(hr) + pool[idx];
6. scene: `pipeline.degrade_scene.degrade_scene_file` (the CLI's device
   code, fed in-memory scenes: no h5py there either) on a seeded
   5x8192x8192 scene with NaN cells, in 1 and 4 row slabs, and on an
   uneven 5x8003x7999 scene; and the public `degrade_slab_fast` on the
   edge-extended 8192^2 scene. Launch counts are set to 0 before each
   route and read after it; each output is held against the plain
   `degrade_strided` of the cropped, mean-filled scene, with identical NaN
   cells; each route is timed end to end (H2D / kernel / D2H stages);
7. api: the public calls that reach v1 and v3ps, each with the counts
   set to 0 before it: `degrade_fused_chwb(version=1)` at the x2 factory's
   batch and `degrade_fused_presplit(baked_halo=True)` at the x8 one;
8. timing: CUDA-event medians of 30 runs for each kernel at the main
   paths' shapes (beside the profiler's device time of the kernel itself,
   which leaves out host time between launches), its plain version and
   the conv route (for v4 also the
   f32 `torch.matmul` of the dense product and the whole `degrade_fused`
   call), beside the least time the card needs for the degrade's bytes
   and operations; for v1/v2, the v3 family and the scene kernels also
   the FP32-pipe floor of their unfused multiply and add (bit equality
   forbids FMA; `instr_bound_ms`), for v4 the bound of the
   banded product it runs (x, noise, out; its bf16 term products over
   each tile's band, `kernels.dense_tiles`); and v3 (CHWB) and
   colsplit_raw at f=4 (K=16), a shape their run-time walk takes (f=8,
   K=20 has a compile-time instantiation), listed under
   `other_layouts_ms`;
9. kernelgan: single-kernel KernelGAN training (`train.single_kernel`) at
   the repo's default widths (G mid_ch 32, 5 bands, 13x13, x8; D 64x4;
   batch 16 of 5x256x256 HR against 32x32 real) on a seeded in-memory
   `synthetic_pool` of 64 patches (the card's machine has no h5py for
   `.nc` patch folders): (a) chain forward, host-sampled batches, 20
   iterations; (b) compose forward (`--fast-forward`), device pool, 10
   steps a call, 40 iterations; (c) real_is_lr against a 64x5x32x32
   lr_pool, raw_sum_reg 0.1, compose, 20 iterations. Each run must write
   `iters` finite CSV rows and a non-negative [5,13,13]
   `kernel_per_band.npy` whose bands sum to 1 (1e-5), its band mean as
   `kernel_merged.npy`, move G's weights and launch none of the degrade
   kernels. One `make_base_step` at full widths (batch 2, real_is_lr, no
   random draw) and the `entry()` forward (G, then D with train=False) at
   [8,5,256,256], from the same weights in the JAX layout, are held
   against the port's CPU path (rtol 1e-4 / atol 1e-5, TF32 off). For (a)
   and (b): iterations/s (median of 5 synchronized windows of >= 10
   iterations after warm-up), the profiler's device time per iteration
   (`utils.profiling.cuda_device_ms`), the device's busy share and the
   top device operations with their input shapes;
10. denoise: the denoise -> noise pool -> factory chain at full width
   (the DAG's defaults: h_factor 1.0, 8 files a chunk, pool crops 32x32,
   5 a file, seed 42) on 32 seeded in-memory 5x256x256 "files" (a smooth
   radiance-like field plus per-band Gaussian noise of known sigma; NaN
   holes in three files, one all-NaN band). `batch_denoise` runs as a user
   runs it, its file reads and writes swapped for the in-memory stacks
   (no h5py there): four chunks, one-deep pipeline. Checks: every file
   out, no per-file fallback, no degrade kernel; NaNs restored at exactly
   the input's cells; the dead band passed through bit for bit with sigma
   0.0; every sigma finite and within 25 % of the noise sigma that made
   it; the pipelined run equal to one `denoise_batch` a chunk; one file
   against the port's CPU run (rtol 1e-4 / atol 1e-5, sigma rel 1e-5);
   the three goldens of tests/fixtures/denoise_golden with
   tests/test_denoise.py's bounds. Chain: the noise pool [160, 5, 32, 32]
   from raw - denoised through the port's `noise_crops`, bit-equal to a
   plain host build of the same draws, then the x8 factory's .npy route
   (v3psn) on 256 seeded patches with that pool, every lr against the
   plain degrade(hr) + pool[idx], one launch a 128-patch batch. Timing of
   one chunk (median of 5 synchronized windows: Mpix/s of band pixels,
   the host's dispatch time; the profiler's device time, busy share and
   launches; the sigma pass's share; peak device memory; the byte bound
   of the NLM's spelling and a fused sweep's compute floor), and the whole
   32-file pipelined run with its stage timers.

Prints one JSON line {"factory": {...}} (per-route results), one
{"scene": {...}}, one {"api": {...}}, one {"kernelgan": {...}}, one
{"denoise": {...}}, then the
card's nvidia-smi line, one JSON line {"kernels": [...]} and, last,
{"ok": true, "device": {...}}. Any mismatch or error in any phase, timing
included, exits non-zero before that last line.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

RTOL, ATOL = 1e-4, 1e-5
B, C, HW, KSIZE, FACTOR = 128, 5, 256, 13, 8
N_FILES, POOL_N, SEED = 256, 64, 0
TIMING_RUNS = 30
#: the plain versions repeat the kernels' arithmetic tap by tap (no yardstick
#: of speed): a few runs give their time
PLAIN_RUNS = 5
#: the scene path's full width (bench_scene.py): 5 bands, 8192^2 f32, x8
SCENE_C, SCENE_HW, SCENE_K = 5, 8192, 13
UNEVEN_HW = (8003, 7999)
#: CUDA source of each kernel, and the TPU kernel it replaces (the kernel
#: body; a noise variant follows it in the same file)
#: the x2 factory (span 14 > 5*2): 256x256 patches take the v2 stencil,
#: 48x48 ones (the largest v4 shape at f=2) the dense v4 kernel
X2, X2_SMALL_HW = 2, 48
SOURCES = {
    "degrade_v3": "kmsr_tpu_torch/kernels/degrade_stencil.cu",
    "degrade_v3psn": "kmsr_tpu_torch/kernels/degrade_stencil.cu",
    "degrade_v3ps": "kmsr_tpu_torch/kernels/degrade_stencil.cu",
    "degrade_v2": "kmsr_tpu_torch/kernels/degrade_wide.cu",
    "degrade_v1": "kmsr_tpu_torch/kernels/degrade_wide.cu",
    "degrade_v4": "kmsr_tpu_torch/kernels/degrade_dense.cu",
    "colsplit_raw": "kmsr_tpu_torch/kernels/scene_stencil.cu",
    "colsplit": "kmsr_tpu_torch/kernels/scene_stencil.cu",
}
REPLACES = {
    "degrade_v3": "kmsr_tpu/ops/degrade_pallas.py:253",
    "degrade_v3psn": "kmsr_tpu/ops/degrade_pallas.py:351",
    "degrade_v3ps": "kmsr_tpu/ops/degrade_pallas.py:320",
    "degrade_v2": "kmsr_tpu/ops/degrade_pallas.py:113",
    "degrade_v1": "kmsr_tpu/ops/degrade_pallas.py:64",
    "degrade_v4": "kmsr_tpu/ops/degrade_pallas.py:634",
    "colsplit_raw": "kmsr_tpu/ops/degrade_scene_fast.py:358",
    "colsplit": "kmsr_tpu/ops/degrade_scene_fast.py:215",
}
#: published peaks (NVIDIA data sheets, dense, no sparsity): HBM bytes/s,
#: fp32 (non-tensor core) FLOP/s and bf16 tensor-core FLOP/s, by a
#: substring of the card's name
PEAKS = [
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100", 3.35e12, 67e12, 989e12),
    ("H200", 4.8e12, 67e12, 989e12),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() \
        else f"nvidia-smi failed ({r.returncode}): {r.stderr.strip()}"


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), or 1.98 GHz, the H100
    SXM's, if it cannot be read."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    try:
        return float(r.stdout.strip().splitlines()[0]) * 1e6
    except (ValueError, IndexError):
        return 1.98e9


def fp32_lanes_per_s(dev) -> float:
    """FP32-pipe lane operations a second: SMs x 128 lanes x the maximum
    SM clock."""
    import torch

    return torch.cuda.get_device_properties(dev).multi_processor_count \
        * 128 * max_sm_clock_hz()


def peaks(name: str) -> tuple[float, float, float]:
    """(HBM bytes/s, fp32 FLOP/s, bf16 tensor-core FLOP/s) of the card."""
    for key, *rates in PEAKS:
        if key in name:
            return tuple(rates)
    return tuple(PEAKS[2][1:])  # unknown card: H100 SXM figures


def errors(got, want) -> dict:
    import torch

    diff = (got - want).abs()
    return {
        "max_abs_err": float(diff.max()),
        "max_rel_err": float((diff / want.abs().clamp_min(ATOL)).max()),
        "ok": bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL)),
    }


def phase_build() -> None:
    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.runtime import loader

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels.SOURCES) + 1) as pool:
        cus = [pool.submit(kernels.build, name) for name in kernels.SOURCES]
        cpp = pool.submit(loader._build_library)
        sos, loader_so = [f.result() for f in cus], cpp.result()
    secs = time.perf_counter() - t0
    for so in sos:
        ptxas = [ln.split("ptxas info    : ")[-1] for ln in
                 so.with_suffix(".log").read_text().splitlines()
                 if "Used" in ln and "registers" in ln]
        log(f"[build] {so.name}: ptxas {sorted(set(ptxas))}")
    log(f"[build] ok in {secs:.1f}s: {', '.join(so.name for so in sos)}, "
        f"{loader_so.name}")


def make_inputs(factor: int, gen, dev, hw: int = HW):
    import torch

    img = (torch.randn(B, C, hw, hw, generator=gen) * 2 + 5).to(dev)
    kernel = (torch.rand(C, KSIZE, KSIZE, generator=gen) * 0.9 + 0.1).to(dev)
    oh = hw // factor
    noise = (torch.randn(C, oh, oh, B, generator=gen) * 0.1).to(dev)
    return img, kernel, noise


def layout_inputs(img, noise, factor, layout, dtype):
    """(x, noise) for one entry point's layout."""
    from kmsr_tpu_torch.ops.degrade_fused import col_halo, phase_split_chwb

    x = img.to(dtype)
    if layout == "nchw":
        return x, noise.permute(3, 0, 1, 2).contiguous()
    x = x.permute(1, 2, 3, 0).contiguous()
    if layout == "presplit":
        x = phase_split_chwb(x, factor).contiguous()
    elif layout == "presplit_halo":
        m = col_halo(KSIZE + factor - 1, factor)
        x = phase_split_chwb(x, factor, halo=True, halo_rows=m).contiguous()
    return x, noise


def entry(layout, version=None):
    """(entry point, its plain version), both called (x, kernel, noise,
    factor=f); version pins the CHWB kernel (None: auto). NCHW always
    auto-selects, as JAX's `degrade_pallas` does."""
    import functools

    from kmsr_tpu_torch.ops import degrade_fused as df

    pinned = functools.partial
    return {
        "nchw": (df.degrade_fused, df.degrade_fused_ref),
        "chwb": (pinned(df.degrade_fused_chwb, version=version),
                 pinned(df.degrade_fused_chwb_ref, version=version)),
        "presplit": (df.degrade_fused_presplit, df.degrade_fused_presplit_ref),
        "presplit_halo": (pinned(df.degrade_fused_presplit, baked_halo=True),
                          pinned(df.degrade_fused_presplit_ref, baked_halo=True)),
    }[layout]


def to_nchw(out, layout):
    return out if layout == "nchw" else out.permute(3, 0, 1, 2)


def phase_kernels(dev, failures: list) -> list:
    import torch

    from kmsr_tpu_torch.ops.degrade import degrade_strided

    gen = torch.Generator().manual_seed(SEED)
    cases = []
    for factor in (FACTOR, 4):
        img, kernel, noise = make_inputs(factor, gen, dev)
        conv = degrade_strided(img, kernel, factor=factor)
        dtypes = (torch.float32, torch.bfloat16) if factor == FACTOR else (torch.float32,)
        for dtype in dtypes:
            for layout in ("nchw", "chwb", "presplit"):
                for with_noise in (False, True):
                    if dtype == torch.bfloat16 and not with_noise:
                        continue
                    x, n = layout_inputs(img, noise, factor, layout, dtype)
                    n = n if with_noise else None
                    fused, ref = entry(layout)
                    got = fused(x, kernel, n, factor=factor)
                    want = ref(x, kernel, n, factor=factor)
                    torch.cuda.synchronize()
                    case = {
                        "kernel": "degrade_v3psn" if layout == "presplit" else "degrade_v3",
                        "layout": layout, "factor": factor, "span": KSIZE + factor - 1,
                        "noise": with_noise, "dtype": str(dtype).replace("torch.", ""),
                        **errors(got, want),
                        "bit_equal": bool(torch.equal(got, want)),
                    }
                    if dtype == torch.float32:  # same taps, order, rounding
                        case["ok"] = case["ok"] and case["bit_equal"]
                        want_conv = conv if n is None else conv + to_nchw(n, layout)
                        e = errors(to_nchw(got, layout), want_conv)
                        case["vs_conv_max_abs_err"] = e["max_abs_err"]
                        case["ok"] = case["ok"] and e["ok"]
                    cases.append(case)
                    tag = "ok" if case["ok"] else "MISMATCH"
                    log(f"[kernels] {case['kernel']} {layout} f={factor} "
                        f"noise={with_noise} {case['dtype']}: {tag} "
                        f"max_abs={case['max_abs_err']:.3g} "
                        f"max_rel={case['max_rel_err']:.3g} "
                        f"bit_equal={case['bit_equal']}"
                        + (f" vs_conv_max_abs={case['vs_conv_max_abs_err']:.3g}"
                           if "vs_conv_max_abs_err" in case else ""))
                    if not case["ok"]:
                        failures.append(f"kernel case {case}")
        del img, conv
    torch.cuda.empty_cache()
    return cases


def phase_wide_kernels(dev, failures: list) -> list:
    """The wide-span instantiations against their plain versions (v1, v2,
    v3ps bit for bit; v4 within the tolerance) and, in float32, against
    the F.pad + grouped strided F.conv2d route (TF32 off). CHWB pins the
    version; NCHW runs only where auto-selection picks the kernel named,
    and must launch it."""
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.ops.degrade import degrade_strided

    gen = torch.Generator().manual_seed(SEED + 6)
    runs = [  # (kernel, version, factor, patch side, layouts)
        ("degrade_v1", 1, X2, HW, ("chwb",)),
        ("degrade_v2", 2, X2, HW, ("nchw", "chwb")),
        ("degrade_v1", 1, FACTOR, HW, ("chwb",)),
        ("degrade_v2", 2, FACTOR, HW, ("chwb",)),
        ("degrade_v3ps", 3, FACTOR, HW, ("presplit_halo",)),
        ("degrade_v3ps", 3, 4, HW, ("presplit_halo",)),
        ("degrade_v4", 4, X2, 32, ("nchw", "chwb")),
        ("degrade_v4", 4, X2, X2_SMALL_HW, ("nchw", "chwb")),
        ("degrade_v4", 4, FACTOR, 64, ("chwb",)),
    ]
    cases = []
    for name, version, factor, hw, layouts in runs:
        img, kernel, noise = make_inputs(factor, gen, dev, hw=hw)
        conv = degrade_strided(img, kernel, factor=factor)
        for layout in layouts:
            fused, ref = entry(layout, version)
            for dtype, with_noise in ((torch.float32, False), (torch.float32, True),
                                      (torch.bfloat16, True)):
                x, n = layout_inputs(img, noise, factor, layout, dtype)
                n = n if with_noise else None
                before = kernels.LAUNCHES[name]
                got = fused(x, kernel, n, factor=factor)
                launched = kernels.LAUNCHES[name] - before
                want = ref(x, kernel, n, factor=factor)
                torch.cuda.synchronize()
                case = {"kernel": name, "layout": layout, "factor": factor,
                        "span": KSIZE + factor - 1, "shape": [B, C, hw, hw],
                        "noise": with_noise,
                        "dtype": str(dtype).replace("torch.", ""),
                        **errors(got, want)}
                if launched != 1:
                    case["ok"] = False
                    failures.append(f"{name} {layout} {hw}x{hw} f={factor}: "
                                    f"launched {launched} times, not once")
                if name != "degrade_v4":  # the stencil modes: same taps, same
                    # order, separately rounded; v4's tensor cores sum in their
                    # own order and are held to the tolerance only
                    case["bit_equal"] = bool(torch.equal(got, want))
                    case["ok"] = case["ok"] and case["bit_equal"]
                if dtype == torch.float32:
                    want_conv = conv if n is None else conv + to_nchw(n, layout)
                    e = errors(to_nchw(got, layout), want_conv)
                    case["vs_conv_max_abs_err"] = e["max_abs_err"]
                    case["ok"] = case["ok"] and e["ok"]
                cases.append(case)
                log(f"[kernels] {name} {layout} {hw}x{hw} f={factor} "
                    f"noise={with_noise} {case['dtype']}: "
                    f"{'ok' if case['ok'] else 'MISMATCH'} "
                    f"max_abs={case['max_abs_err']:.3g} "
                    f"max_rel={case['max_rel_err']:.3g}"
                    + (f" bit_equal={case['bit_equal']}" if "bit_equal" in case else "")
                    + (f" vs_conv_max_abs={case['vs_conv_max_abs_err']:.3g}"
                       if "vs_conv_max_abs_err" in case else ""))
                if not case["ok"]:
                    failures.append(f"kernel case {case}")
                del x, got, want
        del img, conv
    torch.cuda.empty_cache()
    return cases


def write_inputs(tmp: str) -> tuple[dict, str, dict]:
    """Seeded .npy patch sets ({"256": 5x256x256, "48": 5x48x48}, N_FILES
    each), one 13x13 kernel, and a [POOL_N, 5, h, w] noise pool per
    (patch side, factor) the routes use."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    sets = {}
    for hw in (HW, X2_SMALL_HW):
        d = os.path.join(tmp, f"patches{hw}")
        os.makedirs(d)
        sets[hw] = []
        for i in range(N_FILES):
            path = os.path.join(d, f"scene_{i:04d}.npy")
            np.save(path, rng.normal(5, 2, (C, hw, hw)).astype(np.float32))
            sets[hw].append(path)
    k_path = os.path.join(tmp, "kernel.npy")
    np.save(k_path, rng.uniform(0.1, 1, (C, KSIZE, KSIZE)).astype(np.float32))
    pools = {}
    for hw, factor in ((HW, FACTOR), (HW, X2), (X2_SMALL_HW, X2)):
        pools[hw, factor] = os.path.join(tmp, f"pool{hw}_x{factor}.npy")
        np.save(pools[hw, factor], rng.normal(
            0, 0.1, (POOL_N, C, hw // factor, hw // factor)).astype(np.float32))
    return sets, k_path, pools


def drive(batches, files, kernel, pool, noise_of, dev, check: bool,
          failures: list, label: str, factor: int = FACTOR) -> dict:
    """Consume a factory generator as run_factory does (sync batch k after
    batch k+1 was dispatched); with check, hold every lr against the plain
    degrade(hr) + pool[idx] and every hr against its file. A pool built
    from denoised bands with holes holds NaN cells: lr must carry them at
    exactly the plain version's cells and be finite elsewhere."""
    import numpy as np
    import torch

    from kmsr_tpu_torch.ops.degrade import degrade
    from kmsr_tpu_torch.utils.profiling import stage_timer, timing_report

    seen, worst = 0, 0.0
    timing_report(reset=True)

    def writeback(paths, hr, lr_dev):
        nonlocal seen, worst
        with stage_timer("factory.device_sync"):
            lr = lr_dev.cpu()
        seen += len(paths)
        if not check:
            return
        want = degrade(torch.from_numpy(hr).to(dev), kernel, factor=factor).cpu() \
            + torch.from_numpy(pool[[noise_of[p] for p in paths]])
        if lr.shape == want.shape:
            holes = torch.isnan(want)  # a pool entry's NaN cells, carried into lr
            if not torch.equal(torch.isnan(lr), holes):
                failures.append(f"{label}: lr NaN cells differ from the plain version's")
            lr, want = lr[~holes], want[~holes]
        if not bool(torch.isfinite(lr).all()) or lr.shape != want.shape:
            failures.append(f"{label}: non-finite or misshapen lr {tuple(lr.shape)}")
        e = errors(lr, want)
        worst = max(worst, e["max_abs_err"])
        if not e["ok"]:
            failures.append(f"{label}: lr vs plain degrade + noise {e}")
        for p, h in zip(paths, hr):
            if not np.array_equal(h, np.load(p)):
                failures.append(f"{label}: hr of {p} differs from the file")

    t0 = time.perf_counter()
    pending = None
    for paths, hr, lr, fails in batches:
        if fails:
            failures.append(f"{label}: per-file failures {fails}")
        if lr is None:
            continue
        if pending is not None:
            writeback(*pending)
        pending = (paths, hr, lr)
    if pending is not None:
        writeback(*pending)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if seen != len(files):
        failures.append(f"{label}: {seen} of {len(files)} patches came out")
    stages = {name: rec["total_s"] for name, rec in timing_report(reset=True).items()}
    return {"patches": seen, "seconds": secs, "max_abs_err": worst,
            "stages_s": stages}


def phase_factory(dev, failures: list) -> dict:
    """Each factory route with the launch counts set to 0 before it and
    read after it: one launch of the route's kernel per 128-patch batch,
    and no other degrade kernel."""
    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.pipeline import factory

    tmp = tempfile.mkdtemp(prefix="kmsr_chip_smoke_")
    try:
        t0 = time.perf_counter()
        sets, k_path, pools = write_inputs(tmp)
        log(f"[factory] wrote {sum(map(len, sets.values()))} patches in "
            f"{time.perf_counter() - t0:.1f}s")
        routes = [  # (route, kernel, patch side, factor, input route)
            ("npy", "degrade_v3psn", HW, FACTOR, "factory_batches"),
            ("nc-device", "degrade_v3", HW, FACTOR, "natural_batches"),
            ("x2 npy", "degrade_v2", HW, X2, "factory_batches"),
            ("x2 nc-device", "degrade_v2", HW, X2, "natural_batches"),
            ("x2 small npy", "degrade_v4", X2_SMALL_HW, X2, "factory_batches"),
            ("x2 small nc-device", "degrade_v4", X2_SMALL_HW, X2, "natural_batches"),
        ]
        result = {}
        for route, name, hw, factor, via in routes:
            files, pool_path = sets[hw], pools[hw, factor]
            kernel, pool, noise_of = factory.factory_inputs(
                files, k_path, pool_path, seed=42, device=dev)
            if via == "factory_batches":  # the .npy route as run_factory builds it
                def make():
                    return factory.factory_batches(
                        files, k_path, pool_path, factor=factor, batch_size=128,
                        seed=42, backend="auto", input_format="npy", device=dev)
            else:  # the .nc route's device code (natural NCHW stack)
                def make():
                    return factory.natural_batches(
                        files, kernel, pool, noise_of, factor=factor,
                        batch_size=128, backend="auto", input_format="npy",
                        device=dev)
            kernels.reset_launches()
            checked = drive(make(), files, kernel, pool, noise_of, dev, True,
                            failures, route, factor)
            launches = dict(kernels.LAUNCHES)
            batches = -(-len(files) // 128)
            degrades = sum(n for k, n in launches.items() if k.startswith("degrade_"))
            if launches[name] != batches or degrades != batches:
                failures.append(f"route {route}: launches {launches}, want {name} "
                                f"once per batch ({batches}) and nothing else")
            timed = drive(make(), files, kernel, pool, noise_of, dev, False,
                          failures, route, factor)
            result[route] = {"kernel": name, "patch": [C, hw, hw], "factor": factor,
                             "via": via, "launches": launches[name],
                             "all_launches": launches, **checked,
                             "timed_seconds": timed["seconds"],
                             "timed_stages_s": timed["stages_s"]}
            log(f"[factory] route {route} ({C}x{hw}x{hw}, x{factor}, {via}): "
                f"{checked['patches']} patches, "
                f"launches {launches}, lr max_abs_err vs plain "
                f"{checked['max_abs_err']:.3g}; unchecked pass "
                f"{timed['seconds']:.3f}s = "
                f"{timed['patches'] / timed['seconds']:.1f} patches/s "
                f"(host .npy read + H2D + kernel + D2H, page cache warm); "
                f"main-thread stages (s): {timed['stages_s']}")
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_api(dev, failures: list) -> dict:
    """The public calls that reach v1 and v3ps (no CLI route does), each
    with the counts set to 0 before it and read after it, held bit for bit
    against its plain version."""
    import torch

    from kmsr_tpu_torch import kernels

    gen = torch.Generator().manual_seed(SEED + 7)
    result = {}
    for name, version, factor, layout in (("degrade_v1", 1, X2, "chwb"),
                                          ("degrade_v3ps", 3, FACTOR, "presplit_halo")):
        img, kernel, noise = make_inputs(factor, gen, dev)
        x, n = layout_inputs(img, noise, factor, layout, torch.float32)
        fused, ref = entry(layout, version)
        kernels.reset_launches()
        got = fused(x, kernel, n, factor=factor)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        equal = bool(torch.equal(got, ref(x, kernel, n, factor=factor)))
        if launches[name] != 1 or not equal:
            failures.append(f"api {name}: launches {launches}, bit-equal {equal}")
        result[name] = {"launches": launches[name], "all_launches": launches,
                        "bit_equal": equal, "layout": layout, "factor": factor}
        log(f"[api] {name} ({layout}, x{factor}, B={B}): launches {launches}, "
            f"bit-equal to its plain version: {equal}")
        del img, x, got
    torch.cuda.empty_cache()
    return result


def phase_timing(dev, card: str) -> dict:
    """Device times at the main path's shapes (B=128, f=8, with noise)."""
    import torch
    import torch.nn.functional as F

    from kmsr_tpu_torch.ops.degrade import fp32_convs, normalize_kernel, compose_with_box
    from kmsr_tpu_torch.utils.profiling import cuda_time_ms

    bw, flops_peak, _ = peaks(card)
    lanes_per_s = fp32_lanes_per_s(dev)
    gen = torch.Generator().manual_seed(SEED + 1)
    img, kernel, noise = make_inputs(FACTOR, gen, dev)
    comp = compose_with_box(normalize_kernel(kernel), FACTOR)
    pad = KSIZE // 2
    noise_nchw = noise.permute(3, 0, 1, 2).contiguous()

    def conv_route():
        with fp32_convs():
            x = F.pad(img, (pad, pad, pad, pad), mode="replicate")
            return F.conv2d(x, comp[:, None], stride=FACTOR, groups=C) + noise_nchw

    library = cuda_time_ms(conv_route, runs=TIMING_RUNS)["median_ms"]
    padded = F.pad(img, (pad, pad, pad, pad), mode="replicate")

    def conv_only():
        with fp32_convs():
            return F.conv2d(padded, comp[:, None], stride=FACTOR, groups=C)

    conv_ms = cuda_time_ms(conv_only, runs=TIMING_RUNS)["median_ms"]
    out = {}
    for name, layout in (("degrade_v3", "nchw"), ("degrade_v3", "chwb"),
                         ("degrade_v3psn", "presplit")):
        x, n = layout_inputs(img, noise, FACTOR, layout, torch.float32)
        fused, ref = entry(layout)
        ms = cuda_time_ms(lambda: fused(x, kernel, n, factor=FACTOR), runs=TIMING_RUNS)
        plain = cuda_time_ms(lambda: ref(x, kernel, n, factor=FACTOR), runs=PLAIN_RUNS)
        k = comp.shape[-1]
        n_out = n.numel()
        nbytes = x.numel() * x.element_size() + 2 * n_out * 4 + comp.numel() * 4
        nflops = 2 * n_out * k * k + n_out
        t_bytes, t_ops = nbytes / bw * 1e3, nflops / flops_peak * 1e3
        rec = {
            "layout": layout, "ms": ms["median_ms"], "ms_min": ms["min_ms"],
            "ms_max": ms["max_ms"], **device_time(lambda: fused(x, kernel, n, factor=FACTOR)),
            "plain_ms": plain["median_ms"],
            "library_ms": library, "conv_only_ms": conv_ms,
            "bytes": nbytes, "flops": nflops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "instr_bound_ms": 2 * n_out * k * k / lanes_per_s * 1e3,
        }
        out[(name, layout)] = rec
        log(f"[timing] {name} {layout}: {rec['ms']:.4f} ms (min {rec['ms_min']:.4f}, "
            f"max {rec['ms_max']:.4f}; median of {TIMING_RUNS}; profiler device "
            f"{rec['device_ms']:.4f} ms); plain "
            f"{rec['plain_ms']:.3f} ms; conv route (F.pad + grouped F.conv2d + "
            f"noise) {library:.4f} ms, of it the grouped F.conv2d alone "
            f"{conv_ms:.4f} ms; moves {nbytes / 1e6:.1f} MB, "
            f"{nflops / 1e9:.3f} GFLOP -> bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, {bw / 1e12:.2f} TB/s, {flops_peak / 1e12:.0f} "
            f"TFLOP/s fp32); FP32-pipe floor {rec['instr_bound_ms']:.4f} ms; "
            f"{rec['device_ms'] / rec['bound_ms']:.2f}x the bound by device time; "
            f"launches per 128-file factory batch: 1")
    # a shape off the compile-time instantiation (f=4, K=16: the x4 route)
    img4, kernel4, noise4 = make_inputs(4, gen, dev)
    x, n = layout_inputs(img4, noise4, 4, "chwb", torch.float32)
    fused, _ = entry("chwb")
    k4 = KSIZE + 3
    out[("degrade_v3", "chwb f=4 (run-time walk)")] = runtime_record(
        "degrade_v3 chwb f=4, K=16", lambda: fused(x, kernel4, n, factor=4),
        x.numel() * 4 + 2 * n.numel() * 4, n.numel(), k4, bw, flops_peak,
        lanes_per_s)
    return out


def runtime_record(label, fused, nbytes, n_out, k, bw, flops_peak,
                   lanes_per_s) -> dict:
    """Times of a ring kernel at a shape its run-time walk takes (no
    compile-time instantiation), beside its byte bound and FP32 floor."""
    from kmsr_tpu_torch.utils.profiling import cuda_time_ms

    ms = cuda_time_ms(fused, runs=TIMING_RUNS)
    nflops = 2 * n_out * k * k
    rec = {"ms": ms["median_ms"], **device_time(fused),
           "bound_ms": max(nbytes / bw, nflops / flops_peak) * 1e3,
           "instr_bound_ms": nflops / lanes_per_s * 1e3}
    log(f"[timing] {label} (run-time walk): {rec['ms']:.4f} ms (median of "
        f"{TIMING_RUNS}; profiler device {rec['device_ms']:.4f} ms); bound "
        f"{rec['bound_ms']:.4f} ms; FP32-pipe floor {rec['instr_bound_ms']:.4f} "
        f"ms; {rec['device_ms'] / rec['bound_ms']:.2f}x the bound by device time")
    return rec


def phase_wide_timing(dev, card: str) -> dict:
    """Device times of the wide-span kernels at their main paths' shapes
    (B=128, C=5, with noise): v2 at 256x256, x2 (NCHW, the .nc route's
    layout; also CHWB); v1 there on CHWB, the only layout that reaches it;
    v3ps at 256x256, x8; v4 at 48x48, x2 (NCHW). v4's time is the banded
    kernel alone on the composed kernels (it generates the stencil
    matrix's terms per tile on chip); the whole `degrade_fused` call is
    `call_ms`. `bound_ms` is the degrade's own: x, noise and out moved
    once, 2*K*K fp32 operations an output. v1/v2's `instr_bound_ms` is the
    FP32 pipe's floor for their separately rounded multiply and add (2
    lane operations a tap over SMs x 128 lanes x the maximum SM clock).
    v4's `operand_bound_ms` is that of the banded product it runs: x, noise
    and out moved once (no A bytes: A is generated on chip), and its bf16
    term products (6 a pixel pair, 3 for bf16 x) over each tile's band,
    `kernels.dense_tiles`, at the bf16 tensor-core peak."""
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.ops import degrade_fused as df
    from kmsr_tpu_torch.ops.degrade import compose_with_box, normalize_kernel
    from kmsr_tpu_torch.utils.profiling import cuda_time_ms

    bw, flops_peak, bf16_peak = peaks(card)
    lanes_per_s = fp32_lanes_per_s(dev)
    gen = torch.Generator().manual_seed(SEED + 8)
    out = {}

    def record(name, layout, fused, ref, library, nbytes, nflops, peak, extra=()):
        ms = cuda_time_ms(fused, runs=TIMING_RUNS)
        plain = cuda_time_ms(ref, runs=PLAIN_RUNS)
        t_bytes, t_ops = nbytes / bw * 1e3, nflops / peak * 1e3
        rec = {"layout": layout, "ms": ms["median_ms"], "ms_min": ms["min_ms"],
               "ms_max": ms["max_ms"], **device_time(fused),
               "plain_ms": plain["median_ms"],
               "library_ms": library, "bytes": nbytes, "flops": nflops,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               **dict(extra)}
        out[(name, layout)] = rec
        log(f"[timing] {name} {layout}: {rec['ms']:.4f} ms (min {rec['ms_min']:.4f}, "
            f"max {rec['ms_max']:.4f}; median of {TIMING_RUNS}; profiler device "
            f"{rec['device_ms']:.4f} ms); plain "
            f"{rec['plain_ms']:.3f} ms (median of {PLAIN_RUNS}); conv route {library:.4f} ms; "
            + "".join(f"{k} {v:.4f} ms; " for k, v in dict(extra).items())
            + f"moves {nbytes / 1e6:.1f} MB, {nflops / 1e9:.3f} GFLOP -> bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, {bw / 1e12:.2f} TB/s, "
            f"{peak / 1e12:.0f} TFLOP/s); {rec['ms'] / rec['bound_ms']:.2f}x the bound")

    for name, version, factor, hw, layouts in (
            ("degrade_v1", 1, X2, HW, ("chwb",)),
            ("degrade_v2", 2, X2, HW, ("nchw", "chwb")),
            ("degrade_v3ps", 3, FACTOR, HW, ("presplit_halo",)),
            ("degrade_v4", 4, X2, X2_SMALL_HW, ("nchw",))):
        img, kernel, noise = make_inputs(factor, gen, dev, hw=hw)
        comp = compose_with_box(normalize_kernel(kernel), factor).contiguous()
        nn = noise.permute(3, 0, 1, 2).contiguous()
        library = cuda_time_ms(lambda: conv_route_nchw(img, comp, factor) + nn,
                               runs=TIMING_RUNS)["median_ms"]
        for layout in layouts:
            x, n = layout_inputs(img, noise, factor, layout, torch.float32)
            fused, ref = entry(layout, version)
            n_out, k = n.numel(), comp.shape[-1]
            out_bytes = 2 * n_out * 4  # noise read, out written
            nbytes = x.numel() * 4 + out_bytes + comp.numel() * 4
            nflops = 2 * n_out * k * k + n_out
            if name != "degrade_v4":
                extra = {"instr_bound_ms": 2 * n_out * k * k / lanes_per_s * 1e3}
                record(name, layout, lambda: fused(x, kernel, n, factor=factor),
                       lambda: ref(x, kernel, n, factor=factor), library,
                       nbytes, nflops, flops_peak, extra.items())
                continue
            a_terms = df._a_terms(comp, factor, hw, hw)
            dst = torch.empty_like(n)
            a32 = df.stencil_matrix(comp, factor, hw, hw)
            xm = x.reshape(B, C, hw * hw).permute(1, 2, 0).contiguous()

            def matmul():
                with df._fp32_matmuls():
                    return torch.matmul(a32, xm)

            tn, tiles = kernels.dense_tiles(k, factor, hw, hw)
            band_pixels = int((tiles[:, 3] * tiles[:, 5]).sum())
            banded_flops = 6 * 2 * band_pixels * tn * B * C + n_out
            record(name, layout,
                   lambda: kernels.degrade_dense(x, comp, n, dst, layout=layout,
                                                 factor=factor),
                   lambda: df.degrade_v4_ref(x, a_terms, n, factor, layout), library,
                   nbytes, nflops, flops_peak,
                   extra={"matmul_ms": cuda_time_ms(matmul, runs=TIMING_RUNS)["median_ms"],
                          "call_ms": cuda_time_ms(lambda: fused(x, kernel, n, factor=factor),
                                                  runs=TIMING_RUNS)["median_ms"],
                          "operand_bound_ms": max(nbytes / bw,
                                                  banded_flops / bf16_peak) * 1e3
                          }.items())
            out[(name, layout)]["banded_gflop"] = banded_flops / 1e9
        del img, noise, nn
    torch.cuda.empty_cache()
    return out


def device_time(fn) -> dict:
    """The profiler's device time of the kernels one call of fn launches
    (`cuda_device_ms`), and their names. Where no profiler trace holds a
    kernel record, the CUDA-event median of the call stands in, and
    `device_ms_from` says so."""
    from kmsr_tpu_torch.utils.profiling import cuda_device_ms, cuda_time_ms

    try:
        d = cuda_device_ms(fn)
    except RuntimeError as e:
        log(f"[timing] {e}: CUDA-event median in its place")
        return {"device_ms": cuda_time_ms(fn, runs=TIMING_RUNS)["median_ms"],
                "device_kernels": [], "device_ms_from": "cuda events"}
    return {"device_ms": d["device_ms"],
            "device_kernels": [k[:80] for k in d["kernels"]],
            "device_ms_from": "profiler"}


def conv_route_nchw(img, comp, factor: int):
    """The library yardstick on an NCHW batch: F.pad (replicate) + grouped
    strided F.conv2d of the composed kernel, TF32 off."""
    import torch.nn.functional as F

    from kmsr_tpu_torch.ops.degrade import fp32_convs

    half = (comp.shape[-1] - factor) // 2
    with fp32_convs():
        xp = F.pad(img, (half, half, half, half), mode="replicate")
        return F.conv2d(xp, comp[:, None], stride=factor, groups=img.shape[1])


def scene_inputs(hw: int, factor: int, seed: int, dev):
    """(scene [C, hw, hw], kernel [C, 13, 13], comp) made on the card."""
    import torch

    from kmsr_tpu_torch.ops.degrade import compose_with_box, normalize_kernel

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(SCENE_C, hw, hw, generator=gen, device=dev) * 2 + 5
    kernel = torch.rand(SCENE_C, SCENE_K, SCENE_K, generator=gen, device=dev) * 0.9 + 0.1
    return x, kernel, compose_with_box(normalize_kernel(kernel), factor).contiguous()


def conv_route(x, comp, factor: int):
    """The library yardstick: F.pad (replicate) + grouped strided F.conv2d
    of the composed kernel, TF32 off — the same function as the stencil."""
    import torch.nn.functional as F

    from kmsr_tpu_torch.ops.degrade import fp32_convs

    half = (comp.shape[-1] - factor) // 2
    with fp32_convs():
        xp = F.pad(x[None], (half, half, half, half), mode="replicate")
        return F.conv2d(xp, comp[:, None], stride=factor, groups=x.shape[0])[0]


def phase_scene_kernels(dev, failures: list) -> list:
    import torch

    from kmsr_tpu_torch.ops import degrade_scene_fast as sf

    cases = []
    for factor, hw in ((FACTOR, SCENE_HW), (4, SCENE_HW // 4)):
        x, _, comp = scene_inputs(hw, factor, SEED + 2, dev)
        ksize = comp.shape[-1]
        th, bh = sf.halo_rows(factor, ksize)
        top, bot = x[:, :1].expand(-1, th, -1), x[:, -1:].expand(-1, bh, -1)
        conv = conv_route(x, comp, factor)
        lo, hi = x[:, :hw // 2], x[:, hw // 2:]
        x_ext = sf.extend_rows_edge(x, factor, ksize)
        runs = {
            ("colsplit_raw", "edge halos"): (
                lambda: sf.degrade_rows_fast(x, comp, factor, top, bot),
                lambda: sf.degrade_rows_fast_ref(x, comp, factor, top, bot)),
            ("colsplit_raw", "two slabs, neighbour halos"): (
                lambda: torch.cat([
                    sf.degrade_rows_fast(lo, comp, factor, top, hi[:, :bh]),
                    sf.degrade_rows_fast(hi, comp, factor, lo[:, -th:], bot)], 1),
                lambda: torch.cat([
                    sf.degrade_rows_fast_ref(lo, comp, factor, top, hi[:, :bh]),
                    sf.degrade_rows_fast_ref(hi, comp, factor, lo[:, -th:], bot)], 1)),
            ("colsplit", "edge-extended slab"): (
                lambda: sf.degrade_slab_fast(x_ext, comp, factor),
                lambda: sf.degrade_slab_fast_ref(x_ext, comp, factor)),
        }
        for (name, halos), (fused, ref) in runs.items():
            got = fused()
            want = ref()
            torch.cuda.synchronize()
            e = errors(got, conv)
            case = {"kernel": name, "halos": halos, "shape": [SCENE_C, hw, hw],
                    "factor": factor, "span": ksize, **errors(got, want),
                    "bit_equal": bool(torch.equal(got, want)),
                    "vs_conv_max_abs_err": e["max_abs_err"]}
            case["ok"] = case["ok"] and e["ok"] and case["bit_equal"]
            cases.append(case)
            log(f"[scene-kernels] {name} {halos} {SCENE_C}x{hw}x{hw} f={factor} "
                f"K={ksize}: {'ok' if case['ok'] else 'MISMATCH'} "
                f"max_abs={case['max_abs_err']:.3g} "
                f"max_rel={case['max_rel_err']:.3g} bit_equal={case['bit_equal']} "
                f"vs_conv_max_abs={case['vs_conv_max_abs_err']:.3g}")
            if not case["ok"]:
                failures.append(f"scene kernel case {case}")
            del got, want
        del x, x_ext, conv, lo, hi, top, bot
        torch.cuda.empty_cache()
    return cases


def host_scene(shape, seed: int, dev):
    """A seeded float32 host scene (made on the card) with NaN cells: a
    masked corner of whole 8x8 cells, a band of partly masked cells, and a
    masked bottom-right corner reaching into the cropped remainder."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    scene = (torch.randn(SCENE_C, *shape, generator=gen, device=dev) * 2 + 5).cpu().numpy()
    scene[:, :64, :64] = float("nan")
    scene[:, 64:67, 1000:2000] = float("nan")
    scene[1:3, -45:, -70:] = float("nan")
    return scene


def scene_reference(scene, kernel, dev):
    """(lr, any_valid) on the card: plain `degrade_strided` of the cropped
    scene with NaNs filled by each band's mean over its valid pixels
    (float64), and which output cells have a valid pixel in their
    footprint."""
    import torch

    from kmsr_tpu_torch.ops.degrade import degrade_strided

    x = torch.from_numpy(scene).to(dev)
    valid = ~torch.isnan(x)
    fills = torch.stack([x[i][valid[i]].double().mean() for i in range(x.shape[0])])
    x = torch.where(valid, x, fills.float()[:, None, None])
    oh, ow = x.shape[1] // FACTOR, x.shape[2] // FACTOR
    x, valid = x[:, :oh * FACTOR, :ow * FACTOR], valid[:, :oh * FACTOR, :ow * FACTOR]
    lr = degrade_strided(x.contiguous(), kernel, factor=FACTOR)
    any_valid = valid.reshape(-1, oh, FACTOR, ow, FACTOR).any(dim=4).any(dim=2)
    return lr.cpu(), any_valid.cpu()


def check_scene(got, want, any_valid, label: str, failures: list) -> dict:
    import torch

    got = torch.from_numpy(got)
    if tuple(got.shape) != tuple(want.shape):
        failures.append(f"scene {label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        return {"ok": False}
    nan_ok = bool(torch.equal(torch.isnan(got), ~any_valid))
    finite = bool(torch.isfinite(got[any_valid]).all())
    e = errors(got[any_valid], want[any_valid])
    e["nan_cells"] = int((~any_valid).sum())
    e["ok"] = e["ok"] and nan_ok and finite
    if not e["ok"]:
        failures.append(f"scene {label}: nan cells identical {nan_ok}, finite "
                        f"{finite}, {e}")
    return e


def phase_scene(dev, failures: list) -> dict:
    """The whole-scene path through its device entry points, each route
    with the launch counts set to 0 before it and read after it."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.ops import degrade_scene_fast as sf
    from kmsr_tpu_torch.ops.degrade import compose_with_box, normalize_kernel
    from kmsr_tpu_torch.pipeline.degrade_scene import degrade_scene_file
    from kmsr_tpu_torch.utils.profiling import timing_report

    rng = np.random.default_rng(SEED)
    kernel = torch.from_numpy(
        rng.uniform(0.1, 1, (SCENE_C, SCENE_K, SCENE_K)).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    scenes = {"8192": host_scene((SCENE_HW, SCENE_HW), SEED + 3, dev),
              "uneven": host_scene(UNEVEN_HW, SEED + 4, dev)}
    # 4 slabs of 16 rows, thinner than 2*K: still the colsplit_raw kernel
    scenes["thin"] = np.ascontiguousarray(scenes["8192"][:, :4 * 2 * FACTOR])
    refs = {name: scene_reference(sc, kernel, dev) for name, sc in scenes.items()}
    log(f"[scene] made {len(scenes)} scenes and their references in "
        f"{time.perf_counter() - t0:.1f}s")
    result = {}
    for route, name, n_shards in (("n_shards=1", "8192", 1),
                                  ("n_shards=4", "8192", 4),
                                  ("uneven n_shards=1", "uneven", 1),
                                  ("thin slabs n_shards=4", "thin", 4)):
        scene = scenes[name]
        kernels.reset_launches()
        got = degrade_scene_file(scene, kernel, FACTOR, n_shards=n_shards)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if launches["colsplit_raw"] != n_shards:
            failures.append(f"scene route {route}: colsplit_raw launched "
                            f"{launches['colsplit_raw']} times, not once a slab")
        checked = check_scene(got, *refs[name], route, failures)
        walls, stages = [], []
        for _ in range(3):  # timed, unchecked
            timing_report(reset=True)
            t0 = time.perf_counter()
            degrade_scene_file(scene, kernel, FACTOR, n_shards=n_shards)
            walls.append(time.perf_counter() - t0)
            stages.append({k: v["total_s"] for k, v in timing_report(reset=True).items()})
        best = sorted(range(3), key=walls.__getitem__)[1]  # the median run
        mpix = scene.shape[1] * scene.shape[2] / 1e6
        result[route] = {
            "shape": list(scene.shape), "n_shards": n_shards,
            "launches": launches["colsplit_raw"], "all_launches": launches,
            **checked, "seconds": walls[best], "seconds_all": walls,
            "mpix_per_s": mpix / walls[best], "stages_s": stages[best],
        }
        st = stages[best]
        log(f"[scene] {route} {scene.shape}: {'ok' if checked['ok'] else 'MISMATCH'} "
            f"max_abs={checked.get('max_abs_err', float('nan')):.3g} "
            f"nan cells={checked.get('nan_cells')}; launches {launches}; median "
            f"of 3 {walls[best]:.4f}s = {mpix / walls[best]:.1f} Mpix/s (h2d "
            f"{st.get('scene.h2d', 0):.4f}s, kernel {st.get('scene.kernel', 0):.4f}s, "
            f"d2h {st.get('scene.d2h', 0):.4f}s); all walls {walls}")
    # the public halo-extended entry point on the edge-extended scene
    x = torch.from_numpy(np.nan_to_num(scenes["8192"], nan=5.0)).to(dev)
    comp = compose_with_box(normalize_kernel(kernel), FACTOR).contiguous()
    want = conv_route(x, comp, FACTOR)
    x_ext = sf.extend_rows_edge(x, FACTOR, comp.shape[-1])
    kernels.reset_launches()
    got = sf.degrade_slab_fast(x_ext, comp, FACTOR)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["colsplit"] < 1:
        failures.append("slab route: colsplit was never launched")
    e = errors(got, want)
    if not e["ok"]:
        failures.append(f"slab route vs the conv route: {e}")
    result["slab"] = {"launches": launches["colsplit"], "all_launches": launches,
                      "vs_conv": e}
    log(f"[scene] slab (degrade_slab_fast on the extended 8192^2 scene): "
        f"{'ok' if e['ok'] else 'MISMATCH'} vs conv max_abs={e['max_abs_err']:.3g}; "
        f"launches {launches}")
    del x, x_ext, got, want
    torch.cuda.empty_cache()
    return result


def phase_scene_timing(dev, card: str) -> dict:
    """Device times of the scene kernels at the scene path's full width."""
    import torch
    import torch.nn.functional as F

    from kmsr_tpu_torch.ops import degrade_scene_fast as sf
    from kmsr_tpu_torch.ops.degrade import compose_with_box, fp32_convs, normalize_kernel
    from kmsr_tpu_torch.utils.profiling import cuda_time_ms

    bw, flops_peak, _ = peaks(card)
    lanes_per_s = fp32_lanes_per_s(dev)
    x, kernel, comp = scene_inputs(SCENE_HW, FACTOR, SEED + 5, dev)
    ksize = comp.shape[-1]
    half = (ksize - FACTOR) // 2
    th, bh = sf.halo_rows(FACTOR, ksize)
    top, bot = x[:, :1].expand(-1, th, -1), x[:, -1:].expand(-1, bh, -1)
    x_ext = sf.extend_rows_edge(x, FACTOR, ksize)
    library = cuda_time_ms(lambda: conv_route(x, comp, FACTOR), runs=TIMING_RUNS)
    padded = F.pad(x[None], (half, half, half, half), mode="replicate")

    def conv_only():
        with fp32_convs():
            return F.conv2d(padded, comp[:, None], stride=FACTOR, groups=SCENE_C)

    conv_ms = cuda_time_ms(conv_only, runs=TIMING_RUNS)["median_ms"]
    del padded
    n_out = SCENE_C * (SCENE_HW // FACTOR) ** 2
    row_bytes = SCENE_C * SCENE_HW * 4
    out = {}
    for name, fused, ref, in_bytes in (
        ("colsplit_raw", lambda: sf.degrade_rows_fast(x, comp, FACTOR, top, bot),
         lambda: sf.degrade_rows_fast_ref(x, comp, FACTOR, top, bot),
         x.numel() * 4 + (th + bh) * row_bytes),
        ("colsplit", lambda: sf.degrade_slab_fast(x_ext, comp, FACTOR),
         lambda: sf.degrade_slab_fast_ref(x_ext, comp, FACTOR),
         x_ext.numel() * 4),
    ):
        ms = cuda_time_ms(fused, runs=TIMING_RUNS)
        plain = cuda_time_ms(ref, runs=PLAIN_RUNS)
        nbytes = in_bytes + comp.numel() * 4 + n_out * 4
        nflops = 2 * n_out * ksize * ksize
        t_bytes, t_ops = nbytes / bw * 1e3, nflops / flops_peak * 1e3
        rec = {
            "layout": f"{SCENE_C}x{SCENE_HW}x{SCENE_HW} f32, f={FACTOR}, K={ksize}",
            "ms": ms["median_ms"], "ms_min": ms["min_ms"], "ms_max": ms["max_ms"],
            **device_time(fused),
            "plain_ms": plain["median_ms"], "library_ms": library["median_ms"],
            "conv_only_ms": conv_ms, "bytes": nbytes, "flops": nflops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "instr_bound_ms": nflops / lanes_per_s * 1e3,
        }
        out[(name, "scene")] = rec
        log(f"[timing] {name} {rec['layout']}: {rec['ms']:.4f} ms (min "
            f"{rec['ms_min']:.4f}, max {rec['ms_max']:.4f}; median of "
            f"{TIMING_RUNS}; profiler device {rec['device_ms']:.4f} ms); plain "
            f"{rec['plain_ms']:.3f} ms; conv route (F.pad "
            f"+ grouped F.conv2d) {rec['library_ms']:.4f} ms, of it the grouped "
            f"F.conv2d alone {conv_ms:.4f} ms; moves {nbytes / 1e6:.1f} MB, "
            f"{nflops / 1e9:.3f} GFLOP -> bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, {bw / 1e12:.2f} TB/s, {flops_peak / 1e12:.0f} "
            f"TFLOP/s fp32); FP32-pipe floor {rec['instr_bound_ms']:.4f} ms; "
            f"{rec['ms'] / rec['bound_ms']:.2f}x the bound")
    # a shape off the compile-time instantiation (f=4, K=16)
    comp4 = compose_with_box(normalize_kernel(kernel), 4).contiguous()
    th4, bh4 = sf.halo_rows(4, comp4.shape[-1])
    top4, bot4 = x[:, :1].expand(-1, th4, -1), x[:, -1:].expand(-1, bh4, -1)
    out[("colsplit_raw", "scene f=4 (run-time walk)")] = runtime_record(
        f"colsplit_raw {SCENE_C}x{SCENE_HW}x{SCENE_HW} f=4, K=16",
        lambda: sf.degrade_rows_fast(x, comp4, 4, top4, bot4),
        x.numel() * 4 + (th4 + bh4) * row_bytes + n_out * 4 * 4,
        n_out * 4, comp4.shape[-1], bw, flops_peak, lanes_per_s)
    del x, x_ext
    torch.cuda.empty_cache()
    return out


#: KernelGAN phase: the pool (64 x 5x256x256, 84 MB), the runs' iterations
#: and the timing windows (iterations per window >= 10)
KG_POOL_N, KG_WINDOWS, KG_WINDOW_ITERS = 64, 5, 10
#: G's weight gradients sum a mean-5 activation against a near zero-mean
#: upstream gradient over 2 x 5 x 65536 pixels: float32 alone leaves
#: 1.4e-3 (CPU) and 3.8e-3 (card) of grad_norm_G against a float64 step
#: (scripts/torch_kernelgan_ab.py), so the card is held to the CPU there at
KG_GRAD_G_RTOL = 1e-2


def kernelgan_configs(tmp: str) -> dict:
    """name -> (SingleKernelConfig, uses the lr_pool) of the three runs."""
    from kmsr_tpu_torch.models import GeneratorConfig
    from kmsr_tpu_torch.train import SingleKernelConfig

    def cfg(name, **kw):
        return SingleKernelConfig(outdir=os.path.join(tmp, name), log_every=10,
                                  kernel_log_every=10, verbose=False, seed=SEED, **kw)

    compose = GeneratorConfig(forward_mode="compose")
    return {
        "chain": (cfg("chain", iters=20, device_pool=False), False),
        "compose": (cfg("compose", iters=40, device_pool=True, steps_per_call=10,
                        generator=compose), False),
        "real_is_lr": (cfg("real_is_lr", iters=20, real_is_lr=True, raw_sum_reg=0.1,
                           generator=compose), True),
    }


def check_kernelgan_run(cfg, out, failures: list, label: str) -> dict:
    """The run's artifacts: `iters` finite CSV rows under LOG_HEADER, a
    non-negative [5,13,13] kernel_per_band.npy with bands summing to 1,
    kernel_merged.npy its band mean, and G's weights moved off the init."""
    import numpy as np
    import torch

    from kmsr_tpu_torch.models.generator import init_generator
    from kmsr_tpu_torch.train.single_kernel import LOG_HEADER

    rows = open(os.path.join(cfg.outdir, "training_log.txt")).read().splitlines()
    vals = np.array([[float(v) for v in r.split(",")] for r in rows[1:]])
    k = np.load(os.path.join(cfg.outdir, "kernel_per_band.npy"))
    merged = np.load(os.path.join(cfg.outdir, "kernel_merged.npy"))
    init = init_generator(cfg.generator, device=out["state"].rng.device)["layers"]
    moved = max(float((w.detach() - w0).abs().max())
                for w, w0 in zip(out["state"].g_params["layers"], init))
    checks = {
        "header": rows[0] == LOG_HEADER.strip(),
        "rows": vals.shape[0] == cfg.iters
                and vals[:, 0].tolist() == list(range(1, cfg.iters + 1)),
        "finite": bool(np.isfinite(vals).all()),
        "kernel_shape": k.shape == (5, 13, 13),
        "kernel_nonneg": bool((k >= 0).all()),
        "band_sums": bool(np.abs(k.sum(axis=(1, 2)) - 1).max() <= 1e-5),
        "merged": bool(np.allclose(merged, k.mean(axis=0), rtol=0, atol=1e-7)),
        "g_moved": moved > 0,
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        failures.append(f"kernelgan {label}: failed checks {bad}")
    return {"checks_failed": bad, "last_row": rows[-1], "g_max_move": moved,
            "band_sums": k.sum(axis=(1, 2)).tolist(),
            "steps": out["state"].step}


def kernelgan_parity(dev, failures: list) -> dict:
    """One `make_base_step` (batch 2, real_is_lr: no random draw) and the
    `entry()` forward (G, then D with train=False, [8,5,256,256]) at the
    default widths, on the card and on the CPU, from the same weights in
    the JAX layout (numpy pytrees, as `convert` takes them; G perturbed off
    its Gaussian/identity init), TF32 off; the card also runs the step in
    float64, the yardstick of both float32 runs' rounding."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import convert
    from kmsr_tpu_torch.models import (DiscriminatorConfig, GeneratorConfig,
                                       discriminator_forward, generator_forward,
                                       init_discriminator, init_generator)
    from kmsr_tpu_torch.train import SingleKernelConfig, init_gan_state, make_base_step
    from kmsr_tpu_torch.train.state import make_gan_optimizers, tree_map

    rng = np.random.default_rng(SEED + 9)
    g_np = {"layers": [w.numpy() + rng.normal(0, 0.005, w.shape).astype(np.float32)
                       for w in init_generator(GeneratorConfig(), device="cpu")["layers"]]}
    d_np = tree_map(lambda t: t.numpy(),
                    init_discriminator(DiscriminatorConfig(), seed=SEED, device="cpu"))
    hr = torch.from_numpy(rng.normal(5, 2, (2, C, HW, HW)).astype(np.float32))
    real = torch.from_numpy(rng.normal(5, 2, (2, C, 32, 32)).astype(np.float32))
    x = torch.from_numpy(rng.normal(5, 2, (8, C, HW, HW)).astype(np.float32))
    cfg = SingleKernelConfig(batch_size=2, real_is_lr=True, outdir="unused")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = []  # [CPU f32, card f32, card f64]
    for d, dt in ((torch.device("cpu"), torch.float32), (dev, torch.float32),
                  (dev, torch.float64)):
        cast = lambda t: t.to(dt)  # noqa: E731
        g = tree_map(cast, convert.generator_from_jax(g_np, device=d))
        dp, ds = (tree_map(cast, t) for t in convert.discriminator_from_jax(*d_np, device=d))
        with torch.no_grad():
            fake = generator_forward(g, cast(x.to(d)))
            score, _ = discriminator_forward(dp, ds, fake, train=False)
        tx = make_gan_optimizers()
        state = init_gan_state(torch.Generator(device=d).manual_seed(SEED), g, dp, ds, tx, tx)
        _, m = make_base_step(cfg)(state, cast(hr.to(d)), cast(real.to(d)))
        got.append({**{k: m[k].cpu().double() for k in (
            "loss_D", "loss_G_adv", "loss_reg", "grad_norm_D", "grad_norm_G", "kernels")},
            "entry_fake": fake.cpu().double(), "entry_score": score.cpu().double()})
    result = {}
    for k, want in got[0].items():
        rtol = KG_GRAD_G_RTOL if k == "grad_norm_G" else RTOL
        diff = (got[1][k] - want).abs()
        ok = bool(torch.allclose(got[1][k], want, rtol=rtol, atol=ATOL))
        ref = got[2][k].abs().clamp_min(ATOL)
        result[k] = {"max_abs_err": float(diff.max()),
                     "max_rel_err": float((diff / want.abs().clamp_min(ATOL)).max()),
                     "rtol": rtol, "ok": ok,
                     "cpu_vs_f64_rel": float(((want - got[2][k]).abs() / ref).max()),
                     "card_vs_f64_rel": float(((got[1][k] - got[2][k]).abs() / ref).max()),
                     **({"cpu": float(want)} if want.numel() == 1 else {})}
        if not ok:
            failures.append(f"kernelgan card vs CPU {k}: {result[k]}")
    log(f"[kernelgan] card vs CPU (rtol={RTOL}, grad_norm_G rtol={KG_GRAD_G_RTOL}, "
        f"atol={ATOL}, TF32 off): " + ", ".join(
            f"{k} max_abs {v['max_abs_err']:.3g} (vs a float64 step: CPU "
            f"{v['cpu_vs_f64_rel']:.2g}, card {v['card_vs_f64_rel']:.2g})"
            for k, v in result.items()))
    return result


def kernelgan_part(op: str, shapes) -> str:
    """Which part of the step an aten op belongs to: the optimizers'
    foreach updates, G on the HR side (an input of side >= 64: the chain or
    compose convs, forward and backward), or the rest (D's three forwards
    and their backward at 32x32, the losses, the kernel composition and
    extraction, the gradient clipping). Copies count with the part their
    shapes name (the chain's batch upload with G)."""
    if op.startswith("aten::_foreach"):
        return "optimizer (foreach Adam)"
    if any(len(s) == 4 and min(s[2:]) >= 64 for s in shapes if isinstance(s, list)):
        return "G at HR (convs, pads, block mean; forward + backward)"
    return "D x3 + losses + extraction + clipping"


def kernelgan_timing(cfg, pool, dev) -> dict:
    """Iterations/s of one config at full width (median of KG_WINDOWS
    synchronized windows after warm-up), the profiler's device time per
    iteration, the busy share, and the top device operations."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kmsr_tpu_torch.train.single_kernel import (init_training, make_batch_source,
                                                    make_train_step)
    from kmsr_tpu_torch.utils.profiling import cuda_device_ms

    k = cfg.steps_per_call
    step_fn = make_train_step(cfg, device_pool=bool(cfg.device_pool))
    state = init_training(cfg, dev)
    draw = make_batch_source(cfg, pool, None, bool(cfg.device_pool),
                             np.random.default_rng(cfg.seed), dev)

    def one_call():
        nonlocal state
        state, _ = step_fn(state, *draw())

    calls = -(-KG_WINDOW_ITERS // k)
    for _ in range(3):
        one_call()
    walls = []
    for _ in range(KG_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            one_call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / (calls * k))
    wall = sorted(walls)[len(walls) // 2]
    dev_ms = cuda_device_ms(one_call, runs=calls)["device_ms"] / k
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(calls):
            one_call()
        torch.cuda.synchronize()
    ops, parts = [], {}
    for ev in prof.key_averages(group_by_input_shape=True):
        us = getattr(ev, "self_device_time_total", None)
        us = us if us is not None else getattr(ev, "self_cuda_time_total", 0)
        if us <= 0 or not ev.key.startswith("aten::"):
            continue  # kernel and copy records repeat their aten op's device time
        ms = us / 1e3 / (calls * k)
        part = kernelgan_part(ev.key, ev.input_shapes)
        parts[part] = parts.get(part, 0.0) + ms
        ops.append({"op": ev.key, "part": part, "shapes": str(ev.input_shapes)[:160],
                    "device_ms_per_iter": ms, "calls_per_iter": ev.count / (calls * k)})
    ops.sort(key=lambda o: -o["device_ms_per_iter"])
    return {"iters_per_s": 1.0 / wall, "wall_ms_per_iter": wall * 1e3,
            "wall_ms_per_iter_windows": [w * 1e3 for w in walls],
            "window_iters": calls * k, "device_ms_per_iter": dev_ms,
            "busy_share": dev_ms / (wall * 1e3), "parts_ms_per_iter": parts,
            "top_ops": ops[:12],
            "profiled_ops": len(ops)}


def phase_kernelgan(dev, failures: list) -> dict:
    """The three training runs through `train_single_kernel` (launch counts
    set to 0 before and read after: this path runs no degrade kernel), the
    card-vs-CPU checks and the timing of (a) and (b)."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.data import synthetic_pool
    from kmsr_tpu_torch.train import train_single_kernel

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    pool = synthetic_pool(rng, n=KG_POOL_N, c=C, size=HW)
    lr_pool = synthetic_pool(rng, n=KG_POOL_N, c=C, size=32)
    log(f"[kernelgan] pools {pool.shape} ({pool.patches.nbytes / 1e6:.0f} MB) and "
        f"{lr_pool.shape} made in {time.perf_counter() - t0:.1f}s")
    tmp = tempfile.mkdtemp(prefix="kmsr_chip_kernelgan_")
    result = {"runs": {}, "timing": {}}
    try:
        configs = kernelgan_configs(tmp)
        for name, (cfg, with_lr) in configs.items():
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = train_single_kernel(pool, cfg, progress=False, device=dev,
                                      lr_pool=lr_pool if with_lr else None)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
            if launched:
                failures.append(f"kernelgan {name}: launched degrade kernels {launched}")
            rec = check_kernelgan_run(cfg, out, failures, name)
            rec.update({"iters": cfg.iters, "seconds_with_setup": secs,
                        "forward_mode": cfg.generator.forward_mode,
                        "device_pool": cfg.device_pool, "steps_per_call": cfg.steps_per_call})
            result["runs"][name] = rec
            log(f"[kernelgan] {name}: {'ok' if not rec['checks_failed'] else 'FAILED'} "
                f"{cfg.iters} iterations in {secs:.2f}s (setup and artifacts included); "
                f"last row {rec['last_row']}; band sums {rec['band_sums']}")
        result["card_vs_cpu"] = kernelgan_parity(dev, failures)
        for name in ("chain", "compose"):
            rec = kernelgan_timing(configs[name][0], pool, dev)
            result["timing"][name] = rec
            log(f"[kernelgan] timing {name}: {rec['iters_per_s']:.2f} it/s (median of "
                f"{KG_WINDOWS} windows of {rec['window_iters']} iterations, "
                f"{rec['wall_ms_per_iter']:.3f} ms/it, windows "
                f"{[round(w, 3) for w in rec['wall_ms_per_iter_windows']]}); device "
                f"{rec['device_ms_per_iter']:.3f} ms/it (profiler), busy share "
                f"{rec['busy_share']:.3f}; device ms/it by part "
                + str({p: round(v, 3) for p, v in rec["parts_ms_per_iter"].items()})
                + "; top ops: "
                + "; ".join(f"{o['op']} {o['shapes'][:60]} {o['device_ms_per_iter']:.3f} ms"
                            for o in rec["top_ops"][:6]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return result


#: the denoise phase (the defaults of kmsr_tpu/pipeline/run_all.py:78-84):
#: 32 in-memory "files" of 5x256x256, 8 a chunk, h_factor 1.0; the pool
#: of 32x32 crops, 5 a file, seed 42
DN_FILES, DN_BATCH, DN_H_FACTOR = 32, 8, 1.0
DN_POOL_PATCH, DN_SAMPLES, DN_POOL_SEED = 32, 5, 42
DN_WINDOWS = 5
#: file -> its NaN holes: a rectangle in every band, a disk in bands 0-2,
#: 1 % scattered pixels; and the all-NaN (dead) band
DN_RECT, DN_DISK, DN_SCATTER, DN_DEAD = 1, 2, 3, (4, 3)
#: card vs the port's CPU run, per pixel; sigma relative
DN_SIGMA_REL = 1e-5
#: FP32 operations a pixel-shift of a fused sweep would need: squared
#: difference 2, running box sums 4, weight argument 3, exp 1, mask 1,
#: weighted accumulation 4
DN_FUSED_OPS = 15
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "fixtures", "denoise_golden")


def denoise_data():
    """DN_FILES seeded band stacks [5, 256, 256]: a smooth radiance-like
    field (per band a level and a long-period wave) plus Gaussian noise of a
    known sigma per band, with the NaN holes and the dead band above.
    Returns (stacks [N, 5, 256, 256] float32, noise sigmas [N, 5])."""
    import numpy as np

    rng = np.random.default_rng(SEED + 10)
    yy, xx = np.meshgrid(np.linspace(0, 1, HW), np.linspace(0, 1, HW), indexing="ij")
    sig = rng.uniform(0.02, 0.1, (DN_FILES, C))
    stacks = np.empty((DN_FILES, C, HW, HW), np.float32)
    for i in range(DN_FILES):
        level = rng.uniform(0.5, 4.0, (C, 1, 1))
        fx, fy, ph = rng.uniform(0.5, 2.0, (3, C, 1, 1))
        clean = level * (1 + 0.3 * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph))
        stacks[i] = clean + sig[i][:, None, None] * rng.standard_normal((C, HW, HW))
    stacks[DN_RECT, :, 40:100, 60:140] = np.nan
    stacks[DN_DISK, :3][:, (yy * HW - 180) ** 2 + (xx * HW - 70) ** 2 < 30 ** 2] = np.nan
    scatter = rng.random((HW, HW)) < 0.01
    stacks[DN_SCATTER][:, scatter] = np.nan
    stacks[DN_DEAD] = np.nan
    return stacks, sig


class InMemoryDenoiseIO:
    """Swaps the denoise CLI's file reads and writes for a dict of stacks
    (the card's machine has no h5py), so `batch_denoise` — its chunking,
    one-deep pipeline, fallback and accounting — runs as a user runs it."""

    def __init__(self, stacks):
        self.inputs = {f"mem/p{i:03d}.nc": s for i, s in enumerate(stacks)}
        self.outputs = {}

    def __enter__(self):
        from kmsr_tpu_torch.pipeline import denoise_cli

        self._saved = {k: getattr(denoise_cli, k) for k in
                       ("list_patch_files", "read_band_stack", "_write_denoised")}
        denoise_cli.list_patch_files = lambda d, pattern: sorted(self.inputs)
        denoise_cli.read_band_stack = lambda path, group: self.inputs[path]
        denoise_cli._write_denoised = self._write
        return self

    def _write(self, path, output_dir, stack, denoised, sigmas, h_factor, **_):
        self.outputs[path] = (denoised, [float(s) for s in sigmas])
        return path

    def __exit__(self, *exc):
        from kmsr_tpu_torch.pipeline import denoise_cli

        for k, v in self._saved.items():
            setattr(denoise_cli, k, v)

    def results(self):
        import numpy as np

        keys = sorted(self.inputs)
        return (np.stack([self.outputs[k][0] for k in keys]),
                np.array([self.outputs[k][1] for k in keys], np.float32))


def run_batch_denoise(stacks, dev):
    """`batch_denoise` over the in-memory stacks at the DAG's settings:
    (report, denoised [N, 5, H, W], sigmas [N, 5], seconds, stage timers)."""
    import torch

    from kmsr_tpu_torch.pipeline.denoise_cli import batch_denoise
    from kmsr_tpu_torch.utils.profiling import timing_report

    timing_report(reset=True)
    with InMemoryDenoiseIO(stacks) as io:
        t0 = time.perf_counter()
        report = batch_denoise("mem", "unused", h_factor=DN_H_FACTOR,
                               device_batch=DN_BATCH, progress=False, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    stages = {k: v["total_s"] for k, v in timing_report(reset=True).items()}
    if report.n_ok != len(stacks):
        return report, None, None, secs, stages
    return (report, *io.results(), secs, stages)


def nlm_spelling_bytes(n_img: int, hgt: int, wid: int, ps: int, pd: int) -> int:
    """HBM bytes `ops.nlm.nlm_denoise_2d` moves when each of its operations
    reads each input once and writes its output once. Per lattice row: the
    squared difference (subtract into the buffer, square in place), the
    7x7 patch mean, four weight passes, the border mask (one byte an
    entry), the weighted product, two sums over the shifts and two
    accumulations; float32, the padded image read once a row."""
    o, s = ps // 2, 2 * pd + 1
    hb, wb, wp = hgt + 2 * o, wid + 2 * o, wid + 2 * (pd + o)
    img, big, buf = n_img * hgt * wid, n_img * s * hgt * wid, n_img * s * hb * wb
    floats = (
        n_img * hb * (wb + wp) + buf + 2 * buf    # subtract, square
        + buf + big                               # patch mean
        + 4 * 2 * big + 2 * big                   # sub, clamp, div, exp; mask
        + big + n_img * hgt * (wid + 2 * pd) + big  # w * shifted
        + 2 * (big + img) + 2 * 3 * img           # two sums, two adds
    )
    return s * (4 * floats + s * hgt * wid)


def profile_device(fn, runs: int = 3) -> dict:
    """Per call of fn (`cuda_device_ms`): device ms of the kernels and of
    the copies, kernel launches, and the kernels with the most time."""
    from kmsr_tpu_torch.utils.profiling import cuda_device_ms

    d = cuda_device_ms(fn, runs=runs)
    copies = [k for k in d["kernels"] if k.startswith(("Memcpy", "Memset"))]
    kern = {k: ms for k, ms in d["kernels"].items() if k not in copies}
    top = sorted(kern, key=kern.get, reverse=True)[:6]
    return {"kernel_ms": sum(kern.values()), "copy_ms": d["device_ms"] - sum(kern.values()),
            "device_ms": d["device_ms"],
            "launches": sum(n for k, n in d["launches"].items() if k not in copies),
            "top_kernels": [{"kernel": k[:70], "ms": kern[k], "launches": d["launches"][k]}
                            for k in top]}


def denoise_timing(chunk, dev, card: str) -> dict:
    """One chunk (DN_BATCH files) through dispatch + finalize: median of
    DN_WINDOWS synchronized windows, the host's dispatch time, the
    profiler's device time, busy share and launches, the sigma pass's share,
    peak device memory, and the spelling's byte bound beside a fused
    sweep's compute floor."""
    import numpy as np
    import torch

    from kmsr_tpu_torch.ops.nlm import (PATCH_DISTANCE, PATCH_SIZE, denoise_batch_dispatch,
                                        denoise_batch_finalize, nlm_denoise_2d)
    from kmsr_tpu_torch.ops.sigma import estimate_sigma

    def one_chunk():
        return denoise_batch_finalize(denoise_batch_dispatch(chunk, DN_H_FACTOR, dev))

    one_chunk()
    walls, dispatch = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(DN_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = denoise_batch_dispatch(chunk, DN_H_FACTOR, dev)
        t1 = time.perf_counter()
        denoise_batch_finalize(handle)
        walls.append(time.perf_counter() - t0)
        dispatch.append(t1 - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    wall = sorted(walls)[len(walls) // 2]
    whole = profile_device(one_chunk)
    x = torch.from_numpy(np.nan_to_num(chunk.reshape(-1, HW, HW), nan=1.0)).to(dev)
    sig = estimate_sigma(x)
    sigma_pass = profile_device(lambda: estimate_sigma(x))
    sweep = profile_device(lambda: nlm_denoise_2d(x, sig * DN_H_FACTOR, sig))
    n_img = x.shape[0]
    pix = n_img * HW * HW
    bw, fp32, _ = peaks(card)
    nbytes = nlm_spelling_bytes(n_img, HW, HW, PATCH_SIZE, PATCH_DISTANCE)
    pixel_shifts = pix * (2 * PATCH_DISTANCE + 1) ** 2
    return {
        "chunk": list(chunk.shape), "band_pixels": pix,
        "mpix_per_s": pix / wall / 1e6, "wall_ms": wall * 1e3,
        "wall_ms_windows": [w * 1e3 for w in walls],
        "dispatch_ms": sorted(dispatch)[len(dispatch) // 2] * 1e3,
        "device_ms": whole["device_ms"], "kernel_ms": whole["kernel_ms"],
        "copy_ms": whole["copy_ms"], "busy_share": whole["device_ms"] / (wall * 1e3),
        "launches_per_chunk": whole["launches"], "top_kernels": whole["top_kernels"],
        "sigma_ms": sigma_pass["kernel_ms"], "sigma_launches": sigma_pass["launches"],
        "sigma_share": sigma_pass["kernel_ms"] / whole["kernel_ms"],
        "sweep_ms": sweep["kernel_ms"], "sweep_launches": sweep["launches"],
        "peak_mem_gb": peak / 1e9,
        "spelling_gb": nbytes / 1e9, "spelling_bound_ms": nbytes / bw * 1e3,
        "pixel_shifts": pixel_shifts,
        "fused_floor_ms": max(pixel_shifts * DN_FUSED_OPS / fp32,
                              2 * 4 * pix / bw) * 1e3,
        "fused_floor_by": "operations" if pixel_shifts * DN_FUSED_OPS / fp32
                          > 2 * 4 * pix / bw else "bytes",
    }


def denoise_goldens(dev, failures: list) -> dict:
    """The three skimage goldens on the card, with tests/test_denoise.py's
    assertions: sigma rel 1e-3, RMSE/scale < 1e-3 against the exact-exp
    result and < 3e-3 against skimage's internals."""
    import glob

    import numpy as np
    import torch

    from kmsr_tpu_torch.ops.nlm import nlm_denoise_2d
    from kmsr_tpu_torch.ops.sigma import estimate_sigma

    out = {}
    paths = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.npz")))
    if len(paths) < 3:
        failures.append(f"denoise goldens: {len(paths)} found in {GOLDEN_DIR}")
    for path in paths:
        z = np.load(path)
        img = torch.from_numpy(z["img"].astype(np.float32)).to(dev)
        sig = float(estimate_sigma(img))
        den = nlm_denoise_2d(img, float(z["h"]), float(z["sigma"]),
                             int(z["patch_size"]), int(z["patch_distance"])).cpu().numpy()
        scale = float(np.std(z["img"])) or 1.0
        rec = {"sigma_rel": abs(sig / float(z["sigma"]) - 1),
               "rmse_exact": float(np.sqrt(np.mean((den - z["denoised_exact"]) ** 2))) / scale,
               "rmse_skimage": float(np.sqrt(np.mean((den - z["denoised_skimage"]) ** 2)))
               / scale}
        rec["ok"] = rec["sigma_rel"] <= 1e-3 and rec["rmse_exact"] < 1e-3 \
            and rec["rmse_skimage"] < 3e-3
        if not rec["ok"]:
            failures.append(f"denoise golden {os.path.basename(path)}: {rec}")
        out[os.path.basename(path)] = rec
    return out


def denoise_chain(stacks, den, dev, failures: list) -> dict:
    """The noise pool from raw - denoised of every file (the port's
    `noise_crops`, DN_SAMPLES crops a file, seed DN_POOL_SEED), held bit for
    bit against a plain host build of the same draws; then the x8 factory's
    .npy route (v3psn) on 256 seeded patches with that pool, every lr
    against the plain degrade(hr) + pool[idx] (NaN cells of the pool's
    holes included), one launch a 128-patch batch."""
    import numpy as np

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.data.noise_pool import noise_crops
    from kmsr_tpu_torch.pipeline import factory

    rng = np.random.default_rng(DN_POOL_SEED)
    pool = np.stack([c for s, d in zip(stacks, den) for c in
                     noise_crops(rng, s, d, DN_POOL_PATCH, DN_SAMPLES)]).astype(np.float32)
    rng = np.random.default_rng(DN_POOL_SEED)
    plain = np.empty_like(pool)
    for i, (s, d) in enumerate(zip(stacks, den)):
        for j in range(DN_SAMPLES):
            top = rng.integers(0, HW - DN_POOL_PATCH + 1)
            left = rng.integers(0, HW - DN_POOL_PATCH + 1)
            plain[i * DN_SAMPLES + j] = (s - d)[:, top:top + DN_POOL_PATCH,
                                                left:left + DN_POOL_PATCH]
    pool_equal = pool.shape == (DN_FILES * DN_SAMPLES, C, DN_POOL_PATCH, DN_POOL_PATCH) \
        and np.array_equal(pool, plain, equal_nan=True)
    if not pool_equal:
        failures.append(f"denoise chain: pool {pool.shape} differs from the plain build")
    tmp = tempfile.mkdtemp(prefix="kmsr_chip_denoise_")
    try:
        prng = np.random.default_rng(SEED + 11)
        files = []
        for i in range(N_FILES):
            files.append(os.path.join(tmp, f"scene_{i:04d}.npy"))
            np.save(files[-1], prng.normal(5, 2, (C, HW, HW)).astype(np.float32))
        k_path, pool_path = os.path.join(tmp, "kernel.npy"), os.path.join(tmp, "pool.npy")
        np.save(k_path, prng.uniform(0.1, 1, (C, KSIZE, KSIZE)).astype(np.float32))
        np.save(pool_path, pool)
        kernel, host_pool, noise_of = factory.factory_inputs(files, k_path, pool_path,
                                                             seed=42, device=dev)
        kernels.reset_launches()
        res = drive(factory.factory_batches(files, k_path, pool_path, factor=FACTOR,
                                            batch_size=128, seed=42, backend="auto",
                                            input_format="npy", device=dev),
                    files, kernel, host_pool, noise_of, dev, True, failures,
                    "denoise chain")
        launches = dict(kernels.LAUNCHES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    batches = -(-N_FILES // 128)
    degrades = sum(n for k, n in launches.items() if k.startswith("degrade_"))
    if launches["degrade_v3psn"] != batches or degrades != batches:
        failures.append(f"denoise chain: launches {launches}, want degrade_v3psn once "
                        f"per batch ({batches}) and nothing else")
    nan_entries = int(np.isnan(pool).any(axis=(1, 2, 3)).sum())
    return {"pool_shape": list(pool.shape), "pool_bit_equal_plain": pool_equal,
            "pool_entries_with_nan": nan_entries, "launches": launches, **res}


def phase_denoise(dev, card: str, failures: list) -> dict:
    """Denoise -> noise pool -> factory on the card at full width (module
    docstring, phase 10)."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.ops.nlm import denoise_batch, denoise_stack

    t0 = time.perf_counter()
    stacks, noise_sig = denoise_data()
    log(f"[denoise] {DN_FILES} stacks {tuple(stacks.shape[1:])} made in "
        f"{time.perf_counter() - t0:.1f}s")
    kernels.reset_launches()
    report, den, sig, secs, stages = run_batch_denoise(stacks, dev)
    launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
    checks = {"files_ok": report.n_ok == DN_FILES and report.n_fail == 0,
              "fallbacks_0": report.fallbacks == 0, "no_degrade_kernel": not launched}
    if den is not None:
        dead = np.zeros(sig.shape, bool)
        dead[DN_DEAD] = True
        ratio = sig[~dead] / noise_sig[~dead]
        checks.update({
            "nan_cells_restored": bool(np.array_equal(np.isnan(den), np.isnan(stacks))),
            "dead_band_identical": bool(np.array_equal(den[DN_DEAD], stacks[DN_DEAD],
                                                       equal_nan=True))
                                   and float(sig[DN_DEAD]) == 0.0,
            "sigma_within_25pct": bool(np.isfinite(sig).all()
                                       and np.abs(ratio - 1).max() <= 0.25),
        })
        chunked = [denoise_batch(stacks[s:s + DN_BATCH], DN_H_FACTOR, dev)
                   for s in range(0, DN_FILES, DN_BATCH)]
        den_c = np.concatenate([d for d, _ in chunked])
        sig_c = np.concatenate([s for _, s in chunked])
        pipelined_bit_equal = bool(np.array_equal(den_c, den, equal_nan=True)
                                   and np.array_equal(sig_c, sig))
        checks["pipelined_equals_per_chunk"] = pipelined_bit_equal or bool(
            np.allclose(den_c, den, rtol=1e-6, atol=1e-7, equal_nan=True)
            and np.allclose(sig_c, sig, rtol=1e-6))
        cpu_den, cpu_sig = denoise_stack(stacks[DN_RECT], DN_H_FACTOR, device="cpu")
        card_vs_cpu = {
            "max_abs_err": float(np.nanmax(np.abs(cpu_den - den[DN_RECT]))),
            "sigma_max_rel": float(np.max(np.abs(np.array(cpu_sig) / sig[DN_RECT] - 1))),
        }
        checks["card_vs_cpu"] = bool(
            np.allclose(den[DN_RECT], cpu_den, rtol=RTOL, atol=ATOL, equal_nan=True)
            and card_vs_cpu["sigma_max_rel"] <= DN_SIGMA_REL)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        failures.append(f"denoise: failed checks {bad} (report {report.summary()}, "
                        f"fallbacks {report.fallbacks}, launched {launched})")
    result = {"checks": checks, "checks_failed": bad, "seconds_first_run": secs,
              "stages_first_run_s": stages, "fallbacks": report.fallbacks}
    if den is None:
        return result
    result.update({
        "sigma_over_noise_sigma": [float(ratio.min()), float(ratio.max())],
        "card_vs_cpu": card_vs_cpu, "pipelined_bit_equal_per_chunk": pipelined_bit_equal,
        "goldens": denoise_goldens(dev, failures)})
    log(f"[denoise] batch_denoise: {report.summary()}, fallbacks {report.fallbacks}; "
        f"checks {'ok' if not bad else bad}; sigma/noise sigma "
        f"{result['sigma_over_noise_sigma']}; card vs CPU {card_vs_cpu}; goldens "
        + str({k: {m: f"{v:.3g}" for m, v in r.items() if m != "ok"}
               for k, r in result["goldens"].items()}))
    result["chain"] = denoise_chain(stacks, den, dev, failures)
    log(f"[denoise] chain: pool {result['chain']['pool_shape']} (bit-equal to the plain "
        f"build: {result['chain']['pool_bit_equal_plain']}, "
        f"{result['chain']['pool_entries_with_nan']} entries with NaN), factory x8 .npy "
        f"{result['chain']['patches']} patches, launches {result['chain']['launches']}, "
        f"lr max_abs_err {result['chain']['max_abs_err']:.3g}")
    timing = denoise_timing(stacks[:DN_BATCH], dev, card)
    _, _, _, secs2, stages2 = run_batch_denoise(stacks, dev)
    timing.update({"pipelined_run_s": secs2, "pipelined_stages_s": stages2,
                   "pipelined_mpix_per_s": DN_FILES * C * HW * HW / secs2 / 1e6})
    result["timing"] = timing
    log(f"[denoise] timing ({card}): chunk {timing['chunk']}: {timing['mpix_per_s']:.2f} "
        f"Mpix/s, wall {timing['wall_ms']:.3f} ms (windows "
        f"{[round(w, 3) for w in timing['wall_ms_windows']]}), dispatch "
        f"{timing['dispatch_ms']:.3f} ms, device {timing['device_ms']:.3f} ms (kernels "
        f"{timing['kernel_ms']:.3f}, copies {timing['copy_ms']:.3f}), busy share "
        f"{timing['busy_share']:.3f}, {timing['launches_per_chunk']:.0f} launches a chunk, "
        f"sigma pass {timing['sigma_ms']:.3f} ms ({timing['sigma_share']:.3%}), sweep "
        f"{timing['sweep_ms']:.3f} ms; spelling {timing['spelling_gb']:.1f} GB -> bound "
        f"{timing['spelling_bound_ms']:.3f} ms; fused floor {timing['fused_floor_ms']:.4f} "
        f"ms ({timing['fused_floor_by']}); peak memory {timing['peak_mem_gb']:.2f} GB; "
        f"whole {DN_FILES}-file pipelined run {secs2:.3f} s = "
        f"{timing['pipelined_mpix_per_s']:.2f} Mpix/s, stages {stages2}")
    torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    failures: list[str] = []
    t_start = time.perf_counter()
    try:
        import kmsr_tpu_torch  # noqa: F401  (fails outside the repository)

        dev = torch.device("cuda")
        card = torch.cuda.get_device_name(0)
        smi = nvidia_smi()
        log(smi)
        log(f"[device] ok: {card} x{torch.cuda.device_count()}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")
        phase_build()
        cases = phase_kernels(dev, failures)
        cases += phase_wide_kernels(dev, failures)
        log(f"[kernels] {'ok' if not failures else 'FAILED'}: {len(cases)} cases, "
            f"rtol={RTOL} atol={ATOL}")
        cases += phase_scene_kernels(dev, failures)
        log(f"[scene-kernels] {'ok' if not failures else 'FAILED'}, "
            f"rtol={RTOL} atol={ATOL}")
        factory_res = phase_factory(dev, failures)
        log(f"[factory] {'ok' if not failures else 'FAILED'}")
        scene_res = phase_scene(dev, failures)
        log(f"[scene] {'ok' if not failures else 'FAILED'}")
        api_res = phase_api(dev, failures)
        log(f"[api] {'ok' if not failures else 'FAILED'}")
        timing = phase_timing(dev, card)
        timing.update(phase_wide_timing(dev, card))
        timing.update(phase_scene_timing(dev, card))
        kernelgan_res = phase_kernelgan(dev, failures)
        kernelgan_res["nvidia_smi"] = smi
        log(f"[kernelgan] {'ok' if not failures else 'FAILED'}")
        t_dn = time.perf_counter()
        denoise_res = phase_denoise(dev, card, failures)
        denoise_res["nvidia_smi"] = smi
        log(f"[denoise] {'ok' if not failures else 'FAILED'} in "
            f"{time.perf_counter() - t_dn:.1f}s")
    except Exception:
        traceback.print_exc()
        return 1
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1

    # launches on each kernel's main-path run: the factory routes (x8
    # .npy and .nc; x2 .nc for v2, x2 small-patch .nc for v4), the public
    # calls of the api phase (v1, v3ps), the default scene route (one
    # 8192^2 scene, n_shards=1), the slab route
    launches = {r["kernel"]: r["launches"] for route, r in factory_res.items()
                if route in ("npy", "nc-device", "x2 nc-device", "x2 small nc-device")}
    launches.update({name: r["launches"] for name, r in api_res.items()})
    launches["colsplit_raw"] = scene_res["n_shards=1"]["launches"]
    launches["colsplit"] = scene_res["slab"]["launches"]
    main_layout = {"degrade_v3": "nchw", "degrade_v3psn": "presplit",
                   "degrade_v3ps": "presplit_halo", "degrade_v2": "nchw",
                   "degrade_v1": "chwb", "degrade_v4": "nchw",
                   "colsplit_raw": "scene", "colsplit": "scene"}
    records = []
    for name, layout in main_layout.items():
        t = timing[(name, layout)]
        mine = [c for c in cases if c["kernel"] == name]
        records.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["max_rel_err"] for c in mine),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call": "F.pad(replicate) + grouped strided F.conv2d "
                            "(TF32 off)" + (" + noise add" if layout != "scene" else ""),
            **{k: t[k] for k in ("device_ms", "device_ms_from", "device_kernels",
                                 "conv_only_ms", "matmul_ms", "call_ms",
                                 "operand_bound_ms", "banded_gflop",
                                 "instr_bound_ms") if k in t},
            "rtol": RTOL, "atol": ATOL, "timed_layout": t.get("layout", layout),
            "cases": mine,
            "other_layouts_ms": {lay: r["ms"] for (n, lay), r in timing.items()
                                 if n == name and lay != layout},
        })
    log(json.dumps({"factory": factory_res}))
    log(json.dumps({"scene": scene_res}))
    log(json.dumps({"api": api_res}))
    log(json.dumps({"kernelgan": kernelgan_res}))
    log(json.dumps({"denoise": denoise_res}))
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f}s")
    log(smi)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
