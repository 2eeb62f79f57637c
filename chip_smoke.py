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
   launch the kernel named; then one span past each old shared-memory
   limit that JAX's guards accept (`SPAN_CASES`: v3 NCHW at f=48, K=240;
   v3, v3psn and v3ps at f=40, K=200; v2 NCHW at f=2, K=152; v2 and v1
   CHWB at f=2, K=34), each planned as its kernel's global-read
   instantiation, launched once and bit-equal to its plain version;
4. scene-kernels: both instantiations of the scene stencil (raw rows +
   halos, `colsplit_raw`; halo-extended slab, `colsplit`) against their
   plain versions and the F.pad + grouped strided F.conv2d route at the
   scene path's full width (5x8192x8192, f=8, 13x13 blur, K=20) and at
   5x2048x2048, f=4 (K=16); the raw one with edge halos and as two slabs
   fed each other's real rows; each bit for bit (`bit_equal`); and both
   at f=4 with a 237x237 blur (K = 240, past the ring's old limit) on a
   5x64x256 slab through the global-read instantiation, bit for bit;
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
11. moe-dynamic: the two other kernel estimators and their routes, none of
   which launches a kernel of the table (JAX's are XLA: cuDNN convs and
   aten ops here; the eight launch counts are set to 0 before each route
   and must read 0 after it). (a) configs/quality_x4_moe.json's factory
   stage: `moe_batches` (the `--moe` route of `run_factory`, .npy input)
   at x4, batch 128, seed 42, on 256 seeded 5x256x256 patches with a
   [64, 5, 64, 64] pool and the committed model
   quality_run_r4/work_x4/kernel_run in eval mode; every lr against the
   port's CPU path with the card's experts (rtol 1e-4 / atol 1e-5), the
   experts equal to the CPU's except where the top-2 logit margin is
   under 1e-4 (each batch's smallest margin printed); `--moe-noise
   sigma`: finite, and the noise's std per (expert, band) within 10 % of
   softplus(sigma_bank); apply_kernel's device function (`make_degrader`)
   on one batch equal to the factory's lr minus its pool noise; a timed
   pass (patches/s, stage timers, peak memory). (b) `train_moe` at the
   config's widths (10 experts, 13x13, x4, batch 8, HR 256, real crops 64,
   the default D) on a seeded in-memory pool of 64 patches: 20 iterations
   with host batches, 40 with the device pool and 20 steps a call; finite
   losses, parameters moved, selections summing to 8, ten non-negative
   kernel_i.npy whose bands sum to 1 (1e-5), positive sigma_i.npy,
   moe_model.npz's names equal to the committed file's, the factory's
   loader reading it back. (c) `train_dynamic` at the defaults (mid_ch 32,
   ks 7,5,3,1,1,1, x8, batch 8, real crops 32): 20 iterations with host
   batches, 40 with 10 steps a call; finite CSV rows under DYN_LOG_HEADER,
   a non-negative [5,13,13] kernel_per_band.npy whose bands sum to 1 (or
   are all zero: a band the clamp zeroed, as the reference's extraction
   leaves it), kernel_merged.npy, one bulk-extracted kernel a pool entry;
   and the device time of G's forward + backward with the chain's
   activations channels_last and NCHW. For (b) and (c): iterations/s
   (median of 5 synchronized windows), the profiler's device time an
   iteration, busy share and the top device operations (K=1 runs). (d)
   one train step of each at full widths (batch 2) on the card, on the
   CPU and on the card in float64, from the same weights in the JAX
   layout with the same fixed draws: losses,
   selections / sigma / kernels (rtol 1e-4 / atol 1e-5), gradients (the
   scaled rule, or no further from the float64 step than twice the
   CPU's float32 distance from it) and the updated parameters (Adam's
   first-step bound, `adam_step_excess`).

12. sr: the SR family, which launches no kernel of the table either
   (JAX's SR is XLA convolutions and einsums: cuDNN / cuBLAS here; the
   eight launch counts are set to 0 before each route and must read 0
   after it), at configs/quality_x8.json's sr_train widths (x8, width 64,
   8 blocks, progressive). (a) The committed model
   quality_run_r4/work/sr_run/sr_model.npz at bench_sr.py's batch (128 x
   5x32x32 LR, 8.39 Mpix out) in bf16 and f32: f32 against the port's CPU
   forward on 2 samples (rtol 1e-4 / atol 1e-5, TF32 off; or no further
   from a float64 forward on the card than twice the CPU is), bf16 no
   further from the CPU's f32 than twice the CPU's own bf16 and within
   tests/test_sr.py's median relative bound (0.05); Mpix/s out (median of
   5 synchronized windows, with each window), the profiler's device time,
   busy share, top ops, peak memory, the conv FLOPs and the bound against
   the card's bf16 / f32 peak and HBM rate; the trunk's device time
   channels_last vs NCHW; oneshot at width 64 from a seeded init, timed.
   (b) `sr_scene` (tile 64, chunk 32, bf16) on an in-memory 5x1024x1024
   LR scene with NaN holes (5x8192x8192 out, 1.34 GB), one warm-up and
   two timed runs (Mpix/s out end to end, seconds by stage); the NaN
   footprint exact; a 5x96x160 NaN scene tiled vs untiled on the card in
   f32 (atol 2e-5 / rtol 1e-5, tests/test_sr_scene.py's), NaN cells
   identical. (c) `sr_infer`'s device loop (`run_batches`) on 256 seeded
   in-memory pairs in chunks of 128: every pair out, preds equal to a
   direct forward, PSNR/SSIM against the CPU's on two samples a chunk
   (rtol 1e-5 / atol 1e-5), a timed pass. (d) `train_sr` at the config's
   widths (batch 32, bf16, LR 32^2 -> HR 256^2) on 64 in-memory pairs,
   holdout 8, 20 iterations: the CSV, parameters moved, `sr_model.npz`'s
   names equal to the committed file's; iterations/s, device time, busy
   share, top ops, peak memory and the wall of a 20,000-iteration run; one
   full-width f32 step (batch 2, committed weights) card vs CPU, with the
   card's float64 gradients as the yardstick (loss rtol 1e-4, gradients
   the scaled rule or <= 2x the CPU's distance from float64, parameters
   Adam's first-step bound).

13. fleet: one KernelGAN per scene (`train.fleet`), which launches no
   kernel of the table (JAX's fleet is XLA; the eight counts are set to 0
   before each run and must read 0 after it). (a) configs/
   quality_x8_real_lr.json's train_kernel block through `train_fleet`
   (compose, real_is_lr, K = 20, batch 16, lr crops 32, raw_sum_reg 0.1,
   seed 0, sigma from `train_fleet_cli.fake_noise_sigma`, the CLI's
   `--fake-noise auto`) on 4 scenes of 64 seeded 5x256x256 HR and 64
   5x32x32 native-LR patches, 40 of its 2,000 iterations: every scene's
   files under the JAX package's names, 40 finite CSV rows, kernels >= 0
   with bands summing to 1 (or zeroed by the clamp); each scene equal to a
   1-scene fleet at seed s (kernels and CSV rows, rtol 1e-4 / atol 1e-5;
   measured bit for bit). (b) `train_fleet_cli.main --patch-root DIR
   --format npy` at the CLI's defaults (chain, K = 1, batch 16) on 2 scene
   dirs of 64 .npy patches, 20 iterations, each scene equal to the port's
   standalone `train_single_kernel` at seed s. Neither run is wrapped
   here: every trainer runs its steps under the package's
   `device.deterministic` on the card, and these runs are its proof.
   (c) `run_factory(kernel_root=(a)'s outdir)` on 5 scenes x 64 .npy
   patches `<scene>_<gi>_<gj>.npy` (the fifth without a kernel), pool
   [64, 5, 32, 32], x8, batch 128, its .nc
   writes captured in memory (no h5py there): one `degrade_v3psn` launch
   a scene batch and no other degrade kernel, every lr against the plain
   degrade(hr, kernel_s) + pool[idx] with idx from `scene_seed(42, s)`
   (rtol 1e-4 / atol 1e-5), the fifth scene failed as a unit. Timing: the
   fleet loop (`train.fleet.make_fleet_advance`) at S = 1 and 2 for (a)
   and S = 2 for (b): scene-iterations/s (median of 5 synchronized
   windows), device ms an iteration of all scenes, busy share, peak
   memory.

   Phases 9, 11 (b)/(c), 12 (d) and 13 (but (a) at S = 2, which runs as
   the package runs it only) time each trainer's step twice in
   one process, as the package runs it (deterministic algorithms) and
   without them (`with_and_without`), and print what determinism costs.

14. oracle: the known-kernel deconvolution oracle (`analysis.oracle`,
   plain PyTorch: cuDNN convs, their vjp, torch.fft; it launches no kernel
   of the table, and the eight counts must read 0 after each run) at
   scripts/quality_report.py's width (--holdout 24, x8): 24 seeded HR
   5x256x256 patches, the fresh generator's 13x13 sigma=2 kernel, LR =
   degrade + a seeded draw from a [64, 5, 32, 32] N(0, 0.05) pool; (a)
   `oracle_sweep(prior="grad")`, 8 lams, 100 CG iterations, one chunk of
   24; (b) prior="matched", 4 lams, the pool's per-band variance and 16
   more patches' spectrum; (c) per-sample kernels at x4 (each patch one of
   the committed quality_run_r4/work_x4/kernel_run kernels, by a seeded
   draw). Each: predictions finite; seconds a lam, CG iterations to the
   stop, wall and device ms an iteration of one lam's solve, busy share,
   peak memory; and, on the first 3 patches (the CPU's sweep at the full
   chunk would take minutes), the card against the port's CPU run: the
   same chosen lam, every lam's mean PSNR within 0.01 dB, the same CG stop
   iterations, and the card's predictions no further from a float64 solve
   on the card (same iterations) than twice the CPU's are.

15. parallel: the multi-card layer (`parallel.local_dp`, `parallel.mesh`)
   on one card. (a) Local DP over the card list (`local_batch_dp`: one card
   here, n_dev = 1) and over [cuda:0, cuda:0] (two blocks on the one card:
   the multi-card code path of pad_put / local_map / gather): the factory's
   .npy route (`presplit_batches`, 256 5x256x256 patches, x8, batch 128:
   one `degrade_v3psn` launch a batch, two with two blocks), the NLM chunk
   (8 of phase 10's files), `sr_infer.run_batches` (24 pairs at the x8
   model's width) and apply_kernel's device part (`make_degraders`,
   `degrade_group`, 24 patches), each against its plain one-device
   computation in this process: bit for bit on the card list; with two
   blocks bit for bit (factory, NLM) or, where cuDNN may pick another
   algorithm for the half batch, at the tolerance (apply_kernel's strided
   conv, SR's metrics) and by phase 12's bf16 rule (SR's predictions no
   further from the f32 forward than twice the whole batch's bf16 are).
   (b) An in-process NCCL group of world size 1 (`init_process_group(
   "nccl", store=HashStore(), rank=0, world_size=1)`, destroyed at the
   end) and its 'data' mesh: the whole scene through the ranks path
   (`parallel.spatial.degrade_scene(mesh=)`) at 5x8192x8192, one
   `colsplit_raw` launch, bit-equal to the n_shards = 1 path; the NaN-aware
   stage code (`degrade_scene_ranks`, band means all-reduced) against
   `degrade_scene_file` at the tolerance, NaN cells identical; each trainer
   for 4 steps with the mesh and without it, host batches both
   (KernelGAN chain and compose with fake-side noise and SR through
   `train_single_kernel` / `train_sr`, MoE with the load-balance loss and
   dynamic through their CLIs with --data-parallel on .npy patches), every
   parameter, BatchNorm statistic and artifact bit for bit; the fleet with
   a 'scene' mesh at S = 2 against the fleet without one, every scene's
   artifacts byte for byte. Timing: each trainer's step at its default
   widths with and without the mesh (iterations/s, median of 5
   synchronized windows of 6 steps, alternating). The card proves world
   size 1 only; worlds of 2-4 ranks are held on the CPU with gloo
   (tests/test_torch_dp_train.py, tests/test_torch_spatial_ranks.py).

16. tools: the last modules of the JAX package (none launches a kernel of
   the table but the factory; each part's eight counts are set to 0
   before it and read after it). (a) The device-sync watchdog
   (`pipeline.common.SyncWatchdog`, thresholds and abort at 0.05 s) around
   a sync on a ~0.5 s `torch.cuda._sleep` kernel: its recorded event is
   pending, so it logs "still running queued work" and never aborts; then
   the factory's .npy route (`run_factory`, 256 seeded 5x256x256 patches,
   x8, batch 128, its .nc writes captured in memory) with `sync_watch`
   armed at JAX's defaults (120 s, poll 30 s, abort 900 s) and with
   KMSR_SYNC_WATCHDOG=0: lr bit-equal, one `degrade_v3psn` launch a batch
   each. (b) Tensor parallelism (`parallel.gan_sharding`) on a (1, 1)
   (data, model) mesh over an in-process NCCL group of world size 1:
   KernelGAN at the default widths (phase 15's; chain, and compose with
   fake-side noise), 2 steps of `make_train_step` on the sharded state
   inside `data_parallel(mesh)` against 2 plain steps under the
   deterministic algorithms, parameters, D state, Adam moments and metrics
   bit for bit; the torch.distributed calls of one TP step by axis; TP /
   plain wall (median of 5 windows of 3 steps). (c)
   `scripts/torch_quality_report.evaluate` at configs/quality_x8.json's
   width with the committed quality_run_r4/work/sr_run/sr_model.npz on
   24 NaN-free 5x256x256 patches of scripts/torch_make_quality_scenes.py's
   seeded 896x896 scenes (x8, LR = degrade with the sigma = 2 kernel + a
   draw of a pool at the scenes' sensor noise; 16 more patches for the
   matched prior's spectrum), SR in float32, both oracle priors at 100 CG
   iterations; then on the first 3 holdout pairs on the card and on the
   CPU: each pair's PSNR/SSIM within rtol 1e-5 / atol 1e-5 (phase 12 (c))
   and the same lam with every lam's mean PSNR within 0.01 dB (phase 14).

inspect_nc, data_stats, viz_cli and make_train_data --vis-dir are host
h5py / matplotlib code (no h5py on the card's machine); the CPU tests
(tests/test_torch_analysis_tools.py) hold them against JAX, and no phase
drives them.

Prints one JSON line {"factory": {...}} (per-route results), one
{"scene": {...}}, one {"api": {...}}, one {"kernelgan": {...}}, one
{"denoise": {...}}, one {"moe_dynamic": {...}}, one {"sr": {...}}, one
{"fleet": {...}}, one {"oracle": {...}}, one {"parallel": {...}}, one
{"tools": {...}}, then the card's nvidia-smi line, one JSON line
{"kernels": [...]} (each kernel's `launches` on the main path above,
`parallel_launches` on phase 15's local-DP factory route and ranks scene
route, `tools_launches` on phase 16's three parts) and, last,
{"ok": true, "device": {...}}. Any mismatch or error in any phase, timing
included, exits non-zero before that last line.
"""
from __future__ import annotations

import contextlib
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


def layout_inputs(img, noise, factor, layout, dtype, kside=None):
    """(x, noise) for one entry point's layout; kside, the composed span,
    sets the baked-halo layout's halo depth (default: a 13x13 blur's)."""
    from kmsr_tpu_torch.ops.degrade_fused import col_halo, phase_split_chwb

    x = img.to(dtype)
    if layout == "nchw":
        return x, noise.permute(3, 0, 1, 2).contiguous()
    x = x.permute(1, 2, 3, 0).contiguous()
    if layout == "presplit":
        x = phase_split_chwb(x, factor).contiguous()
    elif layout == "presplit_halo":
        m = col_halo(kside or KSIZE + factor - 1, factor)
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


#: spans past the shared-memory plans (each planner's old refusal), which
#: JAX's guards accept (v3: K <= 5f; v2/v1: any span; the scene:
#: `_check_span`): (kernel, version, layout, factor, blur side, patch
#: side, batch), each taking its kernel's global-read instantiation
SPAN_CASES = [
    ("degrade_v3", None, "nchw", 48, 193, 96, 4),              # K = 240 > 236
    ("degrade_v3", 3, "chwb", 40, 161, 80, 8),                 # K = 200 > 184
    ("degrade_v3psn", None, "presplit", 40, 161, 80, 8),
    ("degrade_v3ps", None, "presplit_halo", 40, 161, 240, 8),
    ("degrade_v2", None, "nchw", 2, 151, 64, 4),               # K = 152 > 150
    ("degrade_v2", 2, "chwb", 2, 33, 64, 8),                   # K = 34 > 32
    ("degrade_v1", 1, "chwb", 2, 33, 64, 8),
]


def phase_span_kernels(dev, failures: list) -> list:
    """One span past each old shared-memory limit of the ring and wide
    kernels: the planner returns the global-read plan, the entry point
    launches the kernel named once, and the output is bit-equal to its
    plain version (float32, with noise)."""
    import torch

    from kmsr_tpu_torch import kernels

    gen = torch.Generator().manual_seed(SEED + 13)
    cases = []
    for name, version, layout, factor, k, hw, b in SPAN_CASES:
        img = (torch.randn(b, C, hw, hw, generator=gen) * 2 + 5).to(dev)
        kernel = (torch.rand(C, k, k, generator=gen) * 0.9 + 0.1).to(dev)
        noise = (torch.randn(C, hw // factor, hw // factor, b, generator=gen) * 0.1).to(dev)
        kside = k + factor - 1
        plan = (kernels.wide_tiles(layout, kside, factor, hw) if name in
                ("degrade_v2", "degrade_v1")
                else kernels.stencil_tiles(layout, kside, factor, hw, hw, b))
        x, n = layout_inputs(img, noise, factor, layout, torch.float32, kside)
        fused, ref = entry(layout, version)
        kernels.reset_launches()
        got = fused(x, kernel, n, factor=factor)
        launched = dict(kernels.LAUNCHES)
        want = ref(x, kernel, n, factor=factor)
        torch.cuda.synchronize()
        case = {"kernel": name, "layout": layout, "factor": factor, "span": kside,
                "shape": [b, C, hw, hw], "noise": True, "dtype": "float32",
                "plan": list(plan), **errors(got, want),
                "bit_equal": bool(torch.equal(got, want)), "span_case": True}
        direct = tuple(plan) in (kernels.RING_DIRECT, kernels.WIDE_DIRECT)
        once = launched[name] == 1 and sum(launched.values()) == 1
        case["ok"] = case["ok"] and case["bit_equal"] and direct and once
        cases.append(case)
        log(f"[kernels] span {name} {layout} f={factor} K={kside} {b}x{C}x{hw}x{hw}: "
            f"{'ok' if case['ok'] else 'MISMATCH'} plan={plan} launches={launched} "
            f"max_abs={case['max_abs_err']:.3g} bit_equal={case['bit_equal']}")
        if not case["ok"]:
            failures.append(f"span case {case}")
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
    return cases + scene_span_cases(dev, failures)


def scene_span_cases(dev, failures: list) -> list:
    """A span past the scene ring's old shared-memory limit (f=4, a 237x237
    blur: K = 240 > 236, which JAX's `_check_span` accepts) on a 5x64x256
    slab, raw rows and extended slab: the global-read plan, one launch
    each, bit-equal to the plain version."""
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.ops import degrade_scene_fast as sf
    from kmsr_tpu_torch.ops.degrade import compose_with_box, normalize_kernel

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    factor, hs, w, k = 4, 64, 256, 237
    x = torch.randn(SCENE_C, hs, w, generator=gen, device=dev) * 2 + 5
    comp = compose_with_box(normalize_kernel(
        torch.rand(SCENE_C, k, k, generator=gen, device=dev) * 0.9 + 0.1), factor).contiguous()
    ksize = comp.shape[-1]
    th, bh = sf.halo_rows(factor, ksize)
    top, bot = x[:, :1].expand(-1, th, -1), x[:, -1:].expand(-1, bh, -1)
    x_ext = sf.extend_rows_edge(x, factor, ksize)
    plan = kernels.scene_tiles(ksize, factor, hs, w)
    cases = []
    for name, fused, ref in (
            ("colsplit_raw", lambda: sf.degrade_rows_fast(x, comp, factor, top, bot),
             lambda: sf.degrade_rows_fast_ref(x, comp, factor, top, bot)),
            ("colsplit", lambda: sf.degrade_slab_fast(x_ext, comp, factor),
             lambda: sf.degrade_slab_fast_ref(x_ext, comp, factor))):
        kernels.reset_launches()
        got = fused()
        launched = dict(kernels.LAUNCHES)
        want = ref()
        torch.cuda.synchronize()
        case = {"kernel": name, "halos": "span case", "shape": [SCENE_C, hs, w],
                "factor": factor, "span": ksize, "plan": list(plan),
                **errors(got, want), "bit_equal": bool(torch.equal(got, want)),
                "span_case": True}
        once = launched[name] == 1 and sum(launched.values()) == 1
        case["ok"] = (case["ok"] and case["bit_equal"] and once
                      and tuple(plan) == kernels.RING_DIRECT)
        cases.append(case)
        log(f"[scene-kernels] span {name} {SCENE_C}x{hs}x{w} f={factor} K={ksize}: "
            f"{'ok' if case['ok'] else 'MISMATCH'} plan={plan} launches={launched} "
            f"max_abs={case['max_abs_err']:.3g} bit_equal={case['bit_equal']}")
        if not case["ok"]:
            failures.append(f"scene span case {case}")
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
            rec = with_and_without(lambda: kernelgan_timing(configs[name][0], pool, dev))
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
                            for o in rec["top_ops"][:6])
                + det_note(rec))
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


#: the MoE / dynamic phase (configs/quality_x4_moe.json's stages): the
#: committed x4 model, 256 seeded 5x256x256 patches in 128-patch batches,
#: a [64, 5, 64, 64] pool; training at the config's widths (10 experts,
#: 13x13, x4, batch 8, HR 256, real crops 64) and the dynamic model at its
#: defaults (mid_ch 32, ks 7,5,3,1,1,1, x8, batch 8, real crops 32), each
#: on a seeded in-memory pool of 64 patches
MOE_MODEL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quality_run_r4",
                         "work_x4", "kernel_run")
MOE_FACTOR, MOE_FILES, MOE_POOL_N, MOE_SEED = 4, 256, 64, 42
MD_POOL_N, MD_WINDOWS, MD_WINDOW_ITERS, MD_OPS_ITERS = 64, 5, 5, 1
#: two experts whose logits lie closer than this may swap between devices
MOE_MARGIN_TIE = 1e-4
#: --moe-noise sigma: the noise's std per (expert, band) vs softplus(sigma_bank)
MOE_SIGMA_STD_REL = 0.10


def moe_patch_files(tmp: str) -> tuple[list, str]:
    """MOE_FILES seeded .npy patches, each band with its own contrast and
    offset (so the selector spreads them over several experts), and the
    noise pool."""
    import numpy as np

    rng = np.random.default_rng(SEED + 11)
    files = []
    for i in range(MOE_FILES):
        path = os.path.join(tmp, f"patch_{i:04d}.npy")
        a = rng.normal(0, 1, (C, HW, HW)) * rng.uniform(0.2, 3, (C, 1, 1)) \
            + rng.uniform(0, 10, (C, 1, 1))
        np.save(path, a.astype(np.float32))
        files.append(path)
    pool_path = os.path.join(tmp, "pool.npy")
    oh = HW // MOE_FACTOR
    np.save(pool_path, rng.normal(0, 0.1, (MOE_POOL_N, C, oh, oh)).astype(np.float32))
    return files, pool_path


def drain(batches, on_batch) -> float:
    """Consume a factory generator as run_factory does (batch k synchronized
    after batch k+1 was dispatched), calling on_batch(paths, hr, lr,
    experts) with lr and experts on the host; returns the seconds."""
    import torch

    from kmsr_tpu_torch.utils.profiling import stage_timer

    def sync(paths, hr, lr, experts):
        with stage_timer("factory.device_sync"):
            lr, experts = lr.cpu(), experts.cpu()
        on_batch(paths, hr, lr, experts)

    t0 = time.perf_counter()
    pending = None
    for paths, hr, lr, experts, fails in batches:
        if fails:
            raise RuntimeError(f"per-file failures {fails}")
        if pending is not None:
            sync(*pending)
        pending = (paths, hr, lr, experts)
    if pending is not None:
        sync(*pending)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def no_kernel_launched(label: str, failures: list) -> None:
    from kmsr_tpu_torch import kernels

    launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
    if launched:
        failures.append(f"{label}: launched degrade kernels {launched}")


def moe_factory(dev, failures: list) -> dict:
    """(a): the x4 factory's MoE route with the committed model (eval mode),
    every lr against the port's CPU path, the sigma-noise route's
    statistics, apply_kernel's device function, and the timing."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.models.moe import effective_kernels, effective_sigmas
    from kmsr_tpu_torch.ops.degrade import degrade_batch_kernels
    from kmsr_tpu_torch.pipeline import apply_kernel, factory
    from kmsr_tpu_torch.utils.profiling import timing_report

    tmp = tempfile.mkdtemp(prefix="kmsr_chip_moe_")
    try:
        t0 = time.perf_counter()
        files, pool_path = moe_patch_files(tmp)
        log(f"[moe-dynamic] wrote {len(files)} patches in {time.perf_counter() - t0:.1f}s")
        pool, noise_of = factory.noise_inputs(files, pool_path, seed=MOE_SEED)
        model = factory.load_moe_for_factory(MOE_MODEL, dev)
        cpu_model = factory.load_moe_for_factory(MOE_MODEL, "cpu")
        cpu_banks = effective_kernels(cpu_model[0])
        if not (model[2] and cpu_model[2]):
            failures.append("moe factory: the committed model did not load in eval mode")

        def make(moe_noise):
            return factory.moe_batches(files, model, pool, noise_of, factor=MOE_FACTOR,
                                       batch_size=B, seed=MOE_SEED, moe_noise=moe_noise,
                                       input_format="npy", device=dev)

        res = {"patches": len(files), "batch": B, "factor": MOE_FACTOR,
               "pool": list(pool.shape), "eval_mode": bool(model[2]),
               "min_top2_margin": [], "experts_differ": 0, "experts_differ_at_ties": 0,
               "expert_counts": [0] * int(cpu_banks.shape[0]), "max_abs_err": 0.0}
        first = {}

        def check(paths, hr, lr, experts):
            hr_c = torch.from_numpy(hr)
            logits = factory.moe_logits(cpu_model, hr_c)
            top2 = logits.topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            res["min_top2_margin"].append(float(margin.min()))
            differ = experts != logits.argmax(-1)
            res["experts_differ"] += int(differ.sum())
            res["experts_differ_at_ties"] += int((differ & (margin < MOE_MARGIN_TIE)).sum())
            for e in experts.tolist():
                res["expert_counts"][e] += 1
            # the CPU blur with the card's experts (a tie may pick either)
            want = degrade_batch_kernels(hr_c, cpu_banks[experts], factor=MOE_FACTOR,
                                         decimate=False, padding="replicate") \
                + torch.from_numpy(pool[[noise_of[p] for p in paths]])
            e = errors(lr, want)
            res["max_abs_err"] = max(res["max_abs_err"], e["max_abs_err"])
            if not e["ok"] or not bool(torch.isfinite(lr).all()):
                failures.append(f"moe factory: lr vs the CPU path {e}")
            if not first:
                first.update(hr=hr, lr=lr, experts=experts, paths=paths)

        kernels.reset_launches()
        drain(make("pool"), check)
        no_kernel_launched("moe factory (pool noise)", failures)
        if res["experts_differ"] != res["experts_differ_at_ties"]:
            failures.append(f"moe factory: experts differ from the CPU's off ties: {res}")

        # apply_kernel --moe's device function on the first batch
        fn, _ = apply_kernel.make_degrader(None, MOE_MODEL, MOE_FACTOR, dev)
        kernels.reset_launches()
        out_a, ex_a = fn(torch.from_numpy(first["hr"]).to(dev))
        no_kernel_launched("apply_kernel --moe", failures)
        noise = torch.from_numpy(pool[[noise_of[p] for p in first["paths"]]])
        e = errors(out_a.cpu(), first["lr"] - noise)
        res["apply_kernel_vs_factory"] = e
        if not e["ok"] or not torch.equal(ex_a.cpu(), first["experts"]):
            failures.append(f"apply_kernel --moe vs the factory's noise-free lr: {e}")

        # --moe-noise sigma: finite; the noise's std per (expert, band)
        sig = effective_sigmas(model[0]).detach().cpu().double()
        sq = torch.zeros_like(sig)
        cnt = torch.zeros(sig.shape[0], dtype=torch.float64)

        def sigma_check(paths, hr, lr, experts):
            if not bool(torch.isfinite(lr).all()):
                failures.append("moe factory sigma: non-finite lr")
            clean, _ = factory.moe_degrade(model, torch.from_numpy(hr).to(dev), MOE_FACTOR)
            r = (lr - clean.cpu()).double()
            sq.index_add_(0, experts, r.pow(2).sum(dim=(2, 3)))
            cnt.index_add_(0, experts, torch.full((len(paths),), float(r[0, 0].numel()),
                                                  dtype=torch.float64))

        kernels.reset_launches()
        drain(make("sigma"), sigma_check)
        no_kernel_launched("moe factory (sigma noise)", failures)
        used = cnt > 0
        ratio = (sq[used] / cnt[used, None]).sqrt() / sig[used]
        res["sigma_std_over_sigma"] = [float(ratio.min()), float(ratio.max())]
        if float((ratio - 1).abs().max()) > MOE_SIGMA_STD_REL:
            failures.append(f"moe factory sigma: std / sigma {res['sigma_std_over_sigma']}")

        # timing: one unchecked pass, stage timers, peak memory
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        timing_report(reset=True)
        secs = drain(make("pool"), lambda *a: None)
        res["timing"] = {
            "seconds": secs, "patches_per_s": len(files) / secs,
            "stages_s": {k: r["total_s"] for k, r in timing_report(reset=True).items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        hr_dev = torch.from_numpy(first["hr"]).to(dev)
        blur = lambda: factory.moe_degrade(model, hr_dev, MOE_FACTOR)  # noqa: E731
        res["timing"]["batch_device"] = device_time(blur)
        log(f"[moe-dynamic] (a) factory x{MOE_FACTOR} --moe {MOE_MODEL} (eval mode "
            f"{res['eval_mode']}): {len(files)} patches, lr vs CPU max_abs_err "
            f"{res['max_abs_err']:.3g}, experts {res['expert_counts']}, differ "
            f"{res['experts_differ']} (at ties {res['experts_differ_at_ties']}), "
            f"smallest top-2 margin per batch {[round(m, 6) for m in res['min_top2_margin']]}; "
            f"apply_kernel vs factory {res['apply_kernel_vs_factory']['max_abs_err']:.3g}; "
            f"sigma noise std/sigma {res['sigma_std_over_sigma']}; timed pass "
            f"{secs:.3f}s = {res['timing']['patches_per_s']:.1f} patches/s, stages "
            f"{res['timing']['stages_s']}, peak {res['timing']['peak_mem_gb']:.2f} GB; one "
            f"batch's selection + blur {res['timing']['batch_device']}")
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def training_timing(one_call, k: int, top_ops: bool = True) -> dict:
    """Iterations/s of a train-step closure (k steps a call; median of
    MD_WINDOWS synchronized windows of >= MD_WINDOW_ITERS iterations after
    one warm-up call), the profiler's device time an iteration over one
    window, the busy share and, with top_ops, the top device operations of
    MD_OPS_ITERS iterations; with the seconds each part took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kmsr_tpu_torch.utils.profiling import cuda_device_ms

    calls = -(-MD_WINDOW_ITERS // k)
    t_start = time.perf_counter()
    one_call()
    walls = []
    for _ in range(MD_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            one_call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / (calls * k))
    wall = sorted(walls)[len(walls) // 2]
    t_windows = time.perf_counter()
    dev_ms = cuda_device_ms(one_call, runs=calls, warmup=0)["device_ms"] / k
    t_device = time.perf_counter()
    ops = []
    if top_ops:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            for _ in range(MD_OPS_ITERS):
                one_call()
            torch.cuda.synchronize()
        for ev in prof.key_averages(group_by_input_shape=True):
            us = getattr(ev, "self_device_time_total", None)
            us = us if us is not None else getattr(ev, "self_cuda_time_total", 0)
            if us > 0 and ev.key.startswith("aten::"):
                ops.append({"op": ev.key, "shapes": str(ev.input_shapes)[:160],
                            "device_ms_per_iter": us / 1e3 / (MD_OPS_ITERS * k),
                            "calls_per_iter": ev.count / (MD_OPS_ITERS * k)})
        ops.sort(key=lambda o: -o["device_ms_per_iter"])
    return {"iters_per_s": 1.0 / wall, "wall_ms_per_iter": wall * 1e3,
            "wall_ms_per_iter_windows": [w * 1e3 for w in walls],
            "window_iters": calls * k, "device_ms_per_iter": dev_ms,
            "busy_share": dev_ms / (wall * 1e3), "top_ops": ops[:10],
            "seconds": {"windows": t_windows - t_start, "device_ms": t_device - t_windows,
                        "top_ops": time.perf_counter() - t_device}}


def with_and_without(time_it) -> dict:
    """time_it() as the package's trainers run their steps on the card
    (under `device.deterministic`, the default since the analysis slice)
    and, for what that costs, without it, in one process: the first record,
    with the second's rates under "without_deterministic" and
    "deterministic_cost" (iterations/s without over with)."""
    from kmsr_tpu_torch.device import deterministic

    free = time_it()
    with deterministic("cuda"):
        det = time_it()
    det["without_deterministic"] = {k: free[k] for k in (
        "iters_per_s", "scene_iters_per_s", "wall_ms_per_iter", "device_ms_per_iter",
        "busy_share") if k in free}
    det["deterministic_cost"] = free["iters_per_s"] / det["iters_per_s"]
    return det


def det_note(t: dict) -> str:
    w = t["without_deterministic"]
    scene = (f"{w['scene_iters_per_s']:.2f} scene-it/s, " if "scene_iters_per_s" in w else "")
    return (f"; without deterministic algorithms {scene}{w['iters_per_s']:.2f} it/s, device "
            f"{w['device_ms_per_iter']:.3f} ms/it, busy {w['busy_share']:.3f} (cost "
            f"x{t['deterministic_cost']:.3f})")


def timing_line(label: str, t: dict) -> str:
    return (f"{label}: {t['iters_per_s']:.2f} it/s (median of {MD_WINDOWS} windows of "
            f"{t['window_iters']}, {t['wall_ms_per_iter']:.3f} ms/it, windows "
            f"{[round(w, 3) for w in t['wall_ms_per_iter_windows']]}), device "
            f"{t['device_ms_per_iter']:.3f} ms/it, busy {t['busy_share']:.3f}; seconds "
            f"{ {p: round(v, 1) for p, v in t['seconds'].items()} }; top ops: "
            + "; ".join(f"{o['op']} {o['shapes'][:50]} {o['device_ms_per_iter']:.3f} ms"
                        for o in t["top_ops"][:5]))


def moe_training(pool, dev, failures: list) -> dict:
    """(b): `train_moe` at the x4 config's widths, host batches (K=1) and
    the device pool with 20 steps a call; artifacts checked, then timed."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.pipeline.factory import load_moe_for_factory
    from kmsr_tpu_torch.train.moe import (MoETrainConfig, init_moe_training,
                                          make_moe_train_step, train_moe)
    from kmsr_tpu_torch.train.single_kernel import make_batch_source
    from kmsr_tpu_torch.train.state import tree_leaves

    committed = np.load(os.path.join(MOE_MODEL, "moe_model.npz"))
    committed_names = [str(committed[f]) for f in sorted(committed.files)
                       if f.startswith("name_")]
    tmp = tempfile.mkdtemp(prefix="kmsr_chip_moe_train_")
    res = {"runs": {}, "timing": {}}
    try:
        cfgs = {
            "host_k1": MoETrainConfig(iters=20, device_pool=False, log_every=10,
                                      outdir=os.path.join(tmp, "host"), verbose=False,
                                      seed=SEED),
            "pool_k20": MoETrainConfig(iters=40, device_pool=True, steps_per_call=20,
                                       log_every=20, outdir=os.path.join(tmp, "pool"),
                                       verbose=False, seed=SEED),
        }
        for name, cfg in cfgs.items():
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = train_moe(pool, cfg, progress=False, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            no_kernel_launched(f"moe training {name}", failures)
            init = init_moe_training(cfg, device=dev)
            moved = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(
                tree_leaves(out["state"].g_params), tree_leaves(init.g_params)))
            ks = [np.load(os.path.join(cfg.outdir, f"kernel_{i}.npy")) for i in range(10)]
            sg = [np.load(os.path.join(cfg.outdir, f"sigma_{i}.npy")) for i in range(10)]
            saved = np.load(os.path.join(cfg.outdir, "moe_model.npz"))
            names = [str(saved[f]) for f in sorted(saved.files) if f.startswith("name_")]
            loaded = load_moe_for_factory(cfg.outdir, dev)
            checks = {
                "losses_finite": all(np.isfinite(d) for _, d, _ in out["history"]),
                "params_moved": moved > 0,
                "selection_sums": all(int(s.sum()) == cfg.batch_size
                                      for _, _, s in out["history"]),
                "kernels": all(k.shape == (C, KSIZE, KSIZE) and (k >= 0).all()
                               and np.abs(k.sum(axis=(1, 2)) - 1).max() <= 1e-5 for k in ks),
                "sigmas": all(s.shape == (C,) and (s > 0).all() for s in sg),
                "npz_names_as_committed": names == committed_names,
                "factory_loader_reads_it": bool(loaded[2]) and tuple(
                    loaded[0]["kernel_bank"].shape) == (10, C, KSIZE, KSIZE),
            }
            bad = [k for k, ok in checks.items() if not ok]
            if bad:
                failures.append(f"moe training {name}: failed checks {bad}")
            res["runs"][name] = {"iters": cfg.iters, "seconds_with_setup": secs,
                                 "checks_failed": bad, "max_param_move": moved,
                                 "history": [(i, d, s.tolist()) for i, d, s in out["history"]]}
            log(f"[moe-dynamic] (b) moe training {name}: "
                f"{'ok' if not bad else 'FAILED ' + str(bad)} {cfg.iters} iterations in "
                f"{secs:.2f}s; history {res['runs'][name]['history']}")
        for name, cfg in cfgs.items():
            k = cfg.steps_per_call
            step_fn = make_moe_train_step(cfg, device_pool=bool(cfg.device_pool))
            state = init_moe_training(cfg, device=dev)
            draw = make_batch_source(cfg, pool, None, bool(cfg.device_pool),
                                     np.random.default_rng(cfg.seed), dev)
            temps = np.linspace(cfg.temp_start, cfg.temp_end, cfg.iters).astype(np.float32)

            def one_call():
                nonlocal state
                state, _ = step_fn(state, *draw(), temps[:k] if k > 1 else temps[0])

            res["timing"][name] = with_and_without(
                lambda: training_timing(one_call, k, top_ops=k == 1))
            log("[moe-dynamic] (b) timing " + timing_line(name, res["timing"][name])
                + det_note(res["timing"][name]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def dynamic_training(pool, dev, failures: list) -> dict:
    """(c): `train_dynamic` at the defaults, host batches (K=1) and the
    device pool with 10 steps a call; artifacts and bulk extraction
    checked; both activation layouts timed."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.models import dynamic
    from kmsr_tpu_torch.ops.degrade import fp32_convs
    from kmsr_tpu_torch.train.dynamic import (DYN_LOG_HEADER, DynamicTrainConfig,
                                              bulk_extract_kernels,
                                              init_dynamic_training,
                                              make_dynamic_train_step, train_dynamic)
    from kmsr_tpu_torch.train.single_kernel import make_batch_source
    from kmsr_tpu_torch.utils.profiling import cuda_device_ms

    tmp = tempfile.mkdtemp(prefix="kmsr_chip_dynamic_")
    res = {"runs": {}, "timing": {}}
    try:
        cfgs = {
            "host_k1": DynamicTrainConfig(iters=20, device_pool=False, log_every=10,
                                          kernel_log_every=10, verbose=False, seed=SEED,
                                          outdir=os.path.join(tmp, "host")),
            "pool_k10": DynamicTrainConfig(iters=40, device_pool=True, steps_per_call=10,
                                           log_every=10, kernel_log_every=10, verbose=False,
                                           seed=SEED, outdir=os.path.join(tmp, "pool")),
        }
        for name, cfg in cfgs.items():
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = train_dynamic(pool, cfg, progress=False, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            per_patch = bulk_extract_kernels(out["state"].g_params, pool,
                                             os.path.join(cfg.outdir, "per_patch"), cfg.model)
            no_kernel_launched(f"dynamic training {name}", failures)
            rows = open(out["log_file"]).read().splitlines()
            vals = np.array([[float(v) for v in r.split(",")] for r in rows[1:]])
            k = np.load(os.path.join(cfg.outdir, "final_results", "kernel_per_band.npy"))
            merged = os.path.join(cfg.outdir, "final_results", "kernel_merged.npy")
            checks = {
                "header": rows[0] == DYN_LOG_HEADER.strip(),
                "rows": vals.shape[0] == cfg.iters
                        and vals[:, 0].tolist() == list(range(1, cfg.iters + 1)),
                "finite": bool(np.isfinite(vals).all()),
                "kernel_shape": k.shape == (C, KSIZE, KSIZE),
                "kernel_nonneg": bool((k >= 0).all()),
                # a band the clamp zeroed stays all zero (the reference's
                # extraction); every other band sums to 1
                "band_sums": bool(all(abs(t - 1) <= 1e-5 or (t == 0 and not band.any())
                                      for t, band in zip(k.sum(axis=(1, 2)), k))),
                "merged": os.path.exists(merged) and bool(np.allclose(
                    np.load(merged), k.mean(axis=0), rtol=0, atol=1e-7)),
                "bulk_extract": len(per_patch) == len(pool) and all(
                    np.load(p).shape == (C, KSIZE, KSIZE) for p in per_patch[:3]),
            }
            bad = [c for c, ok in checks.items() if not ok]
            if bad:
                failures.append(f"dynamic training {name}: failed checks {bad}")
            res["runs"][name] = {"iters": cfg.iters, "seconds_with_setup": secs,
                                 "checks_failed": bad, "last_row": rows[-1],
                                 "band_sums": k.sum(axis=(1, 2)).tolist(),
                                 "bands_zeroed_by_the_clamp": int((k.sum(axis=(1, 2)) == 0).sum())}
            log(f"[moe-dynamic] (c) dynamic training {name}: "
                f"{'ok' if not bad else 'FAILED ' + str(bad)} {cfg.iters} iterations in "
                f"{secs:.2f}s; last row {rows[-1]}; band sums "
                f"{res['runs'][name]['band_sums']}; {len(per_patch)} per-patch kernels")
        for name, cfg in cfgs.items():
            k = cfg.steps_per_call
            step_fn = make_dynamic_train_step(cfg, device_pool=bool(cfg.device_pool))
            state = init_dynamic_training(cfg, device=dev)
            draw = make_batch_source(cfg, pool, None, bool(cfg.device_pool),
                                     np.random.default_rng(cfg.seed), dev)

            def one_call():
                nonlocal state
                state, _ = step_fn(state, *draw())

            res["timing"][name] = with_and_without(
                lambda: training_timing(one_call, k, top_ops=k == 1))
            log("[moe-dynamic] (c) timing " + timing_line(name, res["timing"][name])
                + det_note(res["timing"][name]))
        # the chain's activation layout: device ms of G's forward + backward
        # at the training batch, each way
        cfg = cfgs["host_k1"]
        g = init_dynamic_training(cfg, device=dev).g_params["generator"]
        hr = torch.from_numpy(pool.patches[:cfg.batch_size]).to(dev)
        layouts = {}
        for cl in (True, False):
            def g_step():
                with fp32_convs():
                    dynamic.dynamic_generator_forward(g, hr, cfg.model,
                                                      channels_last=cl).sum().backward()

            layouts["channels_last" if cl else "nchw"] = cuda_device_ms(g_step, runs=5)[
                "device_ms"]
        res["layout_g_fwd_bwd_device_ms"] = layouts
        log(f"[moe-dynamic] (c) chain layout, device ms of G forward + backward: "
            f"{layouts}; the port runs channels_last")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


class FixedDraws:
    """Stands in for the trainers' draw hooks with fixed draws made from a
    seed (random crop offsets, Gumbel uniforms, normals), served in call
    order on the caller's device and dtype, so a step on the card and on
    the CPU see the same draws."""

    def __init__(self, seed: int):
        import numpy as np

        self.rng = np.random.default_rng(seed)
        self.made: list = []
        self.i = 0

    def _next(self, make):
        if self.i == len(self.made):
            self.made.append(make())
        out = self.made[self.i]
        self.i += 1
        return out

    def rewind(self) -> None:
        self.i = 0

    def random_crops(self, gen, src, crop):
        import torch

        b, _, h, w = src.shape
        ys, xs = self._next(lambda: (self.rng.integers(0, h - crop + 1, b),
                                     self.rng.integers(0, w - crop + 1, b)))
        return torch.stack([src[i, :, y:y + crop, x:x + crop]
                            for i, (y, x) in enumerate(zip(ys, xs))])

    def gumbel_uniform(self, gen, shape, device):
        import torch

        u = self._next(lambda: self.rng.uniform(1e-10, 1.0, tuple(shape)))
        return torch.as_tensor(u, dtype=torch.float32, device=device)

    def standard_normal(self, gen, like):
        import torch

        n = self._next(lambda: self.rng.standard_normal(tuple(like.shape)))
        return torch.as_tensor(n, dtype=like.dtype, device=like.device)


def adam_step_excess(got, want, grads, lr: float) -> float:
    """Parameters after Adam's first step (update -lr * g / (|g| + eps)),
    got vs want: the largest excess over the bound TOL + lr * min(2,
    tol_g / (|g| + eps)), tol_g the scaled gradient tolerance (rtol 1e-4,
    atol 1e-5 of the largest gradient); <= 0 passes. A gradient near eps
    takes a sign-like step that rounding can flip."""
    import torch

    scale = max(float(g.abs().max()) for g in grads)
    worst = -1.0
    for p, q, g in zip(got, want, grads):
        g = g.abs()
        bound = ATOL + RTOL * q.abs() + lr * torch.clamp(
            (1e-5 * scale + 1e-4 * g) / (g + 1e-8), max=2.0)
        worst = max(worst, float(((p - q).abs() - bound).max()))
    return worst


def step_parity(kind: str, dev, failures: list) -> dict:
    """(d): one train step at full widths (batch 2) on the CPU, on the card
    and on the card in float64, from the same weights in the JAX layout
    with the same fixed draws: losses, selection / sigma / kernels,
    gradients (scaled rule) and the updated parameters (Adam's first-step
    bound) of the card against the CPU; float64 is the yardstick of both."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import convert
    from kmsr_tpu_torch.models import discriminator, dynamic, moe
    from kmsr_tpu_torch.train import dynamic as tdyn
    from kmsr_tpu_torch.train import moe as tmoe
    from kmsr_tpu_torch.train.state import (init_gan_state, make_gan_optimizers,
                                            tree_leaves, tree_map)

    rng = np.random.default_rng(SEED + 13)
    to_np = lambda tree: tree_map(lambda t: t.numpy(), tree)  # noqa: E731
    d_np = to_np(discriminator.init_discriminator(seed=SEED, device="cpu"))
    hr = rng.normal(5, 2, (2, C, HW, HW)).astype(np.float32)
    crop = rng.normal(5, 2, (2, C, HW, HW)).astype(np.float32)
    if kind == "moe":
        cfg = tmoe.MoETrainConfig(batch_size=2, outdir="unused")
        g_np = to_np(moe.init_moe(cfg.model, seed=SEED, device="cpu"))
        make_step, mod, hooks = tmoe.make_moe_base_step, tmoe, (tmoe, moe)
        keys = ("loss_D", "loss_G_adv", "loss_reg", "loss_balance", "selection")
    else:
        cfg = tdyn.DynamicTrainConfig(batch_size=2, outdir="unused")
        g_np = to_np(dynamic.init_degradation_model(cfg.model, seed=SEED, device="cpu"))
        make_step, mod, hooks = tdyn.make_dynamic_base_step, tdyn, (tdyn, dynamic)
        keys = ("loss_D", "loss_G_adv", "loss_reg", "loss_noise_reg", "sigma", "kernels")
    draws = FixedDraws(SEED + 17)
    saved = [(m, n, getattr(m, n)) for m in hooks
             for n in ("random_crops", "gumbel_uniform", "standard_normal") if hasattr(m, n)]
    got = []  # [CPU f32, card f32, card f64]
    try:
        for m, n, _ in saved:
            setattr(m, n, getattr(draws, n))
        for d, dt in ((torch.device("cpu"), torch.float32), (dev, torch.float32),
                      (dev, torch.float64)):
            draws.rewind()
            cast = lambda t: t.to(dt)  # noqa: E731
            if kind == "moe":
                gp, ms = (tree_map(cast, t) for t in convert.moe_from_jax(*g_np, device=d))
            else:
                gp = tree_map(cast, convert.dynamic_from_jax(g_np, device=d))
            dp, ds = (tree_map(cast, t) for t in convert.discriminator_from_jax(*d_np, device=d))
            tx = make_gan_optimizers(cfg.lr_rate, grad_clip_norm=None)
            state = init_gan_state(torch.Generator(device=d).manual_seed(SEED), gp, dp,
                                   {"disc": ds, "moe": ms} if kind == "moe" else ds, tx, tx)
            new, m = make_step(cfg)(state, cast(torch.from_numpy(hr).to(d)),
                                    cast(torch.from_numpy(crop).to(d)),
                                    *((1.0,) if kind == "moe" else ()))
            host = lambda ts: [t.detach().cpu().double() for t in ts]  # noqa: E731
            got.append({"metrics": {k: m[k].detach().cpu().double() for k in keys},
                        "grads_G": host(tree_leaves(m["grads_G"])),
                        "grads_D": host(tree_leaves(m["grads_D"])),
                        "G": host(tree_leaves(new.g_params)),
                        "D": host(tree_leaves(new.d_params))})
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    cpu, card, f64 = got
    result = {}
    for k in keys:
        want, have = cpu["metrics"][k], card["metrics"][k]
        ok = bool(torch.equal(have, want)) if k == "selection" else bool(
            torch.allclose(have, want, rtol=RTOL, atol=ATOL))
        ref = f64["metrics"][k].abs().clamp_min(ATOL)
        result[k] = {"max_abs_err": float((have - want).abs().max()), "ok": ok,
                     "cpu_vs_f64_rel": float(((want - f64["metrics"][k]).abs() / ref).max()),
                     "card_vs_f64_rel": float(((have - f64["metrics"][k]).abs() / ref).max())}
    for k in ("grads_G", "grads_D"):
        scale = max(float(g.abs().max()) for g in cpu[k])
        excess = max(float(((h - w).abs() - (1e-5 * scale + RTOL * w.abs())).max())
                     for h, w in zip(card[k], cpu[k]))
        f64_scale = max(float(g.abs().max()) for g in f64[k])
        cpu_f64, card_f64 = (max(float((a - b).abs().max()) for a, b in zip(side[k], f64[k]))
                             / f64_scale for side in (cpu, card))
        # float32 keeps a gradient summed over many pixels only to ~1e-3 of
        # the largest (either device, against the float64 step): the card
        # is held to the scaled rule, or to no more than twice the CPU's
        # own distance from the float64 step
        ok = excess <= 0 or card_f64 <= 2 * max(cpu_f64, 1e-5)
        result[k] = {"ok": ok, "excess_over_scaled_tol": excess, "scale": scale,
                     "cpu_vs_f64_scaled": cpu_f64, "card_vs_f64_scaled": card_f64}
    for k, gk in (("G", "grads_G"), ("D", "grads_D")):
        excess = adam_step_excess(card[k], cpu[k], cpu[gk], cfg.lr_rate)
        result[f"updated_{k}"] = {"ok": excess <= 0, "excess_over_adam_bound": excess}
    bad = [k for k, r in result.items() if not r["ok"]]
    if bad:
        failures.append(f"{kind} step card vs CPU: {bad}: "
                        + json.dumps({k: result[k] for k in bad}))
    log(f"[moe-dynamic] (d) {kind} step card vs CPU (rtol={RTOL}, atol={ATOL}; gradients "
        f"scaled; updated parameters by Adam's first-step bound; TF32 off): "
        + ", ".join(f"{k} {'ok' if r['ok'] else 'FAILED'} "
                    + " ".join(f"{m}={v:.3g}" for m, v in r.items() if m != "ok")
                    for k, r in result.items()))
    return result


def phase_moe_dynamic(dev, failures: list) -> dict:
    """Phase 11 (module docstring): the MoE factory route, MoE and dynamic
    training, and one step of each card vs CPU; the eight kernels' launch
    counts set to 0 before each route and read after it."""
    import numpy as np
    import torch

    from kmsr_tpu_torch.data import synthetic_pool

    t0 = time.perf_counter()
    secs = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t
        return out

    res = {"factory": part("factory", moe_factory, dev, failures)}
    pool = synthetic_pool(np.random.default_rng(SEED + 12), n=MD_POOL_N, c=C, size=HW)
    res["moe_training"] = part("moe_training", moe_training, pool, dev, failures)
    res["dynamic_training"] = part("dynamic_training", dynamic_training, pool, dev, failures)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res["card_vs_cpu"] = {kind: part(f"{kind}_step_parity", step_parity, kind, dev, failures)
                          for kind in ("moe", "dynamic")}
    res["part_seconds"] = secs
    log(f"[moe-dynamic] seconds by part: { {k: round(v, 1) for k, v in secs.items()} }")
    res["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return res


#: the SR phase: configs/quality_x8.json:31-42 (x8, width 64, 8 blocks,
#: progressive; sr_train batch 32, holdout 24 of the factory's pairs), the
#: committed x8 model behind docs/QUALITY.md, bench_sr.py's batch (128 x
#: 5x32^2 LR, 8.39 Mpix out); a 5x1024^2 LR scene (5x8192^2 out, 1.34 GB)
SR_MODEL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quality_run_r4",
                        "work", "sr_run", "sr_model.npz")
SR_BATCH, SR_LR, SR_SUB, SR_SEED = 128, 32, 2, 7
SR_SCENE_HW, SR_EXACT_HW, SR_SCENE_RUNS = 1024, (96, 160), 2
SR_PAIRS, SR_INFER_BATCH = 256, 128
SR_TRAIN_BATCH, SR_TRAIN_POOL, SR_TRAIN_HOLDOUT, SR_TRAIN_ITERS = 32, 64, 8, 20
SR_PRODUCTION_ITERS = 20_000
#: tests/test_sr.py:74's median relative bf16 distance; the tiled scene's
#: tolerance (tests/test_sr_scene.py)
SR_MEDIAN_REL, SR_TILED_ATOL, SR_TILED_RTOL = 0.05, 2e-5, 1e-5


def sr_config(upsampler: str = "progressive"):
    from kmsr_tpu_torch.models.sr import SRConfig

    return SRConfig(width=64, n_blocks=8, factor=8, upsampler=upsampler)


def sr_macs_per_lr_px(cfg) -> int:
    """Multiply-adds of the convs per LR pixel (the bilinear skip's dense
    matmuls, < 1 % at x8, are left out)."""
    w, c, f = cfg.width, cfg.in_ch, cfg.factor
    trunk = 9 * c * w + (2 * cfg.n_blocks + 1) * 9 * w * w
    if cfg.upsampler == "oneshot":
        return trunk + 9 * w * c * f * f
    n_up = f.bit_length() - 1
    ups = sum(9 * w * 4 * w * 4**i for i in range(n_up - 1))
    return trunk + ups + 9 * w * c * 4 * 4 ** (n_up - 1)


def sr_bound(cfg, lr_px: int, io_bytes: int, param_bytes: int, dtype_peak: float,
             card: str) -> dict:
    """The least time of a forward: max(FLOPs / the dtype's peak, bytes
    (input and output once, parameters once) / HBM rate)."""
    bw = peaks(card)[0]
    flops = 2 * sr_macs_per_lr_px(cfg) * lr_px
    t_ops, t_bytes = flops / dtype_peak * 1e3, (io_bytes + param_bytes) / bw * 1e3
    return {"gflop": flops / 1e9, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes}


def sr_timing_line(label: str, t: dict, mpix: float) -> str:
    return (f"{label}: {mpix / t['wall_ms_per_iter'] * 1e3:.1f} Mpix/s out (median of "
            f"{MD_WINDOWS} windows of {t['window_iters']}; windows "
            f"{[round(mpix / w * 1e3, 1) for w in t['wall_ms_per_iter_windows']]}), "
            f"{t['wall_ms_per_iter']:.3f} ms a call, device {t['device_ms_per_iter']:.3f} ms, "
            f"busy {t['busy_share']:.3f}; top ops: "
            + "; ".join(f"{o['op']} {o['shapes'][:40]} {o['device_ms_per_iter']:.3f} ms"
                        for o in t["top_ops"][:4]))


def sr_forward_part(dev, card: str, failures: list) -> dict:
    """(a): the committed x8 model at batch 128 in bf16 and f32 against the
    CPU on a sub-batch; throughput, device time, busy share, top ops, peak
    memory and the bound; the trunk's layouts; oneshot at width 64."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.models.sr import count_params, init_sr, sr_forward
    from kmsr_tpu_torch.pipeline.sr_infer import load_sr_model
    from kmsr_tpu_torch.train.state import tree_map
    from kmsr_tpu_torch.utils.profiling import cuda_device_ms

    cfg = sr_config()
    params = load_sr_model(SR_MODEL, cfg, dev)
    cpu_params = load_sr_model(SR_MODEL, cfg, "cpu")
    rng = np.random.default_rng(SR_SEED)
    x = torch.from_numpy(rng.normal(3.0, 1.0, (SR_BATCH, C, SR_LR, SR_LR)).astype(np.float32))
    x_dev = x.to(dev)
    kernels.reset_launches()
    y16 = sr_forward(params, x_dev)
    y32 = sr_forward(params, x_dev, cfg, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    no_kernel_launched("sr forward", failures)
    out_shape = (SR_BATCH, C, SR_LR * cfg.factor, SR_LR * cfg.factor)
    res = {"batch": SR_BATCH, "lr": SR_LR, "model": SR_MODEL, "out_shape": list(out_shape)}
    if tuple(y16.shape) != out_shape or not bool(torch.isfinite(y16).all()) \
            or not bool(torch.isfinite(y32).all()):
        failures.append(f"sr forward: shape {tuple(y16.shape)} or non-finite output")
    cpu32 = sr_forward(cpu_params, x[:SR_SUB], cfg, compute_dtype=torch.float32)
    cpu16 = sr_forward(cpu_params, x[:SR_SUB], cfg)
    f64 = sr_forward(tree_map(lambda t: t.double(), params), x_dev[:SR_SUB].double(), cfg,
                     compute_dtype=torch.float64).cpu()
    e = errors(y32[:SR_SUB].cpu(), cpu32)
    # float32 through 23 convs keeps ~1e-5 of the output's scale on either
    # device: the card passes at the tolerance, or no further from a
    # float64 forward than twice the CPU is
    dist = {side: float((t.double() - f64).abs().max())
            for side, t in (("card", y32[:SR_SUB].cpu()), ("cpu", cpu32))}
    e.update({"card_vs_f64": dist["card"], "cpu_vs_f64": dist["cpu"],
              "ok": e["ok"] or dist["card"] <= 2 * max(dist["cpu"], ATOL)})
    res["f32_card_vs_cpu"] = e
    cpu_own = float((cpu16 - cpu32).abs().max())
    card_dist = float((y16[:SR_SUB].cpu() - cpu32).abs().max())
    rel = ((y16 - y32).abs() / (y32.abs() + 1e-3)).median()
    res["bf16"] = {"card_vs_cpu_f32_max": card_dist, "cpu_bf16_vs_f32_max": cpu_own,
                   "median_rel_vs_card_f32": float(rel),
                   "ok": card_dist <= 2 * cpu_own and float(rel) < SR_MEDIAN_REL}
    if not res["f32_card_vs_cpu"]["ok"]:
        failures.append(f"sr forward f32 card vs CPU: {res['f32_card_vs_cpu']}")
    if not res["bf16"]["ok"]:
        failures.append(f"sr forward bf16 bound: {res['bf16']}")
    mpix = SR_BATCH * (SR_LR * cfg.factor) ** 2 / 1e6
    lr_px = SR_BATCH * SR_LR * SR_LR
    io = x.numel() * 4 + int(np.prod(out_shape)) * 4
    timing = {}
    for label, dt, peak in (("bf16", torch.bfloat16, peaks(card)[2]),
                            ("f32", torch.float32, peaks(card)[1])):
        def call(dt=dt):
            sr_forward(params, x_dev, cfg, compute_dtype=dt)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = training_timing(call, 1)
        t["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        t["mpix_per_s"] = mpix / t["wall_ms_per_iter"] * 1e3
        t["mpix_per_s_windows"] = [mpix / w * 1e3 for w in t["wall_ms_per_iter_windows"]]
        t.update(sr_bound(cfg, lr_px, io, count_params(params) * 4, peak, card))
        t["bound_mpix_per_s"] = mpix / t["bound_ms"] * 1e3
        timing[label] = t
        log(f"[sr] (a) x8 progressive {label} " + sr_timing_line(label, t, mpix)
            + f"; peak {t['peak_mem_gb']:.2f} GB; {t['gflop']:.1f} GFLOP, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) = {t['bound_mpix_per_s']:.0f} Mpix/s")
    res["timing"] = timing
    layouts = {}
    for name, cl in (("channels_last", True), ("nchw", False)):
        layouts[name] = cuda_device_ms(lambda cl=cl: sr_forward(params, x_dev, cfg,
                                                                channels_last=cl),
                                       runs=3)["device_ms"]
    res["layout_bf16_device_ms"] = layouts
    one_cfg = sr_config("oneshot")
    one_params = init_sr(one_cfg, seed=SR_SEED, device=dev)
    kernels.reset_launches()
    y1 = sr_forward(one_params, x_dev, one_cfg)
    torch.cuda.synchronize()
    no_kernel_launched("sr forward oneshot", failures)
    if tuple(y1.shape) != out_shape or not bool(torch.isfinite(y1).all()):
        failures.append("sr oneshot forward: wrong shape or non-finite")
    t = training_timing(lambda: sr_forward(one_params, x_dev, one_cfg), 1)
    t["mpix_per_s"] = mpix / t["wall_ms_per_iter"] * 1e3
    t.update(sr_bound(one_cfg, lr_px, io, count_params(one_params) * 4, peaks(card)[2], card))
    res["oneshot_bf16"] = t
    log("[sr] (a) x8 oneshot bf16 (seeded init) " + sr_timing_line("bf16", t, mpix)
        + f"; bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    log(f"[sr] (a) {SR_MODEL}: f32 card vs CPU ({SR_SUB} samples) "
        f"{res['f32_card_vs_cpu']}; bf16 card vs CPU f32 {card_dist:.4g} (CPU bf16 "
        f"{cpu_own:.4g}), median rel vs f32 {float(rel):.4g}; trunk layout, bf16 device ms "
        f"{ {k: round(v, 3) for k, v in layouts.items()} }")
    return res


def sr_scene_part(params, dev, failures: list) -> dict:
    """(b): `sr_scene` on an in-memory 5x1024^2 LR scene with NaN holes
    (the CLI's defaults: tile 64, chunk 32, bf16), timed end to end and by
    stage; exactness on a smaller NaN scene: tiled vs untiled on the card
    in f32, NaN cells identical."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.models.sr import sr_forward
    from kmsr_tpu_torch.pipeline.sr_scene import _band_filled, receptive_halo, sr_scene
    from kmsr_tpu_torch.utils.profiling import timing_report

    cfg = sr_config()
    f = cfg.factor
    rng = np.random.default_rng(SR_SEED + 1)

    def nan_scene(h, w):
        s = rng.normal(3.0, 1.0, (C, h, w)).astype(np.float32)
        s[:, h // 4:h // 4 + 9, w // 3:w // 3 + 17] = np.nan   # a hole in every band
        s[1, -5:, :7] = np.nan                                  # a corner of one band
        return s

    res = {"tile": 64, "chunk": 32, "halo": receptive_halo(cfg)}
    # exactness: tiled (shifted last tiles, clamped slabs) vs the untiled forward
    small = nan_scene(*SR_EXACT_HW)
    kernels.reset_launches()
    tiled = sr_scene(params, small, cfg, compute_dtype=torch.float32, chunk=4, device=dev)
    filled = torch.from_numpy(_band_filled(small, np.isfinite(small)))[None].to(dev)
    whole = sr_forward(params, filled, cfg, compute_dtype=torch.float32)[0].cpu().numpy()
    no_kernel_launched("sr_scene (exactness)", failures)
    want_nan = np.isnan(small).repeat(f, axis=1).repeat(f, axis=2)
    ok = ~want_nan
    exact = {"shape": list(small.shape), "nan_cells_identical":
             bool(np.array_equal(np.isnan(tiled), want_nan)),
             "max_abs_err": float(np.abs(tiled[ok] - whole[ok]).max()),
             "close": bool(np.allclose(tiled[ok], whole[ok], atol=SR_TILED_ATOL,
                                       rtol=SR_TILED_RTOL))}
    res["exactness_f32"] = exact
    if not (exact["nan_cells_identical"] and exact["close"]):
        failures.append(f"sr_scene tiled vs untiled: {exact}")
    # the full-size scene: one warm-up, then timed runs
    scene = nan_scene(SR_SCENE_HW, SR_SCENE_HW)
    valid = np.isfinite(scene)
    out_px = (SR_SCENE_HW * f) ** 2
    runs = []
    for i in range(1 + SR_SCENE_RUNS):
        kernels.reset_launches()
        timing_report(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sr_scene(params, scene, cfg, device=dev)
        secs = time.perf_counter() - t0
        no_kernel_launched("sr_scene", failures)
        stages = {k: r["total_s"] for k, r in timing_report(reset=True).items()
                  if k.startswith("sr_scene.")}
        if i:
            runs.append({"seconds": secs, "mpix_per_s_out": out_px / secs / 1e6,
                         "stages_s": stages,
                         "mpix_per_s_by_stage": {k: out_px / v / 1e6
                                                 for k, v in stages.items() if v > 0}})
    blocks = np.isnan(out).reshape(C, SR_SCENE_HW, f, SR_SCENE_HW, f)
    checks = {"shape": out.shape == (C, SR_SCENE_HW * f, SR_SCENE_HW * f),
              "nan_footprint": bool((blocks == ~valid[:, :, None, :, None]).all()),
              "no_inf": not bool(np.isinf(out).any())}
    bad = [k for k, v in checks.items() if not v]
    if bad:
        failures.append(f"sr_scene {SR_SCENE_HW}^2: failed checks {bad}")
    res.update({"scene": [C, SR_SCENE_HW, SR_SCENE_HW], "out_gb": out.nbytes / 1e9,
                "runs": runs, "checks_failed": bad})
    best = min(runs, key=lambda r: r["seconds"])
    log(f"[sr] (b) sr_scene 5x{SR_SCENE_HW}^2 -> 5x{SR_SCENE_HW * f}^2 ({out.nbytes / 1e9:.2f}"
        f" GB): {'ok' if not bad else 'FAILED ' + str(bad)}; runs "
        + "; ".join(f"{r['seconds']:.3f}s = {r['mpix_per_s_out']:.1f} Mpix/s, stages "
                    f"{ {k[9:]: round(v, 4) for k, v in r['stages_s'].items()} }"
                    for r in runs)
        + f"; exactness f32 {SR_EXACT_HW}: {exact}; best {best['mpix_per_s_out']:.1f} Mpix/s")
    del out, blocks
    return res


def sr_pairs(n: int, rng):
    """n seeded (lr [n,5,32,32], hr [n,5,256,256]) pairs: hr a blocky field
    plus noise, lr its x8 block mean (the factory's pairs without blur)."""
    import numpy as np

    f = 8
    base = rng.normal(3.0, 1.0, (n, C, SR_LR, SR_LR)).astype(np.float32)
    hr = base.repeat(f, axis=2).repeat(f, axis=3)
    hr += 0.05 * rng.standard_normal(hr.shape, dtype=np.float32)
    lr = hr.reshape(n, C, SR_LR, f, SR_LR, f).mean(axis=(3, 5))
    return lr, hr


def sr_infer_part(params, pairs, dev, failures: list) -> dict:
    """(c): `sr_infer`'s device loop (`run_batches`) on in-memory pairs in
    chunks of 128 (the CLI's batch), with PSNR/SSIM against hr; each
    batch's preds against a direct forward, two samples' metrics against
    the CPU's, the bilinear baseline's PSNR beside the model's."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.models.sr import bilinear_upsample, sr_forward
    from kmsr_tpu_torch.ops.metrics import psnr, ssim
    from kmsr_tpu_torch.pipeline.sr_infer import run_batches
    from kmsr_tpu_torch.utils.profiling import timing_report

    cfg = sr_config()
    lr, hr = pairs
    paths = [f"pair_{i:04d}" for i in range(len(lr))]
    chunks = [(paths[i:i + SR_INFER_BATCH],
               [(lr[j], hr[j]) for j in range(i, min(i + SR_INFER_BATCH, len(lr)))], [])
              for i in range(0, len(lr), SR_INFER_BATCH)]
    got = {"metrics": [], "max_abs_vs_direct": 0.0, "metric_checks": []}

    def check(p, preds, mets):
        i0 = paths.index(p[0])
        direct = sr_forward(params, torch.from_numpy(lr[i0:i0 + len(p)]).to(dev), cfg).cpu()
        got["max_abs_vs_direct"] = max(got["max_abs_vs_direct"],
                                       float((torch.from_numpy(preds) - direct).abs().max()))
        got["metrics"].append(mets)
        for k in (0, len(p) - 1):
            h = torch.from_numpy(hr[i0 + k])
            dr = float(h.max() - h.min()) or 1.0
            pr = torch.from_numpy(preds[k])
            got["metric_checks"].append(bool(np.allclose(
                mets[k], [float(psnr(pr, h, dr)), float(ssim(pr, h, dr))],
                rtol=1e-5, atol=1e-5)))

    kernels.reset_launches()
    fails = run_batches(chunks, params, cfg, check, dev)
    no_kernel_launched("sr_infer", failures)
    mets = np.concatenate(got["metrics"])
    bil = [float(psnr(bilinear_upsample(torch.from_numpy(lr[i:i + 1]).to(dev), 8)[0],
                      torch.from_numpy(hr[i]).to(dev),
                      float(hr[i].max() - hr[i].min()) or 1.0)) for i in range(min(8, len(lr)))]
    checks = {"no_failures": not fails, "all_pairs": len(mets) == len(lr),
              "finite": bool(np.isfinite(mets).all()),
              "preds_equal_direct": got["max_abs_vs_direct"] <= ATOL,
              "metrics_equal_cpu": all(got["metric_checks"])}
    bad = [k for k, v in checks.items() if not v]
    if bad:
        failures.append(f"sr_infer loop: failed checks {bad} {fails[:3]}")
    # timed: one more pass, stage timers
    timing_report(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_batches(chunks, params, cfg, lambda *a: None, dev)
    secs = time.perf_counter() - t0
    stages = {k: r["total_s"] for k, r in timing_report(reset=True).items()
              if k.startswith("sr_infer.")}
    out_px = len(lr) * (SR_LR * 8) ** 2
    res = {"pairs": len(lr), "batch": SR_INFER_BATCH, "checks_failed": bad,
           "psnr_mean": float(mets[:, 0].mean()), "ssim_mean": float(mets[:, 1].mean()),
           "bilinear_psnr_mean_first8": float(np.mean(bil)),
           "max_abs_vs_direct": got["max_abs_vs_direct"], "seconds": secs,
           "mpix_per_s_out": out_px / secs / 1e6, "stages_s": stages}
    log(f"[sr] (c) sr_infer loop, {len(lr)} in-memory pairs in chunks of {SR_INFER_BATCH}: "
        f"{'ok' if not bad else 'FAILED ' + str(bad)}; PSNR {res['psnr_mean']:.3f} dB, SSIM "
        f"{res['ssim_mean']:.4f} (bilinear PSNR {res['bilinear_psnr_mean_first8']:.3f} on 8); "
        f"preds vs direct forward {got['max_abs_vs_direct']:.3g}; timed pass {secs:.3f}s = "
        f"{res['mpix_per_s_out']:.1f} Mpix/s out, stages "
        f"{ {k: round(v, 4) for k, v in stages.items()} }")
    return res


def sr_step_parity(pairs, dev, failures: list) -> dict:
    """(d): one full-width f32 train step (batch 2, from the committed
    model) on the CPU and on the card, and the card's float64 gradients as
    the yardstick: loss rtol 1e-4, gradients by the scaled rule (or no
    further from float64 than twice the CPU), updated parameters within
    Adam's first-step bound."""
    import numpy as np
    import torch

    from kmsr_tpu_torch.models.sr import sr_forward
    from kmsr_tpu_torch.pipeline.sr_infer import load_sr_model
    from kmsr_tpu_torch.train import sr as tsr
    from kmsr_tpu_torch.train.state import _trainable, tree_leaves, tree_map

    cfg = tsr.SRTrainConfig(batch_size=2, compute_dtype="float32", model=sr_config(),
                            outdir="unused")
    lr, hr = (torch.from_numpy(a[:2]) for a in pairs)
    got = []
    for d in ("cpu", dev):
        params = _trainable(load_sr_model(SR_MODEL, cfg.model, d))
        state = tsr.SRTrainState(0, params, tsr.make_optimizer(cfg).init(params))
        state, m = tsr.make_sr_train_step(cfg)[0](state, lr.to(d), hr.to(d))
        got.append({"loss": float(m["l1"]),
                    "grads": [g.detach().cpu().double() for g in tree_leaves(m["grads"])],
                    "params": [p.detach().cpu().double() for p in tree_leaves(state.params)]})
    p64 = tree_map(lambda t: t.double().requires_grad_(True),
                   load_sr_model(SR_MODEL, cfg.model, dev))
    pred = sr_forward(p64, lr.to(dev).double(), cfg.model, compute_dtype=torch.float64)
    loss64 = (pred - hr.to(dev).double()).abs().mean()
    g64 = [g.cpu() for g in torch.autograd.grad(loss64, tree_leaves(p64))]
    loss64 = loss64.item()
    cpu, card = got
    scale = max(float(g.abs().max()) for g in cpu["grads"])
    excess = max(float(((h - w).abs() - (1e-5 * scale + RTOL * w.abs())).max())
                 for h, w in zip(card["grads"], cpu["grads"]))
    s64 = max(float(g.abs().max()) for g in g64)
    cpu_f64, card_f64 = (max(float((a - b).abs().max()) for a, b in zip(side["grads"], g64))
                         / s64 for side in (cpu, card))
    upd = adam_step_excess(card["params"], cpu["params"], cpu["grads"], cfg.lr_rate)
    res = {"loss": {"card": card["loss"], "cpu": cpu["loss"], "f64": loss64,
                    "ok": abs(card["loss"] - cpu["loss"]) <= RTOL * abs(cpu["loss"])},
           "grads": {"excess_over_scaled_tol": excess, "scale": scale,
                     "cpu_vs_f64_scaled": cpu_f64, "card_vs_f64_scaled": card_f64,
                     "ok": excess <= 0 or card_f64 <= 2 * max(cpu_f64, 1e-5)},
           "updated": {"excess_over_adam_bound": upd, "ok": upd <= 0}}
    bad = [k for k, r in res.items() if not r["ok"]]
    if bad:
        failures.append(f"sr step card vs CPU: {bad}: {json.dumps(res)}")
    log(f"[sr] (d) full-width f32 step card vs CPU (batch 2, committed weights): "
        + ", ".join(f"{k} {'ok' if r['ok'] else 'FAILED'} "
                    + " ".join(f"{m}={v:.4g}" for m, v in r.items() if m != "ok")
                    for k, r in res.items()))
    return res


def sr_training_part(pairs, dev, failures: list) -> dict:
    """(d): `train_sr` at the config's widths (batch 32, bf16, LR 32^2 ->
    HR 256^2) on an in-memory pool with a holdout tail, device pool:
    CSV, parameters moved, `sr_model.npz` names as committed; then a step's
    it/s, device time, busy share and top ops, and the wall a 20,000-
    iteration run would take; one full-width f32 step card vs CPU."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.pipeline.sr_infer import load_sr_model
    from kmsr_tpu_torch.train import sr as tsr
    from kmsr_tpu_torch.train.state import tree_leaves
    from kmsr_tpu_torch.utils.params_io import _named_leaves

    lr, hr = (a[:SR_TRAIN_POOL] for a in pairs)
    committed = np.load(SR_MODEL)
    committed_names = [str(committed[k]) for k in sorted(committed.files)
                       if k.startswith("name_")]
    tmp = tempfile.mkdtemp(prefix="kmsr_chip_sr_train_")
    try:
        cfg = tsr.SRTrainConfig(iters=SR_TRAIN_ITERS, batch_size=SR_TRAIN_BATCH,
                                model=sr_config(), holdout=SR_TRAIN_HOLDOUT, eval_every=10,
                                log_every=5, outdir=tmp)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = tsr.train_sr((lr, hr), cfg, progress=False, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        no_kernel_launched("sr training", failures)
        init = tsr.init_sr_training(cfg, dev)
        moved = max(float((a.detach() - b.detach()).abs().max())
                    for a, b in zip(tree_leaves(out["state"].params), tree_leaves(init.params)))
        with open(out["csv_path"], encoding="utf-8") as fh:
            rows = [ln.strip().split(",") for ln in fh]
        saved = np.load(out["model_path"])
        names = [str(saved[k]) for k in sorted(saved.files) if k.startswith("name_")]
        reloaded = load_sr_model(out["model_path"], cfg.model, dev)
        checks = {
            "csv_header": rows[0] == ["Iteration", "Loss_L1", "Eval_PSNR", "Eval_SSIM"],
            "csv_rows": [r[0] for r in rows[1:]] == [str(i) for i in
                                                     range(5, SR_TRAIN_ITERS + 1, 5)],
            "csv_finite": all(np.isfinite(float(v)) for r in rows[1:] for v in r if v),
            "evals": sum(1 for r in rows[1:] if r[2]) == SR_TRAIN_ITERS // 10,
            "final_eval": np.isfinite(out["final_eval"]["psnr"]),
            "params_moved": moved > 0,
            "npz_names_as_committed": names == committed_names,
            "reloads": all(torch.equal(a.detach(), b) for (_, a), (_, b) in zip(
                _named_leaves(out["state"].params), _named_leaves(reloaded))),
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            failures.append(f"sr training: failed checks {bad}")
        res = {"iters": cfg.iters, "seconds_with_setup": secs, "checks_failed": bad,
               "max_param_move": moved, "log": out["log"], "final_eval": out["final_eval"]}
        log(f"[sr] (d) train_sr {cfg.iters} iterations (batch {cfg.batch_size}, bf16, "
            f"holdout {cfg.holdout}, device pool): {'ok' if not bad else 'FAILED ' + str(bad)}"
            f" in {secs:.2f}s; log {[(i, round(v, 5)) for i, v in out['log']]}; final eval "
            f"{out['final_eval']}")
        # timing: the step on device-pool batches drawn as train_sr draws them
        step_fn, _ = tsr.make_sr_train_step(cfg)
        state = tsr.init_sr_training(cfg, dev)
        lr_dev, hr_dev = torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev)
        host_rng = np.random.default_rng(cfg.seed)

        def one_call():
            nonlocal state
            i = torch.from_numpy(host_rng.integers(0, len(lr) - cfg.holdout, cfg.batch_size))
            if dev.type == "cuda":
                i = i.pin_memory().to(dev, non_blocking=True)
            state, _ = step_fn(state, lr_dev[i], hr_dev[i])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = with_and_without(lambda: training_timing(one_call, 1))
        t["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        t["production_run_hours"] = SR_PRODUCTION_ITERS / t["iters_per_s"] / 3600
        res["timing"] = t
        log("[sr] (d) timing " + timing_line("bf16 step, batch 32", t)
            + f"; peak {t['peak_mem_gb']:.2f} GB; a {SR_PRODUCTION_ITERS}-iteration run "
            f"{t['production_run_hours'] * 60:.1f} min" + det_note(t))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["card_vs_cpu"] = sr_step_parity((lr, hr), dev, failures)
    return res


def phase_sr(dev, card: str, smi: str, failures: list) -> dict:
    """Phase 12 (module docstring): SR inference at bench_sr.py's batch,
    whole-scene SR, the sr_infer loop and SR training at the x8 config's
    widths; the eight kernels' launch counts set to 0 before each route
    and read after it."""
    import numpy as np
    import torch

    from kmsr_tpu_torch.pipeline.sr_infer import load_sr_model

    t0 = time.perf_counter()
    secs = {}
    # cuDNN's default (phase 11 turned TF32 off): the f32 path must set it itself
    torch.backends.cudnn.allow_tf32 = True

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t
        return out

    res = {"forward": part("forward", sr_forward_part, dev, card, failures)}
    params = load_sr_model(SR_MODEL, sr_config(), dev)
    res["scene"] = part("scene", sr_scene_part, params, dev, failures)
    pairs = part("pairs", sr_pairs, SR_PAIRS, np.random.default_rng(SR_SEED + 2))
    res["infer"] = part("infer", sr_infer_part, params, pairs, dev, failures)
    res["training"] = part("training", sr_training_part, pairs, dev, failures)
    res["part_seconds"] = secs
    fwd, scene = res["forward"]["timing"], res["scene"]["runs"]
    log(f"[sr] on {smi}: x8 inference bf16 {fwd['bf16']['mpix_per_s']:.1f} Mpix/s "
        f"(progressive), {res['forward']['oneshot_bf16']['mpix_per_s']:.1f} (oneshot), f32 "
        f"{fwd['f32']['mpix_per_s']:.1f}; scene {max(r['mpix_per_s_out'] for r in scene):.1f}"
        f" Mpix/s out; sr_infer loop {res['infer']['mpix_per_s_out']:.1f} Mpix/s out; "
        f"training {res['training']['timing']['iters_per_s']:.2f} it/s")
    log(f"[sr] seconds by part: { {k: round(v, 1) for k, v in secs.items()} }")
    res["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return res


#: the fleet phase: configs/quality_x8_real_lr.json's train_kernel block
#: (compose, real_is_lr, K = 20, batch 16, lr crops 32, fake noise auto,
#: raw_sum_reg 0.1, seed 0) on 4 scenes of 64 HR patches 5x256x256 and 64
#: native-LR patches 5x32x32 each, 40 of its 2,000 iterations; the CLI's
#: defaults (chain, K = 1) on 2 scene dirs of 64 .npy patches, 20
#: iterations; the per-scene factory on 4 + 1 scenes of 64 .npy patches
FLEET_SCENES, FLEET_N, FLEET_ITERS, FLEET_K, FLEET_CLI_ITERS = 4, 64, 40, 20, 20


def fleet_scene_pools(s: int, dev):
    """Scene s's (HR pool [64, 5, 256, 256], native-LR pool [64, 5, 32, 32])
    as host PatchPools, made on the card from seed SEED + 100 + s: a smooth
    radiance-like field (3x3 box mean of N(5, 2)); the LR side the x8 block
    mean of another such field plus N(0, 0.05) sensor noise."""
    import torch
    import torch.nn.functional as F

    from kmsr_tpu_torch.data.sampler import PatchPool

    gen = torch.Generator(device=dev).manual_seed(SEED + 100 + s)

    def field(n):
        x = torch.randn(n, C, HW, HW, generator=gen, device=dev) * 2 + 5
        return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)

    hr = field(FLEET_N)
    lr = F.avg_pool2d(field(FLEET_N), FACTOR) + 0.05 * torch.randn(
        FLEET_N, C, HW // FACTOR, HW // FACTOR, generator=gen, device=dev)
    return PatchPool(hr.cpu().numpy()), PatchPool(lr.cpu().numpy())


def check_fleet_scene(outdir: str, iters: int, dumps: tuple, failures: list,
                      label: str) -> dict:
    """One scene's artifacts: the JAX package's file names, `iters` finite
    CSV rows under LOG_HEADER, a non-negative [5,13,13] kernel_per_band.npy
    whose bands sum to 1 (or were zeroed by the clamp), its band mean as
    kernel_merged.npy, and each dump's kernel_iter{N} the band mean of its
    kernel_per_band_iter{N}."""
    import numpy as np

    from kmsr_tpu_torch.train.single_kernel import LOG_HEADER

    names = {"training_log.txt", "kernel_per_band.npy", "kernel_merged.npy"}
    names |= {f"kernel{p}_iter{n}.npy" for n in dumps for p in ("", "_per_band")}
    rows = open(os.path.join(outdir, "training_log.txt")).read().splitlines()
    vals = np.array([[float(v) for v in r.split(",")] for r in rows[1:]])
    k = np.load(os.path.join(outdir, "kernel_per_band.npy"))
    sums = k.sum(axis=(1, 2))
    checks = {
        "files": set(os.listdir(outdir)) == names,
        "header": rows[0] == LOG_HEADER.strip(),
        "rows": vals.shape[0] == iters and vals[:, 0].tolist() == list(range(1, iters + 1)),
        "finite": bool(np.isfinite(vals).all()),
        "kernel_nonneg": k.shape == (5, 13, 13) and bool((k >= 0).all()),
        "band_sums": bool(((np.abs(sums - 1) <= 1e-5) | (sums == 0)).all()),
        "merged": bool(np.allclose(np.load(os.path.join(outdir, "kernel_merged.npy")),
                                   k.mean(axis=0), rtol=0, atol=1e-7)),
        "dumps": all(np.allclose(np.load(os.path.join(outdir, f"kernel_iter{n}.npy")),
                                 np.load(os.path.join(outdir, f"kernel_per_band_iter{n}.npy"))
                                 .mean(axis=0), rtol=0, atol=1e-7) for n in dumps),
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        failures.append(f"fleet {label}: failed checks {bad}")
    return {"checks_failed": bad, "band_sums": sums.tolist(), "last_row": rows[-1]}


def compare_runs(got_dir: str, want_dir: str, failures: list, label: str) -> dict:
    """Kernels and CSV rows of two runs of one scene, at the KernelGAN
    tolerance (rtol 1e-4, atol 1e-5)."""
    import numpy as np

    def rows(d):
        lines = open(os.path.join(d, "training_log.txt")).read().splitlines()[1:]
        return np.array([[float(v) for v in r.split(",")] for r in lines])

    rg, rw = rows(got_dir), rows(want_dir)
    kg, kw = (np.load(os.path.join(d, "kernel_per_band.npy")) for d in (got_dir, want_dir))
    res = {"rows_max_abs": float(np.abs(rg - rw).max()) if rg.shape == rw.shape else None,
           "kernel_max_abs": float(np.abs(kg - kw).max()),
           "ok": rg.shape == rw.shape and bool(np.allclose(rg, rw, rtol=RTOL, atol=ATOL))
                 and bool(np.allclose(kg, kw, rtol=RTOL, atol=ATOL))}
    if not res["ok"]:
        failures.append(f"fleet {label}: differs from its reference {res}")
    return res


def fleet_timing(cfg, pools, lr_pools, dev) -> dict:
    """Scene-iterations/s of the fleet loop (`train.fleet.make_fleet_advance`,
    what `train_fleet` calls each iteration) at S = len(pools): the median of
    MD_WINDOWS synchronized windows, the profiler's device time an
    iteration of all S scenes, the busy share and peak device memory."""
    import dataclasses

    import numpy as np
    import torch

    from kmsr_tpu_torch.train import fleet

    s_n = len(pools)
    states = [fleet.init_training(dataclasses.replace(cfg, seed=cfg.seed + s), dev)
              for s in range(s_n)]
    pools_dev, crop_dev = fleet.device_pools(pools, lr_pools, dev)
    rngs = [np.random.default_rng(cfg.seed + s) for s in range(s_n)]
    advance = fleet.make_fleet_advance(cfg, states, pools_dev, crop_dev, rngs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = training_timing(advance, cfg.steps_per_call, top_ops=False)
    t["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    t["scenes"] = s_n
    t["scene_iters_per_s"] = s_n * t["iters_per_s"]
    del states, pools_dev, crop_dev
    torch.cuda.empty_cache()
    return t


def fleet_line(label: str, t: dict) -> str:
    return (f"{label}: S={t['scenes']} {t['scene_iters_per_s']:.2f} scene-it/s "
            f"({t['iters_per_s']:.2f} fleet it/s, {t['wall_ms_per_iter']:.2f} ms an "
            f"iteration of all scenes, windows "
            f"{[round(w, 2) for w in t['wall_ms_per_iter_windows']]}), device "
            f"{t['device_ms_per_iter']:.3f} ms, busy {t['busy_share']:.3f}, peak "
            f"{t['peak_mem_gb']:.2f} GB")


def fleet_library(tmp: str, dev, failures: list) -> tuple[dict, str]:
    """(a): the real_lr config's train_kernel block through `train_fleet`
    on 4 scenes; every scene's artifacts; each scene against a 1-scene
    fleet at seed + s; timing at S = 1 and 2. Returns the result and the
    4-scene run's outdir (the kernel root of (c))."""
    import dataclasses

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.models import GeneratorConfig
    from kmsr_tpu_torch.pipeline.train_fleet_cli import fake_noise_sigma
    from kmsr_tpu_torch.train import SingleKernelConfig, train_fleet

    t0 = time.perf_counter()
    scenes = [fleet_scene_pools(s, dev) for s in range(FLEET_SCENES)]
    pools, lr_pools = [p for p, _ in scenes], [q for _, q in scenes]
    sigma = fake_noise_sigma(lr_pools)
    t_data = time.perf_counter() - t0
    outdir = os.path.join(tmp, "fleet_a")
    cfg = SingleKernelConfig(
        iters=FLEET_ITERS, batch_size=16, lr_crop_size=32, real_is_lr=True,
        steps_per_call=FLEET_K, seed=0, fake_noise_sigma=sigma, raw_sum_reg=0.1,
        log_every=FLEET_K, kernel_log_every=FLEET_K, outdir=outdir, verbose=False,
        generator=GeneratorConfig(forward_mode="compose"))
    res = {"sigma": [float(v) for v in sigma], "data_seconds": t_data}
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = train_fleet(pools, cfg, lr_pools=lr_pools, progress=False, device=dev)
    res["run_seconds"] = time.perf_counter() - t0
    no_kernel_launched("fleet (a)", failures)
    names = out["scene_names"]
    res["scenes"] = {n: check_fleet_scene(os.path.join(outdir, n), FLEET_ITERS,
                                          (FLEET_K, FLEET_ITERS), failures, f"(a) {n}")
                     for n in names}
    for s, n in enumerate(names):
        one = dataclasses.replace(cfg, seed=s, outdir=os.path.join(tmp, f"fleet_a1_{s}"))
        train_fleet([pools[s]], one, scene_names=[n], lr_pools=[lr_pools[s]],
                    progress=False, device=dev)
        res["scenes"][n]["vs_one_scene_fleet"] = compare_runs(
            os.path.join(outdir, n), os.path.join(one.outdir, n), failures,
            f"(a) {n} vs a 1-scene fleet at seed {s}")
    no_kernel_launched("fleet (a)", failures)
    log(f"[fleet] (a) {FLEET_SCENES} scenes x {FLEET_ITERS} iterations (compose, "
        f"real_is_lr, K={FLEET_K}, sigma {[round(float(v), 4) for v in sigma]}) in "
        f"{res['run_seconds']:.1f}s: "
        + "; ".join(f"{n} checks {'ok' if not r['checks_failed'] else r['checks_failed']}"
                    f", vs 1-scene fleet {'ok' if r['vs_one_scene_fleet']['ok'] else 'FAILED'}"
                    f" (rows {r['vs_one_scene_fleet']['rows_max_abs']:.3g}, kernel "
                    f"{r['vs_one_scene_fleet']['kernel_max_abs']:.3g})"
                    for n, r in res["scenes"].items()))
    res["timing"] = {}
    # S = 2 as the package runs it only: the wall's budget (ROADMAP
    # follow-ups) took S = 4 and its run without deterministic algorithms
    for s_n in (1, 2):
        def time_it(s_n=s_n):
            return fleet_timing(cfg, pools[:s_n], lr_pools[:s_n], dev)

        t = with_and_without(time_it) if s_n == 1 else time_it()
        res["timing"][f"S={s_n}"] = t
        log(f"[fleet] (a) " + fleet_line("compose real_is_lr K=20", t)
            + (det_note(t) if "without_deterministic" in t else ""))
    no_kernel_launched("fleet (a) timing", failures)
    return res, outdir


def fleet_cli(tmp: str, dev, failures: list) -> dict:
    """(b): `train_fleet_cli.main --patch-root DIR --format npy` with the
    CLI's defaults (chain, K = 1, batch 16) on 2 scene dirs of 64 .npy
    patches, 20 iterations; each scene against the port's standalone
    `train_single_kernel` at seed s; timing at S = 2."""
    import numpy as np

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.data.sampler import PatchPool
    from kmsr_tpu_torch.pipeline import train_fleet_cli
    from kmsr_tpu_torch.train import SingleKernelConfig, train_single_kernel

    root = os.path.join(tmp, "fleet_b_in")
    pools = []
    for s, name in enumerate(("sceneA", "sceneB")):
        os.makedirs(os.path.join(root, name))
        hr, _ = fleet_scene_pools(10 + s, dev)
        for i, p in enumerate(hr.patches):
            np.save(os.path.join(root, name, f"p{i:03d}.npy"), p)
        pools.append(PatchPool.from_npy_dir(os.path.join(root, name)))
    outdir = os.path.join(tmp, "fleet_b")
    every = FLEET_CLI_ITERS // 2
    kernels.reset_launches()
    res = {}
    t0 = time.perf_counter()
    rc = train_fleet_cli.main(["--patch-root", root, "--format", "npy", "--outdir",
                               outdir, "--iters", str(FLEET_CLI_ITERS), "--log-every",
                               str(every), "--kernel-log-every", str(every)])
    res["run_seconds"] = time.perf_counter() - t0
    if rc != 0:
        failures.append(f"fleet (b): train_fleet_cli returned {rc}")
    res["scenes"] = {}
    for s, name in enumerate(("sceneA", "sceneB")):
        r = check_fleet_scene(os.path.join(outdir, name), FLEET_CLI_ITERS,
                              (every, FLEET_CLI_ITERS), failures, f"(b) {name}")
        one = SingleKernelConfig(iters=FLEET_CLI_ITERS, log_every=every,
                                 kernel_log_every=every, seed=s, verbose=False,
                                 outdir=os.path.join(tmp, f"fleet_b1_{s}"))
        train_single_kernel(pools[s], one, progress=False, device=dev)
        r["vs_standalone"] = compare_runs(os.path.join(outdir, name), one.outdir,
                                          failures, f"(b) {name} vs standalone seed {s}")
        res["scenes"][name] = r
    no_kernel_launched("fleet (b)", failures)
    log(f"[fleet] (b) train_fleet_cli --patch-root (npy, chain, K=1) 2 scenes x "
        f"{FLEET_CLI_ITERS} iterations in {res['run_seconds']:.1f}s: "
        + "; ".join(f"{n} checks {'ok' if not r['checks_failed'] else r['checks_failed']}"
                    f", vs standalone {'ok' if r['vs_standalone']['ok'] else 'FAILED'} "
                    f"(rows {r['vs_standalone']['rows_max_abs']:.3g}, kernel "
                    f"{r['vs_standalone']['kernel_max_abs']:.3g})"
                    for n, r in res["scenes"].items()))
    cfg = SingleKernelConfig(seed=0, verbose=False, outdir=os.path.join(tmp, "unused"))
    res["timing"] = {"S=2": with_and_without(lambda: fleet_timing(cfg, pools, None, dev))}
    log("[fleet] (b) " + fleet_line("chain K=1 host draws", res["timing"]["S=2"])
        + det_note(res["timing"]["S=2"]))
    no_kernel_launched("fleet (b) timing", failures)
    return res


def fleet_factory(tmp: str, kernel_root: str, dev, failures: list) -> dict:
    """(c): `run_factory(kernel_root=...)` on 5 scenes x 64 .npy patches
    `<scene>_<gi>_<gj>.npy` (the fifth without a kernel) with a [64, 5, 32,
    32] pool, x8, batch 128, its .nc writes captured in memory (no h5py on
    this machine): one degrade_v3psn launch a scene batch and no other
    degrade kernel; every lr against the plain degrade(hr, kernel_s) +
    pool[idx], idx drawn from `scene_seed(42, scene)`; the fifth scene's
    files failed as a unit, the rest written."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.ops.degrade import degrade
    from kmsr_tpu_torch.pipeline import factory
    from kmsr_tpu_torch.pipeline.apply_kernel import load_kernel

    indir = os.path.join(tmp, "fleet_c_in")
    os.makedirs(indir)
    rng = np.random.default_rng(SEED + 120)
    names = [f"scene_{s:03d}" for s in range(FLEET_SCENES + 1)]
    for name in names:
        for i in range(FLEET_N):
            np.save(os.path.join(indir, f"{name}_{i // 8:03d}_{i % 8:03d}.npy"),
                    rng.normal(5, 2, (C, HW, HW)).astype(np.float32))
    pool_path = os.path.join(tmp, "fleet_c_pool.npy")
    np.save(pool_path, rng.normal(0, 0.1, (POOL_N, C, HW // FACTOR, HW // FACTOR))
            .astype(np.float32))
    written = {}

    def capture(out_path, hr, lr, nav, lr_attrs=None):
        written[os.path.basename(out_path)] = (hr, lr)

    saved = factory.save_training_sample
    factory.save_training_sample = capture
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        rep = factory.run_factory(indir, None, pool_path, os.path.join(tmp, "fleet_c_out"),
                                  factor=FACTOR, batch_size=128, seed=42,
                                  input_format="npy", kernel_root=kernel_root,
                                  progress=False, device=dev)
        secs = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        factory.save_training_sample = saved
    res = {"seconds": secs, "ok_files": rep.n_ok, "failed_files": rep.n_fail,
           "launches": launches}
    n_kernel = FLEET_SCENES * FLEET_N
    if rep.n_ok != n_kernel or rep.n_fail != FLEET_N or len(written) != n_kernel:
        failures.append(f"fleet (c): {rep.n_ok} ok / {rep.n_fail} failed / "
                        f"{len(written)} written, want {n_kernel} / {FLEET_N} / {n_kernel}")
    if not all(names[-1] in p and "no kernel for scene" in m for p, m in rep.failed):
        failures.append(f"fleet (c): unexpected failures {rep.failed[:3]}")
    batches = FLEET_SCENES * -(-FLEET_N // 128)
    if launches["degrade_v3psn"] != batches or sum(launches.values()) != batches:
        failures.append(f"fleet (c): launches {launches}, want degrade_v3psn once a "
                        f"scene batch ({batches}) and nothing else")
    pool = np.load(pool_path)
    worst = 0.0
    for name in names[:-1]:
        files = sorted(os.path.join(indir, f) for f in os.listdir(indir)
                       if f.startswith(name + "_"))
        _, noise_of = factory.noise_inputs(files, pool_path, factory.scene_seed(42, name))
        kernel = torch.from_numpy(load_kernel(os.path.join(kernel_root, name,
                                                           "kernel_per_band.npy"))).to(dev)
        hr = torch.from_numpy(np.stack([np.load(f) for f in files])).to(dev)
        want = (degrade(hr, kernel, factor=FACTOR)
                + torch.from_numpy(pool[[noise_of[f] for f in files]]).to(dev)).cpu()
        got_hr = np.stack([written[os.path.basename(f)[:-4] + "_train.nc"][0] for f in files])
        got = torch.from_numpy(np.stack(
            [written[os.path.basename(f)[:-4] + "_train.nc"][1] for f in files]))
        if not np.array_equal(got_hr, hr.cpu().numpy()):
            failures.append(f"fleet (c) {name}: hr differs from its files")
        e = errors(got, want)
        worst = max(worst, e["max_abs_err"])
        if not e["ok"]:
            failures.append(f"fleet (c) {name}: lr vs plain degrade + noise {e}")
    res["max_abs_err"] = worst
    log(f"[fleet] (c) run_factory(kernel_root=(a)) {len(names)} scenes x {FLEET_N} .npy: "
        f"{rep.n_ok} written, {rep.n_fail} failed (the scene without a kernel), "
        f"launches {launches}, lr max_abs_err vs plain {worst:.3g}, {secs:.2f}s")
    return res


def phase_fleet(dev, failures: list) -> dict:
    """Phase 13 (module docstring): the fleet through the library and the
    CLI, and the per-scene factory route."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="kmsr_chip_fleet_")
    try:
        res = {}
        res["library"], kernel_root = fleet_library(tmp, dev, failures)
        res["cli"] = fleet_cli(tmp, dev, failures)
        res["factory"] = fleet_factory(tmp, kernel_root, dev, failures)
        res["seconds"] = time.perf_counter() - t0
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

#: phase 14, the known-kernel oracle at scripts/quality_report.py's width
#: (--holdout 24, x8): 24 HR 5x256x256 patches, one chunk of 24, 100 CG
#: iterations; the matched prior's spectrum from 16 more patches; the
#: per-sample route at x4 with the committed x4 bank's kernels. The card is
#: held against the port's CPU run on the first ORACLE_CPU_N patches (one
#: joint system of its own): the CPU's sweep takes ~0.15 s an iteration at
#: the full chunk (~1,000 iterations over the three sweeps at their stops).
ORACLE_N, ORACLE_SPEC_N, ORACLE_ITERS, ORACLE_CPU_N = 24, 16, 100, 3
ORACLE_PSNR_DB = 0.01
X4_BANK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "quality_run_r4", "work_x4", "kernel_run")


def oracle_inputs(dev):
    """(hr [24+16, 5, 256, 256] host f32, the fresh generator's kernel,
    the x8 noise pool [64, 5, 32, 32], the x4 pool [64, 5, 64, 64], the x4
    bank [10, 5, 13, 13]); smooth radiance-like fields (3x3 box mean of
    N(5, 2) plus a per-band ramp) made on the card from seed SEED + 140."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from kmsr_tpu_torch.models import GeneratorConfig, extract_kernels, init_generator

    gen = torch.Generator(device=dev).manual_seed(SEED + 140)
    n = ORACLE_N + ORACLE_SPEC_N
    x = torch.randn(n, C, HW, HW, generator=gen, device=dev) * 2 + 5
    x = F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)
    x = x + torch.linspace(0, 1, HW, device=dev)[None, None, None] * torch.arange(
        1, C + 1, device=dev)[None, :, None, None]
    pool8 = 0.05 * torch.randn(POOL_N, C, HW // 8, HW // 8, generator=gen, device=dev)
    pool4 = 0.05 * torch.randn(POOL_N, C, HW // 4, HW // 4, generator=gen, device=dev)
    kernel = extract_kernels(init_generator(GeneratorConfig(), device=dev)).cpu().numpy()
    bank = np.stack([np.load(os.path.join(X4_BANK, f"kernel_{i}.npy")) for i in range(10)])
    return (x.cpu().numpy(), kernel, pool8.cpu().numpy(), pool4.cpu().numpy(),
            bank.astype(np.float32))


def oracle_lr(hr, kernel, factor, pool, rng, dev):
    """degrade(hr, kernel) + one pool entry a patch (shared [C, k, k] or
    per-sample [N, C, k, k] kernels, the oracle's operator)."""
    import numpy as np
    import torch

    from kmsr_tpu_torch.ops.degrade import degrade, degrade_batch_kernels, normalize_kernel

    x = torch.from_numpy(hr).to(dev)
    k = torch.from_numpy(kernel).to(dev)
    lr = (degrade_batch_kernels(x, normalize_kernel(k), factor=factor, padding="replicate")
          if k.ndim == 4 else degrade(x, k, factor=factor))
    idx = rng.integers(0, len(pool), len(hr))
    return (lr.cpu().numpy() + pool[idx]).astype(np.float32), idx


def oracle_run(label, lr, hr, kernel, factor, prior_kw, dev, failures) -> dict:
    """One sweep through `oracle_sweep` on the card (timed; device time an
    iteration; busy share; peak memory; launches), then on the first
    ORACLE_CPU_N patches on the card, on the CPU and once more on the card
    in float64 at the CPU's chosen lam: the same chosen lam, every lam's
    mean PSNR within ORACLE_PSNR_DB, the same CG stop iteration, and the
    card no further from the float64 solve than twice the CPU is."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.analysis import oracle
    from kmsr_tpu_torch.utils.profiling import cuda_device_ms

    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    stops = {}
    t0 = time.perf_counter()
    best, preds, per_lam = oracle.oracle_sweep(lr, hr, kernel, factor, iters=ORACLE_ITERS,
                                               device=dev, cg_iters=stops, **prior_kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    no_kernel_launched(f"oracle {label}", failures)
    if preds.shape != hr.shape or not np.isfinite(preds).all():
        failures.append(f"oracle {label}: predictions {preds.shape}, finite "
                        f"{bool(np.isfinite(preds).all())}")
    # device time of one lam's solve, an iteration
    per_sample = kernel.ndim == 4
    w_prior = inv = None
    if prior_kw.get("prior") == "matched":
        w_np, inv_np = oracle.matched_prior(prior_kw["spec_examples"], prior_kw["noise_var"])
        w_prior, inv = torch.from_numpy(w_np).to(dev), torch.from_numpy(inv_np).to(dev)
    lr_dev, k_dev = torch.from_numpy(lr).to(dev), torch.from_numpy(kernel).to(dev)

    def solve():
        return oracle._deconv_batch(lr_dev, k_dev, factor, float(best), w_prior, inv,
                                    iters=ORACLE_ITERS, per_sample=per_sample,
                                    return_iters=True)

    # CG leaves its loop at the first look at the stop flag after the stop
    ran = min(ORACLE_ITERS, -(-int(solve()[1]) // oracle._STOP_CHECK) * oracle._STOP_CHECK)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t1) * 1e3
    dev_ms = cuda_device_ms(solve, runs=1, warmup=0)["device_ms"]
    no_kernel_launched(f"oracle {label} timing", failures)

    # card vs CPU (and float64 on the card) on the first ORACLE_CPU_N patches
    m = ORACLE_CPU_N
    sub = (lr[:m], hr[:m], kernel[:m] if per_sample else kernel, factor)
    card_stops, cpu_stops = {}, {}
    best_c, preds_c, res_c = oracle.oracle_sweep(*sub, iters=ORACLE_ITERS, device=dev,
                                                 cg_iters=card_stops, **prior_kw)
    t2 = time.perf_counter()
    best_h, preds_h, res_h = oracle.oracle_sweep(*sub, iters=ORACLE_ITERS, device="cpu",
                                                 cg_iters=cpu_stops, **prior_kw)
    cpu_s = time.perf_counter() - t2
    f64 = oracle._deconv_batch(
        torch.from_numpy(sub[0]).to(dev, torch.float64),
        torch.from_numpy(sub[2]).to(dev, torch.float64), factor, float(best_h),
        None if w_prior is None else w_prior.double(), None if inv is None else inv.double(),
        iters=ORACLE_ITERS, per_sample=per_sample).cpu().numpy()
    d_card, d_cpu = float(np.abs(preds_c - f64).max()), float(np.abs(preds_h - f64).max())
    psnr_diff = max(abs(res_c[lam] - res_h[lam]) for lam in res_h)
    checks = {"same_lam": best_c == best_h, "psnr_within": psnr_diff <= ORACLE_PSNR_DB,
              "same_stop": card_stops == cpu_stops, "f64_yardstick": d_card <= 2 * d_cpu}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        failures.append(f"oracle {label}: card vs CPU failed {bad}: lam {best_c} vs {best_h}, "
                        f"PSNR diff {psnr_diff:.3g} dB, stops {card_stops} vs {cpu_stops}, "
                        f"from float64 card {d_card:.3g} vs CPU {d_cpu:.3g}")
    no_kernel_launched(f"oracle {label} card-vs-CPU", failures)
    n_lams = len(per_lam)
    res = {"best_lam": best, "psnr_by_lam": {str(k): v for k, v in per_lam.items()},
           "cg_stop_iters": {str(k): v for k, v in stops.items()}, "seconds": wall,
           "seconds_per_lam": wall / n_lams, "solve_ms": solve_ms, "solve_iters_run": ran,
           "wall_ms_per_iter": solve_ms / ran,
           "device_ms_per_iter": dev_ms / ran, "busy_share": dev_ms / solve_ms,
           "peak_mem_gb": peak, "checks_failed": bad,
           "cpu_check": {"patches": m, "best_lam_card": best_c, "best_lam_cpu": best_h,
                         "max_psnr_diff_db": psnr_diff, "stops_card": card_stops,
                         "stops_cpu": cpu_stops, "card_from_f64": d_card,
                         "cpu_from_f64": d_cpu, "cpu_seconds": cpu_s}}
    log(f"[oracle] {label}: best lam {best} of {n_lams} ({', '.join(f'{k:g}: {v:.3f}' for k, v in per_lam.items())} dB), "
        f"CG stops {sorted(set(v for vs in stops.values() for v in vs))}; {wall:.2f}s "
        f"({wall / n_lams:.3f} s a lam), best lam's solve {solve_ms:.1f} ms for {ran} "
        f"iterations, {res['wall_ms_per_iter']:.3f} ms an iteration "
        f"(device {res['device_ms_per_iter']:.3f}, busy {res['busy_share']:.3f}), peak "
        f"{peak:.2f} GB; card vs CPU on {m} patches {'ok' if not bad else 'FAILED ' + str(bad)}"
        f" (lam {best_c} / {best_h}, PSNR within {psnr_diff:.2e} dB, from float64 card "
        f"{d_card:.3g} / CPU {d_cpu:.3g}, CPU {cpu_s:.1f}s)")
    return res


def phase_oracle(dev, failures: list) -> dict:
    """Phase 14 (module docstring): the known-kernel deconvolution oracle,
    gradient and matched priors at x8 and per-sample kernels at x4."""
    import numpy as np

    t0 = time.perf_counter()
    hr_all, kernel, pool8, pool4, bank = oracle_inputs(dev)
    hr, spec = hr_all[:ORACLE_N], hr_all[ORACLE_N:]
    rng = np.random.default_rng(SEED + 141)
    lr8, _ = oracle_lr(hr, kernel, FACTOR, pool8, rng, dev)
    res = {"data_seconds": time.perf_counter() - t0}
    res["grad_x8"] = oracle_run("(a) grad x8", lr8, hr, kernel, FACTOR, {"prior": "grad"},
                                dev, failures)
    noise_var = pool8.var(axis=(0, 2, 3)).astype(np.float64)
    res["matched_x8"] = oracle_run(
        "(b) matched x8", lr8, hr, kernel, FACTOR,
        {"prior": "matched", "noise_var": noise_var, "spec_examples": spec}, dev, failures)
    per_patch = bank[rng.integers(0, len(bank), ORACLE_N)]
    lr4, _ = oracle_lr(hr, per_patch, 4, pool4, rng, dev)
    res["per_sample_x4"] = oracle_run("(c) per-sample x4", lr4, hr, per_patch, 4,
                                      {"prior": "grad"}, dev, failures)
    res["seconds"] = time.perf_counter() - t0
    return res


# --------------------------------------------------------------- phase 15
#: phase 15: a trainer's DP run and plain run take DP_ITERS steps; the DP
#: overhead is the median of DP_WINDOWS synchronized windows of
#: DP_WINDOW_ITERS steps, after DP_WARMUP steps, DP and plain alternating
DP_ITERS, DP_WINDOWS, DP_WINDOW_ITERS, DP_WARMUP = 4, 5, 6, 2
DP_N = 16  # patches (or SR pairs) of a trainer's pool


def same(label: str, got, want, failures: list, exact: bool = True) -> dict:
    """got vs want (tensors or arrays, NaN cells compared as cells): bit for
    bit when `exact`, else at the tolerance; a failure is recorded."""
    import numpy as np
    import torch

    got, want = (torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor)
                 else a.detach().cpu() for a in (got, want))
    nan = torch.isnan(want)
    res = {"bit_equal": bool(torch.equal(torch.isnan(got), nan)
                             and torch.equal(got[~nan], want[~nan]))}
    res.update(errors(got[~nan].double(), want[~nan].double()) if got.shape == want.shape
               else {"ok": False, "max_abs_err": None})
    res["ok"] = res["bit_equal"] or (not exact and res["ok"]
                                     and torch.equal(torch.isnan(got), nan))
    if not res["ok"]:
        failures.append(f"parallel {label}: {res}")
    return res


def launches_of(label: str, want: dict, failures: list) -> dict:
    """The eight launch counts since the last reset; every kernel not in
    `want` must read 0, every one in it its count."""
    from kmsr_tpu_torch import kernels

    got = dict(kernels.LAUNCHES)
    bad = {k: n for k, n in got.items() if n != want.get(k, 0)}
    if bad:
        failures.append(f"parallel {label}: launches {bad}, want {want}")
    return {k: n for k, n in got.items() if n}


def dp_local(dev, failures: list) -> dict:
    """(a): the local-DP stages on the card list (one card: n_dev = 1) and on
    [cuda:0, cuda:0] (two blocks on one card, the multi-card code path),
    each against its plain one-device computation in this process."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.models.sr import SRConfig, init_sr, sr_forward
    from kmsr_tpu_torch.ops import nlm
    from kmsr_tpu_torch.ops.degrade_fused import degrade_fused_presplit
    from kmsr_tpu_torch.parallel.local_dp import local_batch_dp
    from kmsr_tpu_torch.pipeline import apply_kernel, factory, sr_infer

    two = [torch.device("cuda", 0)] * 2
    res = {"devices": [str(d) for d in local_batch_dp("cuda")[0]]}
    if len(res["devices"]) != 1:
        failures.append(f"parallel: expected one card, got {res['devices']}")
    tmp = tempfile.mkdtemp(prefix="kmsr_dp_")
    try:
        sets, k_path, pools = write_inputs(tmp)
        files = sets[HW]
        kernel, pool, noise_of = factory.factory_inputs(files, k_path, pools[HW, FACTOR],
                                                        42, dev)
        # the plain route: the presplit kernel on each whole batch
        plain = []
        for paths, xp, _, _ in factory._npy_split_batches(files, B, (C, HW, HW), FACTOR, dev):
            noise = np.ascontiguousarray(np.transpose(
                pool[[noise_of[p] for p in paths]], (1, 2, 3, 0)))
            plain.append(degrade_fused_presplit(
                xp.to(dev), kernel, noise=torch.from_numpy(noise).to(dev),
                factor=FACTOR).permute(3, 0, 1, 2).cpu())
        fac = {}
        for label, devices, n_launch in (("cards", None, 2), ("two blocks", two, 4)):
            kernels.reset_launches()
            lrs = [lr.cpu() for _, _, lr, _ in factory.presplit_batches(
                files, kernel, pool, noise_of, shape=(C, HW, HW), factor=FACTOR,
                batch_size=B, device="cuda", devices=devices)]
            torch.cuda.synchronize()
            fac[label] = {"launches": launches_of(f"factory {label}",
                                                  {"degrade_v3psn": n_launch}, failures),
                          **same(f"factory {label}", torch.cat(lrs), torch.cat(plain),
                                 failures)}
        res["factory"] = fac

        # the NLM chunk (8 files, NaN holes, a dead band) at h_factor 1.0
        stacks = denoise_data()[0][:8]
        flat = stacks.reshape(-1, HW, HW)
        valid = ~np.isnan(flat)
        fills = np.array([np.nanmean(f) if v.any() else 0.0 for f, v in zip(flat, valid)],
                         np.float32)
        x = torch.from_numpy(np.where(valid, flat, fills[:, None, None]).astype(np.float32))
        x = x.to(dev)
        sig = nlm.estimate_sigma(x)
        den = nlm.nlm_denoise_2d(x, sig * 1.0, sig).cpu().numpy().reshape(stacks.shape)
        want = np.where(valid.reshape(stacks.shape), den, np.nan).astype(np.float32)
        dead = ~valid.reshape(stacks.shape).any(axis=(2, 3))
        want[dead] = stacks[dead]
        dn = {}
        for label, devices in (("cards", None), ("two blocks", two)):
            kernels.reset_launches()
            got, sigmas = nlm.denoise_batch_finalize(
                nlm.denoise_batch_dispatch(stacks, 1.0, "cuda", devices=devices))
            dn[label] = {"launches": launches_of(f"nlm {label}", {}, failures),
                         **same(f"nlm {label}", got, want, failures),
                         "sigmas": same(f"nlm {label} sigmas", sigmas, np.where(
                             dead, 0.0, sig.cpu().numpy().reshape(dead.shape)
                         ).astype(np.float32), failures)}
        res["nlm"] = dn

        # sr_infer's device loop: 24 pairs at the x8 model's width
        cfg = SRConfig()
        params = init_sr(cfg, seed=SEED + 15, device=dev)
        rng = np.random.default_rng(SEED + 15)
        lrs = [rng.normal(3, 1, (C, 32, 32)).astype(np.float32) for _ in range(24)]
        hrs = [rng.normal(3, 1, (C, 256, 256)).astype(np.float32) for _ in range(24)]
        p_pred, p_met, done = sr_infer.dispatch(params, lrs, hrs, cfg, dev)
        done.synchronize()
        with torch.no_grad():
            f32 = sr_forward(params, torch.from_numpy(np.stack(lrs)).to(dev), cfg,
                             compute_dtype=torch.float32).cpu()
        own_bf16 = float((p_pred - f32).abs().max())
        sr = {}
        for label, devices in (("cards", None), ("two blocks", two)):
            out = []
            kernels.reset_launches()
            fails = sr_infer.run_batches(
                [([str(i) for i in range(24)], list(zip(lrs, hrs)), [])], params, cfg,
                lambda p, preds, m, out=out: out.append((preds, m)), "cuda", devices)
            if fails or len(out) != 1:
                failures.append(f"parallel sr_infer {label}: {fails}, {len(out)} groups")
                continue
            sr[label] = {"launches": launches_of(f"sr_infer {label}", {}, failures),
                         "metrics": same(f"sr_infer {label} metrics", out[0][1], p_met,
                                         failures, exact=devices is None)}
            if devices is None:
                sr[label]["preds"] = same(f"sr_infer {label}", out[0][0], p_pred, failures)
            else:
                # two blocks run the bf16 network on half batches, where cuDNN
                # may pick another algorithm: phase 12's bf16 rule, no further
                # from the f32 forward than twice the whole batch's bf16 is
                d = float((torch.from_numpy(out[0][0]) - f32).abs().max())
                sr[label]["preds"] = {
                    "bit_equal": bool(np.array_equal(out[0][0], p_pred.numpy())),
                    "max_abs_from_f32": d, "whole_batch_max_abs_from_f32": own_bf16,
                    "ok": d <= 2 * own_bf16}
                if not sr[label]["preds"]["ok"]:
                    failures.append(f"parallel sr_infer {label}: {sr[label]['preds']}")
        res["sr_infer"] = sr

        # apply_kernel's device part: 24 patches in one shape group
        stacks_ak = [np.load(p) for p in files[:24]]
        fn, _ = apply_kernel.make_degrader(k_path, None, FACTOR, dev)
        want_ak = fn(torch.from_numpy(np.stack(stacks_ak)).to(dev))[0].cpu()
        ak = {}
        for label, devices in (("cards", None), ("two blocks", two)):
            kernels.reset_launches()
            devs, fns, _ = apply_kernel.make_degraders(k_path, None, FACTOR, "cuda", devices)
            got_ak, experts = apply_kernel.degrade_group(stacks_ak, fns, devs)
            ak[label] = {"launches": launches_of(f"apply_kernel {label}", {}, failures),
                         **same(f"apply_kernel {label}", got_ak, want_ak, failures,
                                exact=devices is None)}
            if experts is not None:
                failures.append("parallel apply_kernel: experts on the kernel route")
        res["apply_kernel"] = ak
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def dp_scene(mesh, dev, failures: list) -> dict:
    """(b) the whole scene through the ranks path at 5x8192^2: the scene
    tensor's row slab of this rank (`degrade_scene(mesh=)`, one
    `colsplit_raw` launch) against the n_shards = 1 path bit for bit, and
    the NaN-aware stage code (`degrade_scene_ranks`, band means
    all-reduced) against `degrade_scene_file` on the same host scene."""
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.parallel import spatial
    from kmsr_tpu_torch.pipeline.degrade_scene import degrade_scene_file, degrade_scene_ranks

    gen = torch.Generator(device=dev).manual_seed(SEED + 150)
    x = torch.randn(SCENE_C, SCENE_HW, SCENE_HW, generator=gen, device=dev) * 2 + 5
    k = torch.rand(SCENE_C, SCENE_K, SCENE_K, generator=gen, device=dev) + 0.1
    res = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = spatial.degrade_scene(x, k, factor=FACTOR, mesh=mesh)
    torch.cuda.synchronize()
    res["ranks_seconds"] = time.perf_counter() - t0
    res["ranks_launches"] = launches_of("scene ranks", {"colsplit_raw": 1}, failures)
    res["ranks"] = same("scene ranks", got, spatial.degrade_scene(x, k, factor=FACTOR),
                        failures)
    host = x.cpu().numpy()
    host[:, 1000:1400, 2000:2600] = float("nan")
    del got, x
    kernels.reset_launches()
    got = degrade_scene_ranks(lambda lo, hi: host[:, lo:hi], SCENE_HW, k, mesh, FACTOR)
    res["stage_launches"] = launches_of("scene stage ranks", {"colsplit_raw": 1}, failures)
    res["stage"] = same("scene stage ranks", got, degrade_scene_file(host, k, FACTOR),
                        failures, exact=False)
    del host
    torch.cuda.empty_cache()
    return res


def dp_pool(n: int, side: int, seed: int, dev):
    """[n, 5, side, side] float32 host array: a smooth field made on the card."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, C, side, side, generator=gen, device=dev) * 2 + 5
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False).cpu().numpy()


def tree_same(label: str, got, want, failures: list) -> dict:
    """Two parameter / state trees (or artifact dirs' arrays) bit for bit."""
    import torch

    from kmsr_tpu_torch.train.state import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    ok = len(a) == len(b) and all(torch.equal(x.detach().cpu(), y.detach().cpu())
                                  for x, y in zip(a, b))
    worst = max((float((x.detach().cpu() - y.detach().cpu()).abs().max())
                 for x, y in zip(a, b) if x.shape == y.shape), default=None)
    if not ok:
        failures.append(f"parallel {label}: differs from the plain run (max abs {worst})")
    return {"bit_equal": ok, "leaves": len(a), "max_abs_err": worst}


def dir_same(label: str, got_dir: str, want_dir: str, failures: list) -> dict:
    """Every .npy / .txt / .csv artifact of two run dirs byte for byte (the
    .npz models array for array: zip members carry their write time)."""
    import numpy as np

    names = sorted(n for n in os.listdir(want_dir) if os.path.isfile(os.path.join(want_dir, n)))
    diff = []
    for n in names:
        a, b = os.path.join(got_dir, n), os.path.join(want_dir, n)
        if not os.path.exists(a):
            diff.append(n)
        elif n.endswith(".npz"):
            x, y = np.load(a), np.load(b)
            if x.files != y.files or not all(np.array_equal(x[f], y[f]) for f in x.files):
                diff.append(n)
        elif open(a, "rb").read() != open(b, "rb").read():
            diff.append(n)
    if diff or not names:
        failures.append(f"parallel {label}: artifacts differ {diff} of {names}")
    return {"files": len(names), "differ": diff}


def dp_trainers(mesh, dev, failures: list) -> dict:
    """(b) each trainer DP_ITERS steps with the mesh (NCCL, world size 1) and
    without it, host batches both: KernelGAN chain and compose with
    fake-side noise and SR through the library calls (their CLIs read .nc
    patches: no h5py on the card's machine), MoE and dynamic through their
    CLIs with --data-parallel on .npy patches; every parameter, BatchNorm
    statistic and artifact bit for bit."""
    import dataclasses

    import numpy as np

    from kmsr_tpu_torch.data.sampler import PatchPool
    from kmsr_tpu_torch.models.generator import GeneratorConfig
    from kmsr_tpu_torch.pipeline import train_dynamic_cli, train_moe_cli
    from kmsr_tpu_torch.train.single_kernel import SingleKernelConfig, train_single_kernel
    from kmsr_tpu_torch.train.sr import SRTrainConfig, train_sr

    res = {}
    tmp = tempfile.mkdtemp(prefix="kmsr_dpt_")
    try:
        pool = PatchPool(dp_pool(DP_N, HW, SEED + 151, dev))
        for mode, extra in (("chain", {}),
                            ("compose", {"fake_noise_sigma": (0.1, 0.2, 0.1, 0.3, 0.1)})):
            cfg = SingleKernelConfig(iters=DP_ITERS, log_every=2, kernel_log_every=DP_ITERS,
                                     device_pool=False, verbose=False,
                                     generator=GeneratorConfig(forward_mode=mode), **extra)
            runs = {}
            for label, m in (("dp", mesh), ("plain", None)):
                out_dir = os.path.join(tmp, f"kg_{mode}_{label}")
                t0 = time.perf_counter()
                runs[label] = train_single_kernel(
                    pool, dataclasses.replace(cfg, outdir=out_dir), progress=False,
                    device=dev, mesh=m)
                runs[label]["seconds"] = time.perf_counter() - t0
            st = {k: runs[k]["state"] for k in runs}
            res[f"kernelgan_{mode}"] = {
                "params": tree_same(f"kernelgan {mode} params",
                                    [st["dp"].g_params, st["dp"].d_params],
                                    [st["plain"].g_params, st["plain"].d_params], failures),
                "d_state": tree_same(f"kernelgan {mode} D state", st["dp"].d_state,
                                     st["plain"].d_state, failures),
                "artifacts": dir_same(f"kernelgan {mode}", os.path.join(tmp, f"kg_{mode}_dp"),
                                      os.path.join(tmp, f"kg_{mode}_plain"), failures),
                "seconds": {k: r["seconds"] for k, r in runs.items()}}

        npy_dir = os.path.join(tmp, "npy")
        os.makedirs(npy_dir)
        for i, p in enumerate(pool.patches):
            np.save(os.path.join(npy_dir, f"p{i:03d}.npy"), p)
        for name, cli, args, sub in (
                ("moe", train_moe_cli, ["--batch-size", "8", "--balance-weight", "0.5"], ""),
                ("dynamic", train_dynamic_cli, ["--batch-size", "8"], "final_results")):
            secs = {}
            for label, flag in (("dp", ["--data-parallel"]), ("plain", [])):
                t0 = time.perf_counter()
                rc = cli.main(["--patch-dir", npy_dir, "--format", "npy", "--iters",
                               str(DP_ITERS), "--outdir", os.path.join(tmp, f"{name}_{label}"),
                               "--device", "cuda"] + args + flag)
                secs[label] = time.perf_counter() - t0
                if rc != 0:
                    failures.append(f"parallel {name} CLI {label}: rc {rc}")
            res[name] = {"artifacts": dir_same(
                name, os.path.join(tmp, f"{name}_dp", sub),
                os.path.join(tmp, f"{name}_plain", sub), failures), "seconds": secs}
            if name == "dynamic":
                res[name]["log"] = dir_same("dynamic log", os.path.join(tmp, "dynamic_dp"),
                                            os.path.join(tmp, "dynamic_plain"), failures)

        rng = np.random.default_rng(SEED + 152)
        hr = dp_pool(DP_N, HW, SEED + 153, dev)
        lr = hr.reshape(DP_N, C, 32, FACTOR, 32, FACTOR).mean(axis=(3, 5)) \
            + rng.normal(0, 0.05, (DP_N, C, 32, 32)).astype(np.float32)
        cfg = SRTrainConfig(iters=DP_ITERS, batch_size=8, log_every=2, eval_every=DP_ITERS,
                            device_pool=False)
        runs = {}
        for label, m in (("dp", mesh), ("plain", None)):
            t0 = time.perf_counter()
            runs[label] = train_sr((lr.astype(np.float32), hr),
                                   dataclasses.replace(cfg, outdir=os.path.join(tmp, f"sr_{label}")),
                                   mesh=m, progress=False, device=dev)
            runs[label]["seconds"] = time.perf_counter() - t0
        res["sr"] = {"params": tree_same("sr params", runs["dp"]["state"].params,
                                         runs["plain"]["state"].params, failures),
                     "log_equal": runs["dp"]["log"] == runs["plain"]["log"],
                     "artifacts": dir_same("sr", os.path.join(tmp, "sr_dp"),
                                           os.path.join(tmp, "sr_plain"), failures),
                     "seconds": {k: r["seconds"] for k, r in runs.items()}}
        if not res["sr"]["log_equal"]:
            failures.append("parallel sr: DP log differs from the plain log")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def dp_fleet(dev, failures: list) -> dict:
    """(b) the fleet with a scene mesh (NCCL, world size 1) at S = 2 against
    the fleet without one: every scene's artifacts byte for byte."""
    import dataclasses

    from kmsr_tpu_torch.data.sampler import PatchPool
    from kmsr_tpu_torch.models.generator import GeneratorConfig
    from kmsr_tpu_torch.parallel.mesh import make_mesh
    from kmsr_tpu_torch.train.fleet import train_fleet
    from kmsr_tpu_torch.train.single_kernel import SingleKernelConfig

    mesh = make_mesh(axis_names=("scene",), device="cuda")
    pools = [PatchPool(dp_pool(DP_N, HW, SEED + 154 + s, dev)) for s in range(2)]
    cfg = SingleKernelConfig(iters=DP_ITERS, log_every=2, kernel_log_every=DP_ITERS,
                             verbose=False, generator=GeneratorConfig(forward_mode="compose"))
    tmp = tempfile.mkdtemp(prefix="kmsr_dpf_")
    try:
        outs = {label: train_fleet(pools, dataclasses.replace(cfg, outdir=os.path.join(tmp, label)),
                                   mesh=m, progress=False, device=dev)
                for label, m in (("mesh", mesh), ("plain", None))}
        res = {"mesh": {"axis": mesh.axis_name, "size": mesh.size},
               "scenes": len(pools),
               "kernels": same("fleet kernels", outs["mesh"]["kernel_per_band"],
                               outs["plain"]["kernel_per_band"], failures)}
        for name in outs["plain"]["scene_names"]:
            res[name] = dir_same(f"fleet {name}", os.path.join(tmp, "mesh", name),
                                 os.path.join(tmp, "plain", name), failures)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def dp_overhead(mesh, dev, card: str) -> dict:
    """Iterations/s of each trainer's step with and without the data-
    parallel mesh (NCCL, world size 1: the gradient all-reduce, the
    BatchNorm statistics' all-reduces, the draws at the global shape),
    host batches on the card already: the median of DP_WINDOWS synchronized
    windows of DP_WINDOW_ITERS steps, DP and plain windows alternating."""
    import statistics

    import torch

    from kmsr_tpu_torch.device import deterministic
    from kmsr_tpu_torch.models.generator import GeneratorConfig
    from kmsr_tpu_torch.parallel.mesh import data_parallel
    from kmsr_tpu_torch.train import dynamic, moe, single_kernel, sr

    hr = torch.from_numpy(dp_pool(DP_N, HW, SEED + 160, dev)).to(dev)
    cases = {}
    kg = single_kernel.SingleKernelConfig(generator=GeneratorConfig(forward_mode="compose"))
    cases["kernelgan_compose"] = (single_kernel.init_training(kg, dev),
                                  single_kernel.make_base_step(kg), (hr[:16], hr[:16]))
    mc = moe.MoETrainConfig()
    base = moe.make_moe_base_step(mc)
    cases["moe"] = (moe.init_moe_training(mc, device=dev),
                    lambda st, a, b: base(st, a, b, 2.0), (hr[:8], hr[8:16]))
    dc = dynamic.DynamicTrainConfig()
    cases["dynamic"] = (dynamic.init_dynamic_training(dc, dev),
                        dynamic.make_dynamic_base_step(dc), (hr[:8], hr[8:16]))
    sc = sr.SRTrainConfig()
    lr = torch.nn.functional.avg_pool2d(hr, FACTOR)
    sstep, _ = sr.make_sr_train_step(sc)
    cases["sr"] = (sr.init_sr_training(sc, dev), sstep,
                   (lr.repeat(2, 1, 1, 1), hr.repeat(2, 1, 1, 1)))
    res = {"card": card, "world_size": mesh.size, "backend": "nccl"}
    for name, (state, step, args) in cases.items():
        walls = {"dp": [], "plain": []}
        with deterministic(dev):
            for m in (mesh, None):
                with data_parallel(m):
                    for _ in range(DP_WARMUP):
                        state, _ = step(state, *args)
            for _ in range(DP_WINDOWS):
                for label, m in (("plain", None), ("dp", mesh)):
                    with data_parallel(m):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        for _ in range(DP_WINDOW_ITERS):
                            state, _ = step(state, *args)
                        torch.cuda.synchronize()
                    walls[label].append((time.perf_counter() - t0) / DP_WINDOW_ITERS)
        med = {k: statistics.median(v) for k, v in walls.items()}
        res[name] = {"iters_per_s": 1 / med["dp"], "plain_iters_per_s": 1 / med["plain"],
                     "dp_over_plain_wall": med["dp"] / med["plain"],
                     "wall_ms_windows": {k: [w * 1e3 for w in v] for k, v in walls.items()},
                     "batch": int(args[0].shape[0])}
        log(f"[parallel] DP overhead {name} (batch {res[name]['batch']}): "
            f"{res[name]['iters_per_s']:.2f} it/s with the mesh, "
            f"{res[name]['plain_iters_per_s']:.2f} without (wall x"
            f"{res[name]['dp_over_plain_wall']:.3f})")
    return res


def phase_parallel(dev, card: str, failures: list) -> dict:
    """Phase 15 (module docstring): local DP on the card list, then an
    in-process NCCL group of world size 1 for the ranks path, the trainers'
    DP runs, the scene-parallel fleet and the DP overhead."""
    import datetime

    import torch
    import torch.distributed as dist

    from kmsr_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    res = {"local_dp": dp_local(dev, failures)}
    res["local_dp_seconds"] = time.perf_counter() - t0
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(device="cuda")
        res["mesh"] = {"backend": dist.get_backend(), "size": mesh.size,
                       "device": str(mesh.device)}
        t1 = time.perf_counter()
        res["scene"] = dp_scene(mesh, dev, failures)
        t2 = time.perf_counter()
        res["trainers"] = dp_trainers(mesh, dev, failures)
        t3 = time.perf_counter()
        res["fleet"] = dp_fleet(dev, failures)
        t4 = time.perf_counter()
        res["overhead"] = dp_overhead(mesh, dev, card)
        res["part_seconds"] = {"scene": t2 - t1, "trainers": t3 - t2, "fleet": t4 - t3,
                               "overhead": time.perf_counter() - t4}
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


# --------------------------------------------------------------- phase 16
#: phase 16: (a) a SyncWatchdog with thresholds of WATCH_S around a sync on
#: a ~WATCH_SLEEP_S sleep kernel, then the factory's .npy route watched and
#: not; (b) TP_STEPS tensor-parallel steps on a (1, 1) mesh against the
#: plain step, and TP / plain wall over TP_WINDOWS windows of
#: TP_WINDOW_ITERS steps; (c) the quality report's array function over
#: QUALITY_HOLDOUT pairs (QUALITY_TRAIN more for the matched prior's
#: spectrum), card vs CPU on the first QUALITY_CPU_N holdout pairs
WATCH_SLEEP_S, WATCH_S = 0.5, 0.05
TP_STEPS, TP_WINDOWS, TP_WINDOW_ITERS = 2, 5, 3
QUALITY_HOLDOUT, QUALITY_TRAIN, QUALITY_CPU_N = 24, 16, 3
REPO = os.path.dirname(os.path.abspath(__file__))


def watchdog_part(dev, failures: list) -> dict:
    """(a) The watchdog's pending state on the card, then the factory's
    .npy route with sync_watch armed at its defaults against the same route
    with KMSR_SYNC_WATCHDOG=0, its .nc writes captured in memory."""
    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.pipeline import common, factory

    logs, aborts = [], []
    wd = common.SyncWatchdog(label="smoke", threshold_s=WATCH_S, poll_s=WATCH_S,
                             wedge_abort_s=WATCH_S, on_abort=aborts.append, log=logs.append)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(int(WATCH_SLEEP_S * max_sm_clock_hz()))
        with wd.watch():
            torch.cuda.synchronize()
        slept = time.perf_counter() - t0
    finally:
        wd.stop()
    states = [st for _, st in wd.diagnoses]
    res = {"sleep_s": slept, "diagnoses": wd.diagnoses, "aborts": len(aborts),
           "log": logs[:2]}
    if "device_pending" not in states or aborts or not any(
            "still running queued work" in m for m in logs):
        failures.append(f"phase 16 (a): watchdog on a {slept:.2f}s sync: diagnoses "
                        f"{wd.diagnoses}, aborts {aborts}, log {logs[:2]}")

    tmp = tempfile.mkdtemp(prefix="kmsr_chip_watch_")
    try:
        rng = np.random.default_rng(SEED + 170)
        indir = os.path.join(tmp, "in")
        os.makedirs(indir)
        for i in range(N_FILES):
            np.save(os.path.join(indir, f"p{i:04d}.npy"),
                    rng.normal(5, 2, (C, HW, HW)).astype(np.float32))
        k_path, pool_path = os.path.join(tmp, "k.npy"), os.path.join(tmp, "pool.npy")
        np.save(k_path, rng.uniform(0.1, 1, (C, KSIZE, KSIZE)).astype(np.float32))
        np.save(pool_path, rng.normal(0, 0.1, (POOL_N, C, HW // FACTOR, HW // FACTOR))
                .astype(np.float32))
        runs = {}
        saved, env = factory.save_training_sample, os.environ.pop("KMSR_SYNC_WATCHDOG", None)
        try:
            for label in ("watched", "unwatched"):
                written = {}
                factory.save_training_sample = (
                    lambda out, hr, lr, nav, lr_attrs=None, w=written:
                    w.__setitem__(os.path.basename(out), lr))
                if label == "unwatched":
                    os.environ["KMSR_SYNC_WATCHDOG"] = "0"
                kernels.reset_launches()
                t0 = time.perf_counter()
                rep = factory.run_factory(indir, k_path, pool_path, os.path.join(tmp, label),
                                          factor=FACTOR, batch_size=B, seed=42,
                                          input_format="npy", progress=False, device=dev)
                runs[label] = {"written": written, "ok": rep.n_ok, "failed": rep.n_fail,
                               "launches": dict(kernels.LAUNCHES),
                               "seconds": time.perf_counter() - t0}
        finally:
            factory.save_training_sample = saved
            os.environ.pop("KMSR_SYNC_WATCHDOG", None)
            if env is not None:
                os.environ["KMSR_SYNC_WATCHDOG"] = env
        wd = common._WATCHDOGS.get("factory")
        armed = None if wd is None else {k: getattr(wd, k) for k in (
            "threshold_s", "poll_s", "wedge_abort_s")}
        if armed != {"threshold_s": 120.0, "poll_s": 30.0, "wedge_abort_s": 900.0}:
            failures.append(f"phase 16 (a): the factory's watchdog {armed}, want JAX's defaults")
        w, u = runs["watched"]["written"], runs["unwatched"]["written"]
        same_lr = w.keys() == u.keys() and len(w) == N_FILES and all(
            np.array_equal(w[k], u[k]) for k in w)
        batches = -(-N_FILES // B)
        for label, r in runs.items():
            if r["launches"] != {**{k: 0 for k in r["launches"]}, "degrade_v3psn": batches}:
                failures.append(f"phase 16 (a) factory {label}: launches {r['launches']}, "
                                f"want degrade_v3psn once a batch ({batches})")
            if r["ok"] != N_FILES or r["failed"]:
                failures.append(f"phase 16 (a) factory {label}: {r['ok']} ok, {r['failed']} failed")
        if not same_lr:
            failures.append("phase 16 (a): the watched factory's lr differs from the unwatched")
        res["factory"] = {"watchdog": armed, "lr_bit_equal": same_lr,
                          "launches": runs["watched"]["launches"],
                          "unwatched_launches": runs["unwatched"]["launches"],
                          "diagnoses": [] if wd is None else wd.diagnoses,
                          "seconds": {k: r["seconds"] for k, r in runs.items()}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[tools] (a) watchdog: {WATCH_SLEEP_S}s sleep kernel synced in {slept:.2f}s, "
        f"diagnoses {wd_states(res['diagnoses'])}, {len(aborts)} aborts; factory .npy "
        f"watched vs unwatched lr bit-equal {res['factory']['lr_bit_equal']}, launches "
        f"{ {k: n for k, n in res['factory']['launches'].items() if n} }")
    return res


def wd_states(diagnoses) -> dict:
    out: dict = {}
    for _, st in diagnoses:
        out[st] = out.get(st, 0) + 1
    return out


def tp_part(dev, card: str, failures: list) -> dict:
    """(b) An in-process NCCL group of world size 1 and its (1, 1) (data,
    model) mesh: TP_STEPS KernelGAN steps at the default widths (chain;
    compose with fake-side noise) on the sharded state inside
    `data_parallel(mesh)` against the plain step, under the deterministic
    algorithms, every parameter, D state leaf, Adam moment and metric bit
    for bit; the collectives of one TP step, by axis; TP / plain wall."""
    import datetime
    import statistics

    import torch
    import torch.distributed as dist

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.device import deterministic
    from kmsr_tpu_torch.models.generator import GeneratorConfig
    from kmsr_tpu_torch.parallel.gan_sharding import shard_state, sharded_axis
    from kmsr_tpu_torch.parallel.mesh import data_parallel, make_mesh, shard_batch
    from kmsr_tpu_torch.train.single_kernel import (SingleKernelConfig, init_training,
                                                    make_train_step)

    res = {"card": card}
    host = dp_pool(DP_N, HW, SEED + 171, dev)
    hr = torch.from_numpy(host).to(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        res["mesh"] = {"shape": mesh.shape, "backend": dist.get_backend(),
                       "device": str(mesh.device)}
        for mode, extra in (("chain", {}),
                            ("compose", {"fake_noise_sigma": (0.1, 0.2, 0.1, 0.3, 0.1)})):
            cfg = SingleKernelConfig(verbose=False, generator=GeneratorConfig(forward_mode=mode),
                                     **extra)
            plain = init_training(cfg, dev)
            tp = shard_state(mesh, init_training(cfg, dev))
            n_sharded = sum(sharded_axis(t) is not None
                            for t in tree_leaves_of(tp.g_params, tp.d_params))
            step = make_train_step(cfg)
            kernels.reset_launches()
            same_metrics = True
            with deterministic(dev):
                for _ in range(TP_STEPS):
                    plain, m_p = step(plain, hr, hr)
                    with data_parallel(mesh):
                        tp, m_t = step(tp, shard_batch(mesh, host), shard_batch(mesh, host))
                    same_metrics &= all(torch.equal(m_t[k], m_p[k]) for k in (
                        "loss_D", "loss_G_adv", "loss_reg", "grad_norm_D", "grad_norm_G",
                        "kernels"))
            r = {"sharded_leaves": n_sharded,
                 "metrics_bit_equal": same_metrics,
                 "params": tree_same(f"TP {mode} params", [tp.g_params, tp.d_params],
                                     [plain.g_params, plain.d_params], failures),
                 "d_state": tree_same(f"TP {mode} D state", tp.d_state, plain.d_state, failures),
                 "adam": tree_same(f"TP {mode} Adam", [tp.g_opt_state, tp.d_opt_state],
                                   [plain.g_opt_state, plain.d_opt_state], failures)}
            with deterministic(dev):
                calls = count_collectives(lambda: data_parallel(mesh), step, tp, host, mesh)
                walls = {"tp": [], "plain": []}
                for _ in range(TP_WINDOWS):
                    for label in ("plain", "tp"):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        for _ in range(TP_WINDOW_ITERS):
                            if label == "tp":
                                with data_parallel(mesh):
                                    tp, _ = step(tp, shard_batch(mesh, host),
                                                 shard_batch(mesh, host))
                            else:
                                plain, _ = step(plain, hr, hr)
                        torch.cuda.synchronize()
                        walls[label].append((time.perf_counter() - t0) / TP_WINDOW_ITERS)
            no_kernel_launched(f"phase 16 (b) {mode}", failures)
            r["collectives_per_step"] = calls
            if not same_metrics:
                failures.append(f"phase 16 (b) {mode}: TP metrics differ from the plain step's")
            med = {k: statistics.median(v) for k, v in walls.items()}
            r.update({"iters_per_s": 1 / med["tp"], "plain_iters_per_s": 1 / med["plain"],
                      "tp_over_plain_wall": med["tp"] / med["plain"],
                      "wall_ms_windows": {k: [x * 1e3 for x in v] for k, v in walls.items()}})
            res[mode] = r
            log(f"[tools] (b) TP {mode} on a (1, 1) mesh (NCCL, world 1): {TP_STEPS} steps "
                f"bit-equal to the plain step {r['params']['bit_equal'] and same_metrics}, "
                f"{n_sharded} sharded leaves; collectives a step {calls}; "
                f"{r['iters_per_s']:.2f} it/s TP, {r['plain_iters_per_s']:.2f} plain "
                f"(wall x{r['tp_over_plain_wall']:.3f})")
    finally:
        dist.destroy_process_group()
    return res


def tree_leaves_of(*trees) -> list:
    from kmsr_tpu_torch.train.state import tree_leaves

    return [t for tree in trees for t in tree_leaves(tree)]


def count_collectives(context, step, state, host, mesh) -> dict:
    """The torch.distributed calls of one step of `step` on `state` inside
    `context()`, by kind and by the mesh axis whose group they use."""
    import torch.distributed as dist

    from kmsr_tpu_torch.parallel.mesh import shard_batch

    counts: dict = {}
    axis = {id(mesh.group): "data", id(mesh.model_group): "model"}
    saved = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}

    def counting(name, fn):
        def call(*a, group=None, **k):
            key = f"{name}/{axis.get(id(group), 'other')}"
            counts[key] = counts.get(key, 0) + 1
            return fn(*a, group=group, **k)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counting(name, fn))
    try:
        with context():
            step(state, shard_batch(mesh, host), shard_batch(mesh, host))
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    return counts


def quality_part(dev, failures: list) -> dict:
    """(c) `scripts/torch_quality_report.evaluate` (SR and bilinear over the
    holdout, PSNR/SSIM, the gradient and matched oracle sweeps) at
    configs/quality_x8.json's width with the committed SR model, on pairs
    cut from `scripts/torch_make_quality_scenes.py`'s seeded scenes; then on the first QUALITY_CPU_N holdout pairs on the
    card and on the CPU: each pair's PSNR/SSIM at phase 12 (c)'s rule (rtol
    1e-5 / atol 1e-5) and phase 14's for the oracle (the same lam, every
    lam's mean PSNR within ORACLE_PSNR_DB)."""
    import importlib.util

    import numpy as np
    import torch

    from kmsr_tpu_torch import kernels
    from kmsr_tpu_torch.pipeline.sr_infer import load_sr_model

    from kmsr_tpu_torch.models import GeneratorConfig, extract_kernels, init_generator

    def script(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    tqr, mqs = script("torch_quality_report"), script("torch_make_quality_scenes")
    # the quality run's data: NaN-free 256x256 patches (stride 128) of seeded
    # 896x896 Landsat-like scenes, LR = degrade(hr) with the sigma = 2 kernel
    # + a draw of a pool at the scenes' sensor noise
    rng = np.random.default_rng(SEED + 172)
    n = QUALITY_TRAIN + QUALITY_HOLDOUT
    patches = []
    while len(patches) < n:
        scene = mqs.make_scene(rng, 896)[0]
        patches += [scene[:, y:y + HW, x:x + HW] for y in range(0, 896 - HW + 1, HW // 2)
                    for x in range(0, 896 - HW + 1, HW // 2)
                    if np.isfinite(scene[:, y:y + HW, x:x + HW]).all()]
    hr_all = np.stack(patches[:n])
    pool = (rng.normal(0, 1, (POOL_N, C, HW // FACTOR, HW // FACTOR))
            * mqs.NOISE_SIGMA[None, :, None, None]).astype(np.float32)
    kernel = extract_kernels(init_generator(GeneratorConfig(), device=dev)).cpu().numpy()
    lr_all, _ = oracle_lr(hr_all, kernel, FACTOR, pool, rng, dev)
    noise_var = np.nanvar(pool, axis=(0, 2, 3))
    cfg = sr_config()
    params = {d.type: load_sr_model(SR_MODEL, cfg, d) for d in (dev, torch.device("cpu"))}
    n_check = QUALITY_TRAIN + QUALITY_CPU_N
    res = {}
    for run, d, n, holdout in (("full", dev, len(lr_all), QUALITY_HOLDOUT),
                               ("check", dev, n_check, QUALITY_CPU_N),
                               ("cpu", torch.device("cpu"), n_check, QUALITY_CPU_N)):
        kernels.reset_launches()
        if d.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tqr.evaluate(lr_all[:n], hr_all[:n], holdout, params[d.type], cfg,
                           oracle_kernel=kernel, noise_var=noise_var,
                           oracle_iters=ORACLE_ITERS, device=d)
        out["seconds"] = time.perf_counter() - t0
        no_kernel_launched(f"phase 16 (c) {run}", failures)
        res[run] = out
    full = res["full"]
    if full["rows"].shape != (QUALITY_HOLDOUT, 4) or not np.isfinite(full["rows"]).all():
        failures.append(f"phase 16 (c): rows {full['rows'].shape}, finite "
                        f"{bool(np.isfinite(full['rows']).all())}")
    got, want = res["check"], res["cpu"]
    rows_ok = bool(np.allclose(got["rows"], want["rows"], rtol=1e-5, atol=1e-5))
    lam_ok = all(got["stats"][k]["lam"] == want["stats"][k]["lam"] for k in want["stats"])
    psnr_diff = max(abs(got["stats"][k]["per_lam"][lam] - want["stats"][k]["per_lam"][lam])
                    for k in want["stats"] for lam in want["stats"][k]["per_lam"])
    if not (rows_ok and lam_ok and psnr_diff <= ORACLE_PSNR_DB):
        failures.append(f"phase 16 (c): card vs CPU rows {rows_ok} (max diff "
                        f"{np.abs(got['rows'] - want['rows']).max():.3g}), same lam {lam_ok}, "
                        f"lam PSNR within {psnr_diff:.3g} dB")

    def summary(r):
        return {"sr_psnr": r["sr_p"], "sr_ssim": r["sr_s"], "bilinear_psnr": r["bl_p"],
                "bilinear_ssim": r["bl_s"], "seconds": r["seconds"],
                "oracle": {k: {"psnr": v["p"], "ssim": v["s"], "lam": v["lam"],
                               "psnr_by_lam": {str(a): b for a, b in v["per_lam"].items()}}
                           for k, v in r["stats"].items()}}

    out = {"full": summary(full), "check_card": summary(got), "check_cpu": summary(want),
           "rows_max_abs_diff": float(np.abs(got["rows"] - want["rows"]).max()),
           "lam_psnr_max_diff_db": psnr_diff, "pairs": QUALITY_HOLDOUT,
           "spec_pairs": QUALITY_TRAIN}
    log(f"[tools] (c) quality report on the card, {QUALITY_HOLDOUT} pairs: SR "
        f"{full['sr_p']:.4f} dB / {full['sr_s']:.5f}, bilinear {full['bl_p']:.4f} / "
        f"{full['bl_s']:.5f}, oracle " + ", ".join(
            f"{k} {v['p']:.4f} dB at lam {v['lam']:g}" for k, v in full["stats"].items())
        + f" in {full['seconds']:.2f}s; card vs CPU on {QUALITY_CPU_N} pairs: rows "
        f"max diff {out['rows_max_abs_diff']:.3g}, lam PSNR within {psnr_diff:.3g} dB "
        f"(CPU {want['seconds']:.1f}s)")
    return out


def phase_tools(dev, card: str, failures: list) -> dict:
    """Phase 16 (module docstring): the device-sync watchdog and the
    factory under it, tensor parallelism on a (1, 1) mesh, the quality
    report's device part. Each part's eight launch counts are set to 0
    before it and read after it."""
    t0 = time.perf_counter()
    res = {"watchdog": watchdog_part(dev, failures)}
    t1 = time.perf_counter()
    res["tp"] = tp_part(dev, card, failures)
    t2 = time.perf_counter()
    res["quality"] = quality_part(dev, failures)
    res["part_seconds"] = {"watchdog": t1 - t0, "tp": t2 - t1,
                           "quality": time.perf_counter() - t2}
    res["seconds"] = time.perf_counter() - t0
    return res


def main() -> int:
    # the package's trainers (phases 9-13) run under torch's deterministic
    # algorithms on the card, whose cuBLAS calls need this before cuBLAS's
    # first use (phases 3-8 use it first), as the training CLIs set it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
        cases += phase_span_kernels(dev, failures)
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
        moe_dynamic_res = phase_moe_dynamic(dev, failures)
        moe_dynamic_res["nvidia_smi"] = smi
        log(f"[moe-dynamic] {'ok' if not failures else 'FAILED'} in "
            f"{moe_dynamic_res['seconds']:.1f}s")
        sr_res = phase_sr(dev, card, smi, failures)
        sr_res["nvidia_smi"] = smi
        log(f"[sr] {'ok' if not failures else 'FAILED'} in {sr_res['seconds']:.1f}s")
        fleet_res = phase_fleet(dev, failures)
        fleet_res["nvidia_smi"] = smi
        log(f"[fleet] {'ok' if not failures else 'FAILED'} in {fleet_res['seconds']:.1f}s")
        oracle_res = phase_oracle(dev, failures)
        oracle_res["nvidia_smi"] = smi
        log(f"[oracle] {'ok' if not failures else 'FAILED'} in {oracle_res['seconds']:.1f}s")
        parallel_res = phase_parallel(dev, card, failures)
        parallel_res["nvidia_smi"] = smi
        log(f"[parallel] {'ok' if not failures else 'FAILED'} in "
            f"{parallel_res['seconds']:.1f}s")
        tools_res = phase_tools(dev, card, failures)
        tools_res["nvidia_smi"] = smi
        log(f"[tools] {'ok' if not failures else 'FAILED'} in {tools_res['seconds']:.1f}s")
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
    # phase 15's paths: the factory's .npy route over the card list (local
    # DP) and the whole scene through the ranks path (world size 1)
    dp_launches = {name: 0 for name in SOURCES}
    dp_launches["degrade_v3psn"] = parallel_res["local_dp"]["factory"]["cards"]["launches"].get(
        "degrade_v3psn", 0)
    dp_launches["colsplit_raw"] = parallel_res["scene"]["ranks_launches"].get("colsplit_raw", 0)
    # phase 16's paths: the watched factory .npy route; TP and the quality
    # report launch none of the eight (each part fails otherwise)
    tools_launches = {name: {"watchdog_factory": tools_res["watchdog"]["factory"]["launches"]
                             .get(name, 0), "tp_step": 0, "quality_report": 0}
                      for name in SOURCES}
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
            "parallel_launches": dp_launches[name],
            "tools_launches": tools_launches[name],
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
    log(json.dumps({"moe_dynamic": moe_dynamic_res}))
    log(json.dumps({"sr": sr_res}))
    log(json.dumps({"fleet": fleet_res}))
    log(json.dumps({"oracle": oracle_res}))
    log(json.dumps({"parallel": parallel_res}))
    log(json.dumps({"tools": tools_res}, default=str))
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f}s")
    log(smi)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
