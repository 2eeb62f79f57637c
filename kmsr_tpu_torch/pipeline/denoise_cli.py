"""Stage: NLM denoise (single-file + batch folder CLIs + comparison tool).

The port's copy of `kmsr_tpu.pipeline.denoise_cli`, with the same modes,
flags and output, plus `--device cuda|cpu` (default cuda; a CUDA request
without a card raises). Contract parity with `denoise/denoise.py:150-284`
(copy the input file, append a `denoised` group with sigma/h provenance
attrs, optional comparison plots), `denoise/batch_denoise.py` (folder
runner with success/failure accounting) and
`denoise/compare_denoised.py` (before/after/residual figure reading
sigma/h attrs back).

`--cpu-reference` runs the numpy reference NLM band by band on the host
(what the JAX package runs under the same flag). The batch mode's
per-file fallback (files whose shape differs from their chunk's first,
or a whole chunk whose sweep failed) runs on the requested device; the
number of files that took it is printed and returned on the report
(`RunReport.fallbacks`).

Usage:
    python -m kmsr_tpu_torch.pipeline.denoise_cli file.nc --output OUT [--h-factor 1.8] [--plot]
    python -m kmsr_tpu_torch.pipeline.denoise_cli --batch DIR --output OUT [--pattern '*.nc']
    python -m kmsr_tpu_torch.pipeline.denoise_cli --compare file.nc --band L_TOA_443 --output OUT
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.sampler import list_patch_files
from ..device import resolve_device
from ..io.ncio import NCFile, copy_file_with_groups, read_band_stack, write_band_stack
from ..io.schema import BAND_NAMES, GROUP_DENOISED, GROUP_GEO
from ..ops.nlm import (
    PATCH_DISTANCE,
    PATCH_SIZE,
    denoise_batch_dispatch,
    denoise_batch_finalize,
    denoise_stack,
    denoise_stack_np,
)
from ..utils.profiling import stage_timer
from .common import RunReport, run_per_file, sync_watch


def process_nc_file(
    file_path: str,
    output_dir: str,
    h_factor: float = 1.8,
    plot: bool = False,
    verbose: bool = True,
    use_device: bool = True,
    device: str | torch.device = "cuda",
) -> str:
    """Denoise all bands of one file; returns the output path.
    use_device=False runs the numpy reference instead of the torch path."""
    stack = read_band_stack(file_path, GROUP_GEO)
    if use_device:
        denoised, sigmas = denoise_stack(stack, h_factor=h_factor, device=device)
    else:
        denoised, sigmas = denoise_stack_np(stack, h_factor=h_factor)
    return _write_denoised(
        file_path, output_dir, stack, denoised, sigmas, h_factor,
        plot=plot, verbose=verbose,
    )


def _write_denoised(
    file_path: str,
    output_dir: str,
    stack: np.ndarray,
    denoised: np.ndarray,
    sigmas,
    h_factor: float,
    plot: bool = False,
    verbose: bool = True,
) -> str:
    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(file_path))[0]
    out_path = os.path.join(output_dir, f"{stem}_denoised.nc")
    copy_file_with_groups(file_path, out_path)

    attrs: dict = {
        "h_factor": h_factor,
        "denoising_method": "Non-Local Means (NLM)",
        "patch_size": PATCH_SIZE,
        "patch_distance": PATCH_DISTANCE,
    }
    for band, sig in zip(BAND_NAMES, sigmas):
        attrs[f"{band}_sigma"] = sig
        attrs[f"{band}_h"] = h_factor * sig
    attrs["average_sigma"] = float(np.mean(sigmas))
    attrs["average_h"] = h_factor * float(np.mean(sigmas))
    write_band_stack(
        out_path, GROUP_DENOISED, denoised, mode="a", group_attrs=attrs,
        nan_to_fill=False,
    )
    if verbose:
        print(
            f"{os.path.basename(file_path)}: avg sigma {np.mean(sigmas):.6f} "
            f"h {h_factor * np.mean(sigmas):.6f} -> {out_path}"
        )
    if plot:
        from ..analysis.visualize import plot_denoise_comparison

        plot_dir = os.path.join(output_dir, "plots")
        os.makedirs(plot_dir, exist_ok=True)
        for i, band in enumerate(BAND_NAMES):
            plot_denoise_comparison(
                stack[i], denoised[i],
                os.path.join(plot_dir, f"{stem}_{band}_compare.png"), band,
            )
    return out_path


def batch_denoise(
    input_dir: str,
    output_dir: str,
    pattern: str = "*.nc",
    h_factor: float = 1.8,
    use_device: bool = True,
    device_batch: int = 8,
    progress: bool = True,
    device: str | torch.device = "cuda",
) -> RunReport:
    """Folder runner. On the torch path, `device_batch` files are swept in
    one batched NLM call (all files x bands share the shift lattice),
    chunk k+1 dispatched before chunk k is synced and written (one-deep
    pipeline); files whose shape differs from the chunk's first take the
    per-file path on the same device, and per-file failure isolation is
    kept throughout. use_device=False runs the numpy reference per file."""
    dev = resolve_device(device) if use_device else None
    files = list_patch_files(input_dir, pattern)

    if use_device and device_batch > 1:
        t0 = time.time()
        ok, fail = [], []
        n_fallback = 0
        iterator = range(0, len(files), device_batch)
        if progress:
            try:
                from tqdm import tqdm

                iterator = tqdm(iterator, desc="denoising", unit="chunk")
            except ImportError:
                pass

        def _writeback(uniform, odd, handle):
            nonlocal n_fallback
            # finalize syncs chunk k's sweep AFTER chunk k+1 was
            # dispatched: the device sweep overlaps the host's zlib .nc
            # writes and per-file fallbacks
            if handle is not None:
                try:
                    with stage_timer("denoise.device_sync"), sync_watch("denoise"):
                        den, sig = denoise_batch_finalize(handle)
                    with stage_timer("denoise.host_write"):
                        for (path, stack), d, s in zip(uniform, den, sig):
                            try:
                                ok.append(
                                    _write_denoised(
                                        path, output_dir, stack, d,
                                        list(map(float, s)), h_factor,
                                        verbose=False,
                                    )
                                )
                            except Exception as e:
                                fail.append((path, str(e)))
                except Exception:
                    odd = uniform + odd  # sweep failed: per-file fallback
            n_fallback += len(odd)
            for path, _stack in odd:
                try:
                    ok.append(
                        process_nc_file(path, output_dir, h_factor=h_factor,
                                        verbose=False, device=dev)
                    )
                except Exception as e:
                    fail.append((path, str(e)))

        pending = None
        for start in iterator:
            chunk = files[start : start + device_batch]
            stacks, valid_paths = [], []
            with stage_timer("denoise.host_read"):
                for path in chunk:
                    try:
                        stacks.append(read_band_stack(path, GROUP_GEO))
                        valid_paths.append(path)
                    except Exception as e:
                        fail.append((path, str(e)))
            if not stacks:
                continue
            shape0 = stacks[0].shape
            uniform = [
                (p, s) for p, s in zip(valid_paths, stacks) if s.shape == shape0
            ]
            odd = [(p, s) for p, s in zip(valid_paths, stacks) if s.shape != shape0]
            handle = None
            try:
                batch = np.stack([s for _, s in uniform])
                handle = denoise_batch_dispatch(batch, h_factor=h_factor, device=dev)
            except Exception:
                odd = uniform + odd  # dispatch failed: per-file fallback
                uniform = []
            if pending is not None:
                _writeback(*pending)
            pending = (uniform, odd, handle)
        if pending is not None:
            _writeback(*pending)
        report = RunReport(succeeded=ok, failed=fail, seconds=time.time() - t0,
                           fallbacks=n_fallback)
        print(f"denoise: {report.summary()}; {n_fallback} per-file fallbacks "
              f"-> {output_dir}")
        return report

    def one(path):
        process_nc_file(path, output_dir, h_factor=h_factor, verbose=False,
                        use_device=use_device, device=dev)

    report = run_per_file(files, one, desc="denoising", progress=progress)
    print(f"denoise: {report.summary()} -> {output_dir}")
    return report


def compare_denoised(file_path: str, band: str, output_path: str) -> dict:
    """Before/after/residual figure, reading sigma/h provenance back."""
    from ..analysis.visualize import plot_denoise_comparison

    orig = read_band_stack(file_path, GROUP_GEO, band_names=[band])[0]
    den = read_band_stack(file_path, GROUP_DENOISED, band_names=[band])[0]
    with NCFile(file_path, "r") as f:
        attrs = f.get_attrs(group=GROUP_DENOISED)
    stats = plot_denoise_comparison(orig, den, output_path, band)
    stats["sigma"] = attrs.get(f"{band}_sigma")
    stats["h"] = attrs.get(f"{band}_h")
    print(
        f"{band}: rmse={stats['rmse']:.6f} sigma={stats['sigma']} h={stats['h']}"
        f" -> {output_path}"
    )
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="NLM denoise stage")
    p.add_argument("file", nargs="?", help="single .nc file to denoise")
    p.add_argument("--batch", default=None, help="denoise a whole folder")
    p.add_argument("--pattern", default="*.nc")
    p.add_argument("--output", required=True, help="output directory (or file for --compare)")
    p.add_argument("--h-factor", type=float, default=1.8,
                   help="denoise strength factor (GOCI-2: 1.8, Landsat: 1.0)")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--compare", default=None, help="compare mode: denoised .nc file")
    p.add_argument("--band", default=BAND_NAMES[0])
    p.add_argument("--cpu-reference", action="store_true",
                   help="use the numpy reference NLM instead of the torch path")
    p.add_argument("--device-batch", type=int, default=8,
                   help="files per batched sweep in --batch mode")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the torch path runs (default cuda; raises without a card)")
    a = p.parse_args(argv)
    use_device = not a.cpu_reference
    if a.compare:
        compare_denoised(a.compare, a.band, a.output)
        return 0
    if a.batch:
        report = batch_denoise(
            a.batch, a.output, pattern=a.pattern, h_factor=a.h_factor,
            use_device=use_device, device_batch=a.device_batch, device=a.device,
        )
        return 0 if report.n_fail == 0 else 1
    if not a.file:
        p.error("provide a file, --batch DIR, or --compare FILE")
    process_nc_file(a.file, a.output, h_factor=a.h_factor, plot=a.plot,
                    use_device=use_device, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
