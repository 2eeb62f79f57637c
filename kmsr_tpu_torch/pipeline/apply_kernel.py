"""Stage: apply a learned blur kernel + downsample to a patch folder.

Counterpart of `kmsr_tpu.pipeline.apply_kernel` (single-kernel route):
contract parity with `C_30apply_kernel_to_landsat.py:127-213` (reads
`denoised`, appends a `blurred` group to a copied file). Files are stacked
into device batches and degraded with one strided grouped conv
(`ops.degrade.degrade_strided`) per batch. `--moe MODEL` routes each patch
to its selector's argmax expert and blurs it with that expert's kernel
(the factory's `moe_degrade`, no noise), recording the expert as the
`moe_expert` attribute of the written group; it runs on one device.
`--kernel-root DIR` takes per-scene kernels (a fleet run's outdir,
`DIR/<scene>/kernel_per_band.npy`): each scene's files run through its own
kernel, a scene with no kernel failing all of its files, as the factory's
route does.

The single-kernel routes split each batch over the host's cards
(`parallel.local_dp`; the degrade is per-sample independent), as JAX
shards them over its local devices. The MoE route stays on one device, as
in JAX: its selector may use batch statistics, which padding would perturb.

Usage:
    python -m kmsr_tpu_torch.pipeline.apply_kernel --input-dir PATCHES \
        (--kernel kernel_per_band.npy | --moe KERNEL_RUN | --kernel-root FLEET_RUN) \
        --output-dir OUT \
        [--factor 8] [--in-group denoised] [--out-group blurred] \
        [--suffix _blurred] [--batch-size 64] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.sampler import list_patch_files
from ..device import resolve_device
from ..io.ncio import NCFile, copied, read_band_stack, write_bands
from ..io.schema import GROUP_BLURRED, GROUP_DENOISED, RADIANCE_UNITS
from ..ops.degrade import degrade_strided
from ..parallel.local_dp import gather, local_map
from .common import (
    DeviceSyncGuard,
    RunReport,
    chunked_reader,
    local_batch_dp,
    pad_put,
    route_per_scene_kernels,
)


def kernel_bands(k: np.ndarray, n_bands: int = 5, name: str = "kernel") -> np.ndarray:
    """A kernel artifact as [C, kH, kW] float32: [kH,kW] broadcasts to all
    bands; [C,kH,kW] is used per band; [B,C,kH,kW] batch kernels are
    mean-reduced over B (parity: `C_31...py:27-29`). A band that sums to
    ~0 or holds a non-finite value raises ValueError."""
    k = np.asarray(k, np.float32)
    if k.ndim == 4:
        k = k.mean(axis=0)
    if k.ndim == 2:
        k = np.broadcast_to(k[None], (n_bands, *k.shape)).copy()
    if k.ndim != 3 or k.shape[0] != n_bands:
        raise ValueError(f"kernel shape {k.shape} incompatible with {n_bands} bands")
    sums = k.sum(axis=(1, 2))
    if not np.isfinite(k).all() or (np.abs(sums) <= 1e-6).any():
        # a degenerate band (all-zero after the extractor's clamp, or NaN)
        # would silently degrade that band to pure noise in every produced
        # pair; fail the artifact loudly at the factory boundary instead
        raise ValueError(
            f"degenerate kernel {name}: band sums {sums.tolist()} "
            f"(finite={bool(np.isfinite(k).all())}) — at least one band "
            f"is all-zero/NaN; the producing run is collapsed"
        )
    return k


def load_kernel(kernel_path: str, n_bands: int = 5) -> np.ndarray:
    """Load a kernel artifact `.npy` under `kernel_bands`' rank rules."""
    return kernel_bands(np.load(kernel_path), n_bands, kernel_path)


def make_degrader(kernel_path: str | None, moe_path: str | None, factor: int,
                  dev: torch.device):
    """(fn(batch [B,C,H,W] on dev) -> (degraded, experts [B] or None), the
    name recorded as `kernel_file`): the strided conv with one kernel, or
    the factory's MoE blur (`factory.moe_degrade`, no noise)."""
    if moe_path is None:
        kernel = torch.from_numpy(load_kernel(kernel_path)).to(dev)
        return (lambda batch: (degrade_strided(batch, kernel, factor=factor), None),
                os.path.basename(kernel_path))
    from .factory import load_moe_for_factory, moe_degrade

    model = load_moe_for_factory(moe_path, dev)
    return (lambda batch: moe_degrade(model, batch, factor),
            os.path.basename(os.path.normpath(moe_path)))


def make_degraders(kernel_path: str | None, moe_path: str | None, factor: int,
                   device: str | torch.device = "cuda", devices=None):
    """(devices, {device: `make_degrader`'s fn on it}, the kernel_file
    name): the kernel routes over the host's cards (for device "cuda",
    every visible card; `devices` names them explicitly), the MoE route on
    one device."""
    dev = resolve_device(device)
    if moe_path is not None:
        devs = [dev]
        if dev.type == "cuda" and dev.index is None:
            devs = [torch.device("cuda", torch.cuda.current_device())]
    else:
        devs, _ = local_batch_dp(device, devices)
    fns = {d: make_degrader(kernel_path, moe_path, factor, d) for d in devs}
    return devs, {d: fn for d, (fn, _) in fns.items()}, fns[devs[0]][1]


def degrade_group(stacks: list, fns: dict, devs: list) -> tuple:
    """One shape group's device work: the stacked [B, C, H, W] batch padded
    to a multiple of the device count, one contiguous block a device (a
    non-blocking copy to a card), each block degraded on its device and the
    blocks gathered in order on the first; returns (degraded, experts or
    None), dispatched, not synchronized."""
    blocks, b = pad_put(np.stack(stacks), devs, len(devs))
    outs = local_map(lambda x: fns[x.device](x), blocks)
    # the MoE route runs on one device: its experts are the one block's
    return gather([o[0] for o in outs], b), outs[0][1]


def apply_kernel_to_folder(
    input_dir: str,
    kernel_path: str | None,
    output_dir: str,
    factor: int = 8,
    in_group: str = GROUP_DENOISED,
    out_group: str = GROUP_BLURRED,
    suffix: str = "_blurred",
    batch_size: int = 64,
    in_place: bool = False,
    progress: bool = True,
    files: list[str] | None = None,
    device: str | torch.device = "cuda",
    moe_path: str | None = None,
    kernel_root: str | None = None,
    devices=None,
) -> RunReport:
    """Degrade every patch file; write `out_group` into a copy (or in place).

    Exactly one of kernel_path, moe_path (content-adaptive routing, the
    factory's `--moe` blur without its noise) and kernel_root (per-scene
    kernels, a fleet run's outdir) is taken. The batches of the kernel
    routes are split over the host's cards (for device "cuda", every
    visible card; `devices` names them explicitly: `make_degraders`,
    `degrade_group`)."""
    dev = resolve_device(device)
    t0 = time.time()
    if sum(p is not None for p in (kernel_path, moe_path, kernel_root)) != 1:
        raise ValueError(
            "exactly one of kernel_path / moe_path / kernel_root is required"
        )
    if files is None:
        files = list_patch_files(input_dir, "*.nc")
    if kernel_root is not None:
        return route_per_scene_kernels(
            files, kernel_root,
            lambda scene, k_path, scene_files: apply_kernel_to_folder(
                input_dir, k_path, output_dir, factor=factor,
                in_group=in_group, out_group=out_group, suffix=suffix,
                batch_size=batch_size, in_place=in_place, progress=progress,
                files=scene_files, device=device, devices=devices,
            ),
            "apply_kernel", output_dir,
        )
    devs, fns, kernel_src = make_degraders(kernel_path, moe_path, factor, dev, devices)
    os.makedirs(output_dir, exist_ok=True)

    ok, fail = [], []
    reader = chunked_reader(files, batch_size, lambda p: read_band_stack(p, in_group))
    if progress:
        try:
            from tqdm import tqdm

            reader = tqdm(
                reader, desc="applying kernel", unit="batch",
                total=-(-len(files) // batch_size),
            )
        except ImportError:
            pass

    sync_guard = DeviceSyncGuard()

    def _writeback(valid, degraded_dev, experts_dev):
        # sync batch k after batch k+1 was dispatched: device compute +
        # D2H overlap the host-side file copies and .nc writes. CUDA work
        # is asynchronous, so a device-side failure surfaces HERE — fail
        # this group's files instead of crashing the whole run (unless the
        # guard sees the device is persistently wedged: abort loudly).
        try:
            degraded = degraded_dev.cpu().numpy()
            experts = ([None] * len(valid) if experts_dev is None
                       else experts_dev.cpu().tolist())
            sync_guard.succeeded()
        except Exception as e:  # per-group failure isolation
            fail.extend((p, f"{type(e).__name__}: {e}") for p in valid)
            sync_guard.failed(e)
            return
        for path, lr, expert in zip(valid, degraded, experts):
            try:
                base = os.path.splitext(os.path.basename(path))[0]
                out_path = path if in_place else os.path.join(output_dir,
                                                              f"{base}{suffix}.nc")
                # in place: append to the file; else the input's copy plus
                # the group, in one write
                with (NCFile(out_path, "a") if in_place else copied(path, out_path)) as f:
                    write_bands(
                        f,
                        out_group,
                        lr,
                        dims=(f"y_{out_group}", f"x_{out_group}"),
                        var_attrs={"units": RADIANCE_UNITS},
                        group_attrs={
                            "history": f"blur kernel applied, {factor}x downsampled",
                            "kernel_file": kernel_src,
                            **({} if expert is None else {"moe_expert": int(expert)}),
                        },
                    )
                ok.append(out_path)
            except Exception as e:
                fail.append((path, str(e)))

    pending = None
    for valid, stacks, chunk_fail in reader:
        fail.extend(chunk_fail)
        if not stacks:
            continue
        # group the chunk by shape: one mixed-size file must fail (or run
        # in its own group), not crash the whole run at np.stack
        groups: dict = {}
        for p, s in zip(valid, stacks):
            groups.setdefault(s.shape, []).append((p, s))
        for items in groups.values():
            paths = [p for p, _ in items]
            try:
                degraded_dev, experts_dev = degrade_group([s for _, s in items], fns, devs)
            except Exception as e:  # per-group failure isolation
                fail.extend((p, f"{type(e).__name__}: {e}") for p in paths)
                continue
            if pending is not None:
                _writeback(*pending)
            pending = (paths, degraded_dev, experts_dev)
    if pending is not None:
        _writeback(*pending)
    report = RunReport(succeeded=ok, failed=fail, seconds=time.time() - t0)
    print(f"apply_kernel: {report.summary()} -> {output_dir}")
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Apply blur kernel + downsample")
    p.add_argument("--input-dir", required=True)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--kernel",
                     help="kernel .npy ([kH,kW], [C,kH,kW] or [B,C,kH,kW] batch-mean)")
    src.add_argument("--moe", help="content-adaptive mode: MoE model dir / .npz / "
                                   "reference .pth")
    src.add_argument("--kernel-root",
                     help="per-scene kernels: a fleet-trainer outdir "
                          "(<scene>/kernel_per_band.npy)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--factor", type=int, default=8)
    p.add_argument("--in-group", default=GROUP_DENOISED)
    p.add_argument("--out-group", default=GROUP_BLURRED)
    p.add_argument("--suffix", default="_blurred")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--in-place", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    report = apply_kernel_to_folder(
        a.input_dir,
        a.kernel,
        a.output_dir,
        factor=a.factor,
        in_group=a.in_group,
        out_group=a.out_group,
        suffix=a.suffix,
        batch_size=a.batch_size,
        in_place=a.in_place,
        device=a.device,
        moe_path=a.moe,
        kernel_root=a.kernel_root,
    )
    return 0 if report.n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
