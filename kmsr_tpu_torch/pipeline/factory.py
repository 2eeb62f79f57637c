"""Stage: fused train-data factory — one device pass per batch of files.

Counterpart of `kmsr_tpu.pipeline.factory` (single-kernel route). For each
HR patch it blurs with the learned per-band kernel, decimates x`factor`
and adds one noise-pool draw in ONE kernel launch per file batch, then
writes the final `hr`/`lr` training file `<name>_train.nc` directly (the
reference spells this as two file-mediated stages, apply_kernel +
make_train_data, which this package also keeps).

Two input routes, as in the JAX package:

* `.nc` patches (`denoised` group) are read on a background thread,
  stacked NCHW into pinned host memory, copied to the card without
  blocking and degraded by `degrade_fused`, which picks the kernel as
  JAX's `degrade_pallas` does: the v3 stencil when the composed span
  K = k + f - 1 is at most 5f (f >= 3 for a 13x13 blur), else the dense
  v4 kernel for small patches (out_w a multiple of 8 and
  out_h*out_w*H*W <= 2^21, e.g. 48x48 at f=2) and the v2 stencil
  otherwise (e.g. 256x256 at f=2);
* `.npy` patches ([C, H, W] float32) at K <= 5f stream through the
  native loader's dual split gather straight into the halo-free presplit
  layout, degraded by `degrade_fused_presplit` (the v3psn stencil
  kernel); the natural batch read alongside is the hr group. At K > 5f
  (`--factor 2`) they take the natural route above, as in JAX.

`--backend conv` runs the plain grouped strided conv + noise instead (the
JAX `xla` backend); `auto` means `fused`. Noise-pool indices are drawn
per file, up front, with `numpy.random.default_rng(seed).integers`, so
each lr file equals the JAX factory's for the same seed. Not ported yet
(ROADMAP.md): `--moe`, `--moe-noise`, `--kernel-root`, and the `.npy`
route's data parallelism over several local devices.

Usage:
    python -m kmsr_tpu_torch.pipeline.factory --input-dir DENOISED \
        --kernel kernel_per_band.npy --noise-pool pool.npy \
        --output-dir TRAIN [--factor 8] [--batch-size 128] [--seed 42] \
        [--backend auto|conv|fused] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Iterator

import numpy as np
import torch

from ..data.noise_pool import load_noise_pool
from ..data.sampler import list_patch_files
from ..device import resolve_device
from ..io.ncio import read_band_stack, read_nav
from ..io.schema import GROUP_DENOISED
from ..ops.degrade import degrade_strided
from ..ops.degrade_fused import degrade_fused, degrade_fused_presplit
from ..utils.profiling import stage_timer
from .apply_kernel import load_kernel
from .common import DeviceSyncGuard, RunReport, chunked_reader
from .make_train_data import save_training_sample

BACKENDS = ("auto", "conv", "fused")

#: one factory batch: (paths, hr [b, C, H, W] host array, lr [b, C, h, w]
#: device tensor — dispatched, not yet synchronized, failures)
Batch = tuple[list, np.ndarray, torch.Tensor, list]


def _backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return "fused" if backend == "auto" else backend


def _host_empty(shape: tuple, dev: torch.device) -> torch.Tensor:
    """A float32 host staging buffer, pinned when it feeds a card so the
    copy to the device runs asynchronously. Keep the TENSOR (not a numpy
    view of it) for the copy: PyTorch's pinned allocator then holds the
    block until the copy has finished."""
    return torch.empty(shape, dtype=torch.float32, pin_memory=dev.type == "cuda")


def degrade_with_noise(
    batch: torch.Tensor, kernel: torch.Tensor, noise: torch.Tensor,
    factor: int, backend: str,
) -> torch.Tensor:
    """lr = degrade(batch) + noise on batch's device; NCHW in and out."""
    if _backend(backend) == "fused":
        return degrade_fused(batch, kernel, noise=noise, factor=factor)
    return degrade_strided(batch, kernel, factor=factor) + noise


def natural_batches(
    files: list[str],
    kernel: torch.Tensor,
    pool: np.ndarray,
    noise_of: dict,
    *,
    factor: int = 8,
    batch_size: int = 128,
    backend: str = "auto",
    input_format: str = "nc",
    in_group: str = GROUP_DENOISED,
    device: str | torch.device = "cuda",
) -> Iterator[Batch]:
    """The natural-layout route: read each chunk of files on a background
    thread (per-file failure isolation), stack it NCHW into pinned memory,
    copy it to the device and dispatch `degrade_with_noise` on it.
    noise_of maps each path to its noise-pool index."""
    dev = resolve_device(device)

    def _read(p):
        if input_format == "npy":
            a = np.asarray(np.load(p), np.float32)
            if a.ndim != 3:
                raise ValueError(f"npy patch must be [C, H, W], got {a.shape}")
            return a
        return read_band_stack(p, in_group)

    for valid, stacks, chunk_fail in chunked_reader(
            files, batch_size, _read, timer="factory.host_read_bg"):
        if not stacks:
            yield [], None, None, chunk_fail
            continue
        with stage_timer("factory.dispatch"):
            hr = _host_empty((len(stacks), *stacks[0].shape), dev)
            np.stack(stacks, axis=0, out=hr.numpy())
            noise = _host_empty((len(valid), *pool.shape[1:]), dev)
            np.take(pool, [noise_of[p] for p in valid], axis=0,
                    out=noise.numpy())
            lr = degrade_with_noise(
                hr.to(dev, non_blocking=True), kernel,
                noise.to(dev, non_blocking=True), factor, backend,
            )
        yield valid, hr.numpy(), lr, chunk_fail


def _npy_split_batches(files, batch_size, shape, factor, dev):
    """Yield (paths, presplit [C, f, H/f, W, B], natural [B, C, H, W],
    fails) per chunk, both as (pinned) host tensors, via the native
    loader's DUAL split gather — one file read per patch fills the
    halo-free presplit layout (`degrade_fused_presplit`'s input) and the
    natural batch (the hr group) — with double-buffered prefetch. Falls
    back to numpy load + host transpose (per-file isolation) when no
    toolchain is available or the loader errors: a host-loader fallback,
    the device work is the same."""
    c, h, w = shape
    idx_chunks = [
        np.arange(i, min(i + batch_size, len(files)), dtype=np.int64)
        for i in range(0, len(files), batch_size)
    ]
    loader = None
    try:
        from ..runtime import NativePatchLoader

        loader = NativePatchLoader(files, shape=shape)
    except Exception:
        pass  # numpy fallback below

    def buffers(n):
        return (_host_empty((c, factor, h // factor, w, n), dev),
                _host_empty((n, c, h, w), dev))

    def np_split(idx):
        """Per-file-isolated numpy fallback."""
        good, stacks, fails = [], [], []
        for i in idx:
            try:
                a = np.load(files[i])
                if a.shape != shape:
                    raise ValueError(f"shape {a.shape} != {shape}")
                stacks.append(np.asarray(a, np.float32))
                good.append(files[i])
            except Exception as e:
                fails.append((files[i], str(e)))
        if not stacks:
            return good, None, None, fails
        xp, nat = buffers(len(good))
        np.stack(stacks, axis=0, out=nat.numpy())          # [B, C, H, W]
        xr = nat.numpy().reshape(len(good), c, h // factor, factor,
                                 w // factor, factor)
        # [B, C, oh, p, ow, r] -> [C, p, oh, r, ow, B]: row phase p, then
        # columns permuted to v = r * ow + x // f
        np.copyto(xp.numpy().reshape(c, factor, h // factor, factor,
                                     w // factor, len(good)),
                  np.transpose(xr, (1, 3, 2, 5, 4, 0)))
        return good, xp, nat, fails

    pending = {}

    def enqueue(k):
        nonlocal loader
        xp, nat = buffers(len(idx_chunks[k]))
        try:
            loader.prefetch_split_dual(idx_chunks[k], factor, xp.numpy(),
                                       nat.numpy())
            pending[k] = (xp, nat)
        except Exception:
            loader.close()  # loader unusable: numpy path from here on
            loader = None

    try:
        if loader is not None:
            enqueue(0)
        for k, idx in enumerate(idx_chunks):
            bufs = None
            if loader is not None:
                try:
                    with stage_timer("factory.host_read_wait"):
                        loader.wait()
                    bufs = pending.pop(k)
                except Exception:
                    bufs = None  # re-read the chunk with per-file isolation
                if loader is not None and k + 1 < len(idx_chunks):
                    enqueue(k + 1)
            if bufs is not None:
                yield [files[i] for i in idx], bufs[0], bufs[1], []
            else:
                yield np_split(idx)
    finally:
        if loader is not None:
            loader.close()


def presplit_batches(
    files: list[str],
    kernel: torch.Tensor,
    pool: np.ndarray,
    noise_of: dict,
    *,
    shape: tuple[int, int, int],
    factor: int = 8,
    batch_size: int = 128,
    device: str | torch.device = "cuda",
) -> Iterator[Batch]:
    """The `.npy` route: the native split gather feeds the halo-free
    presplit kernel (`degrade_fused_presplit`); lr is returned as a
    [b, C, h, w] view of the kernel's [C, h, w, b] output."""
    dev = resolve_device(device)
    if len(shape) != 3 or shape[1] % factor or shape[2] % factor:
        raise ValueError(
            f"npy patches must be [C, H, W] with H, W multiples of "
            f"factor; got {shape}"
        )
    c, h, w = shape
    for paths, xp, nat, chunk_fail in _npy_split_batches(
            files, batch_size, shape, factor, dev):
        if xp is None:
            yield [], None, None, chunk_fail
            continue
        with stage_timer("factory.dispatch"):
            noise = _host_empty((c, h // factor, w // factor, len(paths)), dev)
            np.copyto(noise.numpy(), np.transpose(
                pool[[noise_of[p] for p in paths]], (1, 2, 3, 0)))  # CHWB
            lr = degrade_fused_presplit(
                xp.to(dev, non_blocking=True), kernel,
                noise=noise.to(dev, non_blocking=True), factor=factor,
            )
        yield paths, nat.numpy(), lr.permute(3, 0, 1, 2), chunk_fail


def _presplit_shape(files, kernel, factor, backend, input_format):
    """The npy patch shape when the presplit route applies, else None.

    The route needs fused `.npy` input and a composed span (kh + f - 1)
    <= 5f; the probe reads the first file's header only. An unreadable
    probe file falls through to the natural route, whose reader isolates
    it per file instead of aborting the whole run."""
    if not (input_format == "npy" and _backend(backend) == "fused"
            and kernel.shape[-1] + factor - 1 <= 5 * factor and files):
        return None
    try:
        return tuple(np.load(files[0], mmap_mode="r").shape)
    except Exception:
        return None


def factory_inputs(
    files: list[str],
    kernel_path: str,
    noise_pool_path: str,
    seed: int = 42,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, np.ndarray, dict]:
    """(kernel [C, kh, kw] on `device`, noise pool [N, C, h, w] on the host,
    {path: noise-pool index}). The indices are drawn per FILE up front
    (position-indexed), so every route/backend/chunking — and per-file
    failures — produces the same lr for the same seed, in this package
    and in the JAX one."""
    dev = resolve_device(device)
    pool = load_noise_pool(noise_pool_path)
    rng = np.random.default_rng(seed)
    noise_idx = rng.integers(0, pool.shape[0], size=len(files))
    kernel = torch.from_numpy(load_kernel(kernel_path)).to(dev)
    return kernel, pool, dict(zip(files, noise_idx.tolist()))


def factory_batches(
    files: list[str],
    kernel_path: str,
    noise_pool_path: str,
    *,
    factor: int = 8,
    batch_size: int = 128,
    seed: int = 42,
    backend: str = "auto",
    input_format: str = "nc",
    in_group: str = GROUP_DENOISED,
    device: str | torch.device = "cuda",
) -> Iterator[Batch]:
    """The factory's device part, batch by batch: the presplit route for
    fused `.npy` input, the natural route otherwise. `run_factory`
    consumes this generator and writes each batch's files."""
    kernel, pool, noise_of = factory_inputs(files, kernel_path,
                                            noise_pool_path, seed, device)
    shape = _presplit_shape(files, kernel, factor, backend, input_format)
    if shape is not None:
        return presplit_batches(files, kernel, pool, noise_of, shape=shape,
                                factor=factor, batch_size=batch_size,
                                device=device)
    return natural_batches(files, kernel, pool, noise_of, factor=factor,
                           batch_size=batch_size, backend=backend,
                           input_format=input_format, in_group=in_group,
                           device=device)


def run_factory(
    input_dir: str,
    kernel_path: str,
    noise_pool_path: str,
    output_dir: str,
    factor: int = 8,
    in_group: str = GROUP_DENOISED,
    batch_size: int = 128,
    seed: int = 42,
    backend: str = "auto",
    progress: bool = True,
    input_format: str = "auto",
    files: list[str] | None = None,
    device: str | torch.device = "cuda",
) -> RunReport:
    """Degrade every patch in `input_dir` and write `<name>_train.nc` pairs.

    input_format: 'nc' (grouped NetCDF patches), 'npy' (raw [C, H, W]
    float32 patch dirs) or 'auto' (npy iff the dir holds .npy files and no
    .nc). Batches run through a one-deep pipeline: batch k is synchronized
    and written while batch k+1 computes on the device. A batch whose
    device sync fails fails its files; three such batches in a row abort
    the run (`DeviceSyncGuard`).
    """
    dev = resolve_device(device)
    t0 = time.time()
    backend = _backend(backend)
    if input_format == "auto":
        has_npy = bool(glob.glob(os.path.join(input_dir, "*.npy")))
        has_nc = bool(glob.glob(os.path.join(input_dir, "*.nc")))
        input_format = "npy" if has_npy and not has_nc else "nc"
    if input_format not in ("nc", "npy"):
        raise ValueError(f"input_format must be auto|nc|npy, got {input_format!r}")
    if files is None:
        files = list_patch_files(
            input_dir, "*.npy" if input_format == "npy" else "*.nc"
        )
    os.makedirs(output_dir, exist_ok=True)
    batches = factory_batches(
        files, kernel_path, noise_pool_path, factor=factor,
        batch_size=batch_size, seed=seed, backend=backend,
        input_format=input_format, in_group=in_group, device=dev,
    )
    if progress:
        try:
            from tqdm import tqdm

            batches = tqdm(
                batches, desc="factory", unit="batch",
                total=-(-len(files) // batch_size),
            )
        except ImportError:
            pass

    ok, fail = [], []
    sync_guard = DeviceSyncGuard()

    def _writeback(paths, hr_batch, lr_dev):
        # the device-to-host copy syncs batch k AFTER batch k+1 was
        # dispatched: device compute + D2H overlap the host-side nav reads
        # and zlib .nc writes. Device-side runtime failures surface at this
        # sync (asynchronous launches) — fail this batch's files, don't
        # crash the run (unless the guard sees the device persistently
        # wedged).
        try:
            with stage_timer("factory.device_sync"):
                lr_batch = lr_dev.cpu().numpy()
            sync_guard.succeeded()
        except Exception as e:  # per-batch failure isolation
            fail.extend((p, f"{type(e).__name__}: {e}") for p in paths)
            sync_guard.failed(e)
            return
        with stage_timer("factory.host_write"):
            for path, hr, lr in zip(paths, hr_batch, lr_batch):
                try:
                    base = os.path.splitext(os.path.basename(path))[0]
                    out_path = os.path.join(output_dir, f"{base}_train.nc")
                    nav = read_nav(path) if input_format == "nc" else None
                    save_training_sample(out_path, hr, lr, nav or None)
                    ok.append(out_path)
                except Exception as e:
                    fail.append((path, str(e)))

    pending = None
    for paths, hr_batch, lr_dev, chunk_fail in batches:
        fail.extend(chunk_fail)
        if lr_dev is None:
            continue
        if pending is not None:
            _writeback(*pending)
        pending = (paths, hr_batch, lr_dev)
    if pending is not None:
        _writeback(*pending)
    report = RunReport(succeeded=ok, failed=fail, seconds=time.time() - t0)
    print(f"factory[{backend}, {input_format}]: {report.summary()} -> {output_dir}")
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Fused hr/lr train-data factory")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--kernel", required=True, help="single per-band kernel .npy")
    p.add_argument("--noise-pool", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--factor", type=int, default=8,
                   help="decimation factor; any factor the JAX factory takes "
                        "(e.g. 2 for KernelGAN's x2)")
    p.add_argument("--in-group", default=GROUP_DENOISED)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="fused: the hand-written CUDA degrade kernels (auto); "
                        "conv: grouped strided conv + noise")
    p.add_argument("--input-format", choices=["auto", "nc", "npy"],
                   default="auto",
                   help="npy: raw [C,H,W] patch dirs, streamed through the "
                        "native split loader into the presplit kernel")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = p.parse_args(argv)
    report = run_factory(
        a.input_dir, a.kernel, a.noise_pool, a.output_dir,
        factor=a.factor, in_group=a.in_group, batch_size=a.batch_size,
        seed=a.seed, backend=a.backend, input_format=a.input_format,
        device=a.device,
    )
    return 0 if report.n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
