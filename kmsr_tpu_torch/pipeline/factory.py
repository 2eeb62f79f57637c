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
each lr file equals the JAX factory's for the same seed.

`--moe MODEL` is the content-adaptive route (both input formats take the
natural route, as in JAX): the trained selector routes each HR patch to
its expert (argmax of the logits; eval-mode BatchNorm when
`moe_state.npz` sits beside the model, batch statistics otherwise), the
patch is blurred with THAT expert's kernel (replicate padding, full-size
blur, x`factor` block mean: `ops.degrade.degrade_batch_kernels`, a cuDNN
grouped conv, as JAX's route is XLA) and gets the pool draw
(`--moe-noise pool`) or a normal draw scaled by the expert's learned
per-band sigma (`--moe-noise sigma`); the `lr` group carries the
`moe_expert` attribute.

`--kernel-root DIR` takes per-scene kernels, a fleet run's outdir
(`DIR/<scene>/kernel_per_band.npy`): the files are grouped by scene name
(`pipeline.common.route_per_scene_kernels`) and each scene runs the
one-kernel route above on its own files, with its own noise seed
`scene_seed(seed, scene)`, so it takes the same routes and launches the
same kernels as a one-kernel run. A scene with no kernel fails all of its
files; the others go on.

The `.npy` presplit route splits each batch over the host's cards
(`parallel.local_dp`), launching `degrade_v3psn` once a card, as JAX
shard_maps it over its local devices; the other routes run on one card,
as in JAX.

Usage:
    python -m kmsr_tpu_torch.pipeline.factory --input-dir DENOISED \
        (--kernel kernel_per_band.npy | --moe KERNEL_RUN | --kernel-root FLEET_RUN) \
        --noise-pool pool.npy --output-dir TRAIN [--factor 8] \
        [--moe-noise pool|sigma] [--batch-size 128] [--seed 42] \
        [--backend auto|conv|fused] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import glob
import os
import time
import zlib
from typing import Iterator

import numpy as np
import torch

from ..data.noise_pool import load_noise_pool
from ..data.sampler import list_patch_files
from ..device import resolve_device
from ..io.ncio import read_band_stack, read_nav
from ..io.schema import GROUP_DENOISED
from ..models.moe import (
    MoEConfig,
    effective_kernels,
    effective_sigmas,
    init_moe,
    selector_forward,
)
from ..ops.degrade import degrade_batch_kernels, degrade_strided
from ..ops.degrade_fused import degrade_fused, degrade_fused_presplit
from ..parallel.local_dp import gather, local_batch_dp, local_map, pad_put
from ..utils.params_io import load_params
from ..utils.profiling import stage_timer
from .apply_kernel import load_kernel
from .common import DeviceSyncGuard, RunReport, chunked_reader, route_per_scene_kernels
from .make_train_data import save_training_sample

BACKENDS = ("auto", "conv", "fused")

#: one factory batch: (paths, hr [b, C, H, W] host array, lr [b, C, h, w]
#: device tensor — dispatched, not yet synchronized, failures)
Batch = tuple[list, np.ndarray, torch.Tensor, list]
#: one batch of the MoE route: (paths, hr, lr, experts [b] device tensor,
#: failures)
MoEBatch = tuple[list, np.ndarray, torch.Tensor, torch.Tensor, list]


#: JAX's TPU lane width (`kmsr_tpu.ops.degrade_pallas.LANE`): the presplit
#: route splits a chunk over n_dev cards once it holds LANE * n_dev / 2 patches
LANE = 128

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


def _natural(files, pool, noise_of, device_fn, *, batch_size, input_format,
             in_group, dev) -> Iterator[tuple]:
    """The natural-layout route: read each chunk of files on a background
    thread (per-file failure isolation), stack it NCHW into pinned memory,
    copy it and its noise-pool draws to the device and dispatch
    device_fn(hr, noise, paths) on them. noise_of maps each path to its
    noise-pool index. Yields (paths, hr host array, device_fn's result,
    failures)."""

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
            out = device_fn(hr.to(dev, non_blocking=True),
                            noise.to(dev, non_blocking=True), valid)
        yield valid, hr.numpy(), out, chunk_fail


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
    """The natural-layout route of the single kernel: each chunk stacked
    NCHW and degraded by `degrade_with_noise` on the device (`_natural`)."""
    return _natural(
        files, pool, noise_of,
        lambda hr, noise, _: degrade_with_noise(hr, kernel, noise, factor, backend),
        batch_size=batch_size, input_format=input_format, in_group=in_group,
        dev=resolve_device(device))


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
    devices=None,
) -> Iterator[Batch]:
    """The `.npy` route: the native split gather feeds the halo-free
    presplit kernel (`degrade_fused_presplit`); lr is returned as a
    [b, C, h, w] view of the kernel's [C, h, w, b] output.

    Batch DP over the host's cards (`parallel.local_dp`; for device
    "cuda", every visible card; `devices` names them explicitly), as JAX
    shard_maps the route over its local devices: a chunk of at least
    LANE * n_dev / 2 patches has its batch (lane) axis split into one
    contiguous block a card, with its noise draws, and `degrade_v3psn` is
    launched once a card; the lr blocks are gathered in order on the first
    card. Smaller (tail) chunks run on the first card alone, as in JAX.
    The CUDA kernel takes any batch width, so the batch is padded to a
    multiple of the card count only, not of JAX's 128-lane quantum."""
    devs, n_dev = local_batch_dp(device, devices)
    dev = devs[0]
    if len(shape) != 3 or shape[1] % factor or shape[2] % factor:
        raise ValueError(
            f"npy patches must be [C, H, W] with H, W multiples of "
            f"factor; got {shape}"
        )
    c, h, w = shape
    kernels = {d: kernel.to(d) for d in devs}
    for paths, xp, nat, chunk_fail in _npy_split_batches(
            files, batch_size, shape, factor, dev):
        if xp is None:
            yield [], None, None, chunk_fail
            continue
        with stage_timer("factory.dispatch"):
            noise = _host_empty((c, h // factor, w // factor, len(paths)), dev)
            np.copyto(noise.numpy(), np.transpose(
                pool[[noise_of[p] for p in paths]], (1, 2, 3, 0)))  # CHWB
            # DP only pays when the chunk roughly fills the card set
            use = devs if n_dev > 1 and len(paths) >= LANE * n_dev // 2 else devs[:1]
            xs, b = pad_put(xp, use, len(use), axis=-1)
            ns, _ = pad_put(noise, use, len(use), axis=-1)
            lr = gather(local_map(
                lambda x, n: degrade_fused_presplit(x, kernels[x.device], noise=n,
                                                    factor=factor), xs, ns), b, axis=-1)
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


def noise_inputs(files: list[str], noise_pool_path: str,
                 seed: int = 42) -> tuple[np.ndarray, dict]:
    """(noise pool [N, C, h, w] on the host, {path: noise-pool index}). The
    indices are drawn per FILE up front (position-indexed), so every
    route/backend/chunking — and per-file failures — produces the same lr
    for the same seed, in this package and in the JAX one."""
    pool = load_noise_pool(noise_pool_path)
    rng = np.random.default_rng(seed)
    noise_idx = rng.integers(0, pool.shape[0], size=len(files))
    return pool, dict(zip(files, noise_idx.tolist()))


def factory_inputs(
    files: list[str],
    kernel_path: str,
    noise_pool_path: str,
    seed: int = 42,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, np.ndarray, dict]:
    """(kernel [C, kh, kw] on `device`, and `noise_inputs`)."""
    dev = resolve_device(device)
    pool, noise_of = noise_inputs(files, noise_pool_path, seed)
    kernel = torch.from_numpy(load_kernel(kernel_path)).to(dev)
    return kernel, pool, noise_of


# ------------------------------------------------------------ the MoE route
def load_moe_for_factory(moe_path: str, device: str | torch.device = "cuda"):
    """A trained MoE degradation model for content-adaptive runs, on
    `device`. moe_path: a directory holding `moe_model.npz` (either
    package's, with an optional `moe_state.npz` of BN running stats beside
    it), that .npz itself, or the reference's torch `moe_model.pth`; the
    config is inferred from the kernel bank. Returns (params, state,
    eval_mode): eval_mode is True when BN running stats were found
    (selection independent of the batch); otherwise selection uses the
    batch's statistics."""
    dev = resolve_device(device)
    if moe_path.endswith(".pth"):
        from ..utils.torch_import import load_moe_torch_checkpoint

        params, state = load_moe_torch_checkpoint(moe_path, cfg=None, device=dev)
        return params, state, True
    npz = moe_path if moe_path.endswith(".npz") else os.path.join(moe_path, "moe_model.npz")
    data = np.load(npz)
    bank = None
    for k in data.files:
        if k.startswith("name_") and "kernel_bank" in str(data[k]):
            bank = data["arr_" + k[len("name_"):]]
    if bank is None:
        raise ValueError(f"{npz} has no kernel_bank leaf — not a MoE model")
    cfg = MoEConfig(n_kernels=bank.shape[0], n_channels=bank.shape[1],
                    kernel_size=bank.shape[2])
    template, state0 = init_moe(cfg, device=dev)
    params = load_params(npz, template, dev)
    state_path = os.path.join(os.path.dirname(npz), "moe_state.npz")
    if os.path.exists(state_path):
        return params, load_params(state_path, state0, dev), True
    return params, state0, False


@torch.no_grad()
def moe_logits(model: tuple, hr: torch.Tensor) -> torch.Tensor:
    """The selector's logits [B, K] for an HR batch; model is
    `load_moe_for_factory`'s (params, state, eval_mode)."""
    params, state, eval_mode = model
    logits, _ = selector_forward(params["selector"], state["selector"], hr,
                                 train=not eval_mode)
    return logits


@torch.no_grad()
def moe_degrade(model: tuple, hr: torch.Tensor, factor: int):
    """(lr [B, C, H/f, W/f] without noise, experts [B]): each patch blurred
    with the kernel of its argmax expert, replicate padding, block mean.
    The factory and apply_kernel's MoE routes share it."""
    experts = moe_logits(model, hr).argmax(dim=-1)
    banks = effective_kernels(model[0])
    return degrade_batch_kernels(hr, banks[experts], factor=factor, decimate=False,
                                 padding="replicate"), experts


def sigma_noise_seed(seed: int, first_pos: int) -> int:
    """The `--moe-noise sigma` generator's seed for the chunk that starts at
    file position first_pos: the run's seed and the position, as JAX folds
    the position into its seed key (so the draws do not depend on the
    chunking). The bits are torch's, not jax.random's: the two packages'
    sigma noise differs, with the same statistics. 32 bits, mixed from both
    (a CPU generator keeps only the low 32 bits of its seed)."""
    return int(np.random.SeedSequence([seed, first_pos]).generate_state(1)[0])


def moe_batches(
    files: list[str],
    model: tuple,
    pool: np.ndarray,
    noise_of: dict,
    *,
    factor: int = 4,
    batch_size: int = 128,
    seed: int = 42,
    moe_noise: str = "pool",
    input_format: str = "nc",
    in_group: str = GROUP_DENOISED,
    device: str | torch.device = "cuda",
) -> Iterator[MoEBatch]:
    """The MoE route, batch by batch: `moe_degrade` on each natural batch,
    plus its noise-pool draws (moe_noise="pool") or a standard normal
    scaled by each patch's expert sigma per band ("sigma")."""
    if moe_noise not in ("pool", "sigma"):
        raise ValueError(f"moe_noise must be pool|sigma, got {moe_noise!r}")
    file_pos = {p: i for i, p in enumerate(files)}
    sigmas = effective_sigmas(model[0]).detach()

    def fn(hr, noise, paths):
        lr, experts = moe_degrade(model, hr, factor)
        if moe_noise == "sigma":
            gen = torch.Generator(device=hr.device).manual_seed(
                sigma_noise_seed(seed, file_pos[paths[0]]))
            noise = torch.randn(lr.shape, generator=gen, device=lr.device) \
                * sigmas[experts][:, :, None, None]
        return lr + noise, experts

    for paths, hr, out, fails in _natural(
            files, pool, noise_of, fn, batch_size=batch_size,
            input_format=input_format, in_group=in_group, dev=resolve_device(device)):
        lr, experts = out if out is not None else (None, None)
        yield paths, hr, lr, experts, fails


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
    devices=None,
) -> Iterator[Batch]:
    """The factory's device part, batch by batch: the presplit route for
    fused `.npy` input (over the host's cards, `presplit_batches`), the
    natural route otherwise (one card, as in JAX). `run_factory` consumes
    this generator and writes each batch's files."""
    kernel, pool, noise_of = factory_inputs(files, kernel_path,
                                            noise_pool_path, seed, device)
    shape = _presplit_shape(files, kernel, factor, backend, input_format)
    if shape is not None:
        return presplit_batches(files, kernel, pool, noise_of, shape=shape,
                                factor=factor, batch_size=batch_size,
                                device=device, devices=devices)
    return natural_batches(files, kernel, pool, noise_of, factor=factor,
                           batch_size=batch_size, backend=backend,
                           input_format=input_format, in_group=in_group,
                           device=device)


def scene_seed(seed: int, scene: str) -> int:
    """Derived noise seed for one scene of a per-scene (--kernel-root)
    factory run: stable across runs AND across scene-set changes (the
    scene NAME is mixed in, not its position)."""
    return (seed ^ zlib.crc32(scene.encode("utf-8"))) & 0x7FFFFFFF


def run_factory(
    input_dir: str,
    kernel_path: str | None,
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
    moe_path: str | None = None,
    moe_noise: str = "pool",
    kernel_root: str | None = None,
) -> RunReport:
    """Degrade every patch in `input_dir` and write `<name>_train.nc` pairs.

    Exactly one of kernel_path (one per-band kernel), moe_path (the
    content-adaptive route) and kernel_root (per-scene kernels, a fleet
    run's outdir; see the module docstring) is taken.

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
    if sum(p is not None for p in (kernel_path, moe_path, kernel_root)) != 1:
        raise ValueError(
            "exactly one of kernel_path / moe_path / kernel_root is required"
        )
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
    if kernel_root is not None:
        # each scene's files through ITS kernel, with a distinct noise
        # stream: with a shared seed every scene's i-th file would draw the
        # SAME noise-pool entry
        return route_per_scene_kernels(
            files, kernel_root,
            lambda scene, k_path, scene_files: run_factory(
                input_dir, k_path, noise_pool_path, output_dir,
                factor=factor, in_group=in_group, batch_size=batch_size,
                seed=scene_seed(seed, scene), backend=backend,
                progress=progress, input_format=input_format,
                files=scene_files, device=dev,
            ),
            "factory", output_dir,
        )
    os.makedirs(output_dir, exist_ok=True)
    if moe_path is None:
        batches = ((paths, hr, lr, None, fails) for paths, hr, lr, fails in factory_batches(
            files, kernel_path, noise_pool_path, factor=factor,
            batch_size=batch_size, seed=seed, backend=backend,
            input_format=input_format, in_group=in_group, device=dev,
        ))
    else:
        pool, noise_of = noise_inputs(files, noise_pool_path, seed)
        batches = moe_batches(
            files, load_moe_for_factory(moe_path, dev), pool, noise_of,
            factor=factor, batch_size=batch_size, seed=seed, moe_noise=moe_noise,
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

    def _writeback(paths, hr_batch, lr_dev, experts_dev):
        # the device-to-host copy syncs batch k AFTER batch k+1 was
        # dispatched: device compute + D2H overlap the host-side nav reads
        # and zlib .nc writes. Device-side runtime failures surface at this
        # sync (asynchronous launches) — fail this batch's files, don't
        # crash the run (unless the guard sees the device persistently
        # wedged).
        try:
            with stage_timer("factory.device_sync"):
                lr_batch = lr_dev.cpu().numpy()
                experts = ([None] * len(paths) if experts_dev is None
                           else experts_dev.cpu().tolist())
            sync_guard.succeeded()
        except Exception as e:  # per-batch failure isolation
            fail.extend((p, f"{type(e).__name__}: {e}") for p in paths)
            sync_guard.failed(e)
            return
        with stage_timer("factory.host_write"):
            for path, hr, lr, expert in zip(paths, hr_batch, lr_batch, experts):
                try:
                    base = os.path.splitext(os.path.basename(path))[0]
                    out_path = os.path.join(output_dir, f"{base}_train.nc")
                    nav = read_nav(path) if input_format == "nc" else None
                    save_training_sample(
                        out_path, hr, lr, nav or None,
                        lr_attrs=None if expert is None else {"moe_expert": int(expert)})
                    ok.append(out_path)
                except Exception as e:
                    fail.append((path, str(e)))

    pending = None
    for paths, hr_batch, lr_dev, experts_dev, chunk_fail in batches:
        fail.extend(chunk_fail)
        if lr_dev is None:
            continue
        if pending is not None:
            _writeback(*pending)
        pending = (paths, hr_batch, lr_dev, experts_dev)
    if pending is not None:
        _writeback(*pending)
    report = RunReport(succeeded=ok, failed=fail, seconds=time.time() - t0)
    route = backend if moe_path is None else f"moe, noise {moe_noise}"
    print(f"factory[{route}, {input_format}]: {report.summary()} -> {output_dir}")
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Fused hr/lr train-data factory")
    p.add_argument("--input-dir", required=True)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--kernel", help="single per-band kernel .npy")
    src.add_argument("--moe", help="content-adaptive mode: MoE model dir / "
                                   "moe_model.npz / reference moe_model.pth — "
                                   "each patch degrades with its selector-"
                                   "routed expert kernel")
    src.add_argument("--kernel-root",
                     help="per-scene kernels: a fleet-trainer outdir "
                          "(<scene>/kernel_per_band.npy); each patch "
                          "degrades with ITS scene's kernel")
    p.add_argument("--moe-noise", choices=["pool", "sigma"], default="pool",
                   help="pool: empirical noise-pool sample; sigma: the "
                        "expert's learned per-band Gaussian")
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
        device=a.device, moe_path=a.moe, moe_noise=a.moe_noise,
        kernel_root=a.kernel_root,
    )
    return 0 if report.n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
