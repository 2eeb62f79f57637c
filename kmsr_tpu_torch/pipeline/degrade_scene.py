"""Stage: degrade FULL scenes (no pre-cutting) on the card.

Counterpart of `kmsr_tpu.pipeline.degrade_scene`: a whole Landsat scene
(~8000^2 px) is degraded in one device pass — the 13x13 per-band blur and
the x`factor` box downsample as one stride-f stencil over row slabs with
halo rows (`parallel.spatial.degrade_scene`, the `colsplit_raw` kernel on
a card). NaN pixels are mean-filled per band for the blur, and output
cells whose whole factor x factor footprint was NaN are restored to NaN,
so masked scenes survive the stencil. Reads `geophysical_data` and
appends a `blurred` group to a copy of each scene file, as the JAX stage
does.

Across ranks (a torchrun launch of several processes, one per card; JAX
row-shards each scene over its mesh): every rank takes part in every
scene, reads only its own row slab from the file (`parallel.spatial.
rank_rows`), fills its NaN pixels with the band means of the whole scene
(sums and counts all-reduced), degrades its slab once with halo rows from
its neighbours, and rank 0 writes the gathered output.

Usage:
    python -m kmsr_tpu_torch.pipeline.degrade_scene --input SCENE.nc_or_DIR \
        --kernel kernel_per_band.npy --output-dir OUT [--factor 8] \
        [--in-group geophysical_data] [--out-group blurred] \
        [--impl fast|bands] [--device cuda|cpu]
    torchrun --nproc_per_node=N -m kmsr_tpu_torch.pipeline.degrade_scene ...
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.sampler import list_patch_files
from ..device import resolve_device
from ..io.ncio import band_shape, copied, read_band_stack, write_bands
from ..io.schema import GROUP_BLURRED, GROUP_GEO, RADIANCE_UNITS
from ..parallel.mesh import make_mesh
from ..parallel.multihost import global_batch, initialize_if_needed, world_size
from ..parallel.spatial import degrade_scene, degrade_slab_ranks, rank_rows, scene_slab
from ..utils.profiling import stage_timer
from .apply_kernel import load_kernel
from .common import RunReport


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def degrade_scene_file(
    scene: np.ndarray, kernel: torch.Tensor, factor: int = 8,
    n_shards: int = 1, impl: str = "fast",
) -> np.ndarray:
    """[C, H, W] host scene -> [C, H//f, W//f] host array, degraded on
    `kernel`'s device; NaN-aware (band-mean fill for the blur, cells whose
    whole footprint was NaN restored to NaN). Stage timers: `scene.h2d`,
    `scene.kernel` (NaN fill, stencil, NaN restore; synchronized) and
    `scene.d2h`."""
    dev = kernel.device
    c = scene.shape[0]
    with stage_timer("scene.h2d"):
        x = torch.from_numpy(np.ascontiguousarray(scene, np.float32)).to(dev)
        _sync(dev)
    with stage_timer("scene.kernel"):
        valid = ~torch.isnan(x)
        if bool(valid.all()):
            out = degrade_scene(x, kernel, n_shards, factor, impl)
        else:
            fills = torch.nanmean(x, dim=(1, 2))
            fills = torch.where(valid.flatten(1).any(dim=1), fills, 0.0)
            out = degrade_scene(torch.where(valid, x, fills[:, None, None]),
                                kernel, n_shards, factor, impl)
            # a downsampled cell is NaN iff its factor x factor footprint
            # had no valid pixel at all (the cutter's NaN gate)
            oh, ow = out.shape[1:]
            v = valid[:, :oh * factor, :ow * factor].reshape(
                c, oh, factor, ow, factor)
            out = torch.where(v.any(dim=4).any(dim=2), out, float("nan"))
        _sync(dev)
    with stage_timer("scene.d2h"):
        return out.cpu().numpy()


def degrade_scene_ranks(read_rows, h: int, kernel: torch.Tensor, mesh,
                        factor: int = 8, impl: str = "fast") -> np.ndarray:
    """The whole-scene degrade with one row slab a rank: this rank reads
    only its slab through read_rows(lo, hi) (scene rows lo..hi as a host
    [C, rows, W] array; H = h), NaN-fills it with the whole scene's band
    means (each rank's NaN-sums and counts over its own rows of the scene,
    all-reduced), degrades it once with its neighbours' halo rows,
    restores the cells whose footprint was all NaN and all-gathers the
    rows: every rank returns the whole [C, H//f, W//f] output. At world
    size 1 this is `degrade_scene_file` on the same scene."""
    dev = kernel.device
    r0, r1, h_keep = rank_rows(h, factor, mesh)
    slab = scene_slab(read_rows, r0, r1, h_keep)
    c, _, w = slab.shape
    w_keep = (w // factor) * factor
    with stage_timer("scene.h2d"):
        x = slab.to(dev)
        _sync(dev)
    with stage_timer("scene.kernel"):
        # the band-mean statistics over the rank's own rows of the scene
        # (the last rank's include the rows past h_keep)
        own = x[:, :max(0, min(r1, h_keep) - r0)]
        if mesh.rank == mesh.size - 1 and h > h_keep:
            own = torch.cat([own, torch.as_tensor(read_rows(h_keep, h)).to(dev)], dim=1)
        valid = ~torch.isnan(x)
        # NaN-sums (float32, as torch.nanmean sums) and exact valid counts
        sums = torch.nansum(own, dim=(1, 2))
        counts = (~torch.isnan(own)).sum(dim=(1, 2))
        if mesh.group is not None:
            for t in (sums, counts):
                torch.distributed.all_reduce(t, group=mesh.group)
        x = x[:, :, :w_keep]
        valid = valid[:, :, :w_keep]
        if int(counts.sum()) == c * h * w:
            out = degrade_slab_ranks(x, kernel, mesh, factor, impl)
        else:
            # nanmean's division: the float32 sum over the integer count
            fills = torch.where(counts > 0, sums / counts, 0.0)
            out = degrade_slab_ranks(torch.where(valid, x, fills[:, None, None]),
                                     kernel, mesh, factor, impl)
            oh, ow = out.shape[1:]
            v = valid.reshape(c, oh, factor, ow, factor)
            out = torch.where(v.any(dim=4).any(dim=2), out, float("nan"))
        out = global_batch(mesh, out, dim=1)[:, : h_keep // factor]
        _sync(dev)
    with stage_timer("scene.d2h"):
        return out.cpu().numpy()


def process_scenes(
    input_path: str,
    kernel_path: str,
    output_dir: str,
    factor: int = 8,
    in_group: str = GROUP_GEO,
    out_group: str = GROUP_BLURRED,
    suffix: str = "_blurred",
    impl: str = "fast",
    device: str | torch.device = "cuda",
    mesh=None,
) -> RunReport:
    """Degrade every scene file; write `out_group` into a copy of each.
    With `mesh` (every rank calls this on the same files), each scene is
    degraded in one slab a rank (`degrade_scene_ranks`) and rank 0
    writes."""
    dev = resolve_device(device) if mesh is None else mesh.device
    t0 = time.time()
    kernel = torch.from_numpy(load_kernel(kernel_path)).to(dev)
    files = (
        [input_path]
        if os.path.isfile(input_path)
        else list_patch_files(input_path, "*.nc", host_shard=mesh is None)
    )
    main = mesh is None or mesh.is_main
    os.makedirs(output_dir, exist_ok=True)
    ok, fail = [], []
    for path in files:
        try:
            if mesh is None:
                lr = degrade_scene_file(read_band_stack(path, in_group), kernel,
                                        factor, impl=impl)
            else:
                lr = degrade_scene_ranks(
                    lambda lo, hi: read_band_stack(path, in_group, rows=slice(lo, hi)),
                    band_shape(path, in_group)[0], kernel, mesh, factor, impl)
            base = os.path.splitext(os.path.basename(path))[0]
            out_path = os.path.join(output_dir, f"{base}{suffix}.nc")
            if not main:
                ok.append(out_path)
                continue
            with copied(path, out_path) as f:  # the scene's groups + the LR group
                write_bands(
                    f,
                    out_group,
                    lr,
                    dims=(f"y_{out_group}", f"x_{out_group}"),
                    var_attrs={"units": RADIANCE_UNITS},
                    group_attrs={
                        "history": (
                            f"whole-scene blur + {factor}x downsample, "
                            + (f"one row slab on {dev.type}" if mesh is None else
                               f"{mesh.size} row slab(s) over ranks on {dev.type}")
                        ),
                        "kernel_file": os.path.basename(kernel_path),
                    },
                )
            ok.append(out_path)
        except Exception as e:  # per-file failure isolation
            fail.append((path, f"{type(e).__name__}: {e}"))
    report = RunReport(succeeded=ok, failed=fail, seconds=time.time() - t0)
    print(f"degrade_scene: {report.summary()} -> {output_dir}")
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Whole-scene degrade in row slabs")
    p.add_argument("--input", required=True, help=".nc scene file or folder")
    p.add_argument("--kernel", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--factor", type=int, default=8)
    p.add_argument("--in-group", default=GROUP_GEO)
    p.add_argument("--out-group", default=GROUP_BLURRED)
    p.add_argument("--suffix", default="_blurred")
    p.add_argument("--impl", choices=["fast", "bands"],
                   default="fast",
                   help="fast: raw-slab stencil kernel; bands: slab conv")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    # under a launch of several processes: one row slab a rank
    started = initialize_if_needed(a.device)
    try:
        report = process_scenes(
            a.input, a.kernel, a.output_dir,
            factor=a.factor, in_group=a.in_group, out_group=a.out_group,
            suffix=a.suffix, impl=a.impl, device=a.device,
            mesh=make_mesh(device=a.device) if world_size() > 1 else None,
        )
    finally:
        if started:
            torch.distributed.destroy_process_group()
    return 0 if report.n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
