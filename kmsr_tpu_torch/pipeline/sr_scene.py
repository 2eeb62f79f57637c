"""Stage: super-resolve whole scenes through exact halo tiling.

Counterpart of `kmsr_tpu.pipeline.sr_scene`. The SR network runs on
fixed tiles; the scene is tiled on a fixed LR grid and the tile centres
are reassembled on the host, equal to the untiled forward (up to the
compute dtype's reduction order), not blended. Exactness needs care at
the scene's borders, where zero conv padding and bilinear tap clamping
make the network other than translation-equivariant, so each tile's
input slab is cut from the real scene with its edges clamped to the
scene's edges:

- interior tiles get a full halo of real pixels (halo >= the receptive
  field's radius, so the centre sees no border);
- tiles at a scene border keep that border as their own, so the
  per-layer padding and clamping happen where the untiled forward's do.

All slabs share one shape (min(tile + 2*halo, scene extent) per axis);
the last chunk of tiles is padded to the chunk size, so every dispatch
has one shape. The filled scene is uploaded once; slabs are gathered and
each tile's centre is cropped on the device by index arithmetic, so only
the centres come back, through pinned memory. A chunk is dispatched
before the previous one is assembled on the host (one-deep pipeline).
NaN pixels are filled with their band's nanmean for the network, and the
output footprint of every NaN LR pixel is NaN again.

Stage timers (`utils.profiling.stage_timer`): sr_scene.fill (NaN fill and
upload), sr_scene.dispatch (slab gather, forward, crop, copy back queued),
sr_scene.device_sync (waiting for a chunk's copy back), sr_scene.assemble
(host copies into the output), sr_scene.nan_restore.

`--data-parallel` (JAX: the tile batch sharded over a device mesh): under
a torchrun launch of one process per card, each chunk (rounded up to a
multiple of the rank count, as JAX rounds it to its devices) is split over
the ranks in contiguous blocks; every rank runs the network on its block,
the centres are all-gathered, and rank 0 assembles the scene and writes
each output file once.

Usage:
    python -m kmsr_tpu_torch.pipeline.sr_scene --input SCENE.nc_or_DIR \
        --model sr_model.npz --output-dir OUT [--in-group lr] \
        [--tile 64] [--halo N] [--chunk 32] [--device cuda|cpu]
    torchrun --nproc_per_node=N -m kmsr_tpu_torch.pipeline.sr_scene ... --data-parallel
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.sampler import list_patch_files
from ..io.ncio import copied, read_band_stack, write_bands
from ..io.schema import GROUP_LR
from ..models.sr import SRConfig, require_edsr, sr_forward
from ..parallel.mesh import launch_mesh, mesh_device, rows_of
from ..parallel.multihost import global_batch
from ..utils.profiling import stage_timer
from .common import RunReport
from .sr_infer import load_sr_model, queued_event, to_host


def receptive_halo(cfg: SRConfig) -> int:
    """Upper bound (in LR pixels) on the SR net's receptive-field radius:
    3x3 head + 2 convs per residual block + body_tail contribute 1 LR px
    each; the upsampler convs run at >= LR scale and sum to < 2 LR px."""
    return 2 * cfg.n_blocks + 4


def _anchors(n: int, t: int) -> list[int]:
    a = list(range(0, n - t + 1, t))
    if a[-1] != n - t:
        a.append(n - t)  # shifted last tile, fully in-scene
    return a


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """`a` on `dev`; through pinned memory to a card, so the copy queues
    behind the device's work instead of waiting for it."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def _band_filled(scene: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """NaN pixels replaced by their band's nanmean (0 for an all-NaN band)."""
    if valid.all():
        return scene
    fills = np.array(
        [np.nanmean(scene[i]) if valid[i].any() else 0.0 for i in range(scene.shape[0])],
        np.float32,
    )
    return np.where(valid, scene, fills[:, None, None]).astype(np.float32)


def _slabs(scene: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
           hgt: int, wid: int) -> torch.Tensor:
    """[N, C, hgt, wid] windows of scene [C, H, W] at rows ys[n] and
    columns xs[n] (one device gather)."""
    rows = ys[:, None, None] + torch.arange(hgt, device=scene.device)[:, None]
    cols = xs[:, None, None] + torch.arange(wid, device=scene.device)
    return scene[:, rows, cols].transpose(0, 1)


def _crops(batch: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
           hgt: int, wid: int) -> torch.Tensor:
    """The [hgt, wid] window of batch[n] [C, H, W] at (ys[n], xs[n]), as a
    contiguous [N, C, hgt, wid] (two device gathers: rows, then columns)."""
    n, c, _, w = batch.shape
    rows = (ys[:, None] + torch.arange(hgt, device=batch.device))[:, None, :, None]
    cols = (xs[:, None] + torch.arange(wid, device=batch.device))[:, None, None, :]
    return batch.gather(2, rows.expand(n, c, hgt, w)).gather(3, cols.expand(n, c, hgt, wid))


def _rank_crops(params, filled, idx, padn, cfg, compute_dtype, sizes, mesh):
    """One chunk's tile centres with the chunk's tiles split over the ranks:
    the chunk (idx padded with padn repeats of its first tile) is cut into
    one contiguous block a rank, each rank runs the network on its block
    and crops its centres, and the centres are all-gathered in rank order."""
    slab_h, slab_w, ch, cw = sizes
    if padn:
        idx = torch.cat([idx, idx[:1].expand(padn, -1)])
    mine = idx[rows_of(mesh, idx.shape[0])]
    res = sr_forward(params, _slabs(filled, mine[:, 0], mine[:, 1], slab_h, slab_w),
                     cfg, compute_dtype)
    return global_batch(mesh, _crops(res, mine[:, 2], mine[:, 3], ch, cw))


def sr_scene(
    params: dict,
    scene: np.ndarray,
    cfg: SRConfig = SRConfig(),
    tile: int = 64,
    halo: int | None = None,
    chunk: int = 32,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    mesh=None,
) -> np.ndarray | None:
    """[C, H, W] LR scene -> [C, H*factor, W*factor] SR scene (host array).
    With `mesh` (a 'data' mesh; every rank passes the same scene), each
    chunk's tiles are split over the ranks and the scene is assembled on
    rank 0, which returns it; the other ranks return None. The EDSR only
    (ValueError for another network)."""
    require_edsr(cfg, "sr_scene")
    dev = mesh_device(device, mesh)
    n_rank = 1 if mesh is None else mesh.size
    if chunk % n_rank:  # even blocks per rank: round up, don't fail mid-run
        chunk = -(-chunk // n_rank) * n_rank
    main = mesh is None or mesh.is_main
    scene = np.asarray(scene, np.float32)
    c, h, w = scene.shape
    f = cfg.factor
    th, tw = min(tile, h), min(tile, w)
    r = receptive_halo(cfg) if halo is None else halo
    slab_h, slab_w = min(h, th + 2 * r), min(w, tw + 2 * r)

    with stage_timer("sr_scene.fill"):
        valid = np.isfinite(scene)
        filled = _upload(_band_filled(scene, valid), dev)

    coords = [(y, x) for y in _anchors(h, th) for x in _anchors(w, tw)]
    out = np.empty((c, h * f, w * f), np.float32) if main else None

    def assemble(group, res, done):
        with stage_timer("sr_scene.device_sync"):
            if done is not None:
                done.synchronize()
        if not main:
            return
        with stage_timer("sr_scene.assemble"):
            for (y0, x0), tile_out in zip(group, res.numpy()):
                out[:, y0 * f:(y0 + th) * f, x0 * f:(x0 + tw) * f] = tile_out

    pending = None  # one-deep pipeline: (group, host result, done event)
    for i0 in range(0, len(coords), chunk):
        group = coords[i0:i0 + chunk]
        with stage_timer("sr_scene.dispatch"):
            starts = np.array([(min(max(y0 - r, 0), h - slab_h), min(max(x0 - r, 0), w - slab_w))
                               for y0, x0 in group], np.int64).reshape(-1, 2)
            centre = (np.array(group, np.int64) - starts) * f
            # keep ONE dispatch shape: pad the last chunk with zero slabs
            padn = chunk - len(group)
            idx = _upload(np.concatenate([starts, centre], axis=1), dev)
            if mesh is None:
                slabs = _slabs(filled, idx[:, 0], idx[:, 1], slab_h, slab_w)
                if padn:
                    slabs = torch.cat([slabs, slabs.new_zeros((padn, *slabs.shape[1:]))])
                res = sr_forward(params, slabs, cfg, compute_dtype)[:len(group)]
                crops = _crops(res, idx[:, 2], idx[:, 3], th * f, tw * f)
            else:
                crops = _rank_crops(params, filled, idx, padn, cfg, compute_dtype,
                                    (slab_h, slab_w, th * f, tw * f), mesh)[:len(group)]
            host, done = (to_host(crops), queued_event(dev)) if main else (None, None)
        if pending is not None:
            assemble(*pending)
        pending = (group, host, done)
    if pending is not None:
        assemble(*pending)

    if main and not valid.all():
        with stage_timer("sr_scene.nan_restore"):
            # in-place masked write on a block view — a repeated boolean
            # mask would allocate another full-HR array (GBs at scene scale)
            np.copyto(out.reshape(c, h, f, w, f), np.nan,
                      where=~valid[:, :, None, :, None])
    return out


def sr_scene_folder(
    input_path: str,
    model_path: str,
    output_dir: str,
    cfg: SRConfig = SRConfig(),
    in_group: str = GROUP_LR,
    out_group: str = "sr",
    tile: int = 64,
    halo: int | None = None,
    chunk: int = 32,
    device: str | torch.device = "cuda",
    mesh=None,
) -> RunReport:
    """Super-resolve every scene; with `mesh` every rank takes part in every
    scene (`sr_scene`) and rank 0 writes each output file."""
    require_edsr(cfg, "sr_scene")
    t0 = time.time()
    dev = mesh_device(device, mesh)
    main = mesh is None or mesh.is_main
    params = load_sr_model(model_path, cfg, dev)
    files = (
        [input_path] if os.path.isfile(input_path)
        else list_patch_files(input_path, "*.nc", host_shard=mesh is None)
    )
    os.makedirs(output_dir, exist_ok=True)
    ok, fail = [], []
    total_px = 0
    for path in files:
        try:
            scene = read_band_stack(path, in_group)
            sr = sr_scene(params, scene, cfg, tile=tile, halo=halo, chunk=chunk,
                          device=dev, mesh=mesh)
            if not main:
                ok.append(path)
                continue
            dst = os.path.join(output_dir, os.path.basename(path))
            with copied(path, dst) as f:  # the input's groups + the SR group
                write_bands(
                    f, out_group, sr,
                    group_attrs={
                        "source_group": in_group, "factor": cfg.factor,
                        "tile": tile, "halo": halo if halo is not None
                        else receptive_halo(cfg),
                        "model": os.path.basename(model_path),
                    },
                )
            total_px += sr.shape[1] * sr.shape[2]
            ok.append(path)
        except Exception as e:  # per-file failure isolation
            fail.append((path, f"{type(e).__name__}: {e}"))
    dt = time.time() - t0
    if main:
        print(
            f"sr_scene: {len(ok)} scene(s), {total_px / 1e6:.1f} Mpix out in "
            f"{dt:.1f}s ({total_px / dt / 1e6:.1f} Mpix/s end-to-end)"
        )
    return RunReport(succeeded=ok, failed=fail, seconds=dt)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Whole-scene SR via exact halo tiling")
    p.add_argument("--input", required=True, help="scene .nc or a dir of them")
    p.add_argument("--model", required=True, help="sr_model.npz")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--in-group", default=GROUP_LR)
    p.add_argument("--out-group", default="sr")
    p.add_argument("--factor", type=int, default=8)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--n-blocks", type=int, default=8)
    p.add_argument("--upsampler", default="progressive",
                   choices=["progressive", "oneshot"])
    p.add_argument("--tile", type=int, default=64)
    p.add_argument("--halo", type=int, default=None,
                   help="LR halo (default: the receptive-field bound)")
    p.add_argument("--chunk", type=int, default=32, help="tiles per dispatch")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the tile batch over all devices: one process "
                        "per card under torchrun (a plain process is one rank)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    cfg = SRConfig(width=a.width, n_blocks=a.n_blocks, factor=a.factor,
                   upsampler=a.upsampler)
    with launch_mesh(a.data_parallel, "data", a.device) as mesh:
        rep = sr_scene_folder(
            a.input, a.model, a.output_dir, cfg, in_group=a.in_group,
            out_group=a.out_group, tile=a.tile, halo=a.halo, chunk=a.chunk,
            device=a.device, mesh=mesh,
        )
    for path, err in rep.failed:
        print(f"FAILED {path}: {err}")
    return 0 if not rep.failed else 1


if __name__ == "__main__":
    raise SystemExit(main())
