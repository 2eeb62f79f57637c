"""Whole-scene degrade in row slabs with halo rows — the counterpart of
`kmsr_tpu.parallel.spatial`.

The JAX package row-shards a full scene (e.g. 8000^2 px Landsat) over a
device mesh: each device holds a contiguous row slab, swaps halo rows with
its neighbours (`lax.ppermute`) and degrades its slab locally. Here the
mesh becomes `n_shards`: the scene is cut into `n_shards` row slabs, and
each slab gets exactly the halo rows its JAX shard would get — neighbour
rows in the interior, its own edge row replicated at the global edges.
The slabs run one after another on the scene's device, so the result
equals JAX's on an n-device mesh and every slab seam runs through the
kernel.

Across ranks (`mesh=`, a `parallel.mesh.Mesh` of a torch.distributed
group): each rank holds one slab and `_rank_halo` swaps the thin halo rows
with its neighbours by `dist.batch_isend_irecv` (JAX's `ppermute`): its
last `top` rows go to the next rank, its first `bot` rows to the previous
one; the first and last ranks replicate their own edge rows. Each rank
runs the kernel on its slab once (`degrade_slab_ranks`), and
`degrade_scene_sharded` / `degrade_scene` all-gather the rows in rank
order. At world size 1 no row is sent and the result is the one-slab one.

Two local implementations, as in JAX:
- 'fast' (default): `ops.degrade_scene_fast.degrade_rows_fast`, the raw
  slab plus two thin halo tensors (views of the neighbouring slabs, or a
  few replicated edge rows) — no slab-sized concat; on a CUDA tensor the
  `colsplit_raw` kernel, at every slab height. JAX switches slabs thinner
  than 2*K rows to 'bands' because its Pallas strip convs reach about K
  rows into the slab; the CUDA kernel has no strip convs and takes thin
  slabs as they are, so the switch has no counterpart.
- 'bands': an extended slab (one concat) through one grouped strided
  `F.conv2d` (full float32). JAX's `_degrade_slab` row-band batching is
  an XLA memory workaround and has no counterpart; the result is the same
  conv.

Global edges use replicate padding, so the result matches the
single-device `ops.degrade`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.degrade import compose_with_box, depthwise_conv2d, normalize_kernel
from ..ops.degrade_scene_fast import degrade_rows_fast, halo_rows
from .multihost import global_batch


def _thin_halo(
    slabs: list[torch.Tensor], idx: int, top: int, bot: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(top_rows [C, top, W], bot_rows [C, bot, W]) for slab `idx`: the
    last `top` rows of the slab above and the first `bot` rows of the slab
    below, or this slab's own edge row replicated at the scene's first /
    last slab (all views, no copy) — what `ppermute` gives each JAX shard."""
    x = slabs[idx]
    for rows in (top, bot):
        if rows > x.shape[1]:
            raise ValueError(
                f"halo of {rows} rows exceeds the {x.shape[1]}-row slab")
    if idx == 0:
        top_rows = x[:, :1].expand(-1, top, -1)
    else:
        top_rows = slabs[idx - 1][:, -top:]
    if idx == len(slabs) - 1:
        bot_rows = x[:, -1:].expand(-1, bot, -1)
    else:
        bot_rows = slabs[idx + 1][:, :bot]
    return top_rows, bot_rows


def _rank_halo(x: torch.Tensor, top: int, bot: int, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(top_rows [C, top, W], bot_rows [C, bot, W]) for this rank's slab x:
    the previous rank's last `top` rows and the next rank's first `bot`
    rows, swapped by one `batch_isend_irecv`, or this slab's own edge row
    replicated on the first / last rank."""
    for rows in (top, bot):
        if rows > x.shape[1]:
            raise ValueError(
                f"halo of {rows} rows exceeds the {x.shape[1]}-row slab")
    r, n = mesh.rank, mesh.size
    c, _, w = x.shape
    ops, top_rows, bot_rows = [], None, None
    if r > 0:
        prev = dist.get_global_rank(mesh.group, r - 1)
        top_rows = x.new_empty((c, top, w))
        ops += [dist.P2POp(dist.isend, x[:, :bot].contiguous(), prev, mesh.group),
                dist.P2POp(dist.irecv, top_rows, prev, mesh.group)]
    if r < n - 1:
        nxt = dist.get_global_rank(mesh.group, r + 1)
        bot_rows = x.new_empty((c, bot, w))
        ops += [dist.P2POp(dist.isend, x[:, -top:].contiguous(), nxt, mesh.group),
                dist.P2POp(dist.irecv, bot_rows, nxt, mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if top_rows is None:
        top_rows = x[:, :1].expand(-1, top, -1)
    if bot_rows is None:
        bot_rows = x[:, -1:].expand(-1, bot, -1)
    return top_rows, bot_rows


def _composed(kernel: torch.Tensor, c: int, factor: int,
              device: torch.device) -> torch.Tensor:
    """The per-band normalized kernel composed with the box: [C, K, K]."""
    kernel = kernel.to(device=device, dtype=torch.float32)
    if kernel.ndim == 2:
        kernel = kernel[None].expand(c, *kernel.shape)
    return compose_with_box(normalize_kernel(kernel), factor).contiguous()


def _impl(impl: str) -> str:
    if impl == "tiles":  # removed JAX local path, kept as an alias
        impl = "fast"
    if impl not in ("fast", "bands"):
        raise ValueError(f"impl must be fast|bands, got {impl!r}")
    return impl


def _slab_out(x: torch.Tensor, comp: torch.Tensor, factor: int, impl: str,
              halo) -> torch.Tensor:
    """One slab's output rows; halo(top, bot) gives its halo rows. 'fast':
    the raw slab and two thin halos; 'bands': one extended slab (a concat)
    through a grouped strided conv."""
    ksize = comp.shape[-1]
    if impl == "fast":
        top, bot = halo_rows(factor, ksize)
        top_rows, bot_rows = halo(max(top, 1), max(bot, 1))
        return degrade_rows_fast(x, comp, factor, top_rows, bot_rows)
    # the blur's half sides (comp is the blur composed with the f-box)
    half_h, half_w = ((n - factor + 1) // 2 for n in comp.shape[-2:])
    top_rows, bot_rows = halo(half_h, half_h)
    x_ext = torch.cat([top_rows, x, bot_rows], dim=1)
    x_ext = F.pad(x_ext[None], (half_w, half_w, 0, 0), mode="replicate")
    return depthwise_conv2d(x_ext, comp, stride=factor)[0]


def degrade_slab_ranks(slab: torch.Tensor, kernel: torch.Tensor, mesh,
                       factor: int = 8, impl: str = "fast") -> torch.Tensor:
    """This rank's row slab [C, Hs, W] (Hs and W multiples of factor) ->
    its output rows [C, Hs/f, W/f], with the halo rows swapped with the
    neighbouring ranks (`_rank_halo`); the stencil runs once on the slab
    (the `colsplit_raw` kernel on a card)."""
    c, hs, w = slab.shape
    if hs % factor or w % factor:
        raise ValueError(
            f"slab {tuple(slab.shape)} must have rows and columns that are "
            f"multiples of factor={factor}")
    comp = _composed(kernel, c, factor, slab.device)
    if mesh.group is None:  # one rank: the scene's own edges
        def halo(top, bot):
            return _thin_halo([slab], 0, top, bot)
    else:
        def halo(top, bot):
            return _rank_halo(slab, top, bot, mesh)
    return _slab_out(slab, comp, factor, _impl(impl), halo)


def rank_rows(h: int, factor: int, mesh) -> tuple[int, int, int]:
    """(r0, r1, h_keep) for an H-row scene over `mesh`: H is cropped to
    h_keep (a multiple of factor), padded with edge rows up to a multiple
    of size * factor, and this rank holds rows [r0, r1) of the padded
    scene (rows from h_keep on repeat row h_keep - 1)."""
    h_keep = (h // factor) * factor
    hs = (h_keep + (-h_keep) % (mesh.size * factor)) // mesh.size
    return mesh.rank * hs, (mesh.rank + 1) * hs, h_keep


def scene_slab(read_rows, r0: int, r1: int, h_keep: int):
    """This rank's slab [C, r1 - r0, W] from read_rows(lo, hi) (rows lo..hi
    of the scene, any array type with [C, rows, W] slicing): the real rows
    it holds, then row h_keep - 1 repeated where the padded scene runs past
    the real one."""
    lo = min(r0, h_keep - 1)
    real = read_rows(lo, max(min(r1, h_keep), lo + 1))
    t = torch.as_tensor(real)
    if r0 >= h_keep:
        return t[:, -1:].expand(-1, r1 - r0, -1).contiguous()
    if t.shape[1] < r1 - r0:
        t = torch.cat([t, t[:, -1:].expand(-1, r1 - r0 - t.shape[1], -1)], dim=1)
    return t


def degrade_scene_sharded(
    scene: torch.Tensor,
    kernel: torch.Tensor,
    n_shards: int = 1,
    factor: int = 8,
    impl: str = "fast",
    mesh=None,
) -> torch.Tensor:
    """scene: [C, H, W] float32 (H divisible by n*factor, W by factor) ->
    [C, H/f, W/f], in n row slabs with halo rows: n = n_shards slabs run
    one after another in this process, or, with `mesh`, one slab a rank
    (n = mesh.size; every rank passes the whole scene, runs its own slab
    and gets the whole output back). kernel: [C, kh, kw] or [kh, kw]
    (normalized per band inside). impl: 'fast' | 'bands' ('tiles' is an
    alias of 'fast')."""
    c, h, w = scene.shape
    n = n_shards if mesh is None else mesh.size
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    if h % (n * factor) != 0:
        raise ValueError(f"H={h} must divide n_shards*factor={n * factor}")
    if w % factor != 0:
        raise ValueError(f"W={w} must be a multiple of factor={factor}")
    impl = _impl(impl)
    hs = h // n
    if mesh is not None:
        out = degrade_slab_ranks(scene[:, mesh.rank * hs:(mesh.rank + 1) * hs],
                                 kernel, mesh, factor, impl)
        return global_batch(mesh, out, dim=1)
    comp = _composed(kernel, c, factor, scene.device)
    slabs = [scene[:, i * hs:(i + 1) * hs] for i in range(n)]
    outs = [_slab_out(x, comp, factor, impl,
                      lambda top, bot, i=i: _thin_halo(slabs, i, top, bot))
            for i, x in enumerate(slabs)]
    return outs[0] if n == 1 else torch.cat(outs, dim=1)


def degrade_scene(
    scene: torch.Tensor,
    kernel: torch.Tensor,
    n_shards: int = 1,
    factor: int = 8,
    impl: str = "fast",
    mesh=None,
) -> torch.Tensor:
    """Shape-tolerant whole-scene degrade: [C, H, W] -> [C, H//f, W//f].

    Wraps `degrade_scene_sharded` for any scene size: H and W are cropped
    down to multiples of `factor` (a view: the kernel reads the cropped
    rows in place), then H is padded up to a multiple of n*factor (n =
    n_shards, or the mesh's size) with edge-replicated rows — exactly the
    rows the bottom replicate padding would synthesize — and the extra
    output rows are cropped off. With `mesh`, each rank degrades only its
    own slab (`rank_rows`, `scene_slab`) and the rows are all-gathered.
    """
    c, h, w = scene.shape
    h_keep, w_keep = (h // factor) * factor, (w // factor) * factor
    scene = scene[:, :h_keep, :w_keep]
    if mesh is not None:
        r0, r1, _ = rank_rows(h, factor, mesh)
        slab = scene_slab(lambda lo, hi: scene[:, lo:hi], r0, r1, h_keep)
        out = global_batch(mesh, degrade_slab_ranks(slab, kernel, mesh, factor, impl), dim=1)
        return out[:, : h_keep // factor]
    pad_rows = (-h_keep) % (n_shards * factor)
    if pad_rows:
        scene = torch.cat([scene, scene[:, -1:].expand(-1, pad_rows, -1)], dim=1)
    out = degrade_scene_sharded(scene, kernel, n_shards, factor, impl)
    return out[:, : h_keep // factor]
