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
kernel; one slab per torch.distributed rank is ROADMAP.md queue 1 item 7.

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
import torch.nn.functional as F

from ..ops.degrade import compose_with_box, depthwise_conv2d, normalize_kernel
from ..ops.degrade_scene_fast import degrade_rows_fast, halo_rows


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


def _halo_exchange(
    slabs: list[torch.Tensor], idx: int, top: int, bot: int
) -> torch.Tensor:
    """Slab `idx` as [C, top + Hs + bot, W] with its halo rows (the
    'bands' path; one slab-sized concat)."""
    top_rows, bot_rows = _thin_halo(slabs, idx, top, bot)
    return torch.cat([top_rows, slabs[idx], bot_rows], dim=1)


def degrade_scene_sharded(
    scene: torch.Tensor,
    kernel: torch.Tensor,
    n_shards: int = 1,
    factor: int = 8,
    impl: str = "fast",
) -> torch.Tensor:
    """scene: [C, H, W] float32 (H divisible by n_shards*factor, W by
    factor) -> [C, H/f, W/f], in `n_shards` row slabs with halo rows.
    kernel: [C, kh, kw] or [kh, kw] (normalized per band inside).
    impl: 'fast' | 'bands' ('tiles' is an alias of 'fast')."""
    c, h, w = scene.shape
    n = n_shards
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    if h % (n * factor) != 0:
        raise ValueError(f"H={h} must divide n_shards*factor={n * factor}")
    if w % factor != 0:
        raise ValueError(f"W={w} must be a multiple of factor={factor}")
    kernel = kernel.to(device=scene.device, dtype=torch.float32)
    if kernel.ndim == 2:
        kernel = kernel[None].expand(c, *kernel.shape)
    kernel = normalize_kernel(kernel)
    kh, kw = kernel.shape[-2:]
    comp = compose_with_box(kernel, factor).contiguous()  # [C, kh+f-1, kw+f-1]
    ksize = comp.shape[-1]

    if impl == "tiles":  # removed JAX local path, kept as an alias
        impl = "fast"
    if impl not in ("fast", "bands"):
        raise ValueError(f"impl must be fast|bands, got {impl!r}")
    hs = h // n
    slabs = [scene[:, i * hs:(i + 1) * hs] for i in range(n)]
    outs = []
    for i, x in enumerate(slabs):
        if impl == "fast":
            top, bot = halo_rows(factor, ksize)
            top_rows, bot_rows = _thin_halo(slabs, i, max(top, 1), max(bot, 1))
            outs.append(degrade_rows_fast(x, comp, factor, top_rows, bot_rows))
        else:
            halo = kh // 2
            x_ext = _halo_exchange(slabs, i, halo, halo)
            x_ext = F.pad(x_ext[None], (kw // 2, kw // 2, 0, 0), mode="replicate")
            outs.append(depthwise_conv2d(x_ext, comp, stride=factor)[0])
    return outs[0] if n == 1 else torch.cat(outs, dim=1)


def degrade_scene(
    scene: torch.Tensor,
    kernel: torch.Tensor,
    n_shards: int = 1,
    factor: int = 8,
    impl: str = "fast",
) -> torch.Tensor:
    """Shape-tolerant whole-scene degrade: [C, H, W] -> [C, H//f, W//f].

    Wraps `degrade_scene_sharded` for any scene size: H and W are cropped
    down to multiples of `factor` (a view: the kernel reads the cropped
    rows in place), then H is padded up to a multiple of n_shards*factor
    with edge-replicated rows — exactly the rows the bottom replicate
    padding would synthesize — and the extra output rows are cropped off.
    """
    c, h, w = scene.shape
    h_keep, w_keep = (h // factor) * factor, (w // factor) * factor
    scene = scene[:, :h_keep, :w_keep]
    pad_rows = (-h_keep) % (n_shards * factor)
    if pad_rows:
        scene = torch.cat([scene, scene[:, -1:].expand(-1, pad_rows, -1)], dim=1)
    out = degrade_scene_sharded(scene, kernel, n_shards, factor, impl)
    return out[:, : h_keep // factor]
