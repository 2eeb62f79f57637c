"""Fleet kernel estimation: one KernelGAN per scene, all scenes in one run.

Counterpart of `kmsr_tpu.train.fleet`. The reference estimates one
degradation kernel PER SCENE by running `single_kernel/train.py:121-355`
once per scene; the JAX package stacks the S scenes' states and vmaps the
combined D+G step over the scene axis. Here each iteration runs each
scene's `make_base_step` on its own state, scene after scene, on one CUDA
stream: nothing waits for the host between scenes, and only one scene's
chain-mode residuals are alive at a time. That is what JAX computes with
`scene_chunk = 1` (`lax.map` over one-scene chunks), so scene s equals a
standalone run at seed `cfg.seed + s`.

Per-scene artifacts are those of the JAX package: under
`cfg.outdir/<scene_name>/` a `training_log.txt` (same CSV header),
`kernel_iter{N}.npy` (the band mean) / `kernel_per_band_iter{N}.npy`
dumps, and the final `kernel_per_band.npy` + `kernel_merged.npy`.

Draws: at K = 1 the host draws each scene's batch indices from
`np.random.default_rng(seed + s + start_iter)`, the HR indices then the
crop indices, as JAX's fleet does; random real crops, fake-side noise and
the K > 1 indices come from each scene's own `torch.Generator` (seeded
`seed + s`), not from `jax.random`. Checkpoints (`outdir/ckpt/step_N`)
are one torch.save file holding every scene's state.

Scene parallelism (`mesh=`, `--scene-parallel` under torchrun): the
scenes are split over the mesh's ranks in contiguous blocks, as JAX's
`P("scene")` places the stacked scene axis, with no collectives in the
steps. Scene s keeps seed `cfg.seed + s` whichever rank trains it, so each
scene equals its one-process run. Each rank writes only its own scenes'
directories; a checkpoint gathers every scene's state to rank 0, which
writes the one file a one-process fleet would, and every rank resumes its
own scenes from it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.sampler import PatchPool
from ..device import deterministic
from ..models.generator import extract_kernels
from ..parallel.mesh import mesh_device
from ..parallel.multihost import global_batch
from .single_kernel import (
    _CHUNK_KEYS,
    _LOG_KEYS,
    LOG_HEADER,
    SingleKernelConfig,
    _format_rows,
    _to_device,
    init_training,
    make_base_step,
)
from .state import (
    batch_indices,
    check_scan_intervals,
    latest_checkpoint_step,
    load_checkpoint,
    save_checkpoint,
    state_blob,
    state_from_blob,
    tree_map,
)


def _stack_pools(pools: Sequence[PatchPool]) -> tuple[np.ndarray, list[int]]:
    """[S] pools -> ([S, N_max, C, H, W] array, per-scene sizes).

    Pools may differ in size; shorter pools are cycle-padded to N_max.
    Padding rows are NEVER sampled (indices are drawn in [0, n_s) per
    scene), so the padding content is irrelevant — cycling just keeps
    the array NaN-free for the pool's own gate.
    """
    shapes = {p.patches.shape[1:] for p in pools}
    if len(shapes) != 1:
        raise ValueError(f"pools must share the patch shape, got {shapes}")
    sizes = [len(p) for p in pools]
    n_max = max(sizes)
    stacked = np.empty((len(pools), n_max) + pools[0].patches.shape[1:],
                       np.float32)
    for s, p in enumerate(pools):
        stacked[s, : sizes[s]] = p.patches
        for j in range(sizes[s], n_max):
            stacked[s, j] = p.patches[j % sizes[s]]
    return stacked, sizes


def _activation_bytes_per_scene(cfg: SingleKernelConfig, hr_size: int) -> int:
    """Rough residual footprint of ONE scene's chain-mode G step: the
    inputs of every conv layer are saved for the backward pass (f32).
    Compose mode stores only the 5-band input — negligible."""
    g = cfg.generator
    if g.forward_mode != "chain":
        return 4 * cfg.batch_size * g.in_ch * hr_size**2
    chans = g.in_ch  # layer-0 input: the raw bands
    for out_c, _in_c in g.layer_channels[:-1]:
        chans += g.in_ch * out_c  # grouped-conv activations, all bands
    return 4 * cfg.batch_size * chans * hr_size**2


def pick_scene_chunk(cfg: SingleKernelConfig, s_local: int, hr_size: int,
                     budget_bytes: int = 6 << 30) -> int:
    """Largest divisor m of s_local whose m-scene chunk keeps the
    estimated chain residuals under `budget_bytes` (min 1). Compose-mode
    fleets always fit — returns s_local there. (The JAX package's chunk
    size; the port runs one scene at a time whatever it is.)"""
    per_scene = _activation_bytes_per_scene(cfg, hr_size)
    for m in range(s_local, 0, -1):
        if s_local % m == 0 and m * per_scene <= budget_bytes:
            return m
    return 1


def make_fleet_chunk_step(cfg: SingleKernelConfig) -> Callable:
    """One scene's K-step chunk: chunk(state, pool_dev, crop_dev) ->
    (state, metrics), `_CHUNK_KEYS` stacked over the K steps. Each step
    draws its HR indices from the scene's HR pool, then its crop indices
    from `crop_dev` (the scene's native-LR pool under real_is_lr, else the
    HR pool), both from the scene's generator, as JAX's
    `make_fleet_chunk_step` splits (k_hr, k_cr) per step; pass the HR pool
    twice for the non-real_is_lr fleet."""
    base = make_base_step(cfg)
    bs, k_steps = cfg.batch_size, cfg.steps_per_call

    def chunk(state, pool_dev: torch.Tensor, crop_dev: torch.Tensor):
        rows = []
        for _ in range(k_steps):
            hr_idx = batch_indices(state.rng, pool_dev.shape[0], bs, pool_dev.device)
            cr_idx = batch_indices(state.rng, crop_dev.shape[0], bs, crop_dev.device)
            state, m = base(state, pool_dev[hr_idx], crop_dev[cr_idx])
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows]) for k in _CHUNK_KEYS}

    return chunk


def device_pools(pools: Sequence[PatchPool], lr_pools: Optional[Sequence[PatchPool]],
                 dev: torch.device) -> tuple[list, list]:
    """(each scene's HR pool, each scene's crop source) on `dev`: the
    stacked pools go up in one copy (`_stack_pools`) and scene s reads its
    own rows, its crop source being its native-LR pool when lr_pools are
    given, else its HR pool."""
    stacked, sizes = _stack_pools(pools)
    pool_all = torch.from_numpy(stacked).to(dev)
    hr = [pool_all[s, :n] for s, n in enumerate(sizes)]
    if lr_pools is None:
        return hr, hr
    lr_stacked, lr_sizes = _stack_pools(lr_pools)
    lr_all = torch.from_numpy(lr_stacked).to(dev)
    return hr, [lr_all[s, :n] for s, n in enumerate(lr_sizes)]


def make_fleet_advance(cfg: SingleKernelConfig, states: list, pools_dev: list,
                       crop_dev: list, host_rngs: Optional[list]) -> Callable:
    """advance() -> each scene's metrics: one call of the fleet loop, which
    updates `states` in place. K > 1: each scene's K-step chunk
    (`make_fleet_chunk_step`), `_CHUNK_KEYS` stacked over the steps. K = 1:
    each scene's host RNG draws its HR indices, then its crop indices (the
    draw order of a standalone run), every scene's go up in one copy, and
    each scene runs `make_base_step` on its own gathers. Scenes run one
    after another on one stream; nothing waits for the device.

    This takes the place of JAX's `make_fleet_step` (the vmapped K = 1
    step, shard_mapped over a scene mesh) and of its vmapped
    `make_fleet_chunk_step` call: under a mesh, `states` are this rank's
    scenes only."""
    n = len(states)
    if cfg.steps_per_call > 1:
        chunk_fn = make_fleet_chunk_step(cfg)

        def advance_chunks():
            out = []
            for s in range(n):
                states[s], ms = chunk_fn(states[s], pools_dev[s], crop_dev[s])
                out.append(ms)
            return out

        return advance_chunks
    step_fn = make_base_step(cfg)
    dev = pools_dev[0].device

    def advance():
        idx = np.stack([
            np.stack([r.integers(0, pools_dev[s].shape[0], size=cfg.batch_size),
                      r.integers(0, crop_dev[s].shape[0], size=cfg.batch_size)])
            for s, r in enumerate(host_rngs)])
        idx_dev = _to_device(idx, dev)
        out = []
        for s in range(n):
            states[s], m = step_fn(states[s], pools_dev[s][idx_dev[s, 0]],
                                   crop_dev[s][idx_dev[s, 1]])
            out.append(m)
        return out

    return advance


def _world_size() -> int:
    """Processes of the launch: torch.distributed's group when one is
    initialized, else torchrun's WORLD_SIZE, else 1."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def train_fleet(
    pools: Sequence[PatchPool],
    cfg: SingleKernelConfig = SingleKernelConfig(),
    scene_names: Optional[Sequence[str]] = None,
    mesh=None,
    progress: bool = True,
    scene_chunk: Optional[int] = None,
    lr_pools: Optional[Sequence[PatchPool]] = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Train one KernelGAN per pool, all in one run.

    pools: one PatchPool per scene (HR patches, same [C, H, W] shape).
    cfg: shared hyper-parameters; scene s uses seed `cfg.seed + s` and
    writes artifacts under `cfg.outdir/<scene_names[s]>/`.
    cfg.steps_per_call = K > 1 runs K steps per scene per call with the
    indices drawn on the device from the scene's generator; K = 1 keeps
    the host-RNG stream of a standalone K = 1 run. scene_chunk: JAX's
    scenes per vmapped chunk; it must divide the scene count (None: the
    JAX package's automatic choice, `pick_scene_chunk`) and does not change
    the port's values: the port runs one scene at a time.

    lr_pools (with cfg.real_is_lr): one pool of native-LR patches per
    scene, at cfg.lr_crop_size: each scene's D sees its own LR pool.

    mesh: an optional 1-axis mesh (`parallel.mesh.make_mesh(axis_names=
    ("scene",))`): the scene axis is split over its ranks (len(pools) must
    be a multiple of the mesh size; no collectives in the steps; composes
    with either K). A multi-process launch without a mesh is refused.

    Returns {"scene_names", "kernel_per_band" [S,C,kH,kW],
    "kernel_merged" [S,kH,kW], "state" (the per-scene GANTrainStates),
    "log_files"}. On a CUDA device the steps run under `device.deterministic`, so a
    run is reproducible (CUBLAS_WORKSPACE_CONFIG must be set before the
    process first uses cuBLAS; the training CLIs set it).
    """
    if mesh is None and _world_size() > 1:
        raise ValueError(
            "train_fleet in a multi-process launch needs mesh= "
            "(--scene-parallel): without it every process would train "
            "every scene")
    dev = mesh_device(device, mesh)
    s_total = len(pools)
    if s_total == 0:
        raise ValueError("train_fleet needs at least one pool")
    if mesh is not None and s_total % mesh.size:
        raise ValueError(
            f"{s_total} scenes not divisible over {mesh.size} devices")
    s_local = s_total if mesh is None else s_total // mesh.size
    lo = 0 if mesh is None else mesh.rank * s_local
    own = range(lo, lo + s_local)  # this rank's scenes
    if cfg.real_is_lr:
        if lr_pools is None:
            raise ValueError(
                "real_is_lr=True needs lr_pools (one pool of native-LR "
                f"patches per scene at lr_crop_size={cfg.lr_crop_size})"
            )
        if len(lr_pools) != s_total:
            raise ValueError(
                f"lr_pools has {len(lr_pools)} pools for {s_total} scenes"
            )
        if lr_pools[0].patches.shape[-1] != cfg.lr_crop_size:
            raise ValueError(
                f"real_is_lr=True needs lr_pools patches at lr_crop_size="
                f"{cfg.lr_crop_size}, got {lr_pools[0].patches.shape[-1]}"
            )
    elif lr_pools is not None:
        raise ValueError("lr_pools given but cfg.real_is_lr is False")
    k_steps = cfg.steps_per_call
    if k_steps > 1:
        check_scan_intervals(
            cfg,
            {"iters": cfg.iters, "log_every": cfg.log_every,
             "kernel_log_every": cfg.kernel_log_every,
             "ckpt_every": cfg.ckpt_every},
            use_device_pool=True,  # the fleet's pools are always on the device
        )
    names = list(scene_names) if scene_names else [
        f"scene_{s:03d}" for s in range(s_total)
    ]
    if len(names) != s_total or len(set(names)) != s_total:
        raise ValueError("scene_names must be unique, one per pool")
    outdirs = [os.path.join(cfg.outdir, names[s]) for s in own]
    for d in outdirs:
        os.makedirs(d, exist_ok=True)

    states = [init_training(dataclasses.replace(cfg, seed=cfg.seed + s), dev)
              for s in own]

    ckpt_dir = os.path.join(cfg.outdir, "ckpt")
    start_iter = 0
    if cfg.resume and (step := latest_checkpoint_step(ckpt_dir)) is not None:
        blobs = load_checkpoint(ckpt_dir, step, dev)["scenes"]
        if len(blobs) != s_total:
            raise ValueError(f"checkpoint step {step} holds {len(blobs)} scenes, "
                             f"this fleet has {s_total}")
        states = [state_from_blob(blobs[s], st) for s, st in zip(own, states)]
        start_iter = step
        if cfg.verbose:
            print(f"resumed from checkpoint step {step}")
    if k_steps > 1 and start_iter % k_steps:
        raise ValueError(f"resume step {start_iter} not a multiple of K={k_steps}")

    pools_dev, crop_dev = device_pools(
        [pools[s] for s in own],
        None if lr_pools is None else [lr_pools[s] for s in own], dev)
    if scene_chunk is None:
        scene_chunk = pick_scene_chunk(cfg, s_local, pools_dev[0].shape[-1])
    elif s_local % scene_chunk:
        raise ValueError(
            f"scene_chunk {scene_chunk} must divide the per-device scene "
            f"count {s_local}"
        )
    # K = 1: per-scene host RNG streams identical to a standalone run at
    # seed+s (reseeded at the resume point, as JAX's are)
    host_rngs = None if k_steps > 1 else [
        np.random.default_rng(cfg.seed + s + start_iter) for s in own]
    advance = make_fleet_advance(cfg, states, pools_dev, crop_dev, host_rngs)
    log_files = [os.path.join(d, "training_log.txt") for d in outdirs]
    if start_iter == 0:
        for f in log_files:
            with open(f, "w", encoding="utf-8") as fh:
                fh.write(LOG_HEADER)

    log_rows: list[list] = [[] for _ in own]

    def flush():
        for f, rows in zip(log_files, log_rows):
            if rows:
                with open(f, "a", encoding="utf-8") as fh:
                    fh.writelines(_format_rows(rows))
                rows.clear()

    if k_steps > 1:
        # t iterates over the LAST iteration index of each K-step chunk
        iterator = range(start_iter + k_steps - 1, cfg.iters, k_steps)
    else:
        iterator = range(start_iter, cfg.iters)
    if progress:
        try:
            from tqdm import tqdm

            iterator = tqdm(iterator, desc=f"Fleet[{s_total}]",
                            unit="chunk" if k_steps > 1 else "iter")
        except ImportError:
            pass

    last: list = [None] * s_local  # each scene's metrics at its latest step
    with deterministic(dev):
        for t in iterator:
            for s, m in enumerate(advance()):
                if k_steps > 1:
                    log_rows[s].append((t + 2 - k_steps, m))
                    last[s] = {k: m[k][-1] for k in _CHUNK_KEYS}
                else:
                    log_rows[s].append((t + 1, {k: m[k] for k in _LOG_KEYS}))
                    last[s] = m

            if (t + 1) % cfg.log_every == 0:
                flush()
                if progress and hasattr(iterator, "set_postfix"):
                    iterator.set_postfix(
                        D=f"{float(torch.stack([m['loss_D'] for m in last]).mean()):.4f}",
                        G=f"{float(torch.stack([m['loss_G_adv'] for m in last]).mean()):.4f}",
                    )

            if cfg.save_intermediate and (t + 1) % cfg.kernel_log_every == 0:
                ks = torch.stack([m["kernels"] for m in last]).cpu().numpy()  # [S,C,kH,kW]
                for s, d in enumerate(outdirs):
                    np.save(os.path.join(d, f"kernel_iter{t + 1}.npy"),
                            ks[s].mean(axis=0))
                    np.save(os.path.join(d, f"kernel_per_band_iter{t + 1}.npy"),
                            ks[s])

            if cfg.ckpt_every and (t + 1) % cfg.ckpt_every == 0:
                blobs = _gather_scenes(mesh, [state_blob(st) for st in states])
                if blobs is not None:
                    save_checkpoint(ckpt_dir, {"scenes": blobs}, t + 1)

    flush()
    ks_local = torch.stack([extract_kernels(st.g_params).detach()
                            for st in states])  # [S_local, C, kH, kW]
    merged_local = ks_local.cpu().numpy().mean(axis=1)
    for s, d in enumerate(outdirs):
        np.save(os.path.join(d, "kernel_per_band.npy"), ks_local[s].cpu().numpy())
        np.save(os.path.join(d, "kernel_merged.npy"), merged_local[s])
    ks_final = (ks_local if mesh is None else global_batch(mesh, ks_local)).cpu().numpy()
    return {
        "scene_names": names,
        "kernel_per_band": ks_final,  # [S, C, kH, kW], every rank's scenes
        "kernel_merged": ks_final.mean(axis=1),
        "state": states,  # this rank's scenes
        "log_files": [os.path.join(cfg.outdir, n, "training_log.txt") for n in names],
    }


def _gather_scenes(mesh, blobs: list) -> Optional[list]:
    """Every rank's scene blobs, in scene order, on rank 0 (None on the
    other ranks); the blobs as they are without a mesh."""
    if mesh is None or mesh.group is None:
        return blobs
    host = [tree_map(lambda t: t.cpu(), b) for b in blobs]
    parts = [None] * mesh.size if mesh.is_main else None
    torch.distributed.gather_object(
        host, parts, dst=torch.distributed.get_global_rank(mesh.group, 0),
        group=mesh.group)
    return [b for p in parts for b in p] if mesh.is_main else None
