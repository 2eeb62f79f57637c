"""Fleet kernel estimation: one KernelGAN per scene, all scenes in one run.

Counterpart of `kmsr_tpu.train.fleet`. The reference estimates one
degradation kernel PER SCENE by running `single_kernel/train.py:121-355`
once per scene. As in the JAX package, the S scenes' train states and
patch pools are stacked on a leading scene axis and one call of the
combined D+G step advances a chunk of m scenes, where JAX vmaps the step
(`single_kernel.make_scenes_step`: the scenes fold into the generator's
grouped convs and the discriminator's batched matmuls). `scene_chunk` = m
runs the scenes in S/m chunks, one after another (JAX's `_chunk_scenes`,
`lax.map` over vmapped chunks): chain-mode residuals at full width are
~3.4 GB a scene by JAX's estimate, and `pick_scene_chunk` keeps a chunk's
under 6 GiB. Compose fleets take m = S. Scene s trains with seed `cfg.seed + s` and equals a standalone
run at that seed: bit for bit at m = 1, to float32 reduction order at
m > 1 (JAX's own contract, `_chunk_scenes`).

Per-scene artifacts are those of the JAX package: under
`cfg.outdir/<scene_name>/` a `training_log.txt` (same CSV header),
`kernel_iter{N}.npy` (the band mean) / `kernel_per_band_iter{N}.npy`
dumps, and the final `kernel_per_band.npy` + `kernel_merged.npy`.

Draws: at K = 1 the host draws each scene's batch indices from
`np.random.default_rng(seed + s + start_iter)`, the HR indices then the
crop indices, as JAX's fleet does; random real crops, fake-side noise and
the K > 1 indices come from each scene's own `torch.Generator` (seeded
`seed + s`), not from `jax.random`. Checkpoints (`outdir/ckpt/step_N`)
are one torch.save file holding every scene's state, one blob a scene,
so a checkpoint written at one chunk width resumes at any other.

Scene parallelism (`mesh=`, `--scene-parallel` under torchrun): the
scenes are split over the mesh's ranks in contiguous blocks, as JAX's
`P("scene")` places the stacked scene axis, with no collectives in the
steps; each rank stacks its own scenes in chunks. Scene s keeps seed
`cfg.seed + s` whichever rank trains it. Each rank writes only its own
scenes' directories; a checkpoint gathers every scene's state to rank 0,
which writes the one file a one-process fleet would, and every rank
resumes its own scenes from it.
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
from ..utils.profiling import stage_timer
from .single_kernel import (
    _CHUNK_KEYS,
    _LOG_KEYS,
    LOG_HEADER,
    SingleKernelConfig,
    _format_rows,
    _to_device,
    init_training,
    make_scenes_step,
)
from .state import (
    GANTrainState,
    _trainable,
    batch_indices,
    check_scan_intervals,
    latest_checkpoint_step,
    load_checkpoint,
    save_checkpoint,
    state_blob,
    state_from_blob,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

_TREES = ("g_params", "d_params", "d_state", "g_opt_state", "d_opt_state")


def _stack_states(states: Sequence[GANTrainState]) -> GANTrainState:
    """Per-scene states (at one step) -> one state whose tensors carry the
    scenes on a leading axis, its parameters trainable, its rng the list of
    the scenes' generators."""
    if len({st.step for st in states}) != 1:
        raise ValueError("stacked scenes must be at one step")

    def stack(name):
        trees = [getattr(st, name) for st in states]
        return tree_unflatten(trees[0], [torch.stack(leaves) for leaves in
                                         zip(*(tree_leaves(t) for t in trees))])

    with torch.no_grad():
        out = GANTrainState(states[0].step, *(stack(n) for n in _TREES),
                            [st.rng for st in states])
    _trainable(out.g_params)
    _trainable(out.d_params)
    return out


def _unstack_state(state: GANTrainState) -> list[GANTrainState]:
    """`_stack_states`' inverse: each scene's state, its tensors copies."""
    out = []
    for s, rng in enumerate(state.rng):
        with torch.no_grad():
            st = GANTrainState(state.step, *(tree_map(lambda t: t[s].clone(), getattr(state, n))
                                             for n in _TREES), rng)
        _trainable(st.g_params)
        _trainable(st.d_params)
        out.append(st)
    return out


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
    """Largest divisor m of s_local whose m-scene stacked step keeps the
    estimated chain residuals under `budget_bytes` (min 1). Compose-mode
    fleets always fit — returns s_local there."""
    per_scene = _activation_bytes_per_scene(cfg, hr_size)
    for m in range(s_local, 0, -1):
        if s_local % m == 0 and m * per_scene <= budget_bytes:
            return m
    return 1


def make_fleet_step(cfg: SingleKernelConfig, scenes: int) -> Callable:
    """JAX's `make_fleet_step` for a chunk of m = `scenes` scenes (K = 1):
    step(state, pool, crop_pool, hr_idx, crop_idx) -> (state, metrics [m]).
    `state` is the chunk's stacked state, pool [m, N, C, H, W] its stacked
    HR pools, crop_pool the crop sources' (the native-LR pools under
    real_is_lr, else pool itself), the indices [m, B] drawn on the host:
    one gather each and one `make_scenes_step` call."""
    step = make_scenes_step(cfg, scenes)
    rows: dict = {}  # device -> [m, 1] scene index

    def fleet_step(state, pool, crop_pool, hr_idx, crop_idx):
        dev = pool.device
        with stage_timer("fleet.gather", item=state.step, scene_its=scenes):
            if dev not in rows:
                rows[dev] = torch.arange(scenes, device=dev)[:, None]
            hr, crops = pool[rows[dev], hr_idx], crop_pool[rows[dev], crop_idx]
        return step(state, hr, crops)

    return fleet_step


def make_fleet_chunk_step(cfg: SingleKernelConfig, scenes: int) -> Callable:
    """JAX's `make_fleet_chunk_step` for a chunk of m = `scenes` scenes (K >
    1): chunk(state, pool, crop_pool, sizes, crop_sizes) -> (state,
    `_CHUNK_KEYS` metrics [m, K, ...]), `make_fleet_step`'s arguments with
    the pools' sizes in place of indices. Each of the K steps draws each
    scene's HR indices in [0, sizes[s]), then its crop indices in
    [0, crop_sizes[s]), from the scene's generator, as JAX splits
    (k_hr, k_cr) per scene and step."""
    step = make_fleet_step(cfg, scenes)
    bs, k_steps = cfg.batch_size, cfg.steps_per_call

    def chunk(state, pool, crop_pool, sizes, crop_sizes):
        dev = pool.device
        rows, t0 = [], state.step
        for _ in range(k_steps):
            with stage_timer("fleet.draw", item=state.step):
                idx = [(batch_indices(g, n, bs, dev), batch_indices(g, nc, bs, dev))
                       for g, n, nc in zip(state.rng, sizes, crop_sizes)]
                hr_idx = torch.stack([h for h, _ in idx])
                crop_idx = torch.stack([c for _, c in idx])
            state, m = step(state, pool, crop_pool, hr_idx, crop_idx)
            rows.append(m)
        with stage_timer("fleet.collect", item=t0):
            out = {k: torch.stack([m[k] for m in rows], dim=1) for k in _CHUNK_KEYS}
        return state, out

    return chunk


def device_pools(pools: Sequence[PatchPool], lr_pools: Optional[Sequence[PatchPool]],
                 dev: torch.device) -> tuple:
    """(HR pools [S, N, C, H, W], crop sources, their sizes, the crop
    sources' sizes) on `dev`: each side's stacked pools (`_stack_pools`) go
    up in one copy; the crop source is the native-LR pools when lr_pools
    are given, else the HR pools."""
    stacked, sizes = _stack_pools(pools)
    pool_all = torch.from_numpy(stacked).to(dev)
    if lr_pools is None:
        return pool_all, pool_all, sizes, sizes
    lr_stacked, lr_sizes = _stack_pools(lr_pools)
    return pool_all, torch.from_numpy(lr_stacked).to(dev), sizes, lr_sizes


def make_fleet_advance(cfg: SingleKernelConfig, states: list, pool: torch.Tensor,
                       crop_pool: torch.Tensor, sizes: list, crop_sizes: list,
                       host_rngs: Optional[list]) -> Callable:
    """advance() -> each chunk's metrics: one fleet iteration (K of them
    for K > 1), one stacked step call a chunk (JAX's `_chunk_scenes`: the
    chunks run one after another). `states` are the chunks' stacked states
    (equal widths), updated in place; the pools and sizes are every local
    scene's, in order. K = 1: each scene's host RNG draws its HR indices,
    then its crop indices (a standalone run's draw order), and every
    scene's go up in one copy. Nothing waits for the device.

    Spans (`utils.profiling.stage_timer`, the step count as item), beside
    the step's `kernelgan.*`: `fleet.draw` (the index draws and, at K = 1,
    their upload), `fleet.gather` (the pool gather, counting
    `scene_its=m`), `fleet.collect` (K > 1: stacking the K rows of
    metrics)."""
    m = len(states[0].rng)
    chunks = [slice(c * m, (c + 1) * m) for c in range(len(states))]
    if cfg.steps_per_call > 1:
        chunk_fn = make_fleet_chunk_step(cfg, m)

        def advance_chunks():
            out = []
            for i, c in enumerate(chunks):
                states[i], ms = chunk_fn(states[i], pool[c], crop_pool[c], sizes[c],
                                         crop_sizes[c])
                out.append(ms)
            return out

        return advance_chunks
    step_fn = make_fleet_step(cfg, m)
    bs = cfg.batch_size

    def advance():
        with stage_timer("fleet.draw", item=states[0].step):
            idx = _to_device(np.stack([
                np.stack([r.integers(0, sizes[s], size=bs),
                          r.integers(0, crop_sizes[s], size=bs)])
                for s, r in enumerate(host_rngs)]), pool.device)  # [S, 2, B]
        out = []
        for i, c in enumerate(chunks):
            states[i], ms = step_fn(states[i], pool[c], crop_pool[c], idx[c, 0], idx[c, 1])
            out.append(ms)
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
    the host-RNG stream of a standalone K = 1 run.

    scene_chunk: the scenes each stacked step call advances (on each rank
    under a mesh); the chunks run one after another, which bounds
    chain-mode residuals by one chunk. It must divide the (per-rank) scene
    count; None = JAX's automatic choice (`pick_scene_chunk`): every scene
    in compose mode, the largest divisor under a ~6 GiB residual budget in
    chain mode. At 1 each scene's step is the standalone step, bit for bit;
    wider chunks agree to float32 reduction order.

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

    pool_dev, crop_dev, sizes, crop_sizes = device_pools(
        [pools[s] for s in own],
        None if lr_pools is None else [lr_pools[s] for s in own], dev)
    if scene_chunk is None:
        scene_chunk = pick_scene_chunk(cfg, s_local, pool_dev.shape[-1])
        if cfg.verbose and scene_chunk != s_local:
            print(f"[fleet] chain-mode residuals: dispatching "
                  f"{scene_chunk}/{s_local} scenes per chunk")
    elif s_local % scene_chunk:
        raise ValueError(
            f"scene_chunk {scene_chunk} must divide the per-device scene "
            f"count {s_local}"
        )
    m = scene_chunk
    chunks = [_stack_states(states[c:c + m]) for c in range(0, s_local, m)]
    del states
    # K = 1: per-scene host RNG streams identical to a standalone run at
    # seed+s (reseeded at the resume point, as JAX's are)
    host_rngs = None if k_steps > 1 else [
        np.random.default_rng(cfg.seed + s + start_iter) for s in own]
    advance = make_fleet_advance(cfg, chunks, pool_dev, crop_dev, sizes, crop_sizes,
                                 host_rngs)
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
            for c, ms in enumerate(advance()):
                for j in range(m):
                    s = c * m + j
                    if k_steps > 1:
                        log_rows[s].append((t + 2 - k_steps, {k: ms[k][j] for k in _LOG_KEYS}))
                        last[s] = {k: ms[k][j, -1] for k in _CHUNK_KEYS}
                    else:
                        log_rows[s].append((t + 1, {k: ms[k][j] for k in _LOG_KEYS}))
                        last[s] = {k: ms[k][j] for k in _CHUNK_KEYS}

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
                blobs = _gather_scenes(mesh, [state_blob(st) for c in chunks
                                              for st in _unstack_state(c)])
                if blobs is not None:
                    save_checkpoint(ckpt_dir, {"scenes": blobs}, t + 1)

    states = [st for c in chunks for st in _unstack_state(c)]
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
