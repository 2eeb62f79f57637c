"""The work each rank of a test world does (see `dist_world.run_world`),
and the same work in one process for the reference.

Every job builds its inputs from fixed seeds, so the ranks and the
one-process reference see the same global batches. Imports torch and the
port only (no jax): the ranks start fast.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from kmsr_tpu_torch.data.sampler import PatchPool
from kmsr_tpu_torch.models.discriminator import DiscriminatorConfig
from kmsr_tpu_torch.models.dynamic import DynamicConfig
from kmsr_tpu_torch.models.generator import GeneratorConfig
from kmsr_tpu_torch.models.moe import MoEConfig
from kmsr_tpu_torch.models.sr import SRConfig, init_sr
from kmsr_tpu_torch.parallel.mesh import data_parallel, make_mesh, shard_batch
from kmsr_tpu_torch.train import dynamic as tdyn
from kmsr_tpu_torch.train import moe as tmoe
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train import sr as tsr
from kmsr_tpu_torch.train.fleet import train_fleet
from kmsr_tpu_torch.train.state import tree_leaves

#: the trainers whose DP steps the tests hold to one device
KINDS = ("chain", "compose", "moe", "dynamic", "sr")
N_STEPS = 2
BATCH = 4
_D = DiscriminatorConfig(base_ch=8, num_blocks=2)


def _np(leaves) -> list:
    return [t.detach().cpu().numpy().copy() for t in leaves]


def _setup(kind: str, outdir: str):
    """(cfg, state, step(state, hr, crop) -> (state, metrics), hr pool,
    crop pool) of one trainer at a tiny size on the CPU."""
    rng = np.random.default_rng(3)
    if kind == "sr":
        cfg = tsr.SRTrainConfig(batch_size=BATCH, compute_dtype="float32", outdir=outdir,
                                model=SRConfig(width=8, n_blocks=2, factor=4))
        state = tsr.init_sr_training(cfg, "cpu")
        step, _ = tsr.make_sr_train_step(cfg)
        lr = rng.normal(3, 1, (8, 5, 8, 8)).astype(np.float32)
        hr = rng.normal(3, 1, (8, 5, 32, 32)).astype(np.float32)
        return cfg, state, step, lr, hr
    pool = rng.normal(5, 1, (8, 5, 32, 32)).astype(np.float32)
    if kind in ("chain", "compose"):
        noise = dict(fake_noise_sigma=(0.1, 0.2, 0.1, 0.3, 0.1)) if kind == "compose" else {}
        cfg = tsk.SingleKernelConfig(
            hr_patch_size=32, lr_crop_size=8, batch_size=BATCH, outdir=outdir,
            verbose=False, generator=GeneratorConfig(mid_ch=8, forward_mode=kind),
            discriminator=_D, device_pool=False, **noise)
        return cfg, tsk.init_training(cfg, "cpu"), tsk.make_base_step(cfg), pool, pool
    if kind == "moe":
        cfg = tmoe.MoETrainConfig(
            batch_size=BATCH, hr_patch_size=32, lr_crop_size=8, outdir=outdir,
            verbose=False, model=MoEConfig(n_kernels=4, factor=4), discriminator=_D,
            device_pool=False, balance_weight=0.5)
        base = tmoe.make_moe_base_step(cfg)
        return (cfg, tmoe.init_moe_training(cfg, device="cpu"),
                lambda st, hr, cr: base(st, hr, cr, 2.0), pool, pool)
    cfg = tdyn.DynamicTrainConfig(
        batch_size=BATCH, hr_patch_size=32, lr_crop_size=8, outdir=outdir,
        verbose=False, model=DynamicConfig(mid_ch=8, factor=4), discriminator=_D,
        device_pool=False)
    return (cfg, tdyn.init_dynamic_training(cfg, "cpu"), tdyn.make_dynamic_base_step(cfg),
            pool, pool)


def steps(kind: str, mesh, outdir: str) -> dict:
    """N_STEPS steps of one trainer on the global batches the host RNG
    draws (each rank keeping its rows under `mesh`): the logged losses,
    the gradients, the updated parameters, the BatchNorm running
    statistics (means, then variances) and (MoE) the selection counts."""
    cfg, state, step, hr_pool, crop_pool = _setup(kind, outdir)
    host = np.random.default_rng(0)
    out: dict = {"loss": [], "grads": [], "selection": [], "lr": cfg.lr_rate}
    with data_parallel(mesh):
        for _ in range(N_STEPS):
            hr = hr_pool[host.integers(0, len(hr_pool), BATCH)]
            crop = crop_pool[host.integers(0, len(crop_pool), BATCH)]
            if mesh is None:
                hr, crop = torch.from_numpy(hr), torch.from_numpy(crop)
            else:
                hr, crop = shard_batch(mesh, hr), shard_batch(mesh, crop)
            state, m = step(state, hr, crop)
            if kind == "sr":
                out["loss"].append([float(m["l1"])])
                out["grads"].append(_np(tree_leaves(m["grads"])))
            else:
                out["loss"].append([float(m["loss_D"]), float(m["loss_G_adv"])])
                # in the order of out["params"]
                out["grads"].append(_np(tree_leaves(m["grads_G"]) + tree_leaves(m["grads_D"])))
            if kind == "moe":
                out["selection"].append(m["selection"].numpy().copy())
    if kind == "sr":
        out["params"], out["bn"] = _np(tree_leaves(state.params)), []
    else:
        out["params"] = _np(tree_leaves(state.g_params) + tree_leaves(state.d_params))
        out["bn"] = _np([t for k in ("bn_mean", "bn_var")
                         for t in tree_leaves(_pick(state.d_state, k))])
    return out


def _pick(tree, key) -> list:
    """Every value under `key` in a nested dict (D's BatchNorm statistics,
    and the MoE selector's under d_state["moe"])."""
    if isinstance(tree, dict):
        return [v for k, v in tree.items() if k == key] + [
            _pick(v, key) for k, v in tree.items() if k != key]
    return []


# ------------------------------------------------------------------- fleet
N_SCENES = 4


def fleet_inputs():
    rng = np.random.default_rng(5)
    return [PatchPool(rng.normal(5, 1, (n, 5, 32, 32)).astype(np.float32))
            for n in (6, 5, 7, 6)]


def fleet_cfg(outdir: str) -> tsk.SingleKernelConfig:
    return tsk.SingleKernelConfig(
        iters=2, hr_patch_size=32, lr_crop_size=8, batch_size=BATCH, log_every=1,
        kernel_log_every=2, ckpt_every=2, outdir=outdir, verbose=False, discriminator=_D,
        generator=GeneratorConfig(mid_ch=8, forward_mode="compose"))


def fleet(mesh, outdir: str) -> dict:
    out = train_fleet(fleet_inputs(), fleet_cfg(outdir), mesh=mesh, progress=False,
                      device="cpu")
    return {"kernel_per_band": out["kernel_per_band"],
            "dirs": sorted(d for d in os.listdir(outdir) if d.startswith("scene_"))}


# --------------------------------------------------------------- sr_scene
def sr_scene(mesh) -> np.ndarray | None:
    from kmsr_tpu_torch.pipeline.sr_scene import sr_scene as run

    cfg = SRConfig(width=8, n_blocks=2, factor=4)
    params = init_sr(cfg, seed=1, device="cpu")
    scene = np.random.default_rng(6).normal(3, 1, (5, 40, 36)).astype(np.float32)
    scene[:, :3, :4] = np.nan
    return run(params, scene, cfg, tile=16, chunk=3, compute_dtype=torch.float32,
               device="cpu", mesh=mesh)


# ------------------------------------------------------------- the worlds
def train_world(rank: int, world: int, tmp: str, cli_args: list) -> dict:
    """Everything a rank of the DP-training test world does."""
    from kmsr_tpu_torch.pipeline import train_single_kernel_cli

    mesh = make_mesh(device="cpu")
    res = {k: steps(k, mesh, os.path.join(tmp, f"{k}_{rank}")) for k in KINDS}
    scene_mesh = make_mesh(axis_names=("scene",), device="cpu")
    res["fleet"] = fleet(scene_mesh, os.path.join(tmp, f"fleet_{rank}"))
    res["sr_scene"] = sr_scene(mesh)
    res["cli"] = train_single_kernel_cli.main(
        cli_args + ["--outdir", os.path.join(tmp, "cli"), "--data-parallel"])
    return res


def reference(tmp: str, cli_args: list) -> dict:
    """`train_world`'s work in this process, with no mesh."""
    from kmsr_tpu_torch.pipeline import train_single_kernel_cli

    res = {k: steps(k, None, os.path.join(tmp, f"ref_{k}")) for k in KINDS}
    res["fleet"] = fleet(None, os.path.join(tmp, "ref_fleet"))
    res["sr_scene"] = sr_scene(None)
    res["cli"] = train_single_kernel_cli.main(cli_args + ["--outdir", os.path.join(tmp, "ref_cli")])
    return res


# ----------------------------------------------------------- whole scene
#: (name, scene shape, kernel side, factor, impl, entry): the whole-scene
#: cases the 4-rank world runs; entry "sharded" is degrade_scene_sharded
#: (H divisible by 4 * factor), "scene" the shape-tolerant degrade_scene
SCENE_CASES = (
    ("small_kernel", (2, 96, 32), 5, 4, "fast", "sharded"),
    ("k13_f8", (5, 128, 64), 13, 8, "fast", "sharded"),
    ("bands", (2, 96, 32), 5, 4, "bands", "sharded"),
    ("nan_cells", (2, 96, 32), 5, 4, "fast", "sharded"),
    ("uneven", (2, 101, 37), 5, 4, "fast", "scene"),
    ("uneven_k13", (5, 203, 77), 13, 8, "fast", "scene"),
)


def scene_inputs(name: str, shape: tuple, k: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(sum(map(ord, name)))
    scene = rng.normal(5, 2, shape).astype(np.float32)
    if name == "nan_cells":
        scene[:, 30:37, 5:9] = np.nan
    return scene, rng.uniform(0, 1, (shape[0], k, k)).astype(np.float32)


def scene_world(rank: int, world: int, tmp: str) -> dict:
    """Every whole-scene case through the ranks path, and the scene stage
    (`process_scenes` with a mesh) on `tmp`/scenes."""
    from kmsr_tpu_torch.parallel import spatial
    from kmsr_tpu_torch.pipeline.degrade_scene import process_scenes

    mesh = make_mesh(device="cpu")
    out = {}
    for name, shape, k, f, impl, entry in SCENE_CASES:
        scene, kernel = (torch.from_numpy(a) for a in scene_inputs(name, shape, k))
        fn = spatial.degrade_scene_sharded if entry == "sharded" else spatial.degrade_scene
        out[name] = fn(scene, kernel, factor=f, impl=impl, mesh=mesh).numpy()
    rep = process_scenes(os.path.join(tmp, "scenes"), os.path.join(tmp, "k.npy"),
                         os.path.join(tmp, "out"), device="cpu", mesh=mesh)
    out["stage"] = (rep.n_ok, rep.n_fail)
    return out


def solo_world(rank: int, world: int, tmp: str) -> dict:
    """The trainers' steps in a world of one rank, where every collective
    runs, and the same steps with no mesh in the same process (the same
    thread count: CPU reductions round by it)."""
    mesh = make_mesh(device="cpu")
    assert mesh.group is not None
    return {(k, dp): steps(k, mesh if dp else None, os.path.join(tmp, f"{k}{dp}"))
            for k in KINDS for dp in (True, False)}
