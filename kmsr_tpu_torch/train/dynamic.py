"""Dynamic (content-conditioned) degradation-model training, on one device
or data-parallel.

Counterpart of `kmsr_tpu.train.dynamic`: Adam 1e-4 (betas (0.5, 0.999),
no clipping) for G (generator + noise estimator) and for D, LSGAN, the
4-term kernel regularizer on the batch-mean extracted kernels (detached,
so it adds to the loss but gives G no gradient: the reference's quirk),
the noise regularizer at weight 20 toward per-band targets; the CSV log
under `DYN_LOG_HEADER`, ASCII kernels under `visuals/` and
`batch_kernels_iter*.npy` every `kernel_log_every`, and the final
`final_results/kernel_per_band.npy` (unit scales, [C,13,13]) and
`kernel_merged.npy`; plus `bulk_extract_kernels` over a patch pool.

The D step and the G step see the SAME noise draw, as in the JAX step: the
degraded batch is generated once; D sees it detached, G backpropagates
through it against the freshly updated D.

Host batches come from `np.random.default_rng(seed + start_iter)` as in
the JAX package; the device draws (crops, noise, K > 1 batch indices) come
from a `torch.Generator` seeded with `seed`, not `jax.random`'s stream.

Data parallelism (`mesh=`, `--data-parallel`) follows
`train.single_kernel`: the same global host batch on every rank, each
keeping its rows; the crop offsets and the noise drawn at the global
batch's shape and sliced; D's BatchNorm statistics and the logged
batch-mean kernels taken over the global batch; the gradients averaged
over ranks. Rank 0 writes the log, the kernels and the checkpoints.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..analysis.kernel_metrics import ascii_kernel, kernel_metrics
from ..data.sampler import PatchPool
from ..device import deterministic, resolve_device
from ..losses import (
    lsgan_d_loss,
    lsgan_g_loss,
    noise_reg_loss,
    per_band_kernel_regularization,
)
from ..models.discriminator import (
    DiscriminatorConfig,
    discriminator_forward,
    init_discriminator,
)
from ..models.dynamic import (
    DynamicConfig,
    degradation_model_forward,
    extract_dynamic_kernels,
    init_degradation_model,
)
from ..ops.degrade import fp32_convs
from ..parallel.mesh import (
    batch_mean,
    data_parallel,
    mesh_device,
    metrics_mean,
    reduce_grads,
    replicate_state,
)
from .single_kernel import _format_rows, make_batch_source, random_crops
from .state import (
    GANTrainState,
    check_mesh_vs_scan,
    check_scan_intervals,
    init_gan_state,
    make_chunk_step,
    make_gan_optimizers,
    maybe_resume,
    save_checkpoint,
    tree_leaves,
    tree_unflatten,
)

TARGET_SIGMA = (0.55, 0.72, 0.83, 0.63, 0.19)

# The 4th logged metric is the NOISE regularizer, not a weighted kernel reg
DYN_LOG_HEADER = "Iteration,Loss_D,Loss_G_adv,Loss_Reg,Loss_Noise_Reg\n"
_DYN_LOG_KEYS = ("loss_D", "loss_G_adv", "loss_reg", "loss_noise_reg")
#: the metrics a K-step chunk stacks over its steps
_CHUNK_KEYS = _DYN_LOG_KEYS + ("sigma", "kernels")


@dataclasses.dataclass
class DynamicTrainConfig:
    iters: int = 3000
    batch_size: int = 8
    hr_patch_size: int = 256
    lr_crop_size: int = 32
    lr_rate: float = 1e-4
    noise_reg_weight: float = 20.0
    target_sigma: tuple = TARGET_SIGMA
    reg_weights: dict = dataclasses.field(
        default_factory=lambda: dict(alpha=0.5, beta=0.5, gamma=5.0, delta=1.0)
    )
    model: DynamicConfig = dataclasses.field(
        default_factory=lambda: DynamicConfig(noise_init=0.3, noise_max=1.2)
    )
    discriminator: DiscriminatorConfig = dataclasses.field(
        default_factory=DiscriminatorConfig
    )
    log_every: int = 100
    kernel_log_every: int = 100
    outdir: str = "output/dynamic_kernel"
    device_pool: Optional[bool] = None  # device-resident pool with device
    #   batch gathers; None = auto for pools <= 4 GB
    steps_per_call: int = 1  # >1: K steps per call, batch indices drawn on
    #   the device (requires device_pool; iters and intervals multiples of K)
    ckpt_every: int = 0  # 0 = no checkpoints
    resume: bool = False  # resume from the latest checkpoint in outdir/ckpt
    seed: int = 0
    verbose: bool = True


def make_dynamic_base_step(cfg: DynamicTrainConfig) -> Callable:
    """The combined D+G step: step(state, hr, crop_src) -> (state, metrics),
    updating `state` in place. Besides the JAX package's metrics,
    "grads_D" / "grads_G" hold the gradients in the parameters' layout."""
    g_tx = make_gan_optimizers(cfg.lr_rate, grad_clip_norm=None)
    d_tx = make_gan_optimizers(cfg.lr_rate, grad_clip_norm=None)
    targets: dict = {}  # device -> target sigma tensor, uploaded once

    def step(state: GANTrainState, hr: torch.Tensor, crop_src: torch.Tensor):
        with fp32_convs():  # the backward convs too
            return _step(state, hr, crop_src)

    def _step(state, hr, crop_src):
        g_params, d_params = state.g_params, state.d_params
        real = random_crops(state.rng, crop_src, cfg.lr_crop_size)
        _, fake, sigma = degradation_model_forward(g_params, hr, cfg.model, gen=state.rng)

        # ---- D step --------------------------------------------------------
        d_leaves = tree_leaves(d_params)
        pred_real, st = discriminator_forward(d_params, state.d_state, real, train=True)
        pred_fake, st = discriminator_forward(d_params, st, fake.detach(), train=True)
        loss_d = lsgan_d_loss(pred_real, pred_fake)
        d_grads = reduce_grads(torch.autograd.grad(loss_d, d_leaves))
        d_tx.step(d_params, list(d_grads), state.d_opt_state)

        # ---- G step: the same fake (same noise draw), the updated D ---------
        pred_fake, d_state = discriminator_forward(d_params, st, fake, train=True)
        adv = lsgan_g_loss(pred_fake)
        # detached batch mean: the global batch's under DP
        ks = batch_mean(extract_dynamic_kernels(g_params["generator"], hr, cfg.model))
        reg = per_band_kernel_regularization(ks, cfg.reg_weights, center_max=False)
        if hr.device not in targets:
            targets[hr.device] = torch.tensor(cfg.target_sigma, dtype=torch.float32,
                                              device=hr.device)
        nreg = noise_reg_loss(sigma, targets[hr.device])
        loss = adv + reg + cfg.noise_reg_weight * nreg
        g_leaves = tree_leaves(g_params)
        g_grads = reduce_grads([g if g is not None else torch.zeros_like(p) for g, p in zip(
            torch.autograd.grad(loss, g_leaves, allow_unused=True), g_leaves)])
        g_tx.step(g_params, g_grads, state.g_opt_state)

        state.step += 1
        state.d_state = d_state
        metrics = {
            "loss_D": loss_d.detach(),
            "loss_G_adv": adv.detach(),
            "loss_reg": reg.detach(),
            "loss_noise_reg": nreg.detach(),
            "sigma": sigma.detach(),
            "kernels": ks,  # [C, kH, kW], detached
            "grads_D": tree_unflatten(d_params, d_grads),
            "grads_G": tree_unflatten(g_params, g_grads),
        }
        return state, metrics_mean(metrics, ("loss_D", "loss_G_adv"))

    return step


def make_dynamic_train_step(cfg: DynamicTrainConfig, device_pool: bool = False) -> Callable:
    """step(state, hr, crop_src); with `device_pool=True`
    step(state, pool_dev, hr_idx, crop_idx); with steps_per_call K > 1 as
    well chunk(state, pool_dev), K steps with the indices drawn on the
    device."""
    step = make_dynamic_base_step(cfg)
    if device_pool and cfg.steps_per_call > 1:
        return make_chunk_step(step, cfg.batch_size, cfg.steps_per_call, _CHUNK_KEYS)
    if device_pool:

        def pool_step(state, pool_dev, hr_idx, crop_idx):
            return step(state, pool_dev[hr_idx], pool_dev[crop_idx])

        return pool_step
    return step


def init_dynamic_training(cfg: DynamicTrainConfig,
                          device: str | torch.device = "cuda") -> GANTrainState:
    """The initial train state on `device`: the degradation model and D
    drawn from `cfg.seed`, zeroed Adam moments, the device generator."""
    dev = resolve_device(device)
    g_params = init_degradation_model(cfg.model, seed=cfg.seed, device=dev)
    d_params, d_state = init_discriminator(cfg.discriminator, seed=cfg.seed, device=dev)
    tx = make_gan_optimizers(cfg.lr_rate, grad_clip_norm=None)
    rng = torch.Generator(device=dev).manual_seed(cfg.seed)
    return init_gan_state(rng, g_params, d_params, d_state, tx, tx)


def train_dynamic(
    pool: PatchPool,
    cfg: DynamicTrainConfig = DynamicTrainConfig(),
    progress: bool = True,
    device: str | torch.device = "cuda",
    mesh=None,
) -> dict:
    """Run the dynamic-model loop over a patch pool (mesh: optional 'data'
    mesh, module docstring; no device pool, K = 1); returns
    {"kernel_per_band": [C,13,13], "kernel_merged": [13,13], "state",
    "log_file"}. On a CUDA device the steps run under `device.deterministic`, so a
    run is reproducible (CUBLAS_WORKSPACE_CONFIG must be set before the
    process first uses cuBLAS; the training CLIs set it).
    """
    dev = mesh_device(device, mesh)
    main = mesh is None or mesh.is_main
    os.makedirs(cfg.outdir, exist_ok=True)
    visuals = os.path.join(cfg.outdir, "visuals")
    final_dir = os.path.join(cfg.outdir, "final_results")
    os.makedirs(visuals, exist_ok=True)
    os.makedirs(final_dir, exist_ok=True)
    log_file = os.path.join(cfg.outdir, "training_log.txt")

    check_mesh_vs_scan(cfg, mesh)
    use_device_pool = cfg.device_pool
    if use_device_pool is None:
        use_device_pool = (mesh is None and hasattr(pool, "patches")
                           and pool.patches.nbytes <= 4 << 30)
    K = cfg.steps_per_call
    check_scan_intervals(
        cfg,
        {"iters": cfg.iters, "log_every": cfg.log_every,
         "kernel_log_every": cfg.kernel_log_every,
         "ckpt_every": cfg.ckpt_every},
        use_device_pool,
    )
    step_fn = make_dynamic_train_step(cfg, use_device_pool)
    state = init_dynamic_training(cfg, dev)
    ckpt_dir = os.path.join(cfg.outdir, "ckpt")
    state, start_iter = maybe_resume(cfg, state, ckpt_dir,
                                     announce=cfg.verbose and main)
    if mesh is not None:
        replicate_state(mesh, state)
    if start_iter == 0 and main:
        with open(log_file, "w", encoding="utf-8") as f:
            f.write(DYN_LOG_HEADER)

    host_rng = np.random.default_rng(cfg.seed + start_iter)
    draw = make_batch_source(cfg, pool, None, use_device_pool, host_rng, dev, mesh)
    rows: list = []
    if K > 1:
        iterator = range(start_iter + K - 1, cfg.iters, K)
    else:
        iterator = range(start_iter, cfg.iters)
    if progress and main:
        try:
            from tqdm import tqdm

            iterator = tqdm(iterator, desc="Training dynamic", unit="chunk" if K > 1 else "iter")
        except ImportError:
            pass

    with deterministic(dev), data_parallel(mesh):
        for t in iterator:
            state, m = step_fn(state, *draw())
            if K > 1:
                rows.append((t + 2 - K, m))
                m = {k: m[k][-1] for k in _CHUNK_KEYS}
            else:
                rows.append((t + 1, {k: m[k] for k in _DYN_LOG_KEYS}))
            if (t + 1) % cfg.log_every == 0:
                if main:
                    with open(log_file, "a", encoding="utf-8") as f:
                        f.writelines(_format_rows(rows, keys=_DYN_LOG_KEYS))
                rows.clear()
            if (t + 1) % cfg.kernel_log_every == 0 and main:
                ks = m["kernels"].cpu().numpy()
                merged = ks.mean(axis=0)
                km = kernel_metrics(merged)
                with open(os.path.join(visuals, f"kernel_ascii_iter{t + 1}.txt"), "w") as f:
                    f.write(ascii_kernel(merged) + "\n")
                np.save(os.path.join(cfg.outdir, f"batch_kernels_iter{t + 1}.npy"), ks)
                if cfg.verbose:
                    print(f"  [iter {t + 1}] sigma={m['sigma'].cpu().numpy().round(3)} "
                          f"k_sum={km['k_sum']:.4f} center_off={km['center_offset']:.3f}")
            if cfg.ckpt_every and (t + 1) % cfg.ckpt_every == 0 and main:
                save_checkpoint(ckpt_dir, state, t + 1)
    if rows and main:
        with open(log_file, "a", encoding="utf-8") as f:
            f.writelines(_format_rows(rows, keys=_DYN_LOG_KEYS))

    ks_final = extract_dynamic_kernels(state.g_params["generator"], None,
                                       cfg.model).cpu().numpy()
    merged = ks_final.mean(axis=0)
    if main:
        np.save(os.path.join(final_dir, "kernel_per_band.npy"), ks_final)
        np.save(os.path.join(final_dir, "kernel_merged.npy"), merged)
    return {"kernel_per_band": ks_final, "kernel_merged": merged, "state": state,
            "log_file": log_file}


def bulk_extract_kernels(
    state_params: dict,
    pool: PatchPool,
    out_dir: str,
    cfg: DynamicConfig = DynamicConfig(),
    batch_size: int = 8,
) -> list[str]:
    """One per-patch kernel for every pool entry -> kernel_<stem>.npy (or
    kernel_<i:05d>.npy for a pool without sources), computed on the device
    of the parameters."""
    os.makedirs(out_dir, exist_ok=True)
    if not hasattr(pool, "patches"):
        raise ValueError(
            "bulk_extract_kernels needs an in-memory PatchPool (streaming "
            "pools expose sampling only, not positional iteration)"
        )
    dev = state_params["generator"]["layers"][0].device
    paths = []
    for start in range(0, len(pool), batch_size):
        batch = torch.from_numpy(pool.patches[start:start + batch_size]).to(dev)
        ks = extract_dynamic_kernels(state_params["generator"], batch, cfg,
                                     reduce_batch=False).cpu().numpy()
        for i, k in enumerate(ks):
            name = f"kernel_{start + i:05d}"
            if pool.sources:
                stem = os.path.splitext(os.path.basename(pool.sources[start + i]))[0]
                name = f"kernel_{stem}"
            p = os.path.join(out_dir, f"{name}.npy")
            np.save(p, k)
            paths.append(p)
    return paths
