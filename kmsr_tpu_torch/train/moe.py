"""Mixture-of-kernels (MoE bank) training on one device.

Counterpart of `kmsr_tpu.train.moe`: Adam 1e-4 (betas (0.5, 0.999), no
clipping) for the model (selector + banks) and for D, the Gumbel
temperature annealed linearly from temp_start to temp_end over the run,
LSGAN, and G regularized by the 4-term kernel regularizer on the MEAN of
the bank's effective kernels (differentiable: the bank is parameterized
directly). Artifacts: `kernel_{i}.npy` [C,13,13] (bands sum to 1),
`sigma_{i}.npy` [C], `moe_model.npz` and `moe_state.npz` in the JAX
package's `.npz` layout (`utils.params_io`), which either package loads.

Each iteration is a D step, then a G step, with two separate Gumbel and
noise draws, as in the JAX step. The D step's forward runs the selector
in train mode too, but its BatchNorm update is discarded: only the G
step's is kept, so the running stats move once an iteration. D's own
BatchNorm state threads from the D step into the G step.

Host batches come from `np.random.default_rng(seed + start_iter)` exactly
as in the JAX package (`hr`, then `crop_src`); the device draws (crops,
Gumbel uniforms, noise, K > 1 batch indices) come from a `torch.Generator`
seeded with `seed`, a different stream from `jax.random`'s by design.
Checkpoints are this package's `torch.save` files. Data-parallel training
(the JAX `mesh=`) is not ported.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..data.sampler import PatchPool
from ..device import resolve_device
from ..losses import (
    load_balance_loss,
    lsgan_d_loss,
    lsgan_g_loss,
    per_band_kernel_regularization,
)
from ..models.discriminator import (
    DiscriminatorConfig,
    discriminator_forward,
    init_discriminator,
)
from ..models.moe import (
    MoEConfig,
    effective_kernels,
    effective_sigmas,
    init_moe,
    moe_forward,
)
from ..ops.degrade import fp32_convs
from ..utils.params_io import load_params, save_params
from .single_kernel import make_batch_source, random_crops
from .state import (
    GANTrainState,
    check_scan_intervals,
    init_gan_state,
    make_chunk_step,
    make_gan_optimizers,
    maybe_resume,
    save_checkpoint,
    tree_leaves,
    tree_unflatten,
)

#: the metrics a K-step chunk stacks over its steps
_CHUNK_KEYS = ("loss_D", "loss_G_adv", "loss_reg", "loss_balance", "selection")


@dataclasses.dataclass
class MoETrainConfig:
    iters: int = 5000
    batch_size: int = 8
    hr_patch_size: int = 256
    lr_crop_size: int = 64          # 256 / 4 (::4 decimation)
    lr_rate: float = 1e-4
    temp_start: float = 5.0
    temp_end: float = 0.5
    reg_weights: dict = dataclasses.field(
        default_factory=lambda: dict(alpha=0.5, beta=0.5, gamma=5.0, delta=1.0)
    )
    balance_weight: float = 0.0  # >0: add the Switch-style load-balance aux
    #   loss (`losses.load_balance_loss`) to the G objective (opt-in; the
    #   reference has no such term)
    model: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    discriminator: DiscriminatorConfig = dataclasses.field(
        default_factory=DiscriminatorConfig
    )
    log_every: int = 100
    outdir: str = "output/moe_kernels_run"
    device_pool: Optional[bool] = None  # device-resident pool with device
    #   batch gathers; None = auto for pools <= 4 GB
    steps_per_call: int = 1  # >1: K steps per call, batch indices drawn on
    #   the device; the temperature schedule rides the chunk as per-step
    #   inputs (requires device_pool; iters and intervals multiples of K)
    ckpt_every: int = 0  # 0 = no checkpoints
    resume: bool = False  # resume from the latest checkpoint in outdir/ckpt
    seed: int = 0
    verbose: bool = True


def make_moe_base_step(cfg: MoETrainConfig) -> Callable:
    """The combined D+G step: step(state, hr, crop_src, temp) -> (state,
    metrics), updating `state` in place. Besides the JAX package's metrics,
    "grads_D" / "grads_G" hold the gradients in the parameters' layout."""
    g_tx = make_gan_optimizers(cfg.lr_rate, grad_clip_norm=None)
    d_tx = make_gan_optimizers(cfg.lr_rate, grad_clip_norm=None)

    def step(state: GANTrainState, hr: torch.Tensor, crop_src: torch.Tensor, temp):
        # the backward convs too (TF32 is cuDNN's default)
        with fp32_convs():
            return _step(state, hr, crop_src, float(temp))

    def _step(state, hr, crop_src, temp):
        real = random_crops(state.rng, crop_src, cfg.lr_crop_size)
        moe_params, moe_state = state.g_params, state.d_state["moe"]
        d_params = state.d_params

        # ---- D step (G forward without gradients, its own Gumbel draw; the
        # selector's BN update of this forward is discarded) ---------------
        with torch.no_grad():
            fake, _, _, _ = moe_forward(moe_params, moe_state, hr, temp, train=True,
                                        cfg=cfg.model, gen=state.rng)
        d_leaves = tree_leaves(d_params)
        pred_real, st = discriminator_forward(d_params, state.d_state["disc"], real,
                                              train=True)
        pred_fake, st = discriminator_forward(d_params, st, fake, train=True)
        loss_d = lsgan_d_loss(pred_real, pred_fake)
        d_grads = torch.autograd.grad(loss_d, d_leaves)
        d_tx.step(d_params, list(d_grads), state.d_opt_state)

        # ---- G step (selector + banks), against the updated D -------------
        fake_g, weights, kernels, new_moe_state = moe_forward(
            moe_params, moe_state, hr, temp, train=True, cfg=cfg.model, gen=state.rng)
        pred_fake, disc_state = discriminator_forward(d_params, st, fake_g, train=True)
        adv = lsgan_g_loss(pred_fake)
        reg = per_band_kernel_regularization(kernels.mean(dim=0), cfg.reg_weights,
                                             center_max=False)
        bal = load_balance_loss(weights)
        total = adv + reg + cfg.balance_weight * bal
        g_leaves = tree_leaves(moe_params)
        g_grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(
            torch.autograd.grad(total, g_leaves, allow_unused=True), g_leaves)]
        g_tx.step(moe_params, g_grads, state.g_opt_state)

        state.step += 1
        state.d_state = {"disc": disc_state, "moe": new_moe_state}
        selection = torch.bincount(weights.detach().argmax(dim=1),
                                   minlength=cfg.model.n_kernels).to(torch.float32)
        metrics = {
            "loss_D": loss_d.detach(),
            "loss_G_adv": adv.detach(),
            "loss_reg": reg.detach(),
            "loss_balance": bal.detach(),
            "selection": selection,
            "grads_D": tree_unflatten(d_params, d_grads),
            "grads_G": tree_unflatten(moe_params, g_grads),
        }
        return state, metrics

    return step


def make_moe_train_step(cfg: MoETrainConfig, device_pool: bool = False) -> Callable:
    """step(state, hr, crop_src, temp); with `device_pool=True`
    step(state, pool_dev, hr_idx, crop_idx, temp); with steps_per_call
    K > 1 as well chunk(state, pool_dev, temps), len(temps) steps with the
    indices drawn on the device."""
    step = make_moe_base_step(cfg)
    if device_pool and cfg.steps_per_call > 1:
        return make_chunk_step(step, cfg.batch_size, cfg.steps_per_call, _CHUNK_KEYS,
                               scan_xs=True)
    if device_pool:

        def pool_step(state, pool_dev, hr_idx, crop_idx, temp):
            return step(state, pool_dev[hr_idx], pool_dev[crop_idx], temp)

        return pool_step
    return step


def init_moe_training(
    cfg: MoETrainConfig, init_from: str | None = None,
    device: str | torch.device = "cuda",
) -> GANTrainState:
    """The initial train state on `device`. `init_from` warm-starts the
    selector + banks from a checkpoint: the reference's torch
    `moe_model.pth`, or an `.npz` as `save_moe_artifacts` writes it (either
    package's), with the selector's BN running stats from a sibling
    `moe_state.npz` when there is one."""
    dev = resolve_device(device)
    moe_params, moe_state = init_moe(cfg.model, seed=cfg.seed, device=dev)
    if init_from:
        if init_from.endswith(".pth"):
            from ..utils.torch_import import load_moe_torch_checkpoint

            moe_params, moe_state = load_moe_torch_checkpoint(init_from, cfg.model,
                                                              device=dev)
        else:
            moe_params = load_params(init_from, moe_params, dev)
            state_path = os.path.join(os.path.dirname(init_from), "moe_state.npz")
            if os.path.exists(state_path):
                moe_state = load_params(state_path, moe_state, dev)
    d_params, disc_state = init_discriminator(cfg.discriminator, seed=cfg.seed, device=dev)
    tx = make_gan_optimizers(cfg.lr_rate, grad_clip_norm=None)
    rng = torch.Generator(device=dev).manual_seed(cfg.seed)
    return init_gan_state(rng, moe_params, d_params,
                          {"disc": disc_state, "moe": moe_state}, tx, tx)


def save_moe_artifacts(
    params: dict, out_dir: str, model_state: dict | None = None
) -> list[str]:
    """kernel_{i}.npy + sigma_{i}.npy + moe_model.npz (the state-dict
    analog); model_state (the selector's BN running stats) adds
    moe_state.npz, so eval-mode selection downstream (the factory's
    content-adaptive mode) does not depend on the batch."""
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        kernels = effective_kernels(params).cpu().numpy()
        sigmas = effective_sigmas(params).cpu().numpy()
    paths = []
    for i in range(kernels.shape[0]):
        kp = os.path.join(out_dir, f"kernel_{i}.npy")
        sp = os.path.join(out_dir, f"sigma_{i}.npy")
        np.save(kp, kernels[i])
        np.save(sp, sigmas[i])
        paths += [kp, sp]
    model_path = os.path.join(out_dir, "moe_model.npz")
    save_params(model_path, params)  # reloadable via train --init-from
    paths.append(model_path)
    if model_state is not None:
        state_path = os.path.join(out_dir, "moe_state.npz")
        save_params(state_path, model_state)
        paths.append(state_path)
    return paths


def train_moe(
    pool: PatchPool,
    cfg: MoETrainConfig = MoETrainConfig(),
    progress: bool = True,
    init_from: str | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Run the MoE loop over a patch pool; returns {"state", "artifacts",
    "history": [(iteration, loss_D, selection counts)] at each log}."""
    dev = resolve_device(device)
    os.makedirs(cfg.outdir, exist_ok=True)
    use_device_pool = cfg.device_pool
    if use_device_pool is None:
        use_device_pool = hasattr(pool, "patches") and pool.patches.nbytes <= 4 << 30
    K = cfg.steps_per_call
    check_scan_intervals(
        cfg,
        {"iters": cfg.iters, "log_every": cfg.log_every,
         "ckpt_every": cfg.ckpt_every},
        use_device_pool,
    )
    step_fn = make_moe_train_step(cfg, device_pool=use_device_pool)
    state = init_moe_training(cfg, init_from=init_from, device=dev)
    ckpt_dir = os.path.join(cfg.outdir, "ckpt")
    state, start_iter = maybe_resume(cfg, state, ckpt_dir, announce=cfg.verbose)

    temps = np.linspace(cfg.temp_start, cfg.temp_end, cfg.iters).astype(np.float32)
    host_rng = np.random.default_rng(cfg.seed + start_iter)
    draw = make_batch_source(cfg, pool, None, use_device_pool, host_rng, dev)
    if K > 1:
        iterator = range(start_iter + K - 1, cfg.iters, K)
    else:
        iterator = range(start_iter, cfg.iters)
    if progress:
        try:
            from tqdm import tqdm

            iterator = tqdm(iterator, desc="Training MoE", unit="chunk" if K > 1 else "iter")
        except ImportError:
            pass

    history = []
    for t in iterator:
        if K > 1:
            state, ms = step_fn(state, *draw(), temps[t + 1 - K: t + 1])
            m = {k: ms[k][-1] for k in _CHUNK_KEYS}
        else:
            state, m = step_fn(state, *draw(), temps[t])
        if (t + 1) % cfg.log_every == 0:
            sel = m["selection"].cpu().numpy().astype(int)
            loss_d = float(m["loss_D"])
            history.append((t + 1, loss_d, sel))
            if cfg.verbose:
                print(f"Iter {t + 1} | Temp {temps[t]:.2f} | D {loss_d:.3f} "
                      f"| Selection {sel}")
        if cfg.ckpt_every and (t + 1) % cfg.ckpt_every == 0:
            save_checkpoint(ckpt_dir, state, t + 1)

    artifacts = save_moe_artifacts(state.g_params, cfg.outdir,
                                   model_state=state.d_state["moe"])
    return {"state": state, "artifacts": artifacts, "history": history}
