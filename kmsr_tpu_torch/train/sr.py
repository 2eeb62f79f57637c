"""SR model training on (lr, hr) pairs, on one device or data-parallel.

Counterpart of `kmsr_tpu.train.sr`: L1 loss through the SR CNN (bfloat16
compute by default), optax's `adam(cosine_decay_schedule(lr, iters,
alpha=0.1))` (b1 0.9, b2 0.999, eps 1e-8, no clipping; the schedule
reads the count before its increment) as `train.state.ClippedAdam` with a
schedule, periodic PSNR/SSIM evaluation in float32, the CSV log
`Iteration,Loss_L1,Eval_PSNR,Eval_SSIM`, checkpoints and `sr_model.npz`.

Batches come from the host exactly as in the JAX package:
`np.random.default_rng(seed + start_iter)` draws each batch's indices
(`integers(0, N, batch_size)`), and an eval without a holdout draws its 8
samples from the same generator in the same order, so both packages train
on the same batches. With `holdout`, the last pairs are never sampled and
are the eval set. The pairs go to the device once when they take at most
4 GB (`device_pool=None`), and each batch is gathered there; otherwise
each batch is uploaded through pinned memory.

Checkpoints are this package's `torch.save` files (`OUTDIR/ckpt/step_N`);
JAX's orbax directories are refused. `sr_model.npz` is written in the JAX
package's layout (`utils.params_io`) and either package loads it.

Data parallelism (`mesh=`, `--data-parallel` under torchrun): every rank
draws the same batch indices and keeps its contiguous rows of the batch,
the L1 loss is each rank's mean and the gradients are averaged over ranks
(the L1 mean has no cross-sample term, so this is the global batch's
gradient); the logged loss is the global batch's. The pairs stay on the
host, as in JAX's mesh run. Rank 0 writes the log, the checkpoints and
`sr_model.npz`.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..device import deterministic
from ..models.sr import SRConfig, init_sr, precision, require_edsr, sr_forward
from ..ops.metrics import psnr, ssim
from ..parallel.mesh import (
    data_parallel,
    mesh_device,
    metrics_mean,
    reduce_grads,
    replicate_state,
    shard_batch,
)
from ..utils.params_io import save_params
from .state import (ClippedAdam, _trainable, maybe_resume, save_checkpoint, tree_leaves,
                    tree_unflatten)

LOG_HEADER = "Iteration,Loss_L1,Eval_PSNR,Eval_SSIM\n"


@dataclasses.dataclass
class SRTrainConfig:
    iters: int = 20_000
    batch_size: int = 32
    lr_rate: float = 2e-4
    model: SRConfig = dataclasses.field(default_factory=SRConfig)
    compute_dtype: str = "bfloat16"
    log_every: int = 100
    eval_every: int = 1000
    ckpt_every: int = 0      # checkpoint interval (0 = off)
    resume: bool = False     # resume from the latest checkpoint in outdir/ckpt
    outdir: str = "output/sr"
    device_pool: Optional[bool] = None  # keep (lr, hr) pairs on the device
    #   and gather batches there; auto for datasets <= 4 GB
    seed: int = 0
    holdout: int = 0         # pairs held out (from the END of the array)
    #   for eval: never sampled in training, so the logged PSNR/SSIM is a
    #   true validation number, not a train-set echo


@dataclasses.dataclass
class SRTrainState:
    step: int
    params: Any
    opt_state: dict


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.1) -> Callable:
    """optax.cosine_decay_schedule: init_value * ((1 - alpha) * 0.5 * (1 +
    cos(pi * min(t, decay_steps) / decay_steps)) + alpha)."""

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps))
                             + alpha)

    return schedule


def make_optimizer(cfg: SRTrainConfig) -> ClippedAdam:
    """optax.adam(cosine_decay_schedule(lr_rate, iters, alpha=0.1))."""
    return ClippedAdam(lr=cosine_decay(cfg.lr_rate, cfg.iters, alpha=0.1),
                       b1=0.9, b2=0.999, max_norm=None)


def _dtype(cfg: SRTrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def make_sr_train_step(cfg: SRTrainConfig) -> tuple[Callable, ClippedAdam]:
    """(step, tx): step(state, lr_batch, hr_batch) -> (state, {"l1": loss,
    "grads": the gradients in the parameters' layout}), updating `state`
    in place. Nothing in a step waits for the device. The EDSR only
    (ValueError for another network)."""
    require_edsr(cfg.model, "SR training")
    tx = make_optimizer(cfg)
    dtype = _dtype(cfg)

    def step(state: SRTrainState, lr_batch: torch.Tensor, hr_batch: torch.Tensor):
        leaves = tree_leaves(state.params)
        with precision(dtype):  # the backward's convs and matmuls too
            pred = sr_forward(state.params, lr_batch, cfg.model, compute_dtype=dtype)
            loss = (pred - hr_batch).abs().mean()
            grads = reduce_grads(torch.autograd.grad(loss, leaves))
        tx.step(state.params, grads, state.opt_state)
        state.step += 1
        return state, metrics_mean(
            {"l1": loss.detach(), "grads": tree_unflatten(state.params, grads)}, ("l1",))

    return step, tx


def init_sr_training(cfg: SRTrainConfig, device: str | torch.device = "cuda") -> SRTrainState:
    """The initial state on `device`: `init_sr(cfg.model, seed=cfg.seed)`
    and Adam's zero moments."""
    require_edsr(cfg.model, "SR training")
    params = _trainable(init_sr(cfg.model, seed=cfg.seed, device=device))
    return SRTrainState(0, params, make_optimizer(cfg).init(params))


@torch.no_grad()
def evaluate_sr(params: dict, lr_batch: np.ndarray, hr_batch: np.ndarray,
                cfg: SRConfig = SRConfig()) -> dict:
    """Mean PSNR / SSIM of a float32 forward over a batch; the data range
    is nanmax - nanmin over the whole hr batch (1.0 if that is 0)."""
    dev = tree_leaves(params)[0].device
    pred = sr_forward(params, torch.from_numpy(np.asarray(lr_batch, np.float32)).to(dev),
                      cfg, compute_dtype=torch.float32)
    rng_range = float(np.nanmax(hr_batch) - np.nanmin(hr_batch)) or 1.0
    hr = torch.from_numpy(np.asarray(hr_batch, np.float32)).to(dev)
    ps = psnr(pred, hr, rng_range).tolist()
    ss = ssim(pred, hr, rng_range).tolist()
    return {"psnr": float(np.mean(ps)), "ssim": float(np.mean(ss))}


def train_sr(
    pairs: tuple[np.ndarray, np.ndarray],
    cfg: SRTrainConfig = SRTrainConfig(),
    mesh=None,
    progress: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """pairs: (lr [N,C,h,w], hr [N,C,H,W]) arrays. mesh: an optional
    'data' mesh (module docstring); cfg.batch_size is the global batch.

    Writes `<outdir>/training_log.csv` with one row per log_every iters
    (iter, l1) and the PSNR/SSIM columns filled on eval_every iters; with
    cfg.holdout > 0 the eval set is a held-out tail of the pairs, never
    trained on. Returns {"state", "log": [(iter, l1)], "model_path",
    "final_eval", "csv_path"}. On a CUDA device the steps run under `device.deterministic`, so a
    run is reproducible (CUBLAS_WORKSPACE_CONFIG must be set before the
    process first uses cuBLAS; the training CLIs set it).
    """
    require_edsr(cfg.model, "SR training")
    lr_all, hr_all = pairs
    if lr_all.shape[0] != hr_all.shape[0]:
        raise ValueError(f"{lr_all.shape[0]} lr vs {hr_all.shape[0]} hr arrays")
    if mesh is not None and cfg.device_pool:
        raise ValueError(
            "mesh data-parallelism shards host-sampled batches and is "
            "incompatible with device_pool (it pins the pool to ONE device)"
        )
    dev = mesh_device(device, mesh)
    main = mesh is None or mesh.is_main
    lr_val = hr_val = None
    if cfg.holdout:
        if cfg.holdout >= lr_all.shape[0]:
            raise ValueError(
                f"holdout {cfg.holdout} >= dataset size {lr_all.shape[0]}"
            )
        lr_val, hr_val = lr_all[-cfg.holdout:], hr_all[-cfg.holdout:]
        lr_all, hr_all = lr_all[: -cfg.holdout], hr_all[: -cfg.holdout]
    os.makedirs(cfg.outdir, exist_ok=True)
    step_fn, _ = make_sr_train_step(cfg)
    state = init_sr_training(cfg, dev)
    ckpt_dir = os.path.join(cfg.outdir, "ckpt")
    state, start_iter = maybe_resume(cfg, state, ckpt_dir, announce=progress and main)
    if mesh is not None:
        replicate_state(mesh, state)

    host_rng = np.random.default_rng(cfg.seed + start_iter)
    log = []
    iterator = range(start_iter, cfg.iters)
    if progress and main:
        try:
            from tqdm import tqdm

            iterator = tqdm(iterator, desc="Training SR", unit="iter")
        except ImportError:
            pass
    use_device_pool = cfg.device_pool
    if use_device_pool is None:
        use_device_pool = mesh is None and lr_all.nbytes + hr_all.nbytes <= 4 << 30
    pinned = dev.type == "cuda"
    if use_device_pool:
        lr_dev = torch.from_numpy(np.ascontiguousarray(lr_all, np.float32)).to(dev)
        hr_dev = torch.from_numpy(np.ascontiguousarray(hr_all, np.float32)).to(dev)

    def batch(idx: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        if mesh is not None:
            return shard_batch(mesh, lr_all[idx]), shard_batch(mesh, hr_all[idx])
        if use_device_pool:
            i = torch.from_numpy(idx)
            i = i.pin_memory().to(dev, non_blocking=True) if pinned else i
            return lr_dev[i], hr_dev[i]
        out = []
        for a in (lr_all, hr_all):
            host = torch.empty((len(idx), *a.shape[1:]), dtype=torch.float32,
                               pin_memory=pinned)
            np.take(a, idx, axis=0, out=host.numpy())
            out.append(host.to(dev, non_blocking=True))
        return out[0], out[1]

    csv_path = os.path.join(cfg.outdir, "training_log.csv")
    fresh = not (cfg.resume and start_iter)
    csv_f = (open(csv_path, "w" if fresh else "a", encoding="utf-8") if main
             else open(os.devnull, "w", encoding="utf-8"))
    last_eval: dict = {}

    def eval_now(t):
        if lr_val is not None:
            lr_e, hr_e = lr_val, hr_val
        else:
            i = host_rng.integers(0, lr_all.shape[0], min(8, lr_all.shape[0]))
            lr_e, hr_e = lr_all[i], hr_all[i]
        ev = evaluate_sr(state.params, lr_e, hr_e, cfg.model)
        if progress and main:
            tag = "holdout" if lr_val is not None else "train-sample"
            print(f"  [eval iter {t}] {tag} psnr={ev['psnr']:.2f} "
                  f"ssim={ev['ssim']:.4f}")
        return ev

    with deterministic(dev), data_parallel(mesh):
        try:
            if fresh:
                csv_f.write(LOG_HEADER)
            for t in iterator:
                idx = host_rng.integers(0, lr_all.shape[0], cfg.batch_size)
                state, m = step_fn(state, *batch(idx))
                is_eval = (t + 1) % cfg.eval_every == 0
                if is_eval:
                    last_eval = eval_now(t + 1)
                if (t + 1) % cfg.log_every == 0 or is_eval:
                    l1 = float(m["l1"])
                    log.append((t + 1, l1))
                    csv_f.write(
                        f"{t + 1},{l1:.6f},"
                        + (f"{last_eval['psnr']:.4f},{last_eval['ssim']:.6f}\n"
                           if is_eval else ",\n")
                    )
                    csv_f.flush()
                if cfg.ckpt_every and (t + 1) % cfg.ckpt_every == 0 and main:
                    save_checkpoint(ckpt_dir, state, t + 1)
            final_eval = eval_now(cfg.iters) if lr_val is not None else last_eval
        finally:
            csv_f.close()
    model_path = os.path.join(cfg.outdir, "sr_model.npz")
    if main:
        save_params(model_path, state.params)
    return {"state": state, "log": log, "model_path": model_path,
            "final_eval": final_eval, "csv_path": csv_path}
