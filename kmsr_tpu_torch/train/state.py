"""Train state, the GAN optimizer, torch checkpoints and shared trainer plumbing.

Counterpart of `kmsr_tpu.train.state`. Parameters, optimizer state and
the discriminator's mutable state are nested dicts / lists of tensors in
the JAX package's layouts; the optimizer updates parameters in place.

Checkpoints are `torch.save` files (`OUTDIR/ckpt/step_N`) of the whole
state: step, both parameter sets, D state, both optimizer states and the
device generator's RNG state. They replace the JAX package's orbax
checkpoints, and neither package reads the other's.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Callable, Optional

import torch

from ..parallel.gan_sharding import sharded_axis
from ..parallel.mesh import model_mesh, reduce_from_model


# ------------------------------------------------------------------ pytrees
def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict / list, in insertion order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [leaf for v in tree for leaf in tree_leaves(v)]


def tree_map(fn: Callable, tree):
    """`tree` with every tensor leaf replaced by fn(leaf)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_unflatten(template, leaves) -> Any:
    """`leaves` (in `tree_leaves` order) arranged as `template`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


# ---------------------------------------------------------------- optimizer
def global_norm(tensors: list[torch.Tensor], sharded: Optional[list[bool]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm).

    Under a model mesh, the tensors flagged in `sharded` are this rank's
    slices of their leaves: a slice's norm becomes its leaf's, sqrt of the
    squared norms summed over 'model' (at m = 1 exactly the slice's norm),
    and a replicated tensor counts once."""
    norms = torch._foreach_norm(tensors)
    if sharded is not None and any(sharded):
        idx = [i for i, s in enumerate(sharded) if s]
        part = torch.stack([norms[i] for i in idx])
        full = torch.sqrt(reduce_from_model(part * part))
        norms = list(norms)
        for k, i in enumerate(idx):
            norms[i] = full[k]
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass(frozen=True)
class ClippedAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr, b1, b2, eps)),
    written out so each step matches optax's arithmetic:

    * clipping is `t / g_norm * max_norm` when g_norm >= max_norm, with no
      epsilon (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6);
    * mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, update
      -lr * (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps).

    `lr` is a number or a schedule: a callable of the count before this
    step's increment, as optax calls a schedule (the SR trainer's cosine
    decay). The count lives on the host (the step count is known there),
    so a step never waits for the device.
    """

    lr: float | Callable[[int], float]
    b1: float = 0.5
    b2: float = 0.999
    eps: float = 1e-8
    max_norm: Optional[float] = 20.0

    def init(self, params) -> dict:
        leaves = tree_leaves(params)
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def step(self, params, grads: list[torch.Tensor], opt_state: dict) -> torch.Tensor:
        """Update `params` and `opt_state` in place from `grads` (in
        `tree_leaves(params)` order); returns the global norm of the
        gradients before clipping, as a device scalar. Under a model mesh,
        the global norm is the full leaves' (`global_norm`)."""
        sharded = None
        if model_mesh() is not None:
            sharded = [sharded_axis(p) is not None for p in tree_leaves(params)]
        g_norm = global_norm(grads, sharded)
        if self.max_norm is not None:
            scaled = torch._foreach_div(grads, g_norm)
            torch._foreach_mul_(scaled, self.max_norm)
            keep = g_norm < self.max_norm
            grads = [torch.where(keep, g, s) for g, s in zip(grads, scaled)]
        lr = self.lr(opt_state["count"]) if callable(self.lr) else self.lr
        count = opt_state["count"] + 1
        mu, nu = opt_state["mu"], opt_state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                   1 - self.b2))
        denom = torch._foreach_div(nu, 1 - self.b2**count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1 - self.b1**count)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(tree_leaves(params), upd)
        opt_state["count"] = count
        return g_norm


def make_gan_optimizers(
    lr: float = 4e-4,
    betas: tuple[float, float] = (0.5, 0.999),
    grad_clip_norm: Optional[float] = 20.0,
) -> ClippedAdam:
    """Adam(lr, betas) preceded by global-norm clipping (the reference's
    Adam(4e-4, (0.5, 0.999)) with clip_grad_norm_(20))."""
    return ClippedAdam(lr=lr, b1=betas[0], b2=betas[1], max_norm=grad_clip_norm)


# -------------------------------------------------------------- train state
@dataclasses.dataclass
class GANTrainState:
    """Everything a GAN training step threads through iterations. `rng` is
    the device generator of the step's random draws (crops, fake noise,
    K > 1 batch indices)."""

    step: int
    g_params: Any
    d_params: Any
    d_state: Any          # spectral-norm u vectors + batchnorm stats
    g_opt_state: Any
    d_opt_state: Any
    rng: torch.Generator


def _trainable(params):
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def init_gan_state(
    rng: torch.Generator,
    g_params: Any,
    d_params: Any,
    d_state: Any,
    g_tx: ClippedAdam,
    d_tx: ClippedAdam,
) -> GANTrainState:
    return GANTrainState(
        step=0,
        g_params=_trainable(g_params),
        d_params=_trainable(d_params),
        d_state=d_state,
        g_opt_state=g_tx.init(g_params),
        d_opt_state=d_tx.init(d_params),
        rng=rng,
    )


# ------------------------------------------------------------ checkpointing
def state_blob(state) -> dict:
    """A state dataclass as a dict torch.load(weights_only=True) can read
    back: its fields, the generator as its RNG state."""
    blob = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    if "rng" in blob:
        blob["rng"] = state.rng.get_state()
    return blob


def _param_trees(template) -> list[str]:
    """The fields of a state dataclass that hold parameters (named *params)."""
    return [f.name for f in dataclasses.fields(template) if f.name.endswith("params")]


def _device_of(template) -> torch.device:
    return tree_leaves(getattr(template, _param_trees(template)[0]))[0].device


def state_from_blob(blob: dict, template):
    """`state_blob`'s inverse, on the device of `template`'s parameters;
    its parameter trees (the fields named *params) require grad."""
    dev = _device_of(template)
    blob = dict(blob)
    if "rng" in blob:
        rng = torch.Generator(device=dev)
        rng.set_state(blob["rng"].cpu())
        blob["rng"] = rng
    state = type(template)(**blob)
    for n in _param_trees(template):
        _trainable(getattr(state, n))
    return state


def save_checkpoint(ckpt_dir: str, state, step: int) -> None:
    """torch.save the whole state (a dataclass: `GANTrainState`, the SR
    trainer's state; or any `state_blob`-made object, the fleet's list of
    them) to `ckpt_dir/step_N` (atomically)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    blob = state_blob(state) if dataclasses.is_dataclass(state) else state
    path = os.path.join(ckpt_dir, f"step_{step}")
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_checkpoint(ckpt_dir: str, step: int, device: torch.device):
    """The object saved at `step`, its tensors on `device`."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?); "
            "this package reads only its own torch.save checkpoints")
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(ckpt_dir: str, step: int, template):
    """The state saved at `step`, on the device of `template`'s parameters;
    its parameter trees (the fields named *params) require grad."""
    return state_from_blob(load_checkpoint(ckpt_dir, step, _device_of(template)), template)


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", name))]
    return max(steps) if steps else None


# -------------------------------------------------- shared trainer plumbing
def batch_indices(gen: torch.Generator, n_pool: int, batch_size: int,
                  device: torch.device) -> torch.Tensor:
    """One batch of pool indices drawn on the device (a K-step chunk draws
    the HR batch's, then the real-crop batch's)."""
    return torch.randint(0, n_pool, (batch_size,), generator=gen, device=device)


def make_chunk_step(step: Callable, batch_size: int, steps_per_call: int,
                    stacked_keys: tuple, scan_xs: bool = False) -> Callable:
    """K train steps in one Python call: each draws its HR and real-crop
    batch indices on the device from the state's generator and gathers
    them from the device-resident pool, so nothing in the chunk waits for
    the host (the JAX package's lax.scan). Returns chunk(state, pool_dev)
    -> (state, metrics), `stacked_keys` of the metrics stacked over the K
    steps, the rest the last step's. With scan_xs the chunk takes one more
    argument, a sequence of per-step inputs (the MoE temperature
    schedule): chunk(state, pool_dev, xs) runs len(xs) steps and passes
    xs[i] to step i as its last argument."""

    def chunk_step(state: GANTrainState, pool_dev: torch.Tensor, *xs):
        n_pool = pool_dev.shape[0]
        rows = []
        for x in (xs[0] if scan_xs else range(steps_per_call)):
            hr_idx, cr_idx = (batch_indices(state.rng, n_pool, batch_size, pool_dev.device)
                              for _ in range(2))
            state, m = step(state, pool_dev[hr_idx], pool_dev[cr_idx],
                            *((x,) if scan_xs else ()))
            rows.append(m)
        metrics = dict(rows[-1])
        metrics.update({k: torch.stack([m[k] for m in rows]) for k in stacked_keys})
        return state, metrics

    return chunk_step


def check_mesh_vs_scan(cfg, mesh) -> None:
    """Mesh data parallelism shards host-sampled batches; the device-pool
    / chunking knobs keep sampling on ONE device."""
    if mesh is not None and (cfg.device_pool or cfg.steps_per_call > 1):
        raise ValueError(
            "mesh data-parallelism shards host-sampled batches and is "
            "incompatible with device_pool / steps_per_call > 1 (those keep "
            "sampling on ONE device); drop --data-parallel or the scan knobs"
        )


def check_scan_intervals(cfg, intervals: dict, use_device_pool: bool) -> None:
    """steps_per_call=K>1 requires the device pool and every logging /
    checkpoint interval to be a K-multiple (they fire at chunk ends)."""
    k = cfg.steps_per_call
    if k <= 1:
        return
    if not use_device_pool:
        raise ValueError("steps_per_call > 1 requires device_pool")
    for name, v in intervals.items():
        if v % k:
            raise ValueError(f"{name}={v} must be a multiple of steps_per_call={k}")


def maybe_resume(cfg, state, ckpt_dir: str, announce: bool = False):
    """Restore the latest checkpoint when cfg.resume; returns
    (state, start_iter). Validates K-alignment of the resume point."""
    start_iter = 0
    if cfg.resume:
        last = latest_checkpoint_step(ckpt_dir)
        if last is not None:
            state = restore_checkpoint(ckpt_dir, last, state)
            start_iter = last
            if announce:
                print(f"resumed from checkpoint step {last}")
    k = getattr(cfg, "steps_per_call", 1)
    if k > 1 and start_iter % k:
        raise ValueError(f"resume step {start_iter} not a multiple of K={k}")
    return state, start_iter
