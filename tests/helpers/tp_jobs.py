"""The work each rank of the tensor-parallel test world does (see
`dist_world.run_world`): one KernelGAN step on a (data, model) mesh from
the same initial state and batch as the one-process reference.

Imports torch and the port only (no jax): the ranks start fast.
"""
from __future__ import annotations

import numpy as np
import torch

from kmsr_tpu_torch.models.discriminator import DiscriminatorConfig
from kmsr_tpu_torch.models.generator import GeneratorConfig
from kmsr_tpu_torch.parallel.gan_sharding import shard_state, state_shardings
from kmsr_tpu_torch.parallel.mesh import data_parallel, make_mesh, shard_batch
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train import state as tstate

#: the metrics a case returns
METRICS = ("loss_D", "loss_G_adv", "loss_reg", "grad_norm_D", "grad_norm_G")


def config(mode: str, batch: int = 8) -> tsk.SingleKernelConfig:
    """`tests/test_train_single.py::tiny_cfg` (G mid_ch 8, D 8x2, HR 64, LR
    8) at batch 8, as JAX's TP test, with native-LR real patches (the step
    makes no random draw)."""
    return tsk.SingleKernelConfig(
        iters=1, hr_patch_size=64, lr_crop_size=8, batch_size=batch, log_every=2,
        kernel_log_every=2, verbose=False, real_is_lr=True,
        generator=GeneratorConfig(mid_ch=8, forward_mode=mode),
        discriminator=DiscriminatorConfig(base_ch=8, num_blocks=2))


def tensor_tree(tree):
    """A nested dict / list of arrays as float32 tensors."""
    if isinstance(tree, dict):
        return {k: tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tensor_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))


def initial_state(cfg, init: dict) -> tstate.GANTrainState:
    """The train state from `init` ({"g", "d", "ds"}: the parameters and D
    state in the port's layout, as numpy) with fresh Adam moments."""
    tx = tstate.make_gan_optimizers(cfg.lr_rate, grad_clip_norm=cfg.grad_clip_norm)
    return tstate.init_gan_state(torch.Generator().manual_seed(cfg.seed), tensor_tree(init["g"]),
                                 tensor_tree(init["d"]), tensor_tree(init["ds"]), tx, tx)


def numpy_tree(tree):
    """A nested dict / list of tensors as numpy copies."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def step_result(state, metrics) -> dict:
    """A step's parameters, D state, logged metrics and kernels, as numpy."""
    return {"g": numpy_tree(state.g_params), "d": numpy_tree(state.d_params),
            "ds": numpy_tree(state.d_state),
            "metrics": {k: float(metrics[k]) for k in METRICS},
            "kernels": metrics["kernels"].numpy().copy()}


def tp_world(rank: int, world: int, init: dict, hr: np.ndarray, lr: np.ndarray,
             cases: list) -> dict:
    """Each case ((d, m), forward mode): one step of `make_train_step` on
    this rank's shard of the state and batch inside `data_parallel(mesh)`;
    returns the case's local leaves, metrics, specs and mesh coordinates."""
    out = {}
    for sizes, mode in cases:
        mesh = make_mesh(sizes, ("data", "model"), device="cpu")
        cfg = config(mode, hr.shape[0])
        full = initial_state(cfg, init)
        specs = state_shardings(mesh, full)
        state = shard_state(mesh, full)
        with data_parallel(mesh):
            state, metrics = tsk.make_train_step(cfg)(
                state, shard_batch(mesh, hr), shard_batch(mesh, lr))
        out[sizes, mode] = {**step_result(state, metrics),
                            "specs": {"g": specs.g_params, "d": specs.d_params,
                                      "ds": specs.d_state},
                            "coords": (mesh.rank, mesh.model_rank),
                            "shape": mesh.shape}
    return out
