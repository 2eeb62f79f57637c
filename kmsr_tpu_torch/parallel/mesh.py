"""Process meshes, batch placement and the collectives of a data-parallel step.

Counterpart of `kmsr_tpu.parallel.mesh`. The JAX package's 1-D mesh over
devices becomes a `torch.distributed` process group with one process per
card (`torchrun`): rank r holds cuda:<LOCAL_RANK> (or the CPU, with gloo).
JAX runs one logical global batch whose shards XLA places, and inserts the
gradient psum and the global batch statistics itself. Here every rank
draws the SAME global batch from the same host RNG and keeps its
contiguous rows (`shard_batch`), and the step says where the ranks meet:

- `all_reduce_grads`: the gradients' mean over ranks, before the optimizer;
- `batch_mean`: a per-rank mean made global (BatchNorm statistics, the
  MoE load-balance fractions, the logged losses), differentiable (its
  backward all-reduces the incoming gradients), so each rank's backward
  carries the other ranks' share of the statistics;
- `global_rows` / `local_rows`: a random draw inside a step is made at
  the global batch's shape from the same generator on every rank, and
  each rank keeps its rows, so DP draws what one device would.

The forward functions (`models.discriminator.batch_norm`, the draws in the
trainers and in `models.moe`) consult the mesh made active by
`data_parallel(mesh)`; with none active they are the one-device code. A
mesh of world size 1 runs every collective too (NCCL's or gloo's identity)
and gives bit for bit the one-device result: a mean over one rank is the
rank's value divided by 1, and the variance's cross-rank term is an exact 0.

A 2-D mesh `make_mesh((d, m), ("data", "model"))` lays the ranks out as
JAX's mesh lays its devices out (rank r at data index r // m, model index
r % m). Its first axis is the data-parallel axis above (`size`, `rank`,
`group`: the ranks with this rank's model index), so every DP collective
runs over 'data' only; the second is the 'model' axis of tensor
parallelism (`model_size`, `model_rank`, `model_group`: the ranks with
this rank's data index). `parallel.gan_sharding` keeps each rank's slice
of the GAN's channel dimensions, and the forward functions consult the
active mesh's model axis (`model_mesh`) through the collectives below:

- `copy_to_model`: identity forward, a sum over 'model' backward (a
  replicated tensor entering channel-sharded compute);
- `reduce_from_model`: a sum over 'model' forward, identity backward
  (channel-partial results summed into a replicated tensor);
- `gather_from_model`: the ranks' channel shards concatenated in rank
  order, backward this rank's slice (a sharded tensor made replicated).

At m = 1 each is the identity, so a (d, 1) step is the DP step bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Iterator, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils.tree import tree_leaves
from .multihost import is_initialized, local_card


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of processes: its (first) axis name and size, this process's
    rank on it and this rank's device; a 2-D mesh also names its second
    ('model') axis, with this rank's index and group on it. `group` and
    `model_group` are None for a one-process mesh with no process group,
    where every collective is the identity."""

    axis_name: str
    size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    model_axis: Optional[str] = None
    model_size: int = 1
    model_rank: int = 0
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        if self.model_axis is None:
            return (self.axis_name,)
        return (self.axis_name, self.model_axis)

    @property
    def shape(self) -> dict:
        if self.model_axis is None:
            return {self.axis_name: self.size}
        return {self.axis_name: self.size, self.model_axis: self.model_size}

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the run's artifacts (logs, checkpoints, kernels)."""
        return self.rank == 0 and self.model_rank == 0


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    device: str | torch.device = "cuda",
    group: Optional[dist.ProcessGroup] = None,
) -> Mesh:
    """The mesh of the process group (`group`, else the default group): one
    rank per process, 1-D over `axis_names[0]`, or 2-D, e.g.
    axis_sizes=(2, 2), axis_names=("data", "model"), rank r at (r // m,
    r % m). Without an initialized group: a one-process mesh on `device`
    with no group.

    A 2-D mesh's data groups (the ranks of one model index) and model
    groups (the ranks of one data index) are made with `dist.new_group`,
    every rank making every group in the same order, as the call demands.

    On a card every rank takes cuda:<LOCAL_RANK> (LOCAL_RANK from torchrun,
    else the rank), and the group must be NCCL's: there is no gloo
    substitute on CUDA, and a rank with no card of its own raises.
    """
    if not 1 <= len(axis_names) <= 2:
        raise ValueError(f"only 1-D and 2-D meshes are supported, got "
                         f"axis_names={tuple(axis_names)}")
    if axis_sizes is None:
        if len(axis_names) == 2:
            raise ValueError("a 2-D mesh needs axis_sizes")
    elif len(axis_sizes) != len(axis_names):
        raise ValueError(f"axis_sizes {tuple(axis_sizes)} do not match "
                         f"axis_names {tuple(axis_names)}")
    dev = resolve_device(device)
    if group is None and not is_initialized():
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        world, rank = 1, 0
    else:
        group = group if group is not None else dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        backend = dist.get_backend(group)
        if dev.type == "cuda":
            if backend != "nccl":
                raise ValueError(
                    f"a mesh on the card needs an NCCL process group, got "
                    f"{backend!r}")
            dev = local_card(int(os.environ.get("LOCAL_RANK", rank)))
    sizes = tuple(axis_sizes) if axis_sizes is not None else (world,)
    n = math.prod(sizes)
    if n != world:  # every rank is in the mesh
        raise ValueError(f"mesh needs {n} devices, have {world}")
    if len(sizes) == 1:
        return Mesh(axis_names[0], world, rank, dev, group)
    d, m = sizes
    if group is None:
        return Mesh(axis_names[0], 1, 0, dev, None, axis_names[1], 1, 0, None)
    ranks = dist.get_process_group_ranks(group)
    data_groups = [dist.new_group([ranks[i * m + j] for i in range(d)]) for j in range(m)]
    model_groups = [dist.new_group([ranks[i * m + j] for j in range(m)]) for i in range(d)]
    i, j = divmod(rank, m)
    return Mesh(axis_names[0], d, i, dev, data_groups[j],
                axis_names[1], m, j, model_groups[i])


class Sharding(NamedTuple):
    """Where a batch lives: its leading axis split over `axis` of `mesh`
    (each rank a contiguous block), or replicated when `axis` is None."""

    mesh: Mesh
    axis: Optional[str]


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Shard the leading (batch) axis over `axis`, replicate the rest."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def rows_of(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of an n-row global batch."""
    if n % mesh.size:
        raise ValueError(
            f"the global size of dimension 0 should be divisible by "
            f"{mesh.size} ('{mesh.axis_name}' ranks), but it is equal to {n}")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: Mesh, batch, axis: str = "data") -> torch.Tensor:
    """This rank's rows of a global host batch, on this rank's device (a
    pinned, non-blocking copy to a card). Every rank passes the same
    global batch; the batch must divide by the mesh size, as in JAX."""
    host = torch.as_tensor(batch)
    try:
        rows = rows_of(mesh, host.shape[0])
    except ValueError as e:
        raise ValueError(f"{e} (full shape: {tuple(host.shape)})") from None
    local = host[rows]
    if mesh.device.type == "cuda" and local.device.type == "cpu":
        return local.pin_memory().to(mesh.device, non_blocking=True)
    return local.to(mesh.device)


def replicate_state(mesh: Mesh, tree):
    """Broadcast every tensor leaf of `tree` (a nested dict / list / state
    dataclass) from rank 0, in place, so every rank starts from rank 0's
    state; returns `tree`."""
    if mesh.group is None:
        return tree
    if dataclasses.is_dataclass(tree):
        leaves = [t for f in dataclasses.fields(tree)
                  for t in tree_leaves(getattr(tree, f.name))]
    else:
        leaves = tree_leaves(tree)
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for t in leaves:
            dist.broadcast(t, src, group=mesh.group)
    return tree


def _flat_all_reduce_mean(mesh: Mesh, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor's mean over ranks, in one all-reduce of their
    concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def all_reduce_grads(mesh: Optional[Mesh], grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """The gradients' mean over the mesh's ranks (one all-reduce); the
    identity without a mesh or without a group."""
    if mesh is None or mesh.group is None:
        return list(grads)
    return _flat_all_reduce_mean(mesh, list(grads))


# --------------------------------------------- the step's active mesh
_ACTIVE: list[Mesh] = []


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]) -> Iterator[None]:
    """Make `mesh` the data-parallel mesh of the steps run in the block
    (None: the one-device step)."""
    if mesh is None:
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing `data_parallel` block with a group, if any."""
    return _ACTIVE[-1] if _ACTIVE and _ACTIVE[-1].group is not None else None


def model_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing `data_parallel` block when it has a model
    axis with a group (tensor parallelism), else None."""
    return _ACTIVE[-1] if _ACTIVE and _ACTIVE[-1].model_group is not None else None


def global_rows(n_local: int) -> int:
    """The global batch's row count for a local batch of n_local rows."""
    mesh = active_mesh()
    return n_local if mesh is None else n_local * mesh.size


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor drawn at the global batch's shape."""
    mesh = active_mesh()
    return t if mesh is None else t[rows_of(mesh, t.shape[0])]


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the incoming gradients over ranks
    (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the incoming gradients summed over 'model'."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()  # its layout kept: the step at m = 1 is the plain step
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over 'model' forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' shards of axis `dim` (seen as `blocks` blocks, each split
    over the ranks) concatenated block by block in rank order; backward,
    this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, blocks, mesh):
        ctx.dim, ctx.blocks, ctx.mesh = dim, blocks, mesh
        x = x.contiguous()  # the collective moves raw memory: one layout on every rank
        parts = [torch.empty_like(x) for _ in range(mesh.model_size)]
        dist.all_gather(parts, x, group=mesh.model_group)
        lead, n = x.shape[:dim], x.shape[dim]
        split = [p.reshape(*lead, blocks, n // blocks, *x.shape[dim + 1:]) for p in parts]
        y = torch.stack(split, dim=dim + 1)
        return y.reshape(*lead, n * mesh.model_size, *x.shape[dim + 1:])

    @staticmethod
    def backward(ctx, grad):
        dim, blocks, mesh = ctx.dim, ctx.blocks, ctx.mesh
        lead, n = grad.shape[:dim], grad.shape[dim]
        g = grad.reshape(*lead, blocks, mesh.model_size, n // (blocks * mesh.model_size),
                         *grad.shape[dim + 1:])
        g = g.select(dim + 1, mesh.model_rank)
        return g.reshape(*lead, n // mesh.model_size, *grad.shape[dim + 1:]), None, None, None


class _ShardNorm(torch.autograd.Function):
    """The norm of a tensor sharded over 'model' from this rank's shard's
    norm n: sqrt of n^2 summed over 'model', for channel-sharded consumers.
    Backward: the incoming gradients summed over 'model' (as
    `copy_to_model`'s), times d norm / d n = n / norm, exactly 1 at m = 1."""

    @staticmethod
    def forward(ctx, n, group):
        sq = (n * n).reshape(1)
        dist.all_reduce(sq, group=group)
        norm = torch.sqrt(sq).reshape(n.shape)
        ctx.save_for_backward(n, norm)
        ctx.group = group
        return norm

    @staticmethod
    def backward(ctx, grad):
        n, norm = ctx.saved_tensors
        grad = grad.reshape(1).clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.reshape(n.shape) * (n / norm), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """`x` (replicated over 'model') as the input of channel-sharded compute:
    its backward sums the ranks' partial gradients. The identity outside a
    model mesh."""
    mesh = model_mesh()
    if mesh is None or not x.requires_grad:
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over 'model' of channel-partial results (differentiable)."""
    mesh = model_mesh()
    if mesh is None:
        return x
    return _ReduceFromModel.apply(x, mesh.model_group)


def model_norm(n: torch.Tensor) -> torch.Tensor:
    """The 2-norm of a tensor sharded over 'model', from the 0-d norm `n` of
    this rank's shard (sqrt(n^2) is n exactly at m = 1), for consumers
    that are themselves sharded (differentiable). `n` outside a model mesh."""
    mesh = model_mesh()
    if mesh is None:
        return n
    return _ShardNorm.apply(n, mesh.model_group)


def gather_from_model(x: torch.Tensor, dim: int, blocks: int = 1) -> torch.Tensor:
    """The full tensor of this rank's shard `x` of axis `dim` (differentiable).
    `blocks` > 1: the axis is `blocks` equal blocks (the generator's
    band-major channels), each block split over the ranks."""
    mesh = model_mesh()
    if mesh is None:
        return x
    return _GatherFromModel.apply(x, dim, blocks, mesh)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of a per-rank quantity (a per-rank batch mean
    becomes the global batch's, as the ranks' batches are of equal size),
    differentiable: the backward all-reduces the incoming gradients, so each
    rank's gradient carries the other ranks' use of its rows. The identity
    outside a `data_parallel` block with a group."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return _AllReduceSum.apply(x, mesh.group) / mesh.size


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a per-rank count (no gradient)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.group)
    return y


def metrics_mean(metrics: dict, keys: Sequence[str]) -> dict:
    """`metrics` with the scalars under `keys` replaced by their mean over
    ranks, in one all-reduce (the logged losses of a DP step)."""
    mesh = active_mesh()
    if mesh is None:
        return metrics
    means = _flat_all_reduce_mean(mesh, [metrics[k].detach() for k in keys])
    return {**metrics, **dict(zip(keys, means))}


def reduce_grads(grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """`all_reduce_grads` over the active mesh (the identity without one)."""
    return all_reduce_grads(active_mesh(), list(grads))


def mesh_device(device: str | torch.device, mesh: Optional[Mesh]) -> torch.device:
    """The device an entry point runs on: `device` resolved, or under a mesh
    the mesh's device for this rank (whose type `device` must name)."""
    dev = resolve_device(device)
    if mesh is None:
        return dev
    if mesh.device.type != dev.type:
        raise ValueError(
            f"device {str(device)!r} does not match the mesh's {mesh.device}")
    return mesh.device


@contextlib.contextmanager
def launch_mesh(enabled: bool, axis_name: str = "data",
                device: str | torch.device = "cuda") -> Iterator[Optional[Mesh]]:
    """A CLI's `--data-parallel` / `--scene-parallel`: when `enabled`, the
    process group from torchrun's environment (`multihost.
    initialize_if_needed`; a plain process is a one-rank mesh) and its 1-D
    mesh over `axis_name`, destroyed on exit if this call started it; else
    None."""
    if not enabled:
        yield None
        return
    from .multihost import initialize_if_needed

    started = initialize_if_needed(device)
    try:
        yield make_mesh(axis_names=(axis_name,), device=device)
    finally:
        if started:
            dist.destroy_process_group()
