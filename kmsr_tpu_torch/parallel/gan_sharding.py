"""Sharding rules for GAN training state over a (data, model) mesh.

Counterpart of `kmsr_tpu.parallel.gan_sharding`. DP: the batch axis is
sharded over 'data' (`parallel.mesh.shard_batch`; the gradients are
averaged over 'data' only). TP: channel dimensions of the generator chains
and discriminator convs (and their Adam moments, SN vectors, BN stats) are
sharded over 'model'. Where JAX lets XLA partition the convs, each rank
here keeps its slice of every sharded leaf (`shard_state`), and the
forward functions, run inside `parallel.mesh.data_parallel(mesh)`, convolve
their own channels and meet at the collectives of `parallel.mesh`:

- the generator chain is column-parallel: a rank convolves its output
  channels, all-gathered over 'model' before the next layer; the out = 1
  last layer is row-parallel (a partial conv over the rank's input
  channels, summed over 'model'); compose mode gathers the layer weights
  and composes them replicated, as does kernel extraction;
- the discriminator is column-parallel on O: a rank's channels through its
  conv, BatchNorm (batch statistics over 'data') and LeakyReLU, then the
  activations all-gathered; spectral norm's v = W^T u and sigma are
  partial sums over O summed over 'model', and so is ||W v||^2;
- `train.state.ClippedAdam`'s global norm sums a sharded leaf's squares
  over 'model' and counts a replicated leaf once; Adam is elementwise.

The rules are explicit and per-leaf, keyed on the state-tree path (the
port's trees carry JAX's leaf names), exactly JAX's `_spec_for`:

- generator chain weights ``layers[i]`` `[band, out, in, kh, kw]`: the OUT
  channel axis where it divides by m, else the IN axis (the last layer,
  out = 1), else replicated;
- discriminator ``convs[i]`` `w [O, I, k, k]` / `b [O]`: O;
- `[O]`-shaped side state (``bn_scale/bn_bias/bn_mean/bn_var`` and the
  spectral-norm ``u`` vectors): O;
- Adam's moments follow their parameters; everything else (the step, the
  generator, the optimizer counts) is replicated.

A spec is JAX's PartitionSpec as a tuple: `(None, "model")` shards axis 1,
`()` replicates. A sharded leaf carries its spec as the attribute
`model_spec`, as a JAX array carries its sharding, and the forward
functions read it (`sharded_axis`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .mesh import Mesh

#: the (parameters, their optimizer state) fields of a `GANTrainState`
_OPT_OF = (("g_params", "g_opt_state"), ("d_params", "d_opt_state"))


def _spec_for(path_str: str, shape, m: int) -> tuple:
    def ok(ax: int) -> bool:
        return shape[ax] >= m and shape[ax] % m == 0

    if "layers" in path_str and len(shape) == 5:
        if ok(1):
            return (None, "model")
        if ok(2):
            return (None, None, "model")
        return ()
    if "convs" in path_str:
        if len(shape) in (1, 4) and ok(0):
            return ("model",)
        return ()
    if any(t in path_str for t in ("bn_scale", "bn_bias", "bn_mean", "bn_var", "'u'")):
        if len(shape) == 1 and ok(0):
            return ("model",)
        return ()
    return ()


def _map_paths(fn, tree, path: str = ""):
    """`tree` (nested dicts / lists of tensors) with each tensor leaf
    replaced by fn(path, leaf); the path is JAX's keystr, e.g.
    "['convs'][0]['w']"."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{path}[{i}]") for i, v in enumerate(tree)]
    return ()


def _leaves(specs) -> list:
    """The spec tuples of a spec tree, in the state tree's leaf order."""
    if isinstance(specs, dict):
        specs = list(specs.values())
    if isinstance(specs, list):
        return [x for v in specs for x in _leaves(v)]
    return [specs]


def state_shardings(mesh: Mesh, state):
    """The state with a spec tuple in place of every leaf (params, Adam
    moments, SN/BN state by the explicit per-leaf rules above; the step,
    the generator and the counts `()`), as JAX's returns a NamedSharding
    per leaf."""
    m = mesh.shape.get("model")

    def spec(path, leaf):
        if m is None or leaf.ndim == 0:
            return ()
        return _spec_for(path, tuple(leaf.shape), m)

    trees = {f.name: _map_paths(spec, getattr(state, f.name), f".{f.name}")
             for f in dataclasses.fields(state)}
    for params, opt in _OPT_OF:
        flat = _leaves(trees[params])
        trees[opt] = {k: (list(flat) if k in ("mu", "nu") else ())
                      for k in getattr(state, opt)}
    return dataclasses.replace(state, **trees)


def _local(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of `t` under `spec` (a copy), tagged with it."""
    local = t.detach()
    if "model" in spec:
        ax = spec.index("model")
        n = t.shape[ax] // mesh.model_size
        local = local.narrow(ax, mesh.model_rank * n, n)
    local = local.clone().requires_grad_(t.requires_grad)
    if "model" in spec:
        local.model_spec = spec
    return local


def _zip_map(fn, tree, specs):
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return tree


def shard_state(mesh: Mesh, state):
    """The state with each rank's slice of every sharded leaf and a copy of
    every replicated one, on the mesh's device (every rank passes the same
    full state)."""
    specs = state_shardings(mesh, state)

    def put(t, spec):
        return _local(t.to(mesh.device), spec, mesh)

    return dataclasses.replace(state, **{
        f.name: _zip_map(put, getattr(state, f.name), getattr(specs, f.name))
        for f in dataclasses.fields(state)})


def sharded_axis(t: torch.Tensor) -> Optional[int]:
    """The axis of `t` sharded over 'model' (`shard_state`'s tag), or None."""
    spec = getattr(t, "model_spec", ())
    return spec.index("model") if "model" in spec else None
