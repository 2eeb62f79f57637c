"""Flat .npz save/load for parameter trees (model artifacts).

Counterpart of `kmsr_tpu.utils.params_io`, file for file: arrays are stored
under enumerated keys `arr_NNNN` (for reload against a template of the
same structure) beside their path names `name_NNNN` (for inspection), in
JAX's leaf order (dict keys sorted, lists in order) and with its path
strings (`['selector']['convs'][0]['w']`). A model written by either
package loads in the other.
"""
from __future__ import annotations

import numpy as np
import torch


def _named_leaves(tree, path: str = "") -> list[tuple[str, object]]:
    """(path, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _named_leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in _named_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def _rebuild(template, leaves):
    """`template`'s structure with its leaves, in `_named_leaves` order,
    replaced by `leaves` (an iterator)."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_params(path: str, params) -> None:
    named = {}
    for i, (name, leaf) in enumerate(_named_leaves(params)):
        named[f"arr_{i:04d}"] = _numpy(leaf)
        named[f"name_{i:04d}"] = np.bytes_(name)
    np.savez(path, **named)


def load_params(path: str, template, device: str | torch.device = "cpu"):
    """The arrays of `path` as float32 tensors on `device`, arranged like
    `template`; a shape that differs from the template's raises
    ValueError."""
    data = np.load(path)
    loaded = []
    for i, (_, leaf) in enumerate(_named_leaves(template)):
        arr = data[f"arr_{i:04d}"]
        if arr.shape != tuple(np.shape(leaf)):
            raise ValueError(
                f"param {i} shape mismatch: file {arr.shape} vs template "
                f"{tuple(np.shape(leaf))}"
            )
        loaded.append(torch.from_numpy(np.array(arr, np.float32)).to(device))
    return _rebuild(template, iter(loaded))
