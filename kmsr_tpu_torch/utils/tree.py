"""Pytrees of tensors: nested dicts / lists / tuples with tensor leaves,
the layout of the port's parameters, optimizer and model states."""
from __future__ import annotations

from typing import Any, Callable

import torch


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
