"""Faults planted in the timed path, each of which a cell's check has to
catch: `plant(name)` is a context manager that breaks the program
underneath while it is open. The CPU tests run every cell under its
faults; `control.py --fault NAME` reads a training fault's numbers on the
card.

* `answer`: the factory's lr, or SR's predictions, altered where they are
  produced (scaled by 1 + 1e-3, or 1 + 3e-2);
* `unchanged`: each of the fleet's steps returns its parameters as they
  were;
* `half-batch`: the fleet's steps draw half of the batch, their means
  taken over the rest.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import torch

NAMES = ("answer-factory", "answer-sr", "unchanged", "half-batch")


def _frozen(real):
    from kmsr_tpu_torch.train.state import tree_leaves

    def make(cfg, scenes):
        step = real(cfg, scenes)

        def go(state, *args):
            keep = [t.detach().clone()
                    for t in tree_leaves(state.g_params) + tree_leaves(state.d_params)]
            state, ms = step(state, *args)
            with torch.no_grad():
                for t, k in zip(tree_leaves(state.g_params) + tree_leaves(state.d_params), keep):
                    t.copy_(k)
            return state, ms
        return go
    return make


@contextlib.contextmanager
def plant(name: str):
    import kmsr_tpu_torch.pipeline.factory as fac
    import kmsr_tpu_torch.pipeline.sr_infer as sri
    import kmsr_tpu_torch.train.fleet as flt

    if name == "answer-factory":
        real = fac.degrade_fused
        patch = mock.patch.object(fac, "degrade_fused",
                                  lambda *a, **k: real(*a, **k) * (1 + 1e-3))
    elif name == "answer-sr":
        real = sri.sr_forward
        patch = mock.patch.object(sri, "sr_forward", lambda *a, **k: real(*a, **k) * (1 + 3e-2))
    elif name == "unchanged":
        patch = mock.patch.object(flt, "make_scenes_step", _frozen(flt.make_scenes_step))
    elif name == "half-batch":
        real = flt.batch_indices
        patch = mock.patch.object(flt, "batch_indices",
                                  lambda g, n, bs, dev: real(g, n, bs // 2, dev))
    else:
        raise ValueError(f"no fault {name!r}; one of {NAMES}")
    with patch:
        yield
