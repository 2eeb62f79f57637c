"""A GAN train step replayed as a CUDA graph.

The fleet's stacked step (`single_kernel.make_scenes_step`) launches some
2,500 small aten ops a scene-iteration (D's spectral norm and its
backward, two clipped Adam updates), and nothing in it waits for the
device: the host's dispatch, not the card, sets its pace. `graphed_step`
wraps such a step. On a CUDA device, with no data-parallel or model mesh
active (the step then has no collectives) and with constant learning
rates (`graphable`), the first call for a state object captures the step
into a `torch.cuda.CUDAGraph` and every call replays it: the same kernels
in the same order on the same float32 data, one host call a step.
Elsewhere, or with a learning-rate schedule, the step runs eagerly.

Capture leaves the state as it found it: the state's tensors and its
generators' states are saved, the step runs `WARMUP_STEPS` times eagerly
on a side stream (cuDNN's and cuBLAS's lazy set-up, the step's own cached
device constants), everything is put back, and one step is captured with
the generators registered to the graph, so each replay draws what the
eager step would draw at the generators' current offsets. The graph reads
and writes the state's own tensors: parameters and Adam moments are
updated in place, and D's new state (spectral-norm u, BatchNorm
statistics) is copied into the state's tensors inside the graph.

Each call copies hr and crop_src into the graph's input buffers, sets each
optimizer's bias corrections with `fill_` (`ClippedAdam.device_corrections`:
on a card their reciprocals, which is how the eager division by a host
number applies them), replays, advances the host's step and Adam counts,
and returns the metrics as views of one fresh copy of the graph's flat
output: no metric a caller keeps is overwritten by the next replay. The
graphs of one wrapped step share a memory pool (the calls replay them one
at a time on one stream), so a fleet's chunks hold one chunk's
intermediates.

Spans (`utils.profiling.stage_timer`): `kernelgan.capture` once a graph
(warm-up and capture; the step's own phase spans fire inside it), and
`kernelgan.replay` each call, its item the step count, counting
`scene_its` (the scenes a call advances).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.mesh import active_mesh, model_mesh
from ..utils.profiling import stage_timer
from .state import GANTrainState, tree_leaves, tree_unflatten

#: eager steps before a capture (`torch.cuda.make_graphed_callables`' count)
WARMUP_STEPS = 3


def graphable(dev: torch.device, txs: tuple) -> bool:
    """Whether a step on `dev` updated by the optimizers `txs` may be
    replayed as a CUDA graph: a CUDA device, no data-parallel or model mesh
    active, and every learning rate a number (a schedule is evaluated on
    the host each step)."""
    return (dev.type == "cuda" and active_mesh() is None and model_mesh() is None
            and not any(callable(tx.lr) for tx in txs))


def _state_leaves(state: GANTrainState) -> list[torch.Tensor]:
    """The tensors a step reads and updates: both parameter sets, D's
    state, both optimizers' moments."""
    return tree_leaves([state.g_params, state.d_params, state.d_state,
                        state.g_opt_state, state.d_opt_state])


def _like(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype


class _Graph:
    """One state's captured step: its input buffers, its bias corrections
    (a 0-dim float32 pair an optimizer) and its flat metrics output."""

    def __init__(self, step: Callable, txs: tuple, state: GANTrainState, hr: torch.Tensor,
                 crop_src: torch.Tensor, scenes: int, pool):
        dev = hr.device
        self.txs, self.scenes = txs, scenes
        self.leaves = _state_leaves(state)
        self.gens = list(state.rng)
        self.d_state = state.d_state
        self.hr, self.crop = torch.empty_like(hr), torch.empty_like(crop_src)
        self.corr = {k: (torch.empty((), device=dev), torch.empty((), device=dev))
                     for k in ("g", "d")}
        self.graph = torch.cuda.CUDAGraph()
        self._capture(step, state, hr, crop_src, pool)

    def holds(self, state: GANTrainState, hr: torch.Tensor, crop_src: torch.Tensor) -> bool:
        """Whether this graph runs `state`'s step: the same tensors and
        generators, inputs of the captured shapes."""
        leaves, gens = _state_leaves(state), list(state.rng)
        return (_like(self.hr, hr) and _like(self.crop, crop_src)
                and len(leaves) == len(self.leaves) and len(gens) == len(self.gens)
                and all(a is b for a, b in zip(leaves, self.leaves))
                and all(a is b for a, b in zip(gens, self.gens)))

    def _fill(self, state: GANTrainState) -> None:
        """This step's bias corrections into the graph's scalars."""
        for k, tx in zip(("g", "d"), self.txs):
            count = getattr(state, f"{k}_opt_state")["count"] + 1
            for t, v in zip(self.corr[k], tx.device_corrections(count, self.hr.device)):
                t.fill_(v)

    def _capture(self, step, state, hr, crop_src, pool) -> None:
        host = (state.step, state.g_opt_state["count"], state.d_opt_state["count"])
        rng = [g.get_state() for g in self.gens]
        cur = torch.cuda.current_stream(hr.device)
        side = torch.cuda.Stream(hr.device)
        with torch.no_grad():
            self.hr.copy_(hr)
            self.crop.copy_(crop_src)
            saved = [t.clone() for t in self.leaves]
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._fill(state)
                step(state, self.hr, self.crop, self.corr)
        cur.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(self.leaves, saved):
                t.copy_(s)
        del saved
        for g, s in zip(self.gens, rng):
            g.set_state(s)
            self.graph.register_generator_state(g)
        self._restore(state, host)
        with torch.cuda.graph(self.graph, pool=pool, stream=side):
            state, ms = step(state, self.hr, self.crop, self.corr)
            with torch.no_grad():
                for dst, src in zip(tree_leaves(self.d_state), tree_leaves(state.d_state),
                                    strict=True):
                    dst.copy_(src)
                self.out = torch.cat([t.detach().reshape(-1) for t in tree_leaves(ms)])
        self._restore(state, host)
        self.template = ms
        self.shapes = [t.shape for t in tree_leaves(ms)]
        self.sizes = [t.numel() for t in tree_leaves(ms)]

    def _restore(self, state: GANTrainState, host: tuple) -> None:
        """The host's counts and D's state as they were before the capture."""
        state.step, state.g_opt_state["count"], state.d_opt_state["count"] = host
        state.d_state = self.d_state

    def __call__(self, state: GANTrainState, hr: torch.Tensor, crop_src: torch.Tensor):
        with stage_timer("kernelgan.replay", item=state.step, scene_its=self.scenes):
            self.hr.copy_(hr)
            self.crop.copy_(crop_src)
            self._fill(state)
            self.graph.replay()
            state.step += 1
            state.g_opt_state["count"] += 1
            state.d_opt_state["count"] += 1
            pieces = self.out.clone().split(self.sizes)
            return state, tree_unflatten(self.template, [
                p if p.shape == s else p.view(s) for p, s in zip(pieces, self.shapes)])


def graphed_step(step: Callable, txs: tuple, scenes: int) -> Callable:
    """`step(state, hr, crop_src[, corrections])` as
    run(state, hr, crop_src) -> (state, metrics): replayed from one CUDA
    graph per state object where `graphable(hr.device, txs)` holds, else
    `step` itself (module docstring). `txs` are the step's (G's, D's)
    `ClippedAdam`s, `scenes` the scenes a call advances. A state whose
    tensors, generators or input shapes changed since its capture is
    captured anew. `run.eager` is `step`."""
    graphs: dict[int, _Graph] = {}

    def run(state: GANTrainState, hr: torch.Tensor, crop_src: torch.Tensor):
        if not graphable(hr.device, txs):
            return step(state, hr, crop_src)
        g = graphs.get(id(state))
        if g is None or not g.holds(state, hr, crop_src):
            graphs.pop(id(state), None)
            pool: Optional[tuple] = next((o.graph.pool() for o in graphs.values()), None)
            with stage_timer("kernelgan.capture", item=state.step):
                g = graphs[id(state)] = _Graph(step, txs, state, hr, crop_src, scenes, pool)
        return g(state, hr, crop_src)

    run.eager = step
    return run
