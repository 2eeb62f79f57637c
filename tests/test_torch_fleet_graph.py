"""The fleet's stacked step replayed as a CUDA graph (`train.graphed`) on the
card against the same step run eagerly, bit for bit (marked `cuda`: they
skip on hosts without a card). On the card:
python -m pytest tests/test_torch_fleet_graph.py -m cuda

Imports torch and the port only. Both sides run `train.fleet.
make_fleet_advance` under `device.deterministic` from equal states, pools
and generators; the eager side puts `make_scenes_step(...).eager` in the
fleet's place. Compared: every metric of every call (losses, gradient
norms, kernels; at K = 1 the gradients too), the parameters, Adam's
moments and counts, D's state, the step count and each scene generator's
state after the calls; and each graphed call's metrics once more after
the calls that followed it, which must not have overwritten them.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from kmsr_tpu_torch import device as tdevice
from kmsr_tpu_torch.train import fleet as tfleet
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train.state import tree_leaves
from kmsr_tpu_torch.utils import profiling as tprof

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", tdevice.CUBLAS_WORKSPACE_CONFIG)

#: (scenes, scene_chunk, K, calls): one scene at the benchmark's K over two
#: calls; two scenes stacked; two scenes a graph each; the K = 1 host draws
CASES = {"s1-k20": (1, 1, 20, 2), "s2-stacked": (2, 2, 4, 2), "s2-chunk1": (2, 1, 4, 2),
         "s2-k1-host-rng": (2, 2, 1, 3)}
N_HR, N_LR = 12, 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph)")
    return torch.device("cuda")


def _cfg(k: int) -> tsk.SingleKernelConfig:
    """The benchmark's fleet (compose, real_is_lr, fake-side noise,
    raw_sum_reg, default widths) on 64x64 HR patches, batch 4."""
    return tsk.SingleKernelConfig(
        iters=k, hr_patch_size=64, lr_crop_size=8, batch_size=4, steps_per_call=k,
        real_is_lr=True, raw_sum_reg=0.1, fake_noise_sigma=(0.1, 0.2, 0.1, 0.3, 0.1),
        outdir="unused", verbose=False, save_intermediate=False,
        generator=tsk.GeneratorConfig(forward_mode="compose"))


def _run(cuda, monkeypatch, case: str, eager: bool):
    """([each call's per-chunk metrics], [copies of them taken right after
    the call], the chunks' states) of one fleet."""
    scenes, chunk, k, calls = CASES[case]
    cfg = _cfg(k)
    states = [tsk.init_training(dataclasses.replace(cfg, seed=s), cuda) for s in range(scenes)]
    chunks = [tfleet._stack_states(states[c:c + chunk]) for c in range(0, scenes, chunk)]
    gen = torch.Generator(device=cuda).manual_seed(9)
    pool = torch.rand((scenes, N_HR, 5, 64, 64), generator=gen, device=cuda) * 4 + 3
    crops = torch.rand((scenes, N_LR, 5, 8, 8), generator=gen, device=cuda) * 4 + 3
    host_rngs = None if k > 1 else [np.random.default_rng(50 + s) for s in range(scenes)]
    outs, kept = [], []
    with monkeypatch.context() as m:
        if eager:
            real = tfleet.make_scenes_step
            m.setattr(tfleet, "make_scenes_step", lambda c, n: real(c, n).eager)
        adv = tfleet.make_fleet_advance(cfg, chunks, pool, crops, [N_HR] * scenes,
                                        [N_LR] * scenes, host_rngs)
        tprof.timing_report(reset=True)
        with tdevice.deterministic(cuda):
            for _ in range(calls):
                outs.append(adv())
                kept.append([t.clone() for t in tree_leaves(outs[-1])])
        torch.cuda.synchronize()
    report = tprof.timing_report()
    steps = k * calls * len(chunks)
    if eager:
        assert "kernelgan.replay" not in report and report["kernelgan.d_update"]["calls"] == steps
    else:
        assert report["kernelgan.capture"]["calls"] == len(chunks)  # one graph a state
        assert report["kernelgan.replay"]["calls"] == steps
        # the phases ran at the warm-up and the capture only
        assert report["kernelgan.d_update"]["calls"] == len(chunks) * 4
    return outs, kept, chunks


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_fleet_equals_the_eager_fleet_bit_for_bit(cuda, monkeypatch, case):
    want, _, want_chunks = _run(cuda, monkeypatch, case, eager=True)
    got, kept, got_chunks = _run(cuda, monkeypatch, case, eager=False)
    for c, (w, g) in enumerate(zip(want, got, strict=True)):
        assert [sorted(x) for x in w] == [sorted(x) for x in g]
        for a, b in zip(tree_leaves(w), tree_leaves(g), strict=True):
            assert torch.equal(a, b), (case, c)
    for out, copies in zip(got, kept, strict=True):  # not overwritten by later replays
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out), copies, strict=True))
    for w, g in zip(want_chunks, got_chunks, strict=True):
        assert w.step == g.step == CASES[case][2] * CASES[case][3]
        for name in ("g_opt_state", "d_opt_state"):
            assert getattr(w, name)["count"] == getattr(g, name)["count"] == w.step
        for name in tfleet._TREES:
            for a, b in zip(tree_leaves(getattr(w, name)), tree_leaves(getattr(g, name)),
                            strict=True):
                assert torch.equal(a, b), (case, name)
        for a, b in zip(w.rng, g.rng, strict=True):
            assert torch.equal(a.get_state(), b.get_state())
