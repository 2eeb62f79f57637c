"""The graphed KernelGAN step's CPU side (`train.graphed`): Adam's bias
corrections as device scalars equal the host numbers bit for bit, and the
stacked step stays eager, capturing nothing, wherever `graphable` says no:
on the CPU, under a data-parallel or model mesh, with a learning-rate
schedule. The graph itself runs on the card only
(`tests/test_torch_fleet_graph.py`)."""
import dataclasses
import types

import pytest
import torch

from kmsr_tpu_torch.models.discriminator import DiscriminatorConfig
from kmsr_tpu_torch.models.generator import GeneratorConfig
from kmsr_tpu_torch.parallel.mesh import Mesh, data_parallel
from kmsr_tpu_torch.train import fleet
from kmsr_tpu_torch.train import graphed
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train.state import make_gan_optimizers, tree_leaves
from kmsr_tpu_torch.utils import profiling as tprof


def _leaves(seed: int, scenes):
    gen = torch.Generator().manual_seed(seed)
    lead = () if scenes is None else (scenes,)
    return [torch.randn(lead + s, generator=gen) for s in ((8, 5, 7, 7), (8,), (1, 8, 1, 1))]


@pytest.mark.parametrize("scenes", [None, 3])
def test_adam_device_corrections_equal_the_python_numbers(scenes):
    """30 clipped Adam steps (some clipped, some not) with the bias
    corrections as 0-dim float32 tensors refilled each step, as a replayed
    graph reads them, equal the host-number steps bit for bit: parameters,
    moments, norms."""
    tx = make_gan_optimizers(4e-4)
    host, dev = _leaves(0, scenes), _leaves(0, scenes)
    s_host, s_dev = tx.init(host), tx.init(dev)
    corr = (torch.empty(()), torch.empty(()))
    gen = torch.Generator().manual_seed(1)
    for i in range(30):
        scale = 40.0 if i % 3 == 0 else 0.5  # over and under the clip norm 20
        grads = [torch.randn(p.shape, generator=gen) * scale for p in host]
        for t, v in zip(corr, tx.device_corrections(s_dev["count"] + 1, "cpu")):
            t.fill_(v)
        assert corr[0].dtype == torch.float32
        n_host = tx.step(host, [g.clone() for g in grads], s_host, scenes=scenes)
        n_dev = tx.step(dev, [g.clone() for g in grads], s_dev, scenes=scenes, corrections=corr)
        assert torch.equal(n_host, n_dev)
        for a, b in zip(host + s_host["mu"] + s_host["nu"], dev + s_dev["mu"] + s_dev["nu"],
                        strict=True):
            assert torch.equal(a, b), i
    assert s_host["count"] == s_dev["count"] == 30


def test_device_corrections_are_the_reciprocals_on_a_card():
    """On a card the eager division by a host number multiplies by its
    reciprocal (taken in double), so the graph's scalars are those; on the
    CPU the numbers themselves. Bit-equality on the card:
    `tests/test_torch_fleet_graph.py`."""
    tx = make_gan_optimizers(4e-4)
    for count in (1, 2, 25, 3000):
        c = tx.corrections(count)
        assert c == (1 - 0.5**count, 1 - 0.999**count)
        assert tx.device_corrections(count, "cpu") == c
        assert tx.device_corrections(count, torch.device("cuda")) == (1 / c[0], 1 / c[1])


def test_a_graph_fills_each_optimizers_next_corrections():
    """Before a replay, each optimizer's pair of scalars holds the
    corrections of the step that brings its count to count + 1."""
    txs = (make_gan_optimizers(4e-4), make_gan_optimizers(1e-4))
    g = object.__new__(graphed._Graph)
    g.txs, g.hr = txs, torch.empty(0)
    g.corr = {k: (torch.empty(()), torch.empty(())) for k in "gd"}
    state = types.SimpleNamespace(g_opt_state={"count": 4}, d_opt_state={"count": 9})
    g._fill(state)
    for k, tx, count in (("g", txs[0], 5), ("d", txs[1], 10)):
        want = tx.device_corrections(count, "cpu")
        assert [float(t) for t in g.corr[k]] == [float(torch.tensor(v)) for v in want]


def _cfg(**kw):
    return tsk.SingleKernelConfig(
        iters=2, hr_patch_size=32, lr_crop_size=4, batch_size=2, real_is_lr=True,
        raw_sum_reg=0.1, fake_noise_sigma=(0.1,) * 5, outdir="unused", verbose=False,
        generator=GeneratorConfig(mid_ch=8, forward_mode="compose"),
        discriminator=DiscriminatorConfig(base_ch=8, num_blocks=1), **kw)


def _one_process_mesh(model: bool) -> Mesh:
    """A mesh whose groups are set, as `active_mesh` / `model_mesh` see it
    (no collective runs here)."""
    return Mesh("data", 1, 0, torch.device("cpu"), group=object(),
                **(dict(model_axis="model", model_group=object()) if model else {}))


@pytest.mark.parametrize("case", ["cuda", "cpu", "data mesh", "model mesh", "lr schedule"])
def test_graphable_only_on_a_card_without_a_mesh_at_a_constant_lr(case):
    lr = (lambda count: 4e-4) if case == "lr schedule" else 4e-4
    txs = (make_gan_optimizers(lr), make_gan_optimizers(4e-4))
    dev = torch.device("cpu" if case == "cpu" else "cuda")
    mesh = _one_process_mesh(case == "model mesh") if "mesh" in case else None
    with data_parallel(mesh):
        assert graphed.graphable(dev, txs) == (case == "cuda")


@pytest.mark.parametrize("scenes", [1, 2])
@pytest.mark.parametrize("case", ["cpu", "lr schedule"])
def test_stacked_step_stays_eager_and_captures_nothing(monkeypatch, scenes, case):
    """`make_scenes_step`'s step on the CPU, and with an lr schedule where
    `graphable` is asked as if on a card: no capture attempted, no
    `kernelgan.capture` or `kernelgan.replay` span, and every metric and
    state tensor equal to the eager step's bit for bit over 2 steps."""
    def refuse(*a, **kw):
        raise AssertionError("a capture was attempted")

    monkeypatch.setattr(graphed, "_Graph", refuse)
    if case == "lr schedule":
        real = graphed.graphable
        monkeypatch.setattr(graphed, "graphable",
                            lambda dev, txs: real(torch.device("cuda"), txs))
    cfg = _cfg(lr_rate=(lambda count: 4e-4 / (1 + count)) if case == "lr schedule" else 4e-4)
    states = [fleet._stack_states([tsk.init_training(dataclasses.replace(cfg, seed=s), "cpu")
                                   for s in range(scenes)]) for _ in range(2)]
    run = tsk.make_scenes_step(cfg, scenes)
    eager = tsk.make_scenes_step(cfg, scenes).eager
    gen = torch.Generator().manual_seed(2)
    tprof.timing_report(reset=True)
    for _ in range(2):
        hr = torch.randn((scenes, 2, 5, 32, 32), generator=gen) + 3
        crop = torch.randn((scenes, 2, 5, 4, 4), generator=gen) + 3
        _, want = eager(states[0], hr, crop)
        _, got = run(states[1], hr, crop)
        for k in tsk._CHUNK_KEYS:
            assert torch.equal(got[k], want[k]), k
    for a, b in zip(tree_leaves([states[0].g_params, states[0].d_params, states[0].d_state]),
                    tree_leaves([states[1].g_params, states[1].d_params, states[1].d_state]),
                    strict=True):
        assert torch.equal(a, b)
    assert states[0].step == states[1].step == 2
    names = set(tprof.timing_report())
    assert "kernelgan.d_update" in names
    assert not names & {"kernelgan.capture", "kernelgan.replay"}
