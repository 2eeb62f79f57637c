"""Data-parallel training across ranks, on the CPU: a 2-rank gloo world
against the one-process run.

One world (`tests/helpers/dist_world.py`, started once for the module)
runs every case and the checks are parametrized over its results:

- two DP steps of each trainer (KernelGAN chain, and compose with
  fake-side noise; MoE with the load-balance loss; dynamic; SR) against
  the same two steps in one process on the same global batches: the
  logged losses, the gradients (the scaled-gradient rule of
  `tests/test_torch_train_single.py`: rtol 1e-4, atol 1e-5 of the tree's
  largest entry), the updated parameters and the BatchNorm running
  statistics (rtol 1e-4 / atol 1e-5), and MoE's Gumbel selections
  (equal counts);
- the fleet over 2 ranks with S = 4: each rank trains and writes its own
  two scenes, every scene equals the one-process fleet, and rank 0's
  checkpoint holds all four scenes;
- `sr_scene` with its tiles split over the ranks;
- the single-kernel CLI with --data-parallel, end to end;
- the refusal of the device pool / K > 1 under a mesh, with JAX's text.

A world of one rank (every collective runs: gloo's identity) gives the
one-process steps bit for bit, as the card's world of one does.
"""
import os

import numpy as np
import pytest
import torch

from kmsr_tpu.train import state as jstate
from kmsr_tpu_torch.io.ncio import write_band_stack
from kmsr_tpu_torch.parallel.mesh import make_mesh
from kmsr_tpu_torch.train import dynamic as tdyn
from kmsr_tpu_torch.train import moe as tmoe
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train import sr as tsr
from kmsr_tpu_torch.train.state import check_mesh_vs_scan
from tests.helpers import dp_jobs
from tests.helpers.dist_world import run_world

TOL = dict(rtol=1e-4, atol=1e-5)
WORLD = 2


def _cli_args(root) -> list:
    rng = np.random.default_rng(9)
    os.makedirs(root, exist_ok=True)
    for i in range(6):
        write_band_stack(os.path.join(root, f"p{i}.nc"), "denoised",
                         rng.normal(5, 1, (5, 32, 32)).astype(np.float32), mode="w")
    return ["--patch-dir", str(root), "--iters", "2", "--batch-size", "4",
            "--lr-crop-size", "8", "--log-every", "1", "--kernel-log-every", "2",
            "--fast-forward", "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, one-process results, the world's directory)."""
    tmp = tmp_path_factory.mktemp("dp")
    args = _cli_args(tmp / "patches")
    ranks = run_world(dp_jobs.train_world, WORLD, tmp / "world", str(tmp / "world"), args)
    ref = dp_jobs.reference(str(tmp / "ref"), args)
    return ranks, ref, tmp


@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("solo")
    return run_world(dp_jobs.solo_world, 1, tmp, str(tmp))[0]


@pytest.mark.parametrize("kind", dp_jobs.KINDS)
def test_world_of_one_is_bit_equal(solo, kind):
    """Losses, gradients, parameters, BatchNorm statistics and selections of
    a one-rank world equal the one-process steps (run in the same process)
    bit for bit."""
    got, ref = solo[kind, True], solo[kind, False]
    assert got["loss"] == ref["loss"]
    for key in ("params", "bn", "selection"):
        for a, b in zip(got[key], ref[key], strict=True):
            np.testing.assert_array_equal(a, b)
    for a_step, b_step in zip(got["grads"], ref["grads"], strict=True):
        for a, b in zip(a_step, b_step, strict=True):
            np.testing.assert_array_equal(a, b)


def _scaled(want: list) -> dict:
    scale = max(float(np.abs(w).max()) for w in want)
    return dict(rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("kind", dp_jobs.KINDS)
def test_dp_losses_match_one_device(runs, kind, rank):
    ranks, ref, _ = runs
    np.testing.assert_allclose(ranks[rank][kind]["loss"], ref[kind]["loss"], **TOL)


@pytest.mark.parametrize("kind", dp_jobs.KINDS)
def test_dp_gradients_match_one_device(runs, kind):
    """The gradients every rank applies: equal across ranks (they are
    all-reduced) and equal to the one-device gradients of each step."""
    ranks, ref, _ = runs
    for step in range(dp_jobs.N_STEPS):
        want = ref[kind]["grads"][step]
        for r in range(WORLD):
            got = ranks[r][kind]["grads"][step]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, **_scaled(want))
        for g0, g1 in zip(ranks[0][kind]["grads"][step], ranks[1][kind]["grads"][step]):
            np.testing.assert_array_equal(g0, g1)


def _noise_leaves(ref: dict) -> list[bool]:
    """Per parameter leaf: are its one-device gradients rounding noise in
    every step (below the scaled-gradient rule's atol, 1e-5 of the
    largest gradient)? Such leaves, the conv biases in front of a
    BatchNorm, have a zero gradient in exact arithmetic, and Adam turns
    their noise into steps of up to lr either way."""
    noise = [True] * len(ref["params"])
    for grads in ref["grads"]:
        scale = max(float(np.abs(g).max()) for g in grads)
        noise = [n and float(np.abs(g).max()) <= 1e-5 * scale for n, g in zip(noise, grads)]
    return noise


@pytest.mark.parametrize("kind", dp_jobs.KINDS)
def test_dp_parameters_and_batch_stats_match_one_device(runs, kind):
    """After two steps: every rank holds the same parameters and BatchNorm
    running statistics, and they are the one-device ones (rtol 1e-4 /
    atol 1e-5). A leaf with no gradient beyond rounding noise
    (`_noise_leaves`) has no direction to hold: it is held to the bound of
    two Adam steps either way, 4 lr, and so are the running means, which
    follow those biases; the running variances do not, and are held to
    the tolerance."""
    ranks, ref, _ = runs
    lr = ref[kind]["lr"]
    noise = _noise_leaves(ref[kind])
    assert not all(noise)
    bn = ref[kind]["bn"]
    assert (len(bn) > 0) == (kind != "sr")
    n_mean = len(bn) // 2  # the running means, then the variances
    for r in range(WORLD):
        for i, (g, w) in enumerate(zip(ranks[r][kind]["params"], ref[kind]["params"],
                                       strict=True)):
            np.testing.assert_allclose(g, w, **(dict(rtol=0, atol=4 * lr) if noise[i] else TOL))
        for i, (g, w) in enumerate(zip(ranks[r][kind]["bn"], bn, strict=True)):
            np.testing.assert_allclose(g, w, **(dict(rtol=0, atol=4 * lr) if i < n_mean else TOL))
    for key in ("params", "bn"):
        for g0, g1 in zip(ranks[0][kind][key], ranks[1][kind][key]):
            np.testing.assert_array_equal(g0, g1)


def test_dp_gumbel_selections_match_one_device(runs):
    """MoE's selection counts are the global batch's: the one-device
    counts, on every rank (both Gumbel draws made at the global shape)."""
    ranks, ref, _ = runs
    assert [s.sum() for s in ref["moe"]["selection"]] == [dp_jobs.BATCH] * dp_jobs.N_STEPS
    for r in range(WORLD):
        for got, want in zip(ranks[r]["moe"]["selection"], ref["moe"]["selection"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rank", range(WORLD))
def test_fleet_over_ranks_matches_one_process(runs, rank):
    """S = 4 over 2 ranks: every rank returns all four scenes' kernels, each
    equal to the one-process fleet's, and writes only its own two scenes."""
    ranks, ref, _ = runs
    got, want = ranks[rank]["fleet"], ref["fleet"]
    assert got["kernel_per_band"].shape == (dp_jobs.N_SCENES, 5, 13, 13)
    np.testing.assert_allclose(got["kernel_per_band"], want["kernel_per_band"], **TOL)
    own = [f"scene_{s:03d}" for s in range(2 * rank, 2 * rank + 2)]
    assert got["dirs"] == own and want["dirs"] == [f"scene_{s:03d}" for s in range(4)]


def test_fleet_checkpoint_gathers_every_scene(runs):
    """Rank 0's checkpoint holds every scene's state in scene order, as the
    one-process fleet's does; rank 1 writes none."""
    _, _, tmp = runs
    got = torch.load(tmp / "world" / "fleet_0" / "ckpt" / "step_2", weights_only=True)
    want = torch.load(tmp / "ref" / "ref_fleet" / "ckpt" / "step_2", weights_only=True)
    assert not (tmp / "world" / "fleet_1" / "ckpt").exists()
    assert len(got["scenes"]) == len(want["scenes"]) == dp_jobs.N_SCENES
    for a, b in zip(got["scenes"], want["scenes"]):
        assert a["step"] == b["step"] == 2
        for x, y in zip(a["g_params"]["layers"], b["g_params"]["layers"]):
            np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), **TOL)


def test_sr_scene_tiles_over_ranks(runs):
    """Rank 0 assembles the scene from both ranks' tiles: the one-process
    scene, NaN footprint included; rank 1 returns None."""
    ranks, ref, _ = runs
    got, want = ranks[0]["sr_scene"], ref["sr_scene"]
    assert ranks[1]["sr_scene"] is None and got.shape == want.shape == (5, 160, 144)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **TOL)


def test_cli_data_parallel_end_to_end(runs):
    """train_single_kernel_cli --data-parallel in the 2-rank world: rank 0
    writes the run's artifacts once, equal to the one-process CLI's."""
    ranks, ref, tmp = runs
    assert ranks[0]["cli"] == ranks[1]["cli"] == ref["cli"] == 0
    dp, one = tmp / "world" / "cli", tmp / "ref" / "ref_cli"
    assert sorted(os.listdir(dp)) == sorted(os.listdir(one))
    for name in ("kernel_per_band.npy", "kernel_merged.npy", "kernel_per_band_iter2.npy"):
        np.testing.assert_allclose(np.load(dp / name), np.load(one / name), **TOL)
    rows = [(p / "training_log.txt").read_text().splitlines() for p in (dp, one)]
    assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1]) == 3
    np.testing.assert_allclose(
        [[float(v) for v in r.split(",")] for r in rows[0][1:]],
        [[float(v) for v in r.split(",")] for r in rows[1][1:]], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["single", "moe", "dynamic", "sr"])
def test_mesh_refuses_the_device_pool_and_scan(tmp_path, kind):
    """Under a mesh every trainer refuses the device pool (and the
    KernelGAN family K > 1) with JAX's check_mesh_vs_scan text."""
    mesh = make_mesh(device="cpu")
    pool = tsk.PatchPool(np.ones((4, 5, 32, 32), np.float32))
    cfg_kw = dict(device_pool=True, outdir=str(tmp_path))
    with pytest.raises(ValueError) as e:
        if kind == "single":
            tsk.train_single_kernel(pool, tsk.SingleKernelConfig(**cfg_kw), mesh=mesh,
                                    device="cpu")
        elif kind == "moe":
            tmoe.train_moe(pool, tmoe.MoETrainConfig(**cfg_kw), mesh=mesh, device="cpu")
        elif kind == "dynamic":
            tdyn.train_dynamic(pool, tdyn.DynamicTrainConfig(**cfg_kw), mesh=mesh,
                               device="cpu")
        else:
            tsr.train_sr((np.ones((4, 5, 8, 8), np.float32),) * 2,
                         tsr.SRTrainConfig(**cfg_kw), mesh=mesh, device="cpu")
    if kind != "sr":
        with pytest.raises(ValueError) as j:
            jstate.check_mesh_vs_scan(tsk.SingleKernelConfig(steps_per_call=2), object())
        assert str(e.value) == str(j.value)
        with pytest.raises(ValueError, match="incompatible with device_pool"):
            check_mesh_vs_scan(tsk.SingleKernelConfig(steps_per_call=2), mesh)
    else:
        assert "incompatible with device_pool" in str(e.value)
