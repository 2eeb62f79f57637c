"""The SR family on the card against the port's CPU path (marked `cuda`:
they skip on hosts without a card). On the card:
python -m pytest tests/test_torch_sr_card.py -m cuda

Imports torch and the port only (the card's machine has no h5py for the
JAX package's `io`). Tolerances: float32 at rtol 1e-4 / atol 1e-5, or, as
float32's reduction order allows through a deep net, the card no further
from a float64 run on the card than twice the CPU's float32 is
(`_f32_close`); bfloat16 no further from the CPU's float32 than twice the
CPU's own bfloat16; gradients at rtol 1e-4 / atol 1e-5 of the largest
(or the float64 rule); parameters after one Adam step within Adam's
first-step bound.
"""
import numpy as np
import pytest
import torch

from kmsr_tpu_torch.models import sr as tsr
from kmsr_tpu_torch.models import swinir as sw
from kmsr_tpu_torch.ops.metrics import psnr, ssim
from kmsr_tpu_torch.pipeline import sr_infer, sr_scene
from kmsr_tpu_torch.train import sr as ttrain
from kmsr_tpu_torch.train.state import tree_leaves, tree_map

RTOL, ATOL = 1e-4, 1e-5
CONFIGS = [dict(width=16, n_blocks=2, factor=8), dict(width=16, n_blocks=2, factor=4),
           dict(width=8, n_blocks=1, factor=6, upsampler="oneshot")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to(params, dev, dtype=torch.float32):
    """A copy of params on dev in dtype (never the same tensors: a train
    step updates its parameters in place)."""
    return tree_map(lambda t: t.detach().to(dev, dtype, copy=True), params)


def _f32_close(card, cpu, f64) -> bool:
    """card within RTOL / ATOL of cpu, or no further from f64 than twice
    the CPU is (max norms)."""
    card, cpu, f64 = (t.detach().cpu().double() for t in (card, cpu, f64))
    if torch.allclose(card, cpu, rtol=RTOL, atol=ATOL):
        return True
    return float((card - f64).abs().max()) <= 2 * max(float((cpu - f64).abs().max()), ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CONFIGS)))
def test_card_forward_matches_cpu(cuda, case):
    cfg = tsr.SRConfig(**CONFIGS[case])
    params = tsr.init_sr(cfg, seed=case, device="cpu")
    x = torch.from_numpy(np.random.default_rng(case).normal(
        2.0, 1.0, (4, 5, 16, 16)).astype(np.float32))
    cpu32 = tsr.sr_forward(params, x, cfg, compute_dtype=torch.float32)
    card32 = tsr.sr_forward(_to(params, cuda), x.to(cuda), cfg, compute_dtype=torch.float32)
    f64 = tsr.sr_forward(_to(params, cuda, torch.float64), x.to(cuda).double(), cfg,
                         compute_dtype=torch.float64)
    assert _f32_close(card32, cpu32, f64)
    cpu16 = tsr.sr_forward(params, x, cfg)
    card16 = tsr.sr_forward(_to(params, cuda), x.to(cuda), cfg).cpu()
    assert float((card16 - cpu32).abs().max()) <= 2 * float((cpu16 - cpu32).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("factor,hw", [(2, (10, 6)), (8, (8, 8))])
def test_card_swinir_forward_matches_cpu(cuda, factor, hw):
    """SwinIR (embed 24, depths (2, 2), heads (2, 2), window 4) on the card,
    through its fused attention, against the port on the CPU by the rules
    above; weights fan-in uniform (qkv twice), tables in +-6."""
    _swinir_card_case(cuda, factor, hw, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("factor,hw", [(2, (10, 6)), (8, (8, 8))])
def test_card_padded_swinir_forward_matches_cpu(cuda, factor, hw):
    """As above at embed 20, whose stream is carried 24 wide (the row norm
    over the first 20 of each row, in every dtype)."""
    _swinir_card_case(cuda, factor, hw, 20)


def _swinir_card_case(cuda, factor, hw, embed):
    cfg = sw.SwinIRConfig(embed_dim=embed, depths=(2, 2), num_heads=(2, 2), window_size=4,
                          factor=factor)
    gen = torch.Generator().manual_seed(factor)
    params = {k: (torch.rand(s, generator=gen) * 2 - 1) * (
        6.0 if k.endswith("table") else 1.0 if len(s) == 1 else 2.0 / np.sqrt(np.prod(s[1:])))
        for k, s in sw.param_shapes(cfg).items()}
    x = torch.from_numpy(np.random.default_rng(factor).standard_normal((3, 5, *hw))
                         .astype(np.float32))
    cpu32 = sw.swinir_forward(params, x, cfg, torch.float32)
    card32 = sw.swinir_forward(_to(params, cuda), x.to(cuda), cfg, torch.float32)
    f64 = sw.swinir_forward(_to(params, cuda, torch.float64), x.to(cuda).double(), cfg,
                            torch.float64)
    assert _f32_close(card32, cpu32, f64)
    cpu16 = sw.swinir_forward(params, x, cfg)
    card16 = sw.swinir_forward(_to(params, cuda), x.to(cuda), cfg).cpu()
    assert float((card16 - cpu32).abs().max()) <= 2 * float((cpu16 - cpu32).abs().max())


@pytest.mark.cuda
def test_card_sr_scene_tiled_equals_untiled_and_cpu(cuda):
    cfg = tsr.SRConfig(width=8, n_blocks=2, factor=4)
    params = tsr.init_sr(cfg, seed=1, device="cpu")
    scene = np.random.default_rng(9).normal(3, 1, (5, 50, 70)).astype(np.float32)
    scene[:, 5:9, 30:33] = np.nan
    got = sr_scene.sr_scene(_to(params, cuda), scene, cfg, tile=32, chunk=4,
                            compute_dtype=torch.float32, device=cuda)
    cpu = sr_scene.sr_scene(params, scene, cfg, tile=32, chunk=4,
                            compute_dtype=torch.float32, device="cpu")
    filled = torch.from_numpy(sr_scene._band_filled(scene, np.isfinite(scene)))[None]
    whole = tsr.sr_forward(_to(params, cuda), filled.to(cuda), cfg,
                           compute_dtype=torch.float32)[0].cpu().numpy()
    nan = np.isnan(scene).repeat(4, axis=1).repeat(4, axis=2)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.isnan(cpu), nan)
    np.testing.assert_allclose(got[~nan], whole[~nan], atol=2e-5, rtol=1e-5)
    f64 = tsr.sr_forward(_to(params, cuda, torch.float64), filled.to(cuda).double(), cfg,
                         compute_dtype=torch.float64)[0]
    assert _f32_close(torch.from_numpy(got[~nan]), torch.from_numpy(cpu[~nan]),
                      f64.cpu()[torch.from_numpy(~nan)])


@pytest.mark.cuda
def test_card_run_batches_matches_cpu(cuda):
    cfg = tsr.SRConfig(width=8, n_blocks=1, factor=4)
    params = tsr.init_sr(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(4)
    items = [(rng.normal(3, 1, (5, 8, 8)).astype(np.float32),
              rng.normal(3, 1, (5, 32, 32)).astype(np.float32)) for _ in range(6)]
    chunks = [([f"p{i}" for i in range(j, j + 3)], items[j:j + 3], []) for j in (0, 3)]
    seen = []
    assert sr_infer.run_batches(chunks, _to(params, cuda), cfg,
                                lambda p, preds, m: seen.append((p, preds, m)), cuda) == []
    assert [p for p, _, _ in seen] == [["p0", "p1", "p2"], ["p3", "p4", "p5"]]
    for paths, preds, mets in seen:
        idx = [int(p[1:]) for p in paths]
        lr = torch.from_numpy(np.stack([items[i][0] for i in idx]))
        want = tsr.sr_forward(_to(params, cuda), lr.to(cuda), cfg).cpu().numpy()
        np.testing.assert_array_equal(preds, want)
        for k, i in enumerate(idx):
            h = torch.from_numpy(items[i][1])
            dr = float(h.max() - h.min())
            p = torch.from_numpy(preds[k])
            np.testing.assert_allclose(mets[k], [float(psnr(p, h, dr)), float(ssim(p, h, dr))],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_card_run_batches_kept_views_stay_own_groups(cuda):
    """Six groups of one shape, every preds / metrics the callback gets
    kept to the end: each is a view of pinned memory (no host copy), no
    two share memory, and each still equals its own group's forward and
    metrics, so no kept buffer went back to the allocator and was reused."""
    cfg = tsr.SRConfig(width=8, n_blocks=1, factor=4)
    params = _to(tsr.init_sr(cfg, seed=3, device="cpu"), cuda)
    rng = np.random.default_rng(7)
    items = [(rng.normal(3, 1, (5, 8, 8)).astype(np.float32),
              rng.normal(3, 1, (5, 32, 32)).astype(np.float32)) for _ in range(24)]
    chunks = [([f"p{i}" for i in range(j, j + 4)], items[j:j + 4], []) for j in range(0, 24, 4)]
    seen = []
    assert sr_infer.run_batches(chunks, params, cfg,
                                lambda p, preds, m: seen.append((p, preds, m)), cuda) == []
    assert len(seen) == 6
    for paths, preds, mets in seen:
        assert preds.shape == (4, 5, 32, 32) and mets.shape == (4, 2)
        assert torch.from_numpy(preds).is_pinned() and torch.from_numpy(mets).is_pinned()
    views = [v for _, preds, mets in seen for v in (preds, mets)]
    assert not any(np.shares_memory(a, b)
                   for i, a in enumerate(views) for b in views[i + 1:])
    for paths, preds, mets in seen:
        idx = [int(p[1:]) for p in paths]
        lr = torch.from_numpy(np.stack([items[i][0] for i in idx])).to(cuda)
        hr = torch.from_numpy(np.stack([items[i][1] for i in idx])).to(cuda)
        want = tsr.sr_forward(params, lr, cfg)
        np.testing.assert_array_equal(preds, want.cpu().numpy())
        dr = sr_infer.data_range(hr)
        np.testing.assert_allclose(
            mets, torch.stack([psnr(want, hr, dr), ssim(want, hr, dr)], dim=1).cpu().numpy(),
            rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_card_train_step_matches_cpu(tmp_path, cuda):
    """One float32 step (TF32 off, backward included) from the same weights:
    loss at RTOL, gradients at RTOL / ATOL of the largest (or the float64
    rule), parameters within Adam's first-step bound."""
    cfg = ttrain.SRTrainConfig(compute_dtype="float32", outdir=str(tmp_path),
                               model=tsr.SRConfig(width=8, n_blocks=1, factor=4))
    rng = np.random.default_rng(5)
    hr = rng.normal(3.0, 1.0, (4, 5, 16, 16)).astype(np.float32)
    lr = hr.reshape(4, 5, 4, 4, 4, 4).mean(axis=(3, 5))
    base = tsr.init_sr(cfg.model, seed=0, device="cpu")
    got = []
    for dev in ("cpu", cuda):
        params = ttrain._trainable(_to(base, dev))
        state = ttrain.SRTrainState(0, params, ttrain.make_optimizer(cfg).init(params))
        state, m = ttrain.make_sr_train_step(cfg)[0](
            state, torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev))
        got.append((float(m["l1"]), [g.cpu().double() for g in tree_leaves(m["grads"])],
                    [p.detach().cpu().double() for p in tree_leaves(state.params)]))
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = got
    np.testing.assert_allclose(l_card, l_cpu, rtol=RTOL)
    p64 = tree_map(lambda t: t.requires_grad_(True), _to(base, cuda, torch.float64))
    pred = tsr.sr_forward(p64, torch.from_numpy(lr).to(cuda).double(), cfg.model,
                          compute_dtype=torch.float64)
    g64 = torch.autograd.grad((pred - torch.from_numpy(hr).to(cuda).double()).abs().mean(),
                              tree_leaves(p64))
    scale = max(float(g.abs().max()) for g in g_cpu)
    for a, b, c in zip(g_card, g_cpu, g64):
        assert torch.allclose(a, b, rtol=RTOL, atol=ATOL * scale) or \
            _f32_close(a, b, c)
    for p, q, g in zip(p_card, p_cpu, g_cpu):
        g = g.abs()
        bound = ATOL + RTOL * q.abs() + cfg.lr_rate * torch.clamp(
            (ATOL * scale + RTOL * g) / (g + 1e-8), max=2.0)
        assert bool(((p - q).abs() <= bound).all())
