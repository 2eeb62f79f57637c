"""Port parity: SR training (`kmsr_tpu_torch.train.sr` and its CLI vs
`kmsr_tpu.train.sr`) on the CPU, at width 8, one block, x4.

Both trainers start from the JAX init (converted; the port's
`init_sr_training` is monkeypatched) and draw the same batches (host
numpy from seed + start_iter). Tolerances: the loss at rtol 1e-4;
gradients at rtol 1e-4 / atol 1e-5 of the tree's largest entry
(`_scaled_tol`); parameters after one Adam step within Adam's first-step
bound (`_assert_adam_step_close`); the schedule at rtol 1e-6 (optax
computes it in float32); the CSV rows at their printed precision plus
rtol 1e-4 (L1) and 1e-5 (PSNR).
"""
import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kmsr_tpu.io import GROUP_HR, GROUP_LR, write_band_stack
from kmsr_tpu.models import sr as jsr
from kmsr_tpu.pipeline import sr_infer as jinfer
from kmsr_tpu.train import sr as jtrain
from kmsr_tpu_torch import convert
from kmsr_tpu_torch.models import sr as tsr
from kmsr_tpu_torch.parallel.mesh import make_mesh
from kmsr_tpu_torch.pipeline import sr_infer as tinfer
from kmsr_tpu_torch.pipeline import train_sr_cli as tcli
from kmsr_tpu_torch.train import sr as ttrain
from kmsr_tpu_torch.train.state import ClippedAdam, restore_checkpoint, tree_leaves
from tests.test_torch_moe import _assert_adam_step_close, _assert_tree_close, _scaled_tol

MODEL = dict(width=8, n_blocks=1, factor=4)


def _pairs(n=12, seed=0):
    rng = np.random.default_rng(seed)
    hr = rng.normal(3.0, 1.0, (n, 5, 16, 16)).astype(np.float32)
    return hr.reshape(n, 5, 4, 4, 4, 4).mean(axis=(3, 5)), hr


def _cfgs(tmp_path, **kw):
    kw = {"iters": 4, "batch_size": 2, "log_every": 1, "eval_every": 2,
          "compute_dtype": "float32", **kw}
    return (jtrain.SRTrainConfig(model=jsr.SRConfig(**MODEL), outdir=str(tmp_path / "jax"), **kw),
            ttrain.SRTrainConfig(model=tsr.SRConfig(**MODEL), outdir=str(tmp_path / "port"), **kw))


@pytest.fixture
def jax_init(monkeypatch):
    """Start the port's trainer from JAX's init (seeded like JAX's trainer)."""

    def init(cfg, device="cuda"):
        jparams = jsr.init_sr(jax.random.PRNGKey(cfg.seed), jsr.SRConfig(**MODEL))
        params = ttrain._trainable(convert.sr_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), device))
        return ttrain.SRTrainState(0, params, ttrain.make_optimizer(cfg).init(params))

    monkeypatch.setattr(ttrain, "init_sr_training", init)


def _rows(path):
    with open(path, encoding="utf-8") as f:
        return list(csv.reader(f))


def _assert_csv_close(got_path, want_path):
    got, want = _rows(got_path), _rows(want_path)
    assert got[0] == want[0] == ["Iteration", "Loss_L1", "Eval_PSNR", "Eval_SSIM"]
    assert len(got) == len(want)
    # printed to 6 / 4 / 6 decimals: one unit of the last place, plus rtol
    for g, w in zip(got[1:], want[1:]):
        assert g[0] == w[0] and (g[2] == "") == (w[2] == "")
        np.testing.assert_allclose(float(g[1]), float(w[1]), rtol=1e-4, atol=1.01e-6)
        if w[2]:
            np.testing.assert_allclose(float(g[2]), float(w[2]), rtol=1e-5, atol=1.01e-4)
            np.testing.assert_allclose(float(g[3]), float(w[3]), atol=1e-5)


# ------------------------------------------------------------------ optimizer
def test_schedule_matches_optax():
    for lr, iters in ((2e-4, 4), (2e-4, 20_000), (1e-3, 7)):
        want = optax.cosine_decay_schedule(lr, iters, alpha=0.1)
        got = ttrain.cosine_decay(lr, iters, alpha=0.1)
        for t in sorted({0, 1, 2, iters // 2, iters - 1, iters, iters + 3}):
            np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-6)


def test_adam_with_schedule_matches_optax_over_steps():
    """ClippedAdam with a schedule reads the count before its increment,
    as optax.adam(schedule) does: five steps on fixed gradients."""
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [rng.normal(size=(5,)).astype(np.float32)]}
    grads = [jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                                    params) for _ in range(5)]
    tx = optax.adam(optax.cosine_decay_schedule(1e-2, 5, alpha=0.1))
    jp, st = params, tx.init(params)
    mine = ClippedAdam(lr=ttrain.cosine_decay(1e-2, 5), b1=0.9, b2=0.999, max_norm=None)
    tp = {"a": torch.tensor(params["a"]), "b": [torch.tensor(params["b"][0])]}
    ts = mine.init(tp)
    for g in grads:
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        mine.step(tp, [torch.from_numpy(a) for a in jax.tree_util.tree_leaves(g)], ts)
    _assert_tree_close(tp, jp, rtol=1e-5, atol=1e-7)
    assert ts["count"] == 5


# --------------------------------------------------------------- one step
def test_one_step_matches_jax(tmp_path, jax_init):
    jcfg, tcfg = _cfgs(tmp_path)
    lr, hr = _pairs()
    idx = np.array([3, 7])
    jstate = jtrain.init_sr_training(jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jstate.params)

    def loss_fn(p):
        pred = jsr.sr_forward(p, jnp.asarray(lr[idx]), jcfg.model, compute_dtype=jnp.float32)
        return jnp.mean(jnp.abs(pred - jnp.asarray(hr[idx])))

    want_grads = jax.grad(loss_fn)(jparams)
    step_j, _ = jtrain.make_sr_train_step(jcfg)
    new_j, m_j = step_j(jstate, jnp.asarray(lr[idx]), jnp.asarray(hr[idx]))

    state = ttrain.init_sr_training(tcfg, "cpu")
    step_t, _ = ttrain.make_sr_train_step(tcfg)
    new_t, m_t = step_t(state, torch.from_numpy(lr[idx]), torch.from_numpy(hr[idx]))
    assert new_t.step == int(new_j.step) == 1
    np.testing.assert_allclose(float(m_t["l1"]), float(m_j["l1"]), rtol=1e-4)
    _assert_tree_close(m_t["grads"], want_grads, **_scaled_tol(want_grads))
    _assert_adam_step_close(new_t.params, new_j.params, want_grads, tcfg.lr_rate)


def test_bfloat16_step_loss_near_float32(tmp_path):
    """The default bfloat16 step: finite, and its loss within 2 % of the
    float32 step's from the same init and batch (an L1 over outputs whose
    bfloat16 rounding is ~0.4 %)."""
    _, tcfg = _cfgs(tmp_path, compute_dtype="bfloat16")
    lr, hr = _pairs()
    out = []
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(tcfg, compute_dtype=dt)
        state = ttrain.init_sr_training(cfg, "cpu")
        state, m = ttrain.make_sr_train_step(cfg)[0](state, torch.from_numpy(lr[:4]),
                                                       torch.from_numpy(hr[:4]))
        assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params))
        out.append(float(m["l1"]))
    np.testing.assert_allclose(out[0], out[1], rtol=0.02)


# ------------------------------------------------------------------ runs
@pytest.mark.parametrize("holdout", [2, 0])
def test_four_iteration_run_matches_jax(tmp_path, jax_init, holdout):
    """4 iterations from JAX's init, eval every 2: with a holdout tail, and
    without (the eval samples drawn from the batch generator)."""
    jcfg, tcfg = _cfgs(tmp_path, holdout=holdout)
    pairs = _pairs()
    want = jtrain.train_sr(pairs, jcfg, progress=False)
    got = ttrain.train_sr(pairs, tcfg, progress=False, device="cpu")
    _assert_csv_close(got["csv_path"], want["csv_path"])
    assert [t for t, _ in got["log"]] == [t for t, _ in want["log"]] == [1, 2, 3, 4]
    if holdout:
        for k in ("psnr", "ssim"):
            np.testing.assert_allclose(got["final_eval"][k], want["final_eval"][k],
                                       rtol=1e-5, atol=1e-5)
    # the model files: same names; the weights within 2 * lr * iters (Adam's
    # near-sign steps at tiny gradients, compounded over 4 steps)
    jp = jinfer.load_sr_model(want["model_path"], jcfg.model)
    tp = jinfer.load_sr_model(got["model_path"], jcfg.model)
    names = np.load(got["model_path"])
    assert [str(names[k].astype(str)) for k in sorted(names.files) if k.startswith("name_")] \
        == [str(np.load(want["model_path"])[k].astype(str))
            for k in sorted(names.files) if k.startswith("name_")]
    for a, b in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2 * tcfg.lr_rate * tcfg.iters)


def test_device_pool_and_host_batches_agree(tmp_path):
    _, tcfg = _cfgs(tmp_path)
    pairs = _pairs()
    runs = [ttrain.train_sr(pairs, dataclasses.replace(tcfg, device_pool=pool,
                                                       outdir=str(tmp_path / str(pool))),
                            progress=False, device="cpu") for pool in (True, False)]
    assert _rows(runs[0]["csv_path"]) == _rows(runs[1]["csv_path"])
    for a, b in zip(tree_leaves(runs[0]["state"].params), tree_leaves(runs[1]["state"].params)):
        assert torch.equal(a, b)


def test_checkpoint_and_resume(tmp_path):
    _, tcfg = _cfgs(tmp_path, iters=4, ckpt_every=2, log_every=1, eval_every=100)
    pairs = _pairs()
    full = ttrain.train_sr(pairs, tcfg, progress=False, device="cpu")
    ckpt = tmp_path / "port" / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_4"]
    assert full["state"].step == 4
    # resume from step 2: the restored state is the saved one, the run ends at 4
    os.remove(ckpt / "step_4")
    saved = restore_checkpoint(str(ckpt), 2, ttrain.init_sr_training(tcfg, "cpu"))
    assert saved.step == 2 and saved.opt_state["count"] == 2
    assert all(p.requires_grad for p in tree_leaves(saved.params))
    out = ttrain.train_sr(pairs, dataclasses.replace(tcfg, resume=True), progress=False,
                          device="cpu")
    assert out["state"].step == 4 and out["state"].opt_state["count"] == 4
    rows = _rows(out["csv_path"])
    assert rows[0][0] == "Iteration" and [r[0] for r in rows[1:]] == ["1", "2", "3", "4", "3", "4"]
    # an orbax checkpoint directory (the JAX package's) is refused
    os.remove(ckpt / "step_4")
    os.makedirs(ckpt / "step_6")
    with pytest.raises(ValueError, match="orbax"):
        ttrain.train_sr(pairs, dataclasses.replace(tcfg, resume=True, iters=8),
                        progress=False, device="cpu")


def test_refusals(tmp_path):
    """The device pool under a mesh and a holdout as large as the data are
    refused with JAX's texts; a mesh run (one rank, the CLI's
    --data-parallel without torchrun) equals the run without it bit for
    bit."""
    _, tcfg = _cfgs(tmp_path)
    pairs = _pairs()
    mesh = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="incompatible with device_pool"):
        ttrain.train_sr(pairs, dataclasses.replace(tcfg, device_pool=True), mesh=mesh,
                        device="cpu")
    with pytest.raises(ValueError, match="holdout 12 >= dataset size 12"):
        ttrain.train_sr(pairs, dataclasses.replace(tcfg, holdout=12), device="cpu")
    assert not (tmp_path / "port").exists()
    cfg = dataclasses.replace(tcfg, iters=3, log_every=1, eval_every=2)
    dp = ttrain.train_sr(pairs, dataclasses.replace(cfg, outdir=str(tmp_path / "dp")),
                         mesh=mesh, progress=False, device="cpu")
    one = ttrain.train_sr(pairs, dataclasses.replace(cfg, outdir=str(tmp_path / "one")),
                          progress=False, device="cpu")
    assert dp["log"] == one["log"] and dp["final_eval"] == one["final_eval"]
    assert ((tmp_path / "dp" / "training_log.csv").read_bytes()
            == (tmp_path / "one" / "training_log.csv").read_bytes())
    a, b = np.load(tmp_path / "dp" / "sr_model.npz"), np.load(tmp_path / "one" / "sr_model.npz")
    assert a.files == b.files and all(np.array_equal(a[f], b[f]) for f in a.files)


def test_cli_writes_a_model_jax_reads(tmp_path, capsys):
    rng = np.random.default_rng(2)
    (tmp_path / "pairs").mkdir()
    for i in range(6):
        hr = rng.normal(3, 1, (5, 16, 16)).astype(np.float32)
        write_band_stack(str(tmp_path / "pairs" / f"p{i}.nc"), GROUP_HR, hr, mode="w")
        write_band_stack(str(tmp_path / "pairs" / f"p{i}.nc"), GROUP_LR,
                         hr.reshape(5, 4, 4, 4, 4).mean(axis=(2, 4)), mode="a")
    out = tmp_path / "run"
    assert tcli.main(["--train-dir", str(tmp_path / "pairs"), "--outdir", str(out),
                      "--iters", "3", "--batch-size", "2", "--width", "8", "--n-blocks", "1",
                      "--factor", "4", "--holdout", "2", "--eval-every", "3",
                      "--log-every", "1", "--trace", str(tmp_path / "trace"),
                      "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "loaded 6 pairs" in text and "final eval: psnr=" in text
    assert (tmp_path / "trace" / "trace.json").exists()
    lr, hr = tcli.load_pairs(str(tmp_path / "pairs"))
    assert lr.shape == (6, 5, 4, 4) and hr.shape == (6, 5, 16, 16)
    jcfg = jsr.SRConfig(**MODEL)
    jparams = jinfer.load_sr_model(str(out / "sr_model.npz"), jcfg)
    tparams = tinfer.load_sr_model(str(out / "sr_model.npz"), tsr.SRConfig(**MODEL),
                                   device="cpu")
    want = np.asarray(jsr.sr_forward(jparams, jnp.asarray(lr[:2]), jcfg,
                                     compute_dtype=jnp.float32))
    got = tsr.sr_forward(tparams, torch.from_numpy(lr[:2]), tsr.SRConfig(**MODEL),
                         compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
