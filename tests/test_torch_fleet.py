"""Port parity: fleet KernelGAN training and its CLI (kmsr_tpu_torch vs
kmsr_tpu), on the CPU at tiny widths (G mid_ch 8, D 8x2, HR 32, LR 8,
batch 4).

Against JAX, every scene starts from JAX's `init_training(seed + s)`
weights (converted) and both packages draw the same numpy batches; the
chain-mode run also gets JAX's per-scene `jax.random` crops, injected into
the port's `random_crops` hook keyed by each scene's generator. Kernels and
CSV rows agree at rtol 1e-4 / atol 1e-5 over 4 iterations. Within the port,
scene s of a fleet equals the port's standalone run at seed + s bit for
bit (the same step on the same draws).
"""
import os

import jax
import numpy as np
import pytest
import torch

from kmsr_tpu.data import sampler as jsampler
from kmsr_tpu.io import write_band_stack
from kmsr_tpu.models import discriminator as jd
from kmsr_tpu.models import generator as jg
from kmsr_tpu.train import fleet as jfleet
from kmsr_tpu.train import single_kernel as jsk
from kmsr_tpu_torch import convert
from kmsr_tpu_torch.data import sampler as tsampler
from kmsr_tpu_torch.models import discriminator as td
from kmsr_tpu_torch.models import generator as tg
from kmsr_tpu_torch.pipeline import train_fleet_cli as tcli
from kmsr_tpu_torch.train import fleet as tfleet
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train import state as tstate
from tests.helpers.jax_draws import JaxDraws

TOL = dict(rtol=1e-4, atol=1e-5)


def _cfg(pkg, outdir, mode="chain", **kw):
    sk, gm, dm = (jsk, jg, jd) if pkg == "jax" else (tsk, tg, td)
    fields = dict(
        iters=4, hr_patch_size=32, lr_crop_size=8, batch_size=4, log_every=2,
        kernel_log_every=2, outdir=str(outdir), verbose=False,
        generator=gm.GeneratorConfig(mid_ch=8, forward_mode=mode),
        discriminator=dm.DiscriminatorConfig(base_ch=8, num_blocks=2))
    return sk.SingleKernelConfig(**{**fields, **kw})


def _pools(seed=3, sizes=(6, 9), lr_sizes=(5, 7)):
    """HR pools [n, 5, 32, 32] and native-LR pools [n, 5, 8, 8] per scene."""
    rng = np.random.default_rng(seed)
    hr = [rng.normal(5, 1, (n, 5, 32, 32)).astype(np.float32) for n in sizes]
    lr = [rng.normal(5, 2, (n, 5, 8, 8)).astype(np.float32) for n in lr_sizes]
    return hr, lr


def _torch_state(jax_state, seed):
    """The port's train state from a JAX one (weights and D state
    converted, fresh Adam moments, a generator seeded `seed`)."""
    js = jax.device_get(jax_state)
    g = convert.generator_from_jax(js.g_params, device="cpu")
    d, ds = convert.discriminator_from_jax(js.d_params, js.d_state, device="cpu")
    tx = tstate.make_gan_optimizers(4e-4)
    return tstate.init_gan_state(torch.Generator().manual_seed(seed), g, d, ds, tx, tx)


def _rows(path):
    lines = open(path, encoding="utf-8").read().splitlines()
    return lines[0], np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])


def _assert_runs_close(got, want, tol):
    """Two fleet outputs: kernels, every scene's CSV rows and file names."""
    np.testing.assert_allclose(got["kernel_per_band"], want["kernel_per_band"], **tol)
    np.testing.assert_allclose(got["kernel_merged"], want["kernel_merged"], **tol)
    for fg, fw in zip(got["log_files"], want["log_files"]):
        (hg, rg), (hw, rw) = _rows(fg), _rows(fw)
        assert hg == hw and rg.shape == rw.shape
        np.testing.assert_array_equal(rg[:, 0], rw[:, 0])
        np.testing.assert_allclose(rg, rw, **tol)
        assert sorted(os.listdir(os.path.dirname(fg))) == sorted(os.listdir(os.path.dirname(fw)))


# --------------------------------------------------------------- host helpers
def test_stack_pools_equals_jax():
    rng = np.random.default_rng(0)
    pools = [rng.normal(size=(n, 5, 8, 8)).astype(np.float32) for n in (3, 5, 1)]
    got = tfleet._stack_pools([tsampler.PatchPool(p) for p in pools])
    want = jfleet._stack_pools([jsampler.PatchPool(p) for p in pools])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == [3, 5, 1]
    msgs = []
    for m, s in ((tfleet, tsampler), (jfleet, jsampler)):
        with pytest.raises(ValueError) as e:
            m._stack_pools([s.PatchPool(pools[0]), s.PatchPool(pools[0][:, :, :4])])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("mode", ["chain", "compose"])
@pytest.mark.parametrize("batch,hr", [(16, 256), (16, 128), (4, 32)])
def test_scene_chunk_estimates_equal_jax(mode, batch, hr):
    tc = tsk.SingleKernelConfig(batch_size=batch, generator=tg.GeneratorConfig(forward_mode=mode))
    jc = jsk.SingleKernelConfig(batch_size=batch, generator=jg.GeneratorConfig(forward_mode=mode))
    assert tfleet._activation_bytes_per_scene(tc, hr) == jfleet._activation_bytes_per_scene(jc, hr)
    for s in (1, 3, 8):
        assert tfleet.pick_scene_chunk(tc, s, hr) == jfleet.pick_scene_chunk(jc, s, hr)


# ------------------------------------------------------------ fleet vs JAX
def _jax_fleet(tmp_path, hr, lr, **kw):
    lr_pools = [jsampler.PatchPool(p) for p in lr] if kw.get("real_is_lr") else None
    return jfleet.train_fleet([jsampler.PatchPool(p) for p in hr],
                              _cfg("jax", tmp_path / "jax", seed=7, **kw),
                              scene_names=["a", "b"], progress=False, lr_pools=lr_pools)


def _port_fleet_from_jax_init(tmp_path, monkeypatch, hr, lr, on_init=None, **kw):
    """The port's fleet with every scene started from JAX's init at seed
    7 + s; on_init(state, jax_key) sees each scene's state as it is made."""

    def init(cfg, device):
        js = jsk.init_training(_cfg("jax", "unused", seed=cfg.seed, **kw))
        st = _torch_state(js, cfg.seed)
        if on_init:
            on_init(st, js.rng)
        return st

    monkeypatch.setattr(tfleet, "init_training", init)
    lr_pools = [tsampler.PatchPool(p) for p in lr] if kw.get("real_is_lr") else None
    return tfleet.train_fleet([tsampler.PatchPool(p) for p in hr],
                              _cfg("torch", tmp_path / "torch", seed=7, **kw),
                              scene_names=["a", "b"], progress=False, lr_pools=lr_pools,
                              device="cpu")


def test_fleet_real_is_lr_matches_jax(tmp_path, monkeypatch):
    """K = 1, real_is_lr, no fake noise: no device draws at all, the same
    host batches per scene (HR indices, then LR ones, from seed + s)."""
    hr, lr = _pools()
    want = _jax_fleet(tmp_path, hr, lr, real_is_lr=True)
    got = _port_fleet_from_jax_init(tmp_path, monkeypatch, hr, lr, real_is_lr=True)
    assert got["scene_names"] == want["scene_names"] == ["a", "b"]
    _assert_runs_close(got, want, TOL)


def test_fleet_chain_crops_match_jax(tmp_path, monkeypatch):
    """K = 1, chain mode, random real crops: JAX's per-scene crop draws go
    into the port's `random_crops` hook, keyed by each scene's generator."""
    hr, lr = _pools(seed=4)
    want = _jax_fleet(tmp_path, hr, lr)
    draws = {}
    monkeypatch.setattr(tsk, "random_crops",
                        lambda gen, src, crop: draws[id(gen)].random_crops(gen, src, crop))
    got = _port_fleet_from_jax_init(
        tmp_path, monkeypatch, hr, lr,
        on_init=lambda st, key: draws.__setitem__(id(st.rng), JaxDraws(key, 0)))
    assert len(draws) == 2
    _assert_runs_close(got, want, TOL)


# ------------------------------------------------------------ within the port
@pytest.mark.parametrize("k", [1, 2])
def test_fleet_scene_equals_standalone_run(tmp_path, k):
    """Scene s of a chain fleet equals the port's `train_single_kernel` at
    seed 7 + s on the same pool (the device pool; K = 2 with fake-side
    noise, so every draw comes from the scene's generator): kernels and
    CSV rows bit for bit."""
    hr, _ = _pools(seed=5)
    kw = dict(steps_per_call=k, **({"fake_noise_sigma": (0.1, 0.2, 0.1, 0.3, 0.1)}
                                   if k > 1 else {}))
    fleet = tfleet.train_fleet([tsampler.PatchPool(p) for p in hr],
                               _cfg("torch", tmp_path / "fleet", seed=7, **kw),
                               scene_names=["a", "b"], progress=False, device="cpu")
    for s, pool in enumerate(hr):
        one = tsk.train_single_kernel(
            tsampler.PatchPool(pool),
            _cfg("torch", tmp_path / f"one{s}", seed=7 + s, device_pool=True, **kw),
            progress=False, device="cpu")
        np.testing.assert_array_equal(fleet["kernel_per_band"][s], one["kernel_per_band"])
        assert open(fleet["log_files"][s]).read() == open(one["log_file"]).read()
        for name in ("kernel_iter2.npy", "kernel_per_band_iter4.npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "fleet" / "ab"[s] / name),
                                          np.load(tmp_path / f"one{s}" / name))


def test_real_is_lr_chunked_fleet_equals_one_scene_fleets(tmp_path):
    """K = 2 with real_is_lr (no standalone twin: the standalone trainer
    samples an lr_pool on the host): a 2-scene fleet equals two 1-scene
    fleets at seeds 11 and 12, kernels and CSV bit for bit."""
    hr, lr = _pools(seed=6, sizes=(4, 5), lr_sizes=(3, 6))
    kw = dict(real_is_lr=True, steps_per_call=2)
    two = tfleet.train_fleet([tsampler.PatchPool(p) for p in hr],
                             _cfg("torch", tmp_path / "two", seed=11, **kw),
                             scene_names=["a", "b"], progress=False,
                             lr_pools=[tsampler.PatchPool(p) for p in lr], device="cpu")
    for s in range(2):
        one = tfleet.train_fleet([tsampler.PatchPool(hr[s])],
                                 _cfg("torch", tmp_path / f"one{s}", seed=11 + s, **kw),
                                 scene_names=["only"], progress=False,
                                 lr_pools=[tsampler.PatchPool(lr[s])], device="cpu")
        np.testing.assert_array_equal(two["kernel_per_band"][s], one["kernel_per_band"][0])
        assert open(two["log_files"][s]).read() == open(one["log_files"][0]).read()


def test_resume_equals_uninterrupted_fleet(tmp_path):
    """K = 2: a checkpoint at step 2 of 4, resumed, gives the rows and
    kernels of one uninterrupted run (every scene's generator state is in
    the checkpoint). K = 1 reseeds each scene's host stream at
    seed + s + 2, as JAX does: its resumed run is continuous (rows 1-4,
    every scene at step 4)."""
    hr, _ = _pools(seed=8, sizes=(4, 6))
    pools = [tsampler.PatchPool(p) for p in hr]
    kw = dict(steps_per_call=2, ckpt_every=2, fake_noise_sigma=(0.1,) * 5)
    full = tfleet.train_fleet(pools, _cfg("torch", tmp_path / "full", **kw),
                              progress=False, device="cpu")
    tfleet.train_fleet(pools, _cfg("torch", tmp_path / "cut", iters=2, **kw),
                       progress=False, device="cpu")
    assert tstate.latest_checkpoint_step(str(tmp_path / "cut" / "ckpt")) == 2
    resumed = tfleet.train_fleet(pools, _cfg("torch", tmp_path / "cut", resume=True, **kw),
                                 progress=False, device="cpu")
    assert [st.step for st in resumed["state"]] == [4, 4]
    np.testing.assert_array_equal(resumed["kernel_per_band"], full["kernel_per_band"])
    for a, b in zip(resumed["log_files"], full["log_files"]):
        assert open(a).read() == open(b).read()
    for a, b in zip(tstate.tree_leaves([st.d_params for st in resumed["state"]]),
                    tstate.tree_leaves([st.d_params for st in full["state"]])):
        assert torch.equal(a, b) and a.requires_grad

    kw1 = dict(ckpt_every=2)
    tfleet.train_fleet(pools, _cfg("torch", tmp_path / "k1", iters=2, **kw1),
                       progress=False, device="cpu")
    out = tfleet.train_fleet(pools, _cfg("torch", tmp_path / "k1", resume=True, **kw1),
                             progress=False, device="cpu")
    assert [st.step for st in out["state"]] == [4, 4]
    for f in out["log_files"]:
        header, rows = _rows(f)
        assert header == tsk.LOG_HEADER.strip()
        np.testing.assert_array_equal(rows[:, 0], [1, 2, 3, 4])
        assert np.isfinite(rows).all()


_REFUSALS = {  # (pools, lr side or None, cfg overrides, train_fleet kwargs)
    "no pools": (0, None, {}, {}),
    "K-multiple intervals": (1, None, dict(steps_per_call=3), {}),
    "names per pool": (1, None, {}, dict(scene_names=["a", "b"])),
    "unique names": (2, None, {}, dict(scene_names=["a", "a"])),
    "real_is_lr needs lr_pools": (1, None, dict(real_is_lr=True), {}),
    "lr_pools per scene": (2, 8, dict(real_is_lr=True), dict(scene_names=["a", "b"])),
    "lr side": (1, 16, dict(real_is_lr=True), {}),
    "lr_pools without real_is_lr": (1, 8, {}, {}),
    "scene_chunk divides": (3, None, {}, dict(scene_chunk=2)),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_refusals_match_jax(tmp_path, case):
    n, lr_side, over, kw = _REFUSALS[case]
    rng = np.random.default_rng(9)
    hr = rng.normal(5, 1, (6, 5, 32, 32)).astype(np.float32)
    lr = rng.normal(5, 1, (4, 5, lr_side, lr_side)).astype(np.float32) if lr_side else None
    msgs = []
    for pkg, m, smp, extra in (("jax", jfleet, jsampler, {}),
                               ("torch", tfleet, tsampler, {"device": "cpu"})):
        lr_pools = [smp.PatchPool(lr)] if lr is not None else None
        with pytest.raises(ValueError) as e:
            m.train_fleet([smp.PatchPool(hr)] * n, _cfg(pkg, tmp_path / pkg, **over),
                          progress=False, lr_pools=lr_pools, **kw, **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_scene_parallel_and_multi_process_are_refused(tmp_path, monkeypatch):
    """--scene-parallel runs (a plain process is a one-rank scene mesh) and
    writes every scene's artifacts as the run without it does, bit for
    bit; a multi-process launch without it is refused."""
    pool = tsampler.PatchPool(np.ones((2, 5, 32, 32), np.float32))
    _write_scenes(tmp_path / "root", np.random.default_rng(8), "npy")
    args = ["--patch-root", str(tmp_path / "root"), "--format", "npy", "--iters", "2",
            "--batch-size", "2", "--lr-crop-size", "8", "--log-every", "1",
            "--kernel-log-every", "2", "--fast-forward", "--device", "cpu"]
    assert tcli.main(args + ["--outdir", str(tmp_path / "sp"), "--scene-parallel"]) == 0
    assert tcli.main(args + ["--outdir", str(tmp_path / "one")]) == 0
    for scene in ("sceneA", "sceneB"):
        names = sorted(os.listdir(tmp_path / "one" / scene))
        assert sorted(os.listdir(tmp_path / "sp" / scene)) == names and len(names) == 5
        for name in names:
            assert ((tmp_path / "sp" / scene / name).read_bytes()
                    == (tmp_path / "one" / scene / name).read_bytes())
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="multi-process"):
        tcli.main(["--patch-root", str(tmp_path), "--outdir", str(tmp_path / "o"),
                   "--device", "cpu"])
    with pytest.raises(ValueError, match="multi-process"):
        tfleet.train_fleet([pool], _cfg("torch", tmp_path), device="cpu")


# ------------------------------------------------------------------------ CLI
def _write_scenes(root, rng, fmt, flat=False, names=("sceneA", "sceneB"), n=3, side=32,
                  group="denoised"):
    """n patches per scene, as per-scene subdirectories of root (or one
    flat dir of `<scene>_<gi>_<gj>` files); returns the dirs made."""
    dirs = []
    for name in names:
        d = root if flat else root / name
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            a = rng.normal(5, 1, (5, side, side)).astype(np.float32)
            stem = f"{name}_{i:03d}_000" if flat else f"p{i}"
            if fmt == "npy":
                np.save(d / f"{stem}.npy", a)
            else:
                write_band_stack(d / f"{stem}.nc", group, a, mode="w")
        dirs.append(str(d))
    return sorted(set(dirs))


def _artifacts(outdir, scene):
    d = os.path.join(outdir, scene)
    files = sorted(os.listdir(d))
    shapes = {f: np.load(os.path.join(d, f)).shape for f in files if f.endswith(".npy")}
    lines = open(os.path.join(d, "training_log.txt")).read().splitlines()
    return files, shapes, lines[0], len(lines)


@pytest.mark.parametrize("fmt", ["nc", "npy"])
@pytest.mark.parametrize("source", ["--patch-root", "--patch-dirs", "--patch-dir"])
def test_cli_sources_and_formats(tmp_path, source, fmt):
    """Each source (a root of scene dirs, explicit dirs, one flat dir
    regrouped by scene prefix) in each format: the JAX package's per-scene
    artifact names, header, row count and shapes."""
    rng = np.random.default_rng(10)
    dirs = _write_scenes(tmp_path / "in", rng, fmt, flat=source == "--patch-dir")
    src = {"--patch-root": [str(tmp_path / "in")], "--patch-dirs": dirs,
           "--patch-dir": dirs}[source]
    args = [source, *src, "--format", fmt, "--iters", "2", "--batch-size", "2",
            "--lr-crop-size", "8", "--log-every", "1", "--kernel-log-every", "2"]
    assert tcli.main(args + ["--outdir", str(tmp_path / "out"), "--device", "cpu"]) == 0
    for scene in ("sceneA", "sceneB"):
        files, shapes, header, n_lines = _artifacts(tmp_path / "out", scene)
        assert files == ["kernel_iter2.npy", "kernel_merged.npy", "kernel_per_band.npy",
                         "kernel_per_band_iter2.npy", "training_log.txt"]
        assert shapes["kernel_per_band.npy"] == (5, 13, 13)
        assert shapes["kernel_iter2.npy"] == (13, 13)
        assert header == tsk.LOG_HEADER.strip() and n_lines == 3


def test_cli_real_is_lr_matches_jax_artifacts(tmp_path):
    """The shipped config's flags (compose, real_is_lr from a native-LR
    dir, K = 2, fake noise auto, raw_sum_reg, d-border-crop, d-lr) through
    both CLIs on one flat input: the same files, header, row count and
    shapes; `fake_noise_sigma` equals JAX's inline estimate."""
    from kmsr_tpu.ops.sigma import estimate_sigma_np as j_sigma
    from kmsr_tpu.pipeline import train_fleet_cli as jcli

    rng = np.random.default_rng(11)
    dirs = _write_scenes(tmp_path / "in", rng, "nc", flat=True)
    _write_scenes(tmp_path / "lr", rng, "nc", flat=True, n=4, side=8,
                  group="geophysical_data")
    args = ["--patch-dir", dirs[0], "--format", "nc", "--real-is-lr",
            "--real-lr-dir", str(tmp_path / "lr"), "--fake-noise", "auto",
            "--raw-sum-reg", "0.1", "--d-border-crop", "1", "--d-lr", "2e-4",
            "--steps-per-call", "2", "--fast-forward", "--iters", "4",
            "--batch-size", "2", "--lr-crop-size", "8", "--log-every", "2",
            "--kernel-log-every", "2"]
    assert jcli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["--outdir", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    for scene in ("sceneA", "sceneB"):
        assert _artifacts(tmp_path / "torch", scene) == _artifacts(tmp_path / "jax", scene)

    lr_pools = [tsampler.PatchPool.from_files(
        sorted(str(p) for p in (tmp_path / "lr").glob(f"{s}_*.nc")), group="geophysical_data")
        for s in ("sceneA", "sceneB")]
    want = np.median([[np.median([j_sigma(p[b]) for p in pool.patches[:64]])
                       for b in range(5)] for pool in lr_pools], axis=0)
    np.testing.assert_array_equal(tcli.fake_noise_sigma(lr_pools), want)
