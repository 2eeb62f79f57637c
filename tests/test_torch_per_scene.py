"""Port parity: per-scene kernel routing (`--kernel-root`, a fleet run's
outdir) of the factory and apply_kernel (kmsr_tpu_torch vs kmsr_tpu).

Both packages run on one synthetic patch directory of two scenes and one
kernel root. JAX's factory runs with backend="pallas" (its Pallas kernels
in interpret mode on this CPU host), the port with device="cpu" (its
kernels' plain versions): the same files come out, hr bit-identical, lr
within rtol 1e-4 / atol 1e-5, the degrade family's tolerance.
"""
import os

import numpy as np
import pytest

from kmsr_tpu.io import read_band_stack as j_read
from kmsr_tpu.pipeline import apply_kernel as japply
from kmsr_tpu.pipeline import common as jcommon
from kmsr_tpu.pipeline import factory as jfactory
from kmsr_tpu_torch.io import GROUP_BLURRED, GROUP_DENOISED, GROUP_HR, GROUP_LR
from kmsr_tpu_torch.io import read_band_stack, write_band_stack
from kmsr_tpu_torch.pipeline import apply_kernel as tapply
from kmsr_tpu_torch.pipeline import common as tcommon
from kmsr_tpu_torch.pipeline import factory as tfactory

TOL = dict(rtol=1e-4, atol=1e-5)
SCENES = ("sceneA", "sceneB")


def _patch_dir(tmp_path, rng, fmt="nc", scenes=SCENES, n=3, size=32):
    d = tmp_path / f"patches_{fmt}"
    d.mkdir()
    for s in scenes:
        for i in range(n):
            x = rng.normal(5, 1, (5, size, size)).astype(np.float32)
            stem = f"{s}_{i:03d}_000_denoised"
            if fmt == "npy":
                np.save(d / f"{stem}.npy", x)
            else:
                write_band_stack(d / f"{stem}.nc", GROUP_DENOISED, x, mode="w")
    return d


def _kernel_root(tmp_path, rng, scenes=SCENES):
    root = tmp_path / "fleet_out"
    for s in scenes:
        os.makedirs(root / s)
        k = rng.uniform(0, 1, (5, 13, 13)).astype(np.float32)
        np.save(root / s / "kernel_per_band.npy", k / k.sum(axis=(1, 2), keepdims=True))
    return root


@pytest.mark.parametrize("scene", ["sceneA", "sceneB", "LC08_L1TP_115035_20210317", ""])
@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_scene_seed_equals_jax(seed, scene):
    assert tfactory.scene_seed(seed, scene) == jfactory.scene_seed(seed, scene)


def test_routing_report_equals_jax(tmp_path, capsys):
    """`route_per_scene_kernels` with a stub scene runner: the same calls,
    the same merged report and the same summary line as JAX's."""
    files = [f"/x/{s}_{i:03d}_000.nc" for s in ("a", "b", "c") for i in range(2)]
    root = tmp_path / "root"
    for s in ("a", "c"):
        os.makedirs(root / s)
        np.save(root / s / "kernel_per_band.npy", np.ones((5, 3, 3), np.float32))
    reports = []
    for m in (jcommon, tcommon):
        calls = []

        def run(scene, k_path, scene_files, m=m, calls=calls):
            calls.append((scene, os.path.relpath(k_path, root), scene_files))
            return m.RunReport(succeeded=scene_files[:1], failed=[(scene_files[1], "x")],
                               seconds=0.0)

        rep = m.route_per_scene_kernels(files, str(root), run, "stage", "OUT")
        line = capsys.readouterr().out.strip().rsplit(" in ", 1)[0]
        reports.append((calls, rep.succeeded, rep.failed, line))
    assert reports[0] == reports[1]
    assert [c[0] for c in reports[1][0]] == ["a", "c"]


@pytest.mark.parametrize("fmt", ["nc", "npy"])
def test_factory_kernel_root_matches_jax(tmp_path, fmt):
    """The factory's per-scene route: each scene's files through its kernel
    and its noise seed `scene_seed(42, scene)`; the CLI's --kernel-root
    on the port. hr bit-identical, lr at the tolerance; the scenes' lr
    differ (their kernels do)."""
    rng = np.random.default_rng(20)
    patches = _patch_dir(tmp_path, rng, fmt)
    root = _kernel_root(tmp_path, rng)
    pool = tmp_path / "pool.npy"
    np.save(pool, rng.normal(0, 0.1, (7, 5, 4, 4)).astype(np.float32))
    rep_j = jfactory.run_factory(str(patches), None, str(pool), str(tmp_path / "jax"),
                                 kernel_root=str(root), backend="pallas", progress=False)
    assert tfactory.main(["--input-dir", str(patches), "--kernel-root", str(root),
                          "--noise-pool", str(pool), "--output-dir", str(tmp_path / "torch"),
                          "--device", "cpu"]) == 0
    assert rep_j.n_fail == 0 and rep_j.n_ok == 6
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names and len(names) == 6
    for name in names:
        np.testing.assert_array_equal(read_band_stack(str(tmp_path / "torch" / name), GROUP_HR),
                                      j_read(str(tmp_path / "jax" / name), GROUP_HR))
        np.testing.assert_allclose(read_band_stack(str(tmp_path / "torch" / name), GROUP_LR),
                                   j_read(str(tmp_path / "jax" / name), GROUP_LR), **TOL)
    a, b = (read_band_stack(str(tmp_path / "torch" / f"{s}_000_000_denoised_train.nc"),
                            GROUP_LR) for s in SCENES)
    assert np.abs(a - b).max() > 1e-3


def test_missing_scene_fails_as_a_unit(tmp_path):
    """A scene with no kernel under the root fails all of its files with
    JAX's message; the other scene's files come out."""
    rng = np.random.default_rng(21)
    patches = _patch_dir(tmp_path, rng, "nc")
    root = _kernel_root(tmp_path, rng, scenes=("sceneA",))
    pool = tmp_path / "pool.npy"
    np.save(pool, rng.normal(0, 0.1, (7, 5, 4, 4)).astype(np.float32))
    reps = [m.run_factory(str(patches), None, str(pool), str(tmp_path / name),
                          kernel_root=str(root), progress=False, **kw)
            for m, name, kw in ((jfactory, "jax", {"backend": "xla"}),
                                (tfactory, "torch", {"device": "cpu"}))]
    for rep in reps:
        assert rep.n_ok == 3 and rep.n_fail == 3
        assert all("sceneB" in msg for _, msg in rep.failed)
    assert reps[0].failed == reps[1].failed
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))


def test_exactly_one_kernel_source(tmp_path):
    msgs = []
    for m, kw in ((jfactory, {}), (tfactory, {"device": "cpu"})):
        for srcs in (dict(kernel_path="k.npy", kernel_root="root"), {}):
            path = srcs.pop("kernel_path", None)
            with pytest.raises(ValueError) as e:
                m.run_factory(str(tmp_path), path, "pool.npy", str(tmp_path / "o"),
                              progress=False, **srcs, **kw)
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:] and "exactly one" in msgs[0]


def test_apply_kernel_kernel_root_matches_jax(tmp_path):
    """apply_kernel's per-scene route through both packages: the same
    files, the blurred group at the tolerance; the port's CLI too."""
    rng = np.random.default_rng(22)
    patches = _patch_dir(tmp_path, rng, "nc")
    root = _kernel_root(tmp_path, rng)
    rep_j = japply.apply_kernel_to_folder(str(patches), None, str(tmp_path / "jax"),
                                          kernel_root=str(root), progress=False)
    assert tapply.main(["--input-dir", str(patches), "--kernel-root", str(root),
                        "--output-dir", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    assert rep_j.n_fail == 0 and rep_j.n_ok == 6
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names
    for name in names:
        np.testing.assert_allclose(read_band_stack(str(tmp_path / "torch" / name), GROUP_BLURRED),
                                   j_read(str(tmp_path / "jax" / name), GROUP_BLURRED), **TOL)
        np.testing.assert_array_equal(
            read_band_stack(str(tmp_path / "torch" / name), GROUP_DENOISED),
            j_read(str(tmp_path / "jax" / name), GROUP_DENOISED))
