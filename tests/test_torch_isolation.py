"""The port stands alone: no JAX, nothing of kmsr_tpu, no silent CPU fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kmsr_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parent.parent


#: the port's copies of the JAX package's SR quality scripts
PORT_SCRIPTS = ("torch_make_quality_scenes.py", "torch_quality_report.py",
                "torch_native_lr_eval.py")


def _port_sources():
    files = sorted((REPO / "kmsr_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += [REPO / "scripts" / name for name in PORT_SCRIPTS]
    return files


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax_and_no_kmsr_tpu():
    files = _port_sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "optax", "orbax", "kmsr_tpu"):
                bad.append(f"{path.relative_to(REPO)}: import {mod}")
    assert not bad, bad


def test_importing_the_factory_loads_no_jax():
    code = (
        "import sys; import kmsr_tpu_torch.pipeline.factory, "
        "kmsr_tpu_torch.convert, kmsr_tpu_torch.kernels, "
        "kmsr_tpu_torch.pipeline.degrade_scene, "
        "kmsr_tpu_torch.parallel.spatial, "
        "kmsr_tpu_torch.pipeline.train_single_kernel_cli, "
        "kmsr_tpu_torch.train, kmsr_tpu_torch.models, kmsr_tpu_torch.losses, "
        "kmsr_tpu_torch.analysis, kmsr_tpu_torch.data, "
        "kmsr_tpu_torch.ops.kernel_algebra; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'kmsr_tpu')]; print(bad); "
        "sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_importing_the_data_dag_stages_loads_no_jax():
    """The denoise / noise-pool / cut / check_shapes stages and the modules
    they reach (sigma, NLM, mask, patches, the denoise figure)."""
    code = (
        "import sys; import kmsr_tpu_torch.pipeline.denoise_cli, "
        "kmsr_tpu_torch.pipeline.noise_pool_cli, kmsr_tpu_torch.pipeline.cut, "
        "kmsr_tpu_torch.pipeline.check_shapes, kmsr_tpu_torch.ops, "
        "kmsr_tpu_torch.ops.nlm, kmsr_tpu_torch.ops.sigma, "
        "kmsr_tpu_torch.data.mask, kmsr_tpu_torch.data.patches, "
        "kmsr_tpu_torch.data.noise_pool, kmsr_tpu_torch.analysis.visualize; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'kmsr_tpu', 'matplotlib')]; print(bad); "
        "sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_denoise_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the check is for machines without one")
    from kmsr_tpu_torch.ops import nlm
    from kmsr_tpu_torch.pipeline import denoise_cli

    stack = np.ones((2, 16, 16), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nlm.denoise_stack(stack)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nlm.denoise_batch_dispatch(stack[None])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        denoise_cli.batch_denoise(str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        denoise_cli.main(["--batch", str(tmp_path), "--output", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        denoise_cli.main(["--batch", str(tmp_path), "--output", str(tmp_path / "o"),
                          "--device-batch", "1"])
    assert not (tmp_path / "out").exists() and not (tmp_path / "o").exists()


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without")
    from kmsr_tpu_torch.data import synthetic_pool
    from kmsr_tpu_torch.pipeline import degrade_scene, train_single_kernel_cli
    from kmsr_tpu_torch.pipeline.apply_kernel import apply_kernel_to_folder
    from kmsr_tpu_torch.pipeline.factory import main, run_factory
    from kmsr_tpu_torch.train import SingleKernelConfig, init_training, train_single_kernel

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_factory(str(tmp_path), "k.npy", "pool.npy", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--input-dir", str(tmp_path), "--kernel", "k.npy",
              "--noise-pool", "pool.npy", "--output-dir", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        apply_kernel_to_folder(str(tmp_path), "k.npy", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        degrade_scene.process_scenes(str(tmp_path), "k.npy", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        degrade_scene.main(["--input", str(tmp_path), "--kernel", "k.npy",
                            "--output-dir", str(tmp_path / "o")])
    pool = synthetic_pool(np.random.default_rng(0), n=2, size=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_single_kernel(pool, SingleKernelConfig(outdir=str(tmp_path / "out")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_training(SingleKernelConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_single_kernel_cli.main(["--patch-dir", str(tmp_path),
                                      "--outdir", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    # raised before touching anything
    assert not (tmp_path / "out").exists() and not (tmp_path / "o").exists()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel bindings never run a plain version: a CPU tensor is an
    error (the CPU path is chosen one level up, in ops.degrade_fused and
    ops.degrade_scene_fast)."""
    from kmsr_tpu_torch.kernels import (
        degrade_dense, degrade_stencil, scene_stencil_ext, scene_stencil_raw,
    )

    x = torch.zeros(5, 16, 16, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        degrade_stencil(x, torch.zeros(5, 20, 20), None, torch.zeros(5, 2, 2, 2),
                        layout="chwb", dims=(5, 16, 16, 2), factor=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        degrade_dense(x, torch.zeros(5, 14, 14), None, torch.zeros(5, 8, 8, 2),
                      layout="chwb", factor=2)
    x, comp, out = torch.zeros(5, 16, 16), torch.zeros(5, 20, 20), torch.zeros(5, 2, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scene_stencil_raw(x, x[:, :6], x[:, :6], comp, out, factor=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scene_stencil_ext(x, comp, out[:, :1], factor=8, top=8)


def test_importing_the_moe_and_dynamic_stages_loads_no_jax():
    """The MoE and dynamic trainers, their CLIs and models, and the model
    file modules."""
    code = (
        "import sys; import kmsr_tpu_torch.pipeline.train_moe_cli, "
        "kmsr_tpu_torch.pipeline.train_dynamic_cli, kmsr_tpu_torch.train.moe, "
        "kmsr_tpu_torch.train.dynamic, kmsr_tpu_torch.models.moe, "
        "kmsr_tpu_torch.models.dynamic, kmsr_tpu_torch.utils.params_io, "
        "kmsr_tpu_torch.utils.torch_import; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'kmsr_tpu')]; print(bad); "
        "sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_moe_and_dynamic_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without")
    from kmsr_tpu_torch import convert
    from kmsr_tpu_torch.data import synthetic_pool
    from kmsr_tpu_torch.models import dynamic, moe
    from kmsr_tpu_torch.pipeline import (apply_kernel, factory, train_dynamic_cli,
                                         train_moe_cli)
    from kmsr_tpu_torch.train import dynamic as tdyn
    from kmsr_tpu_torch.train import moe as tmoe
    from kmsr_tpu_torch.utils import torch_import

    out = str(tmp_path / "out")
    pool = synthetic_pool(np.random.default_rng(0), n=2, size=16)
    calls = [
        lambda: train_moe_cli.main(["--patch-dir", str(tmp_path), "--outdir", out]),
        lambda: train_dynamic_cli.main(["--patch-dir", str(tmp_path), "--outdir", out]),
        lambda: tmoe.train_moe(pool, tmoe.MoETrainConfig(outdir=out)),
        lambda: tdyn.train_dynamic(pool, tdyn.DynamicTrainConfig(outdir=out)),
        lambda: tmoe.init_moe_training(tmoe.MoETrainConfig()),
        lambda: tdyn.init_dynamic_training(tdyn.DynamicTrainConfig()),
        lambda: moe.init_moe(),
        lambda: dynamic.init_degradation_model(),
        lambda: factory.run_factory(str(tmp_path), None, "pool.npy", out, moe_path="m"),
        lambda: factory.main(["--input-dir", str(tmp_path), "--moe", "m",
                              "--noise-pool", "pool.npy", "--output-dir", out]),
        lambda: factory.load_moe_for_factory("m"),
        lambda: apply_kernel.apply_kernel_to_folder(str(tmp_path), None, out, moe_path="m"),
        lambda: apply_kernel.main(["--input-dir", str(tmp_path), "--moe", "m",
                                   "--output-dir", out]),
        lambda: torch_import.load_moe_torch_checkpoint("m.pth"),
        lambda: convert.moe_from_jax({}, {}),
        lambda: convert.dynamic_from_jax({}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "out").exists()


def test_importing_the_sr_stages_loads_no_jax():
    """The SR network, metrics, trainer and the three SR stages."""
    code = (
        "import sys; import kmsr_tpu_torch.pipeline.sr_infer, "
        "kmsr_tpu_torch.pipeline.sr_scene, kmsr_tpu_torch.pipeline.train_sr_cli, "
        "kmsr_tpu_torch.train.sr, kmsr_tpu_torch.models.sr, "
        "kmsr_tpu_torch.ops.metrics, kmsr_tpu_torch.convert; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'kmsr_tpu')]; print(bad); "
        "sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sr_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without")
    from kmsr_tpu_torch import convert
    from kmsr_tpu_torch.models import sr
    from kmsr_tpu_torch.pipeline import sr_infer, sr_scene, train_sr_cli
    from kmsr_tpu_torch.train import sr as tsr

    out = str(tmp_path / "out")
    model = str(tmp_path / "m.npz")
    pairs = (np.zeros((2, 5, 4, 4), np.float32), np.zeros((2, 5, 32, 32), np.float32))
    calls = [
        lambda: sr.init_sr(),
        lambda: convert.sr_from_jax({}),
        lambda: sr_infer.load_sr_model(model, sr.SRConfig()),
        lambda: sr_infer.sr_infer_folder(str(tmp_path), model, out),
        lambda: sr_infer.main(["--input-dir", str(tmp_path), "--model", model,
                               "--output-dir", out]),
        lambda: sr_infer.run_batches([], {}, sr.SRConfig(), print),
        lambda: sr_scene.sr_scene({}, np.zeros((5, 8, 8), np.float32)),
        lambda: sr_scene.sr_scene_folder(str(tmp_path), model, out),
        lambda: sr_scene.main(["--input", str(tmp_path), "--model", model,
                               "--output-dir", out]),
        lambda: tsr.init_sr_training(tsr.SRTrainConfig()),
        lambda: tsr.train_sr(pairs, tsr.SRTrainConfig(outdir=out)),
        lambda: train_sr_cli.main(["--train-dir", str(tmp_path), "--outdir", out]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "out").exists()


def test_importing_the_fleet_and_the_dag_loads_no_jax():
    """The fleet trainer and its CLI, the DAG runner, the Landsat
    calibration and the log analyzer (matplotlib and PIL load at first
    use only)."""
    code = (
        "import sys; import kmsr_tpu_torch.pipeline.train_fleet_cli, "
        "kmsr_tpu_torch.train.fleet, kmsr_tpu_torch.pipeline.run_all, "
        "kmsr_tpu_torch.pipeline.calibrate_landsat, kmsr_tpu_torch.io.landsat, "
        "kmsr_tpu_torch.analysis.log_analyzer; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'kmsr_tpu', 'matplotlib', 'PIL')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_fleet_and_dag_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without")
    from kmsr_tpu_torch.data import synthetic_pool
    from kmsr_tpu_torch.pipeline import apply_kernel, factory, run_all, train_fleet_cli
    from kmsr_tpu_torch.train import SingleKernelConfig, train_fleet

    out = str(tmp_path / "out")
    pool = synthetic_pool(np.random.default_rng(0), n=2, size=16)
    cfg_path = tmp_path / "c.json"
    cfg_path.write_text('{"workdir": "%s"}' % out)
    calls = [
        lambda: train_fleet([pool], SingleKernelConfig(outdir=out)),
        lambda: train_fleet_cli.main(["--patch-root", str(tmp_path), "--outdir", out]),
        lambda: factory.run_factory(str(tmp_path), None, "pool.npy", out, kernel_root="r"),
        lambda: factory.main(["--input-dir", str(tmp_path), "--kernel-root", "r",
                              "--noise-pool", "pool.npy", "--output-dir", out]),
        lambda: apply_kernel.apply_kernel_to_folder(str(tmp_path), None, out,
                                                    kernel_root="r"),
        lambda: run_all.run_pipeline({"workdir": out}),
        lambda: run_all.main(["--config", str(cfg_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "out").exists()


def test_running_the_quality_scripts_loads_no_jax():
    """The three quality scripts with what their mains import (the SR model,
    metrics, pairs loader, oracle, kernel loader, sr_scene, params IO, the
    tensor-parallel modules beside them)."""
    code = (
        "import sys, importlib.util; sys.path.insert(0, 'scripts')\n"
        "for n in ('torch_make_quality_scenes', 'torch_quality_report', "
        "'torch_native_lr_eval'):\n"
        "    spec = importlib.util.spec_from_file_location(n, f'scripts/{n}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import kmsr_tpu_torch.analysis.oracle, kmsr_tpu_torch.pipeline.train_sr_cli, "
        "kmsr_tpu_torch.pipeline.apply_kernel, kmsr_tpu_torch.pipeline.sr_scene, "
        "kmsr_tpu_torch.utils.params_io, kmsr_tpu_torch.io.ncio, "
        "kmsr_tpu_torch.data.patches, kmsr_tpu_torch.parallel.gan_sharding, "
        "kmsr_tpu_torch.utils.profiling, kmsr_tpu_torch.pipeline.common\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'kmsr_tpu')]; print(bad); "
        "sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
