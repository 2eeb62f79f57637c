"""Port parity: the DAG runner (`pipeline.run_all`), the training-log
analyzer and the Landsat calibration head (kmsr_tpu_torch vs kmsr_tpu), on
the CPU.

The runner is held to JAX's in what it runs: with every stage's `main`
swapped for a recorder in both packages, each config (the three shipped
ones and variants that reach every stage) gives the same stage sequence
and argv, the port adding `--device DEVICE` to the stages whose CLI takes
it. The marker chain is held the same way. Then the port's own stages run
a tiny DAG end to end (trainer single and fleet), and the port's factory
runs on a workdir JAX's runner made, its pairs equal to JAX's (hr
identical, lr at rtol 1e-4 / atol 1e-5). The analyzer's numbers and
report, and the calibrated NetCDF files, equal JAX's exactly: both are the
same host numpy.
"""
import copy
import importlib
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from kmsr_tpu.analysis import log_analyzer as jlog
from kmsr_tpu.io import NCFile as JNCFile
from kmsr_tpu.io import landsat as jland
from kmsr_tpu.io import read_band_stack as j_read
from kmsr_tpu.io import write_band_stack
from kmsr_tpu.io.schema import GROUP_GEO
from kmsr_tpu.pipeline import run_all as jrun
from kmsr_tpu_torch.analysis import log_analyzer as tlog
from kmsr_tpu_torch.io import landsat as tland
from kmsr_tpu_torch.io import read_band_stack
from kmsr_tpu_torch.pipeline import calibrate_landsat as tcal
from kmsr_tpu_torch.pipeline import run_all as trun
from tests.helpers.landsat_fixtures import make_landsat_scene

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-5)
STAGE_MODULES = (
    "pipeline.calibrate_landsat", "pipeline.cut", "pipeline.denoise_cli",
    "pipeline.noise_pool_cli", "pipeline.train_single_kernel_cli",
    "pipeline.train_fleet_cli", "pipeline.train_dynamic_cli",
    "pipeline.train_moe_cli", "pipeline.factory", "pipeline.apply_kernel",
    "pipeline.make_train_data", "pipeline.check_shapes", "pipeline.train_sr_cli",
    "pipeline.sr_infer", "pipeline.sr_scene", "analysis.log_analyzer",
)


def _record_stages(monkeypatch, pkg: str) -> list:
    """Swap every stage's main in `pkg` for a recorder of (module, argv)."""
    calls = []
    for name in STAGE_MODULES:
        mod = importlib.import_module(f"{pkg}.{name}")
        monkeypatch.setattr(mod, "main", lambda argv, n=name: calls.append((n, list(argv))))
    return calls


def _shipped(name):
    return json.loads((REPO / "configs" / name).read_text())


def _everything(trainer, fused):
    """Every stage on: calibrate, cut_lr, the SR stages, analyze."""
    return {"trainer": trainer, "landsat_root": "raw", "lr_input_dir": "lr_scenes",
            "use_fused_factory": fused, "kernel_file": None,
            "stages": {"calibrate": {"enabled": True}, "cut_lr": {"enabled": True},
                       "train_kernel": {"real_is_lr": trainer == "fleet"},
                       "sr_train": {"enabled": True}, "sr_infer": {"enabled": True},
                       "sr_scene": {"enabled": True}}}


CONFIGS = {
    "quality_x8": lambda: _shipped("quality_x8.json"),
    "quality_x8_real_lr": lambda: _shipped("quality_x8_real_lr.json"),
    "quality_x4_moe": lambda: _shipped("quality_x4_moe.json"),
    "single, apply + make": lambda: _everything("single", False),
    "fleet, apply + make": lambda: _everything("fleet", False),
    "fleet, fused": lambda: _everything("fleet", True),
    "dynamic": lambda: _everything("dynamic", True),
    "kernel_file": lambda: {"kernel_file": "k.npy",
                            "stages": {"train_kernel": {"enabled": False}}},
}


def test_default_config_and_argv_equal_jax():
    assert trun.DEFAULT_CONFIG == jrun.DEFAULT_CONFIG
    blocks = [{"enabled": True, "patch_size": 256, "stride_ratio": 0.5},
              {"bands": [1, 2, 3], "real_is_lr": True, "fast_forward": False,
               "fake_noise": "auto", "raw_sum_reg": 0.1, "d_lr": None}, {}]
    for block in blocks:
        assert trun._argv(block, outdir="o", x_y=3) == jrun._argv(block, outdir="o", x_y=3)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stage_argv_equals_jax_plus_device(tmp_path, monkeypatch, name):
    """The same stages in the same order with JAX's argv; the stages whose
    CLI takes --device get `--device cpu` appended, the others nothing."""
    runs = {}
    for pkg, mod, kw in (("kmsr_tpu", jrun, {}), ("kmsr_tpu_torch", trun, {"device": "cpu"})):
        cfg = CONFIGS[name]()
        cfg["workdir"] = str(tmp_path / "work")  # the same paths in both argv
        shutil.rmtree(tmp_path / "work", ignore_errors=True)
        calls = _record_stages(monkeypatch, pkg)
        timings = mod.run_pipeline(cfg, **kw)
        runs[pkg] = (list(timings), calls)
    (j_stages, j_calls), (t_stages, t_calls) = runs["kmsr_tpu"], runs["kmsr_tpu_torch"]
    assert t_stages == j_stages and len(t_calls) == len(j_calls)
    # the fleet's analyze stage calls the analyzer once a log: none here
    called = j_stages[:len(j_calls)]
    assert len(called) == len(j_calls) and set(j_stages) - set(called) <= {"analyze"}
    for stage, (jm, ja), (tm, ta) in zip(called, j_calls, t_calls):
        assert jm == tm
        assert ta == ja + (["--device", "cpu"] if stage in trun.DEVICE_STAGES else []), stage


def test_shipped_real_lr_config_parses_in_the_fleet_cli(tmp_path, monkeypatch):
    """Every flag run_all gives the fleet stage for
    configs/quality_x8_real_lr.json parses in the port's train_fleet_cli."""
    from kmsr_tpu_torch.pipeline import train_fleet_cli

    calls = _record_stages(monkeypatch, "kmsr_tpu_torch")
    cfg = _shipped("quality_x8_real_lr.json")
    cfg["workdir"] = str(tmp_path / "work")
    trun.run_pipeline(cfg, only=["train_kernel"], device="cpu")
    (mod, argv), = calls
    assert mod == "pipeline.train_fleet_cli"
    a = train_fleet_cli.build_parser().parse_args(argv)
    assert (a.real_is_lr, a.steps_per_call, a.fast_forward, a.fake_noise, a.raw_sum_reg,
            a.iters, a.format, a.device) == (True, 20, True, "auto", 0.1, 2000, "nc", "cpu")


def _chain_runs(mod, monkeypatch, pkg, tmp_path, **kw):
    """JAX's marker-chain scenario (tests/test_run_all.py) with recorded
    stages: the stages each call ran."""
    _record_stages(monkeypatch, pkg)
    cfg = {"workdir": str(tmp_path / pkg), "input_dir": "scenes",
           "stages": {"cut": {"patch_size": 32, "stride_ratio": 1.0}}}
    out = []
    out.append(list(mod.run_pipeline(cfg, only=["cut"], resume=True, **kw)))
    out.append(list(mod.run_pipeline(cfg, only=["cut"], resume=True, **kw)))
    out.append(list(mod.run_pipeline(cfg, only=["cut"], **kw)))
    cfg["stages"]["cut"]["patch_size"] = 16
    out.append(list(mod.run_pipeline(cfg, only=["cut"], resume=True, **kw)))
    out.append(list(mod.run_pipeline(cfg, only=["cut", "denoise"], resume=True, **kw)))
    out.append(list(mod.run_pipeline(cfg, only=["cut", "denoise"], resume=True, **kw)))
    cfg["stages"]["cut"]["stride_ratio"] = 0.5
    out.append(list(mod.run_pipeline(cfg, only=["cut", "denoise"], resume=True, **kw)))
    mod.run_pipeline(cfg, only=["cut"], **kw)
    out.append(list(mod.run_pipeline(cfg, only=["cut", "denoise"], resume=True, **kw)))
    out.append(list(mod.run_pipeline(cfg, from_stage="noise_pool", resume=True, **kw)))
    out.append(list(mod.run_pipeline(cfg, resume=True, **kw)))
    return out


def test_resume_marker_chain_equals_jax(tmp_path, monkeypatch):
    """--resume skips a stage whose marker matches its argv and upstream
    chain; a changed config, or an upstream stage re-made by a partial
    --only run, re-runs it and everything after it; --from-stage."""
    want = _chain_runs(jrun, monkeypatch, "kmsr_tpu", tmp_path)
    got = _chain_runs(trun, monkeypatch, "kmsr_tpu_torch", tmp_path, device="cpu")
    assert got == want
    assert want[:4] == [["cut"], [], ["cut"], ["cut"]] and want[5] == []
    assert want[7] == ["denoise"]
    marker = json.loads((tmp_path / "kmsr_tpu_torch" / ".stages" / "denoise.json").read_text())
    assert marker["argv"][-2:] == ["--device", "cpu"] and set(marker["upstream"]) == {"cut"}


_REJECTIONS = {
    "bad trainer": ({"trainer": "bogus"}, "trainer must be"),
    "cut_lr without lr_input_dir": ({"stages": {"cut_lr": {"enabled": True}}}, "lr_input_dir"),
    "real_is_lr without cut_lr": ({"trainer": "fleet",
                                   "stages": {"train_kernel": {"real_is_lr": True}}}, "cut_lr"),
    "real_is_lr with trainer single": ({"stages": {"train_kernel": {"real_is_lr": True}}},
                                       "fleet"),
    "calibrate without landsat_root": ({"stages": {"calibrate": {"enabled": True}}},
                                       "landsat_root"),
}


@pytest.mark.parametrize("case", sorted(_REJECTIONS))
def test_rejections_equal_jax(tmp_path, case):
    cfg, match = _REJECTIONS[case]
    msgs = []
    for mod, kw in ((jrun, {}), (trun, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match) as e:
            mod.run_pipeline({**copy.deepcopy(cfg), "workdir": str(tmp_path / "w")}, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------- the DAG on the CPU
@pytest.fixture
def scenes(tmp_path):
    """Two 5x80x80 scenes with navigation (as tests/test_run_all.py)."""
    rng = np.random.default_rng(30)
    d = tmp_path / "scenes"
    d.mkdir()
    for i in range(2):
        scene = rng.uniform(0.5, 5.0, size=(5, 80, 80)).astype(np.float32)
        scene[4] = 1.0  # NIR inside the water-mask window
        write_band_stack(str(d / f"s{i}.nc"), GROUP_GEO, scene, mode="w")
        with JNCFile(str(d / f"s{i}.nc"), "a") as f:
            nav = np.linspace(30, 31, 80 * 80).reshape(80, 80).astype(np.float32)
            f.create_variable("navigation_data", "latitude", nav, dims=("y", "x"))
            f.create_variable("navigation_data", "longitude", nav, dims=("y", "x"))
    return d


def _tiny(tmp_path, scenes, trainer="single"):
    return {
        "workdir": str(tmp_path / "run"), "input_dir": str(scenes), "trainer": trainer,
        "stages": {
            "cut": {"patch_size": 32, "stride_ratio": 1.0},
            "denoise": {"h_factor": 1.0, "device_batch": 4},
            "noise_pool": {"patch_size": 4, "samples_per_file": 2},
            "train_kernel": {"iters": 2, "batch_size": 2, "lr_crop_size": 4,
                             "log_every": 2, "kernel_log_every": 2},
            "factory": {"factor": 8},
            "check_shapes": {"size": 4},
        },
    }


@pytest.mark.parametrize("trainer", ["single", "fleet"])
def test_tiny_dag_through_the_port(tmp_path, scenes, trainer):
    """cut -> denoise -> noise_pool -> train_kernel -> factory ->
    check_shapes -> analyze through the port's own stages on the CPU; the
    fleet trains one kernel per scene and the factory routes each scene's
    patches through its own (`--kernel-root`)."""
    from kmsr_tpu_torch.data.patches import scene_prefix

    timings = trun.run_pipeline(_tiny(tmp_path, scenes, trainer), device="cpu")
    assert list(timings) == ["cut", "denoise", "noise_pool", "train_kernel", "factory",
                             "check_shapes", "analyze"]
    run = tmp_path / "run"
    kdirs = [run / "kernel_run"] if trainer == "single" else \
        [run / "kernel_run" / s for s in ("s0", "s1")]
    for d in kdirs:
        k = np.load(d / "kernel_per_band.npy")
        assert k.shape == (5, 13, 13)
        np.testing.assert_allclose(k.sum(axis=(1, 2)), 1.0, rtol=1e-4)
        assert (d / "training_log.txt").exists()
    pairs = sorted(p for p in os.listdir(run / "train_pairs") if p.endswith(".nc"))
    assert {scene_prefix(p) for p in pairs} == {"s0", "s1"}
    assert trun.run_pipeline(_tiny(tmp_path, scenes, trainer), resume=True,
                             device="cpu") == {}


def test_port_factory_on_a_jax_workdir(tmp_path, scenes):
    """Interop: JAX's runner makes the workdir (cut, denoise, noise pool,
    its factory with a given kernel); the port's `run_all --only
    factory,check_shapes` on it writes the same pairs: hr identical, lr at
    the tolerance."""
    rng = np.random.default_rng(31)
    k = rng.uniform(0.1, 1, (5, 13, 13)).astype(np.float32)
    np.save(tmp_path / "k.npy", k)
    cfg = _tiny(tmp_path, scenes)
    cfg["kernel_file"] = str(tmp_path / "k.npy")
    cfg["stages"]["train_kernel"] = {"enabled": False}
    cfg["stages"]["analyze"] = {"enabled": False}
    jrun.run_pipeline(cfg)
    shutil.move(tmp_path / "run" / "train_pairs", tmp_path / "jax_pairs")
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    assert trun.main(["--config", str(path), "--only", "factory,check_shapes",
                      "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax_pairs"))
    assert names and sorted(os.listdir(tmp_path / "run" / "train_pairs")) == names
    for name in names:
        got, want = tmp_path / "run" / "train_pairs" / name, tmp_path / "jax_pairs" / name
        np.testing.assert_array_equal(read_band_stack(str(got), "hr"), j_read(str(want), "hr"))
        np.testing.assert_allclose(read_band_stack(str(got), "lr"), j_read(str(want), "lr"),
                                   **TOL)


def test_write_config_equals_jax(tmp_path):
    assert jrun.main(["--write-config", str(tmp_path / "j.json")]) == 0
    assert trun.main(["--write-config", str(tmp_path / "t.json")]) == 0
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


# ----------------------------------------------------------- the log analyzer
def _write_log(path, rng, n=200):
    rows = np.column_stack([np.arange(1, n + 1), rng.gamma(2, 0.2, (n, 4))])
    rows[17, 2] = 40.0  # an outlier
    with open(path, "w") as f:
        f.write("Iteration,Loss_D,Loss_G_adv,Loss_Reg,Loss_Reg_weighted\n")
        for r in rows:
            f.write(f"{int(r[0])}," + ",".join(f"{v:.6f}" for v in r[1:]) + "\n")


def test_log_analyzer_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(32)
    _write_log(tmp_path / "log.txt", rng)
    jl, tl = jlog.load_training_log(str(tmp_path / "log.txt")), \
        tlog.load_training_log(str(tmp_path / "log.txt"))
    assert list(tl) == list(jl)
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k])
    jr, tr = jlog.analyze_stability(jl), tlog.analyze_stability(tl)
    assert tr["score"] == jr["score"] and tr["max_score"] == jr["max_score"] == 4
    for k in jr["losses"]:
        assert vars(tr["losses"][k]) == vars(jr["losses"][k])
        assert tr["losses"][k].stability == jr["losses"][k].stability
    assert tlog.format_report(tr) == jlog.format_report(jr)
    outs = []
    for m in (jlog, tlog):
        assert m.main([str(tmp_path / "log.txt"), "--plot", str(tmp_path / f"{m.__name__}.png")]) == 0
        outs.append(capsys.readouterr().out.replace(m.__name__, "M"))
    assert outs[0] == outs[1]
    assert (tmp_path / f"{tlog.__name__}.png").stat().st_size > 0
    (tmp_path / "empty.txt").write_text("Iteration,Loss_D\n")
    with pytest.raises(ValueError, match="no data rows"):
        tlog.load_training_log(str(tmp_path / "empty.txt"))


# -------------------------------------------------------------------- Landsat
def _nc_tree(path):
    """{group/variable: array} and {group: attrs} of a calibrated file."""
    from kmsr_tpu_torch.io import NCFile

    out, attrs = {}, {}
    with NCFile(str(path), "r") as f:
        attrs["/"] = f.get_attrs()
        for g in ("navigation_data", "geophysical_data"):
            for v in f.variable_names(g):
                out[f"{g}/{v}"] = f.variable(g, v)
    return out, attrs


@pytest.mark.parametrize("mode", ["rad", "ref"])
def test_landsat_calibration_equals_jax(tmp_path, mode):
    """`calc_landsat_toa` on a synthetic GeoTIFF + MTL scene dir (north-up)
    and on a rotated one: the same file name, bands, lat/lon and attrs."""
    rng = np.random.default_rng(33)
    scene = tmp_path / "LC08_L1TP_syn"
    make_landsat_scene(scene, rng, shape=(24, 32))
    got = tland.calc_landsat_toa(str(scene), [1, 2, 3, 4, 5], mode=mode,
                                 out_dir=str(tmp_path / "t"))
    want = jland.calc_landsat_toa(str(scene), [1, 2, 3, 4, 5], mode=mode,
                                  out_dir=str(tmp_path / "j"))
    assert os.path.basename(got) == os.path.basename(want)
    (gv, ga), (wv, wa) = _nc_tree(got), _nc_tree(want)
    assert sorted(gv) == sorted(wv) and len(gv) == 7
    for k in wv:
        np.testing.assert_array_equal(gv[k], wv[k])
    assert str(ga) == str(wa)
    assert tland.parse_mtl(str(next(scene.glob("*_MTL.txt")))) == \
        jland.parse_mtl(str(next(scene.glob("*_MTL.txt"))))
    e, n = np.array([300000.0, 500000.0, 700000.0]), np.array([4e6, 3.9e6, 4.1e6])
    for north in (True, False):
        for a, b in zip(tland.utm_to_wgs84(e, n, 52, north), jland.utm_to_wgs84(e, n, 52, north)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tland.wgs84_to_utm(e / 1e4, n / 1e5, 52, north),
                        jland.wgs84_to_utm(e / 1e4, n / 1e5, 52, north)):
            np.testing.assert_array_equal(a, b)
    assert tland.utm_epsg_to_zone(32752) == jland.utm_epsg_to_zone(32752) == (52, False)


def test_calibrate_cli_equals_jax(tmp_path, capsys):
    """The calibrate stage over a root of two LC08/LC09 scene dirs (one
    missing a band: it fails alone, rc 1), as JAX's CLI."""
    from kmsr_tpu.pipeline import calibrate_landsat as jcal

    rng = np.random.default_rng(34)
    root = tmp_path / "raw"
    make_landsat_scene(root / "LC08_L1TP_a", rng, shape=(16, 24))
    make_landsat_scene(root / "LC09_L1TP_b", rng, bands=(1, 2, 3, 4), shape=(16, 24))
    rcs = [m.main(["--root", str(root), "--out-dir", str(tmp_path / name)])
           for m, name in ((jcal, "j"), (tcal, "t"))]
    assert rcs == [1, 1]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    (name,) = os.listdir(tmp_path / "t")
    gv, _ = _nc_tree(tmp_path / "t" / name)
    wv, _ = _nc_tree(tmp_path / "j" / name)
    for k in wv:
        np.testing.assert_array_equal(gv[k], wv[k])
