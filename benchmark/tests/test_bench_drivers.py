"""Each cell's driver end to end at a tiny size on the CPU against the plain
reference; the result line; the control and the planted faults
(`faults.py`), each of which must come out not correct."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import control
import faults
import harness
from conftest import tiny

CELLS = ["x8-factory-nc", "x8-sr-tiles", "real_lr-fleet-s8", "real_lr-fleet-s1"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(run_tiny, bench_all, name, trace):
    res = run_tiny(name, seconds=1.5 if trace else 0.6, trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert DEVICE_KEYS <= set(res["device"])
    want = {m["name"] for m in harness.cell_metrics(bench_all, name, trace)}
    if trace:
        # the CPU has no device timeline: the device metrics read nothing
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
        assert set(res["metrics"]) <= want
    else:
        assert set(res["metrics"]) == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    json.loads(json.dumps(res))


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                        "x8-sr-tiles", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=harness.ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_that_loads_jax_prints_no_result(bench, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    cell = harness.find_cell(bench, "x8-sr-tiles")
    cfg, tr = tiny(cell)
    assert harness.execute(bench, cell, 5, 0.3, False, torch.device("cpu"), 0.0,
                           cfg, tr) is None


def _readings(bench_all, name):
    cell = harness.find_cell(bench_all, name)
    cfg, tr = tiny(cell)
    return control.readings(cell, 2**31 + 5, 0.5, torch.device("cpu"), cfg, tr), tr["limits"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(bench_all, name):
    got, limits = _readings(bench_all, name)
    assert got["correct"]
    assert any(got["control"][k] > limits[k] for k in got["control"] if k in limits)


@pytest.mark.parametrize("name,fault", [
    ("x8-factory-nc", "answer-factory"), ("x8-sr-tiles", "answer-sr"),
    ("real_lr-fleet-s8", "unchanged"), ("real_lr-fleet-s8", "half-batch"),
    ("real_lr-fleet-s1", "unchanged"), ("real_lr-fleet-s1", "half-batch"),
])
def test_a_broken_path_is_not_correct(run_tiny, name, fault):
    with faults.plant(fault):
        assert run_tiny(name, seconds=0.5)["correct"] is False
