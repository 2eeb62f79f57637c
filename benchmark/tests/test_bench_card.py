"""On the card: every cell through the benchmark's command, once, with a
short window, and its control not correct at the cell's own size. Skips
where there is no CUDA card; on the card:
`python -m pytest benchmark/tests/test_bench_card.py -m cuda`."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

import control
import harness

CELLS = [w["name"] for w in harness.spec(held=True)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    p = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", name,
                        "--seed", str(2**31 + 101), "--seconds", "5", "--trace", "0"],
                       capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    cell = harness.find_cell(harness.spec(held=True), name)
    limits = harness.cell_files(cell)[1]["limits"]
    got = control.readings(cell, 2**31 + 103, 5.0, card)
    assert got["correct"]
    assert any(got["control"][k] > limits[k] for k in got["control"] if k in limits)
