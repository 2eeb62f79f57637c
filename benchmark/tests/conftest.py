"""Shared set-up of the benchmark's own tests: the benchmark's folder and the
checkout's root on the import path, and each cell's files cut to a size
the CPU runs in seconds."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

#: per driver: (config section, its tiny sizes, the traffic mix's tiny sizes)
TINY = {
    "factory": ("factory", dict(patch_size=64, batch_size=8, noise_patch=8),
                dict(physical_files=8, names=256, write_workers=2, check_pairs=6)),
    "sr_tiles": ("sr", dict(sr_width=16, sr_blocks=2, batch_size=8, lr_size=8),
                 dict(pool_tiles=32, check_tiles=8, trace_s=0.5)),
    "fleet": ("train_kernel", dict(hr_patch_size=32, lr_crop_size=4, batch_size=4,
                                   steps_per_call=3, d_base_ch=8, d_blocks=1),
              dict(hr_patches=8, lr_patches=16, trace_s=0.5)),
}


def tiny(cell: dict) -> tuple[dict, dict]:
    """The cell's configuration and traffic mix at the CPU tests' size
    (two scenes for a fleet of more than one)."""
    cfg, tr = (copy.deepcopy(x) for x in harness.cell_files(cell))
    section, c_over, t_over = TINY[tr["driver"]]
    cfg[section].update(c_over)
    tr.update(t_over)
    if tr["driver"] == "fleet":
        tr["scenes"] = min(tr["scenes"], 2)
    return cfg, tr


@pytest.fixture(scope="session")
def bench() -> dict:
    return harness.spec()


@pytest.fixture(scope="session")
def bench_all() -> dict:
    """BENCHMARK.json with the held cells (`benchmark/held/`)."""
    return harness.spec(held=True)


@pytest.fixture
def run_tiny(bench_all):
    """run_tiny(cell name, seconds, trace=False) -> the result line of one
    run of the cell at the tiny size on the CPU."""
    def go(name: str, seconds: float = 1.0, trace: bool = False) -> dict:
        cell = harness.find_cell(bench_all, name)
        cfg, tr = tiny(cell)
        import time

        return harness.execute(bench_all, cell, 2**31 + 77, seconds, trace,
                               torch.device("cpu"), time.time(), cfg, tr)
    return go


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the H100")
    return torch.device("cuda", 0)
