"""Readings that set the limits of `correct`: for each seed, a short window
of the cell at its own size, then every compared number as the program's
output gives it and as the control gives it (the plain reference one
precision step below the configuration's, in the program's place: the
driver's `control`). One JSON line a seed.

    python3 benchmark/control.py --workload NAME --seconds S --seeds N [N ...] [--fault F]

With --fault, the program's readings with that fault planted instead.

The benchmark's own runs never run the control.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def readings(cell: dict, seed: int, seconds: float, device, config=None, traffic=None,
             fault: str | None = None) -> dict:
    """One seed's readings; with fault, of the program with that fault
    planted (`faults.py`)."""
    import contextlib
    import shutil

    import faults
    import harness

    cfg, tr = harness.cell_files(cell)
    run = harness.Run(cell, config or cfg, traffic or tr, seed, seconds, False, device,
                      time.time())
    drv = harness.driver(run.traffic["driver"])
    try:
        with faults.plant(fault) if fault else contextlib.nullcontext():
            state = drv.setup(run)
            drv.window(run, state)
            drv.verify(run, state)
        out = {"seed": seed, "correct": run.correct,
               "program": {n: v for n, v, _, _ in run.checks}}
        if not fault:
            out["control"] = drv.control(run, state)
        return out
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", help="read the program with this fault planted (faults.py), "
                                   "not the control")
    a = p.parse_args(argv)

    import torch

    import harness

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 1
    cell = harness.find_cell(harness.spec(held=True), a.workload)
    for seed in a.seeds:
        print(json.dumps(readings(cell, seed, a.seconds, torch.device("cuda", 0),
                                  fault=a.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
