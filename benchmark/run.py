"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds the program (`kmsr_tpu_torch`), on
a machine with as many CUDA cards as the cell asks for. The cell's
configuration, traffic mix, driver and metric readers are found by the
names in `BENCHMARK.json` (see `harness.py`); a cell held out of it
(`benchmark/held/`) runs the same way. The last line of standard
output is the result, a JSON object; the last lines of standard error are
the numbers compared for `correct`, each beside its limit. Without the
cards, or if the run loaded JAX or the JAX package, it exits nonzero and
prints no result.
"""
import time

T0 = time.time()  # the set-up time counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
# the trainers run deterministic cuBLAS; this has to precede its first call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    import harness

    bench = harness.spec(held=True)
    cell = harness.find_cell(bench, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = harness.execute(bench, cell, a.seed, a.seconds, bool(a.trace),
                             torch.device("cuda", 0), T0)
    if result is None:
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
