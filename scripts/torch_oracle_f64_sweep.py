"""The quality report's matched-prior oracle sweep solved in float64, to
set the reports' float32 sweeps (the port's and JAX's) against.

Reads the pairs as `scripts/torch_quality_report.py` does (the last
`--holdout` are the holdout; the prior's spectrum comes from the others,
its noise variance from the pool beside the pairs) and prints, for each
lam of the report's grid, the mean PSNR over the holdout of
`analysis.oracle._deconv_batch` run on float64 tensors (operator, CG and
stop test all in float64), each image against its HR range as
`oracle_sweep` scores it. CPU.

    python scripts/torch_oracle_f64_sweep.py --pairs WORK/train_pairs \
        --kernel kernel.npy [--holdout 24] [--iters 100]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> None:
    import torch

    from kmsr_tpu_torch.analysis import oracle
    from kmsr_tpu_torch.ops.metrics import psnr
    from kmsr_tpu_torch.pipeline.train_sr_cli import load_pairs

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pairs", required=True)
    p.add_argument("--kernel", required=True, help="the factory's [C, k, k] kernel .npy")
    p.add_argument("--noise-pool", default=None,
                   help="default: <pairs>/../noise_pool.npy")
    p.add_argument("--holdout", type=int, default=24)
    p.add_argument("--iters", type=int, default=100)
    a = p.parse_args(argv)

    lr_all, hr_all = load_pairs(a.pairs)
    lr_v, hr_v = lr_all[-a.holdout:], hr_all[-a.holdout:]
    pool = np.load(a.noise_pool or os.path.join(
        os.path.dirname(os.path.abspath(a.pairs)), "noise_pool.npy"))
    w, inv = oracle.matched_prior(hr_all[:-a.holdout], np.nanvar(pool, axis=(0, 2, 3)))

    def f64(x):
        return torch.from_numpy(np.asarray(x, np.float64))

    for lam in (0.3, 1.0, 3.0, 10.0):   # oracle_sweep's matched grid
        x = oracle._deconv_batch(f64(lr_v), f64(np.load(a.kernel)), 8, lam, f64(w), f64(inv),
                                 iters=a.iters).numpy()
        scores = [float(psnr(torch.from_numpy(x[i]), f64(hr_v[i]),
                             float(np.nanmax(hr_v[i]) - np.nanmin(hr_v[i])) or 1.0))
                  for i in range(len(hr_v))]
        print(f"matched lam {lam:g}: mean PSNR {np.mean(scores):.4f} dB (float64 solve)")


if __name__ == "__main__":
    main()
