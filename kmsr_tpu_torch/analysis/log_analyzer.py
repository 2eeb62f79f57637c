"""Training-log stability analysis.

The port's copy of `kmsr_tpu.analysis.log_analyzer` (host numpy; matplotlib
is imported only inside `plot_loss_curves`). Parity with
`analyze_training_log.py:9-173`: parse the CSV loss log,
report per-loss mean/std/min/max, first-vs-second-half trend percentage,
coefficient-of-variation stability classes (CV < 0.3 stable, < 0.5
moderate, else unstable), 3-sigma outlier counts, a 0-4 stability score,
and a loss-curve figure.

Usage:
    python -m kmsr_tpu_torch.analysis.log_analyzer training_log.txt [--plot out.png]
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np

CV_STABLE = 0.3
CV_MODERATE = 0.5


def load_training_log(path: str) -> dict[str, np.ndarray]:
    """Parse 'Iteration,<loss columns...>' CSV into named arrays."""
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline().strip().split(",")
        rows = [line.strip().split(",") for line in f if line.strip()]
    if not rows:
        raise ValueError(f"no data rows in {path}")
    data = np.asarray(rows, dtype=np.float64)
    return {name: data[:, i] for i, name in enumerate(header)}


@dataclass
class LossStats:
    name: str
    mean: float
    std: float
    vmin: float
    vmax: float
    cv: float
    trend_pct: float        # second-half mean vs first-half mean, %
    outliers_3sigma: int

    @property
    def stability(self) -> str:
        if self.cv < CV_STABLE:
            return "stable"
        if self.cv < CV_MODERATE:
            return "moderate"
        return "unstable"


def analyze_loss(name: str, values: np.ndarray) -> LossStats:
    mean = float(values.mean())
    std = float(values.std())
    half = len(values) // 2
    first, second = values[:half], values[half:]
    trend = (
        (second.mean() - first.mean()) / abs(first.mean()) * 100
        if first.mean() != 0
        else 0.0
    )
    cv = std / abs(mean) if mean != 0 else np.inf
    outliers = int(np.sum(np.abs(values - mean) > 3 * std)) if std > 0 else 0
    return LossStats(
        name=name,
        mean=mean,
        std=std,
        vmin=float(values.min()),
        vmax=float(values.max()),
        cv=float(cv),
        trend_pct=float(trend),
        outliers_3sigma=outliers,
    )


def analyze_stability(log: dict[str, np.ndarray]) -> dict:
    """Full stability report + 0-4 score.

    Score: +1 if D loss stable (CV < 0.5), +1 if G_adv stable, +1 if no
    loss has >1% 3-sigma outliers, +1 if no loss trends worse than +50%.
    """
    loss_names = [k for k in log if k.lower() != "iteration"]
    stats = {name: analyze_loss(name, log[name]) for name in loss_names}
    score = 0
    d_keys = [n for n in loss_names if n.lower().startswith("loss_d")]
    g_keys = [n for n in loss_names if "g_adv" in n.lower()]
    if d_keys and stats[d_keys[0]].cv < CV_MODERATE:
        score += 1
    if g_keys and stats[g_keys[0]].cv < CV_MODERATE:
        score += 1
    n_rows = len(next(iter(log.values())))
    if all(s.outliers_3sigma <= max(1, 0.01 * n_rows) for s in stats.values()):
        score += 1
    if all(s.trend_pct < 50.0 for s in stats.values()):
        score += 1
    return {"losses": stats, "score": score, "max_score": 4}


def format_report(report: dict) -> str:
    lines = ["Training stability report", "=" * 60]
    for s in report["losses"].values():
        lines.append(
            f"{s.name:20s} mean={s.mean:10.6f} std={s.std:9.6f} "
            f"min={s.vmin:9.6f} max={s.vmax:9.6f}"
        )
        lines.append(
            f"{'':20s} CV={s.cv:6.3f} ({s.stability}) "
            f"trend={s.trend_pct:+7.2f}% outliers(3s)={s.outliers_3sigma}"
        )
    lines.append("-" * 60)
    lines.append(f"stability score: {report['score']}/{report['max_score']}")
    return "\n".join(lines)


def plot_loss_curves(log: dict[str, np.ndarray], out_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = [k for k in log if k.lower() != "iteration"]
    iters = log.get("Iteration", np.arange(len(log[names[0]])))
    n = min(3, len(names))
    fig, axes = plt.subplots(1, n, figsize=(6 * n, 4))
    if n == 1:
        axes = [axes]
    for ax, name in zip(axes, names[:n]):
        ax.plot(iters, log[name], lw=0.7)
        # running mean overlay
        w = max(1, len(iters) // 50)
        if len(iters) > w:
            kernel = np.ones(w) / w
            ax.plot(
                iters[w - 1 :],
                np.convolve(log[name], kernel, mode="valid"),
                lw=1.5,
            )
        ax.set_title(name)
        ax.set_xlabel("iteration")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Analyze a training loss log")
    p.add_argument("log_file")
    p.add_argument("--plot", default=None, help="write loss-curve PNG here")
    a = p.parse_args(argv)
    log = load_training_log(a.log_file)
    report = analyze_stability(log)
    print(format_report(report))
    if a.plot:
        plot_loss_curves(log, a.plot)
        print(f"curves -> {a.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
