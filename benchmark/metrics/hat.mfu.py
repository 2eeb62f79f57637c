"""The HAT forward's share of the card's bf16 dense peak: the network's
FLOPs a tile (`counts_hat.hat_flops_per_tile`) times the tiles delivered in
the traced window, over its seconds."""
import counts_hat


def read(run):
    t, cfg = run.trace_summary, run.config["sr"]
    if t is None or run.peaks is None or not run.counts.get("traced_tiles") or not t["window_s"]:
        return None
    flops = counts_hat.hat_flops_per_tile(cfg, cfg["lr_size"], cfg["lr_size"])
    return 100 * flops * run.counts["traced_tiles"] / t["window_s"] / run.peaks["bf16"]
