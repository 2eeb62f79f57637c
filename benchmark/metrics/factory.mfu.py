"""The whole factory step's share of the card's float32 peak: the fused
degrade's operations a pair (`counts.degrade_cost`, the composed stencil
on one patch) times the pairs completed in the traced window, over its
seconds. The step is bound by bytes and by the host, so this share is
tiny; it bounds what taking the kernel off the path could claim."""
import counts


def read(run):
    t, cfg = run.trace_summary, run.config["factory"]
    if t is None or run.peaks is None or not run.counts.get("pairs") or not t["window_s"]:
        return None
    flops = counts.degrade_cost(1, cfg["bands"], cfg["patch_size"], cfg["kernel_size"],
                                cfg["factor"])["flops"]
    return 100 * flops * run.counts["pairs"] / t["window_s"] / run.peaks["fp32"]
