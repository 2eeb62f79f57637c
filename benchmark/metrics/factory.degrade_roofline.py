"""The fused degrade's share of its roofline: the batches dispatched in the
traced window times one batch's least time (`counts.degrade_cost`: hr,
noise and lr bytes once at the HBM rate, or the composed stencil's
operations at the float32 rate, whichever is longer), over all kernel time
in the window (copies excluded)."""
import counts


def read(run):
    t, cfg = run.trace_summary, run.config["factory"]
    if t is None or run.peaks is None or not run.counts.get("batches") or t["kernel_s"] <= 0:
        return None
    cost = counts.degrade_cost(cfg["batch_size"], cfg["bands"], cfg["patch_size"],
                               cfg["kernel_size"], cfg["factor"])
    return 100 * run.counts["batches"] * counts.roofline_s(cost, run.peaks, "fp32") / t["kernel_s"]
