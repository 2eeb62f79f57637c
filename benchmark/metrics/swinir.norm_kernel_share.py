"""The share of SwinIR's row norms that ran on the program's row-norm
kernel, over the `swinir.forward` spans that start in the traced window:
the `norm_kernels` they count over their norms, 2 x sum(depths) + 2 a
forward (LN1 and LN2 of every STL, patch_embed's and the last). Nothing
where no span carries the count (a program without the kernel) or none
launched it (a forward on the CPU)."""
import spans


def read(run):
    got = spans.traced(run)
    if got is None:
        return None
    t0, t1, rows = got
    fw = [s for s in spans.started(rows, "swinir.forward", t0, t1) if "norm_kernels" in s.counts]
    launched = sum(s.counts["norm_kernels"] for s in fw)
    if not launched:
        return None
    return 100 * launched / (len(fw) * (2 * sum(run.config["sr"]["depths"]) + 2))
