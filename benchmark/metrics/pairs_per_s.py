"""hr/lr pairs whose `<name>_train.nc` was completely written inside the
window, over the window's seconds."""


def read(run):
    if "pairs" not in run.counts or not run.window_s:
        return None
    return run.counts["pairs"] / run.window_s
