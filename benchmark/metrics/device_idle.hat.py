"""The share of the traced window in which no kernel or copy ran on the
card (the profiler's timeline)."""


def read(run):
    t = run.trace_summary
    if t is None or not t["window_s"]:
        return None
    return 100 * (1 - t["busy_s"] / t["window_s"])
