"""aten ops launched from the host (those not inside another aten op) in
the traced window, over the batches dispatched in it."""


def read(run):
    t, cfg = run.trace_summary, run.config["sr"]
    if t is None or not run.counts.get("traced_tiles"):
        return None
    return t["aten_ops"] / (run.counts["traced_tiles"] / cfg["batch_size"])
