"""aten ops launched from the host (those not inside another aten op) per
scene-iteration in the traced window."""


def read(run):
    t = run.trace_summary
    if t is None or not run.counts.get("traced_scene_its"):
        return None
    return t["aten_ops"] / run.counts["traced_scene_its"]
