"""Host milliseconds a scene-iteration in the fleet's spans: the outermost
`fleet.*` and `kernelgan.*` spans' time in the traced window, over the
scene-iterations that `fleet.gather` counted there."""
import spans


def read(run):
    got = spans.traced(run)
    if got is None:
        return None
    t0, t1, rows = got
    n = spans.scene_its(rows, t0, t1)
    if not n:
        return None
    host = sum(spans.clipped_ns(s, t0, t1) for s in spans.outermost(rows, ("fleet.", "kernelgan.")))
    return host / n / 1e6
