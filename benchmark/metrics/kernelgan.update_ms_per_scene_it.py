"""Host milliseconds a scene-iteration in the two clipped Adam updates
(`kernelgan.d_update` + `kernelgan.g_update`) in the traced window, over
the scene-iterations that `fleet.gather` counted there."""
import spans


def read(run):
    got = spans.traced(run)
    if got is None:
        return None
    t0, t1, rows = got
    n = spans.scene_its(rows, t0, t1)
    if not n:
        return None
    upd = sum(spans.clipped_ns(s, t0, t1) for s in rows
              if s.name in ("kernelgan.d_update", "kernelgan.g_update"))
    return upd / n / 1e6
