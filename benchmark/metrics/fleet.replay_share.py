"""The share of the fleet's scene-iterations in the traced window that ran
as a CUDA graph replay: the `scene_its` of the `kernelgan.replay` spans
started there, over those `fleet.gather` counted there. Nothing where the
window holds no replay (a program without the graphed step)."""
import spans


def read(run):
    got = spans.traced(run)
    if got is None:
        return None
    t0, t1, rows = got
    n = spans.scene_its(rows, t0, t1)
    replays = spans.started(rows, "kernelgan.replay", t0, t1)
    if not n or not replays:
        return None
    return 100 * sum(s.counts.get("scene_its", 0) for s in replays) / n
