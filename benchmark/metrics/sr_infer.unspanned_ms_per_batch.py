"""Milliseconds a batch of the SR loop's thread that no `sr_infer.*` span
covers: the traced window's length less the union of that thread's
outermost `sr_infer.*` spans in it, over the `sr_infer.assemble` spans that
start in it."""
import spans


def read(run):
    got = spans.traced(run)
    if got is None:
        return None
    t0, t1, rows = got
    done = spans.started(rows, "sr_infer.assemble", t0, t1)
    if not done:
        return None
    loop = done[0].thread
    covered, end = 0, t0
    for s in sorted(spans.outermost([s for s in rows if s.thread == loop], ("sr_infer.",)),
                    key=lambda s: s.start_ns):
        lo, hi = max(s.start_ns, end), min(s.end_ns, t1)
        if hi > lo:
            covered += hi - lo
            end = hi
    return (t1 - t0 - covered) / len(done) / 1e6
