"""Host milliseconds a `hat.forward` span takes (the program's span around
one HAT forward: the launches of a batch's network, not its device time),
the mean over the spans that start in the traced window."""
import spans


def read(run):
    got = spans.traced(run)
    if got is None:
        return None
    t0, t1, rows = got
    fw = spans.started(rows, "hat.forward", t0, t1)
    if not fw:
        return None
    return sum(s.end_ns - s.start_ns for s in fw) / len(fw) / 1e6
