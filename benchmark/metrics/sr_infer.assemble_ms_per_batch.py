"""Milliseconds a batch in `sr_infer.run_batches`' assembly of the host's
result (`sr_infer.assemble`: `finish`'s concatenation of predictions and
metrics), the mean over the spans that start in the traced window."""
import spans


def read(run):
    got = spans.traced(run)
    if got is None:
        return None
    t0, t1, rows = got
    done = spans.started(rows, "sr_infer.assemble", t0, t1)
    if not done:
        return None
    return sum(s.end_ns - s.start_ns for s in done) / len(done) / 1e6
