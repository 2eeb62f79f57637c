"""Gigabytes a second of `sr_infer.run_batches`' assembly of the host's
result (`sr_infer.assemble`: `finish`'s concatenation of predictions and
metrics): the bytes those spans counted over their time, for the spans
that start in the traced window."""
import spans


def read(run):
    got = spans.traced(run)
    if got is None:
        return None
    t0, t1, rows = got
    done = spans.started(rows, "sr_infer.assemble", t0, t1)
    ns = sum(s.end_ns - s.start_ns for s in done)
    if not done or ns <= 0 or "bytes" not in done[0].counts:
        return None
    return sum(s.counts.get("bytes", 0) for s in done) / ns
