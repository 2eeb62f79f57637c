"""The program's spans (`kmsr_tpu_torch.utils.profiling.spans`) in a run's
traced window, for the metrics that read them.

`traced(run)` gives (start_ns, end_ns, spans) of the window between
`run.trace_t0` and `run.trace_t1` on the `perf_counter_ns` clock, the
spans that overlap it; None where the run was not traced, the program
records no spans, or its bounded ring has dropped spans that may have
overlapped the window."""


def traced(run):
    if run.trace_t0 is None or run.trace_t1 is None:
        return None
    try:
        from kmsr_tpu_torch.utils import profiling
        spans, ring = profiling.spans, profiling.RING_SPANS
    except (ImportError, AttributeError):  # a program without span records
        return None
    t0, t1 = int(run.trace_t0 * 1e9), int(run.trace_t1 * 1e9)
    kept = spans()
    # the ring appends a span when it ends: once full, what it dropped
    # ended before its oldest record, so the window is whole only if that
    # record ended before the window began
    if len(kept) >= ring and kept[0].end_ns >= t0:
        return None
    return t0, t1, [s for s in kept if s.end_ns >= t0 and s.start_ns <= t1]


def started(rows, name: str, t0: int, t1: int) -> list:
    """The spans called `name` that start inside [t0, t1]."""
    return [s for s in rows if s.name == name and t0 <= s.start_ns <= t1]


def clipped_ns(s, t0: int, t1: int) -> int:
    """The span's time inside [t0, t1]."""
    return max(0, min(s.end_ns, t1) - max(s.start_ns, t0))


def outermost(rows, prefixes: tuple) -> list:
    """The spans named with one of `prefixes` whose parent is not one of them."""
    mine = [s for s in rows if s.name.startswith(prefixes)]
    ids = {s.id for s in mine}
    return [s for s in mine if s.parent not in ids]


def scene_its(rows, t0: int, t1: int) -> int:
    """Scene-iterations the fleet's gathers counted in [t0, t1]."""
    return sum(s.counts.get("scene_its", 0) for s in started(rows, "fleet.gather", t0, t1))
