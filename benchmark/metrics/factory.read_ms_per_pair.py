"""Milliseconds a file on the factory's reader thread (`factory.host_read_bg`:
open, index and inflate the denoised group), over the reads ended inside
the window."""


def read(run):
    n = run.counts.get("reads", 0)
    if not n:
        return None
    return run.counts["read_s"] / n * 1e3
