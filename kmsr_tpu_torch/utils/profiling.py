"""Program spans and CUDA-event kernel timing.

* `stage_timer`: a span of host time around a block. Each records its
  id, its parent (the innermost span open on the same thread; a span on
  another thread has none), its thread, its start and end on the
  `time.perf_counter_ns` clock, an optional `item` (what the spans of one
  batch or step share) and integer counts. While a torch.profiler
  records, the span is also a host op of its name in that trace, on the
  same clock as the kernels it launched;
* `timing_report`: per-name aggregates (calls, total, mean, max) of the
  spans since the last reset;
* `spans`: the newest `RING_SPANS` records, or those in a window of the
  clock;
* `device_trace`: a torch.profiler trace of a block (host ops, and the
  card's kernels when one is present);
* `cuda_time_ms`: device time of one call, taken with CUDA events;
* `cuda_device_ms`: the kernels' own device time per call, from a
  torch.profiler trace.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Callable, Iterator, NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

#: the records `spans` can return; the aggregates count every span
RING_SPANS = 65_536


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    thread: int  # threading.get_native_id()
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    item: object
    counts: dict


@dataclasses.dataclass
class _Totals:
    calls: int = 0
    total_ns: int = 0
    max_ns: int = 0


_RING: collections.deque = collections.deque(maxlen=RING_SPANS)
_TOTALS: dict[str, _Totals] = {}
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: the ids of the spans open on this thread


@contextlib.contextmanager
def stage_timer(name: str, item=None, **counts: int) -> Iterator[dict]:
    """A span named `name` around the block; yields its counts, which the
    block may add to (what it copied, once known). The span is recorded
    when the block ends, by an exception too."""
    sid = next(_IDS)
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    parent = stack[-1] if stack else None
    stack.append(sid)
    # reading the flag costs ~0.1 us, a host op ~1 us. A host op, not
    # torch.profiler.record_function: that one (a user annotation, ~10 us
    # even unprofiled) also puts a range on the card's timeline, which a
    # trace's reader takes for device work
    traced = _autograd_profiler._is_profiler_enabled
    if traced:
        rf = _RecordFunctionFast(name)
        rf.__enter__()
    t0 = time.perf_counter_ns()
    try:
        yield counts
    finally:
        t1 = time.perf_counter_ns()
        if traced:
            rf.__exit__(None, None, None)
        stack.remove(sid)
        span = Span(sid, parent, name, threading.get_native_id(), t0, t1, item, counts)
        with _LOCK:
            _RING.append(span)
            tot = _TOTALS.get(name)
            if tot is None:
                tot = _TOTALS[name] = _Totals()
            tot.calls += 1
            tot.total_ns += t1 - t0
            tot.max_ns = max(tot.max_ns, t1 - t0)


def timing_report(reset: bool = False) -> dict[str, dict]:
    """{name: {"calls", "total_s", "mean_s", "max_s"}}; reset empties the
    aggregates and the ring after reading them."""
    with _LOCK:
        out = {}
        for name, tot in _TOTALS.items():
            out[name] = {
                "calls": tot.calls,
                "total_s": tot.total_ns / 1e9,
                "mean_s": tot.total_ns / tot.calls / 1e9,
                "max_s": tot.max_ns / 1e9,
            }
        if reset:
            _TOTALS.clear()
            _RING.clear()
    return out


def spans(since_ns: Optional[int] = None, until_ns: Optional[int] = None) -> list[Span]:
    """The ring's records that overlap [since_ns, until_ns] (either end
    open when None), oldest first."""
    with _LOCK:
        rows = list(_RING)
    lo = -1 if since_ns is None else since_ns
    hi = float("inf") if until_ns is None else until_ns
    return [s for s in rows if s.end_ns >= lo and s.start_ns <= hi]


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """A torch.profiler trace of the block (host ops, and the card's kernels
    when one is present), written as a Chrome trace to
    `log_dir/trace.json` (chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def cuda_time_ms(fn: Callable[[], object], runs: int = 20) -> dict:
    """Device time of `fn()` on the current CUDA stream, in milliseconds.

    Each of `runs` calls (after 3 untimed warm-up calls) sits between its own
    pair of CUDA events, so the number is device time, not enqueue time.
    Returns {"median_ms", "min_ms", "max_ms", "runs"}. Raises on a host
    without a card: a device time cannot be measured on the CPU.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    samples = sorted(s.elapsed_time(e) for s, e in pairs)
    return {
        "median_ms": samples[len(samples) // 2],
        "min_ms": samples[0],
        "max_ms": samples[-1],
        "runs": runs,
    }


def cuda_device_ms(fn: Callable[[], object], runs: int = 10,
                   attempts: int = 3, warmup: int = 3) -> dict:
    """Device time of the CUDA kernels `fn()` launches, in milliseconds per
    call, from a torch.profiler (CUPTI) trace of `runs` calls after
    `warmup` untimed ones: the kernels' own durations, without the host time between
    launches that `cuda_time_ms` also sees when the host is the slower
    side. Each kernel's mean duration is taken over the records the trace
    holds, times its launches per call. Returns {"device_ms": their sum,
    "kernels": {name: ms per call}, "launches": {name: records per
    call}}; copies count as kernels here. A trace that holds no kernel record
    (CUPTI now and then delivers none) is taken again, up to `attempts`
    traces. Raises on a host without a card, or if no trace saw a kernel.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_device_ms needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        kernels, launches = {}, {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if us > 0 and ev.count:
                kernels[ev.key] = us / ev.count * max(1, round(ev.count / runs)) / 1e3
                launches[ev.key] = ev.count / runs
        if kernels:
            return {"device_ms": sum(kernels.values()), "kernels": kernels,
                    "launches": launches}
    raise RuntimeError(f"the profiler saw no kernel on the device in {attempts} traces")
