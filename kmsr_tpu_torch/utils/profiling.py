"""Wall-clock stage scopes and CUDA-event kernel timing.

* `stage_timer` / `timing_report`: the same process-wide wall-clock
  registry as `kmsr_tpu.utils.profiling`, used by the pipeline runners.
* `cuda_time_ms`: device time of one call, taken with CUDA events — the
  counterpart of the JAX package's `bench_windows` (which fences a remote
  TPU queue with a host clock and a scalar readback);
* `cuda_device_ms`: the kernels' own device time per call, from a
  torch.profiler trace.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Iterator

import torch

_TIMINGS: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def stage_timer(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TIMINGS[name].append(time.perf_counter() - t0)


def timing_report(reset: bool = False) -> dict[str, dict]:
    out = {}
    for name, vals in _TIMINGS.items():
        out[name] = {
            "calls": len(vals),
            "total_s": sum(vals),
            "mean_s": sum(vals) / len(vals),
            "max_s": max(vals),
        }
    if reset:
        _TIMINGS.clear()
    return out


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
