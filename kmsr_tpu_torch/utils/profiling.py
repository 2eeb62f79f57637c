"""Wall-clock stage scopes and CUDA-event kernel timing.

* `stage_timer` / `timing_report`: the same process-wide wall-clock
  registry as `kmsr_tpu.utils.profiling`, used by the pipeline runners.
* `bench_windows`: the median of k timing windows with min/max spread,
  JAX's return shape, each window fenced by a device synchronize;
* `detect_sync_stall`: flags a stage whose device-sync time dwarfs its
  host work (a pure host copy of the JAX package's rule);
* `device_trace`: a torch.profiler trace of a block (host ops, and the
  card's kernels when one is present);
* `cuda_time_ms`: device time of one call, taken with CUDA events;
* `cuda_device_ms`: the kernels' own device time per call, from a
  torch.profiler trace.
"""
from __future__ import annotations

import contextlib
import os
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


def bench_windows(fn, *args, iters: int, windows: int = 5,
                  drain=None) -> dict:
    """Median-of-k timing windows with min/max spread.

    Throughput drifts across hours, so a single sample makes deltas
    uninterpretable; this reports {median_s, min_s, max_s} per iteration
    from k back-to-back windows instead. `drain(out)` fences the device
    queue at each window's end; by default `torch.cuda.synchronize()` in a
    process that uses a card, and nothing on the CPU (its ops return when
    done).
    """
    if drain is None:
        def drain(_):
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()

    drain(fn(*args))  # first call (kernel builds, cuDNN autotuning)
    for _ in range(2):
        out = fn(*args)
    drain(out)  # warm queue
    samples = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        drain(out)
        samples.append((time.perf_counter() - t0) / iters)
    samples.sort()
    return {
        "median_s": samples[len(samples) // 2],
        "min_s": samples[0],
        "max_s": samples[-1],
    }


def detect_sync_stall(
    scopes: dict[str, dict],
    stage_seconds: dict[str, float] | None = None,
    ratio: float = 5.0,
    floor_s: float = 120.0,
) -> list[dict]:
    """Flag stages whose main-thread device-sync time dwarfs their host work.

    A wedged device shows up as a stage spending nearly all its wall time
    blocked in `<stage>.device_sync` while its host scopes stay tiny. A
    stage is flagged when

        device_sync > max(ratio * host_s, floor_s)

    where `host_s` sums the stage's other MAIN-THREAD scopes (`*_bg`
    reader-thread scopes overlap device compute and are excluded).
    `floor_s` absorbs legitimate first-call time (kernel builds) and honest
    queue drains so short clean runs never false-positive. Returns one
    record per flagged stage; callers mark their report `"tainted": true`
    when non-empty.
    """
    stage_seconds = stage_seconds or {}
    prefixes = sorted({n.split(".", 1)[0] for n in scopes if "." in n})
    flags = []
    for stage in prefixes:
        sync = scopes.get(f"{stage}.device_sync", {}).get("total_s", 0.0)
        host = sum(
            rec.get("total_s", 0.0)
            for name, rec in scopes.items()
            if name.startswith(stage + ".")
            and not name.endswith("device_sync")
            and not name.endswith("_bg")
        )
        if sync > max(ratio * host, floor_s):
            flags.append({
                "stage": stage,
                "device_sync_s": round(sync, 2),
                "host_s": round(host, 2),
                "wall_s": round(stage_seconds.get(stage, float("nan")), 2),
                "sync_to_host_ratio": round(sync / host, 1) if host else None,
            })
    return flags


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
