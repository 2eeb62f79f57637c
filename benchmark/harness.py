"""The benchmark's core: finds a cell's files by the names in
`BENCHMARK.json`, runs its driver once, reads its metrics and prints the
result line.

A cell (an entry of `workloads`) names a configuration, found as
`benchmark/configs/<config>.json`, and a traffic mix, found as
`benchmark/workloads/<traffic>.json`; the mix names its driver,
`benchmark/drivers/<driver>.py`. Each metric of `BENCHMARK.json` is read by
`benchmark/metrics/<metric>.py`, whose `read(run)` returns a number, or
None where the run has nothing to read (the metric is then left out).

A driver has four functions, each given the `Run`:

* `setup(run)`: makes the cell's inputs and weights from the seed, builds
  what the program builds and warms every shape the window uses; returns
  the state the others are given;
* `window(run, state)`: drives the program, calls `run.begin_window()`
  where the measured window opens (set-up ends there), measures for
  `run.seconds`, and sets `run.window_s`, `run.attempted`, `run.failed`
  and what its metrics read in `run.counts`; with `--trace 1` it brackets
  the traced part with `run.trace_start()` / `run.trace_stop()`;
* `verify(run, state)`: compares what the window produced with the plain
  reference in `benchmark/reference/` and records each compared number
  with its limit (`run.check`);
* `control(run, state)`: the same numbers with the control, the plain
  reference one precision step down, in the program's place
  (`control.py` reads them; the benchmark's runs never do).
"""
from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import counts

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules that may not be loaded in a run: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "kmsr_tpu")


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def spec(held: bool = False) -> dict:
    """BENCHMARK.json; with held, also the cells kept out of it, each with
    its metrics in `benchmark/held/<cell>.json` (in BENCHMARK.json's form,
    plus the reason under "held"). A held metric named in BENCHMARK.json
    adds its cells to that one's. The benchmark's command and tests run
    held cells; a check never asks for them."""
    bench = load_json(ROOT / "BENCHMARK.json")
    if not held:
        return bench
    for path in sorted((BENCH / "held").glob("*.json")):
        extra = load_json(path)
        for key in ("workloads", "end_to_end", "per_layer"):
            known = {e["name"]: e for e in bench[key]}
            for e in extra.get(key, []):
                if e["name"] not in known:
                    bench[key].append(e)
                elif "workloads" in known[e["name"]]:
                    known[e["name"]]["workloads"] += e["workloads"]
    return bench


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(cell: dict) -> tuple[dict, dict]:
    """(configuration, traffic mix) of a cell, by their names."""
    return (load_json(BENCH / "configs" / f"{cell['config']}.json"),
            load_json(BENCH / "workloads" / f"{cell['traffic']}.json"))


def driver(name: str):
    return importlib.import_module(f"drivers.{name}")


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The end-to-end metrics of a cell (untraced run) or its per-layer
    metrics (traced run)."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one kind of draw, from the run's seed and a tag."""
    return int(np.random.SeedSequence([seed, *tag.encode()]).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


def _ok(value: float, limit: float, at_least: bool) -> bool:
    return bool(np.isfinite(value)) and (value >= limit if at_least else value <= limit)


class Run:
    """One run of one cell: its inputs, what its window measured and the
    checks of its output."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device: torch.device, t0: float):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0 = device, t0
        self.setup_s = None
        self.window_s = None
        self.attempted = 0
        self.failed = 0
        self.counts: dict = {}
        self.checks: list[tuple[str, float, float, bool]] = []
        self.trace_summary = None
        self._prof = None
        self._trace_t = None
        self.trace_t1 = None
        self.memory_peak_bytes = 0
        self.tmp = Path(tempfile.mkdtemp(prefix="kmsr_bench_"))
        self.kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        self.peaks = counts.peaks(self.kind)

    # -- for drivers ------------------------------------------------------
    def generator(self, tag: str) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, tag))

    def rng(self, tag: str) -> np.random.Generator:
        return np.random.default_rng(sub_seed(self.seed, tag))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def note(self, what: str) -> None:
        """A line on stderr: seconds since the process started, and what."""
        print(f"[{self.cell['name']}] {time.time() - self.t0:8.2f}s {what}", file=sys.stderr,
              flush=True)

    def begin_window(self) -> float:
        """Ends set-up; returns the window's start on the perf_counter clock."""
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.setup_s = time.time() - self.t0
        self.note("window opens")
        return time.perf_counter()

    def trace_start(self) -> None:
        if not self.trace or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        self._prof = profile(activities=acts)
        self._prof.start()
        self._trace_t = (time.time_ns(), time.perf_counter())

    @property
    def trace_t0(self) -> float | None:
        """The traced window's start on the perf_counter clock."""
        return None if self._trace_t is None else self._trace_t[1]

    def trace_stop(self, since_ns: int | None = None, until_ns: int | None = None,
                   window_s: float | None = None) -> None:
        """Ends the trace. since_ns / until_ns (time.time_ns clock) narrow
        the traced window to a part of it, window_s being that part's
        length: device work outside it is left out."""
        if self._prof is None or self.trace_summary is not None:
            return
        self.sync()
        t_ns, t_pc = time.time_ns(), time.perf_counter()
        self.trace_t1 = t_pc
        self._prof.stop()
        self.trace_summary = summarize(
            self._prof, since_ns or self._trace_t[0], until_ns or t_ns,
            window_s if window_s is not None else t_pc - self._trace_t[1])
        self._prof = None

    def check(self, name: str, value: float, limit: float, at_least: bool = False) -> None:
        """A compared number and its limit: at most the limit, or, with
        at_least, at least it."""
        self.checks.append((name, float(value), float(limit), at_least))

    # -- for the harness ----------------------------------------------------
    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(_ok(*c[1:]) for c in self.checks)

    def result(self, metrics: list[dict]) -> dict:
        values = {}
        for m in metrics:
            v = reader(m["name"])(self)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device = {"platform": "gpu" if self.device.type == "cuda" else "cpu",
                  "kind": self.kind,
                  "count": 1,
                  "memory_peak_bytes": int(self.memory_peak_bytes)}
        out = {"correct": self.correct, "attempted": int(self.attempted),
               "failed": int(self.failed), "metrics": values, "device": device}
        if self.trace_summary is not None:
            device["busy_s"] = self.trace_summary["busy_s"]
            device["window_s"] = self.trace_summary["window_s"]
            out["breakdown"] = {"device_ops": self.trace_summary["device_ops"],
                                "idle_gaps": self.trace_summary["idle_gaps"]}
        out["checks"] = {n: {"value": v, ("min" if least else "limit"): lim}
                         for n, v, lim, least in self.checks}
        return out


def execute(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
            device: torch.device, t0: float, config: dict | None = None,
            traffic: dict | None = None) -> dict | None:
    """Runs a cell once and returns its result line, or None (after naming
    them on stderr) when the run loaded JAX or the JAX package. config and
    traffic replace the cell's files (the CPU tests pass small ones)."""
    cfg_file, traffic_file = cell_files(cell)
    run = Run(cell, config or cfg_file, traffic or traffic_file, seed, seconds,
              trace, device, t0)
    drv = driver(run.traffic["driver"])
    try:
        state = drv.setup(run)
        drv.window(run, state)
        run.trace_stop()
        if device.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        bad = forbidden_modules()
        if bad:
            print(f"the run loaded {', '.join(bad)}: JAX and the JAX package "
                  f"are not part of the system under test", file=sys.stderr)
            return None
        drv.verify(run, state)
        del state
        result = run.result(cell_metrics(bench, cell["name"], trace))
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)
    for name, v, lim, least in run.checks:
        print(f"check {name}: {v!r} ({'at least' if least else 'limit'} {lim!r}) "
              f"{'ok' if _ok(v, lim, least) else 'FAILED'}", file=sys.stderr)
    return result


# ---------------------------------------------------------------- the trace
_COPY_PREFIXES = ("Memcpy", "Memset")


def _union(intervals: list) -> tuple[float, list]:
    """(total length, [(start, end)] merged) of [(start, end)] in ns."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _top_level(events: list) -> dict:
    """{thread: [(start, end, name)]} of the CPU events not inside another
    one on their thread, sorted by start."""
    by_thread: dict = {}
    for s, e, name, tid in sorted(events):
        rows = by_thread.setdefault(tid, [])
        if rows and s < rows[-1][1]:
            continue
        rows.append((s, e, name))
    return by_thread


def summarize(prof, t_start_ns: int, t_stop_ns: int, window_s: float) -> dict:
    """Reduces a profiler trace to what the metrics read: the device's busy
    seconds (the union of kernels and copies), kernel seconds by name,
    top-level aten ops launched on the host, and the longest device-idle
    gaps named by the host op that was running on the busiest thread."""
    device_iv, kernel_s, by_name = [], 0.0, {}
    cpu, aten = [], []
    for ev in prof.profiler.kineto_results.events():
        s, d = ev.start_ns(), ev.duration_ns()
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            s, e = max(s, t_start_ns), min(s + d, t_stop_ns)  # inside the window
            if e <= s:
                continue
            device_iv.append((s, e))
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
            if not name.startswith(_COPY_PREFIXES):
                kernel_s += (e - s) / 1e9
        else:
            cpu.append((s, s + max(d, 0), name, ev.start_thread_id()))
            if name.startswith("aten::"):
                aten.append((s, s + max(d, 0), name, ev.start_thread_id()))
    busy_ns, merged = _union(device_iv)
    n_aten = sum(len(v) for v in _top_level(aten).values())
    # idle gaps inside the traced window, named by the host's op at their middle
    threads = _top_level(cpu)
    main = max(threads, key=lambda t: len(threads[t])) if threads else None
    rows = threads.get(main, [])
    starts = [r[0] for r in rows]
    edges = [t_start_ns] + [x for iv in merged for x in iv] + [t_stop_ns]
    gaps: dict = {}
    for i in range(0, len(edges), 2):
        g0, g1 = max(edges[i], t_start_ns), min(edges[i + 1], t_stop_ns)
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(starts, mid) - 1
        name = rows[j][2] if j >= 0 and rows[j][1] >= mid else "host outside traced ops"
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns / 1e9, "window_s": window_s, "kernel_s": kernel_s,
            "aten_ops": n_aten,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}
