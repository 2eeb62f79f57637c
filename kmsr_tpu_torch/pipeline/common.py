"""Shared pipeline-runner plumbing: per-file failure isolation + accounting.

The port's copy of the parts of `kmsr_tpu.pipeline.common` the factory,
the denoise and cut stages and the trainer CLI use: `RunReport`,
`run_per_file`, `DeviceSyncGuard`, `chunked_reader`, `maybe_trace` and
`route_per_scene_kernels` (the factory's and apply_kernel's
`--kernel-root`), and re-exports `local_batch_dp` / `pad_put` from
`parallel.local_dp` for the stages, as the JAX module does.
Every reference batch driver wraps its per-file work in try/except-continue
with success/failure counting (`A_00_patch_cutter_universal.py:409-419`,
`E_make_train_data.py:264-272`, `denoise/batch_denoise.py:60-93`) so one
bad file never kills a run; this module centralizes that contract.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import traceback
from typing import Callable, Iterable, Optional


@dataclasses.dataclass
class RunReport:
    succeeded: list
    failed: list            # (item, error string)
    seconds: float
    #: files a batched stage sent down its per-file path instead (odd
    #: shapes, or a failed batch); 0 where a stage has no such path
    fallbacks: int = 0

    @property
    def n_ok(self) -> int:
        return len(self.succeeded)

    @property
    def n_fail(self) -> int:
        return len(self.failed)

    def summary(self) -> str:
        return (
            f"{self.n_ok} succeeded, {self.n_fail} failed "
            f"in {self.seconds:.1f}s"
        )


def run_per_file(
    items: Iterable,
    fn: Callable,
    desc: str = "processing",
    progress: bool = True,
    verbose_errors: bool = False,
    on_error: Optional[Callable] = None,
) -> RunReport:
    """Apply `fn(item)` to every item; isolate failures; account results."""
    items = list(items)
    if progress:
        try:
            from tqdm import tqdm

            items_iter = tqdm(items, desc=desc, unit="file")
        except ImportError:
            items_iter = items
    else:
        items_iter = items
    t0 = time.time()
    ok, fail = [], []
    for item in items_iter:
        try:
            fn(item)
            ok.append(item)
        except Exception as e:
            fail.append((item, str(e)))
            if verbose_errors:
                traceback.print_exc()
            if on_error:
                on_error(item, e)
    return RunReport(succeeded=ok, failed=fail, seconds=time.time() - t0)


class DeviceSyncGuard:
    """Escalate persistent device-sync failures into a run abort.

    The pipelined writebacks (factory, apply_kernel) sync each
    batch (a device-to-host copy) AFTER the next batch was dispatched, so
    device-side runtime failures surface there; a single bad batch is
    isolated per-file (reference failure-isolation contract). But a
    permanently wedged device — or a programming error — would convert
    EVERY remaining batch into per-file failures while the driver keeps
    dispatching to a dead device. This guard re-raises after
    `max_consecutive` whole-batch sync failures in a row so such runs
    abort loudly instead of grinding to a 100%-failed report.
    """

    def __init__(self, max_consecutive: int = 3):
        self.max_consecutive = max_consecutive
        self._consecutive = 0

    def succeeded(self) -> None:
        self._consecutive = 0

    def failed(self, exc: Exception) -> None:
        """Record one whole-batch sync failure; re-raise when persistent."""
        self._consecutive += 1
        if self._consecutive >= self.max_consecutive:
            raise RuntimeError(
                f"{self._consecutive} consecutive whole-batch device syncs "
                f"failed (last: {type(exc).__name__}: {exc}) — device wedged "
                f"or programming error; aborting instead of failing every "
                f"remaining batch"
            ) from exc


def chunked_reader(
    files: list,
    batch_size: int,
    read_fn: Callable,
    lookahead: int = 2,
    timer: Optional[str] = None,
):
    """Yield (valid_paths, stacks, failures) per chunk, with the NEXT
    chunk's file reads running on a background thread while the caller
    (typically a device computation) consumes the current one — the host
    IO / device-compute overlap the file-batched stages (factory,
    apply_kernel) use. Per-file failure isolation preserved;
    chunks are yielded strictly in order so seeded RNG streams match the
    synchronous path.

    timer: optional `utils.profiling.stage_timer` scope name accumulated
    around each file read (BACKGROUND-thread busy time — it overlaps the
    caller's device compute, so it is not additive with main-thread
    scopes).
    """
    import queue
    import threading

    if timer is not None:
        from ..utils.profiling import stage_timer
    else:
        stage_timer = None

    q: "queue.Queue" = queue.Queue(maxsize=lookahead)

    def worker():
        for start in range(0, len(files), batch_size):
            chunk = files[start : start + batch_size]
            stacks, valid, fail = [], [], []
            for path in chunk:
                try:
                    if stage_timer is not None:
                        with stage_timer(timer):
                            stacks.append(read_fn(path))
                    else:
                        stacks.append(read_fn(path))
                    valid.append(path)
                except Exception as e:
                    fail.append((path, str(e)))
            q.put((valid, stacks, fail))
        q.put(None)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        yield item


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]):
    """Wrap a stage body in a torch.profiler trace (host ops, and the
    card's kernels when one is present) when log_dir is set (CLI `--trace
    DIR`); no-op otherwise. Writes a Chrome trace, `log_dir/trace.json`
    (chrome://tracing or Perfetto)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[trace] timeline written to {path}")


# Re-exported for the pipeline stages; the implementation lives in
# parallel.local_dp (ops modules use it too and must not import pipeline).
from ..parallel.local_dp import local_batch_dp, pad_put  # noqa: E402,F401


def route_per_scene_kernels(
    files: list, kernel_root: str, run_scene: Callable, label: str,
    output_dir: str,
) -> RunReport:
    """Shared per-scene kernel routing (the fleet trainer's outdir layout).

    Groups `files` by originating scene (`data.patches.scene_prefix`),
    probes `<kernel_root>/<scene>/kernel_per_band.npy`, and calls
    `run_scene(scene, kernel_path, scene_files) -> RunReport` per scene
    with a kernel; a scene whose kernel artifact is missing fails as a unit
    (per-file accounting), the rest proceed. Used by both the fused
    factory and apply_kernel.
    """
    from ..data.patches import group_by_scene

    t0 = time.time()
    ok_all: list = []
    fail_all: list = []
    for scene, scene_files in group_by_scene(files).items():
        k_path = os.path.join(kernel_root, scene, "kernel_per_band.npy")
        if not os.path.exists(k_path):
            fail_all.extend(
                (f, f"no kernel for scene {scene!r}: {k_path} missing")
                for f in scene_files
            )
            continue
        rep = run_scene(scene, k_path, scene_files)
        ok_all.extend(rep.succeeded)
        fail_all.extend(rep.failed)
    report = RunReport(succeeded=ok_all, failed=fail_all, seconds=time.time() - t0)
    print(f"{label}[per-scene kernels]: {report.summary()} -> {output_dir}")
    return report
