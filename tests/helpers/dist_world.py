"""Worlds of torch.distributed ranks for the CPU tests (gloo).

`run_world(job, world, tmp)` starts `world` processes (spawned, so no
state of the test process leaks in), each joining one gloo group through a
file store under `tmp` (no TCP port: the suite runs files in parallel),
and calls job(rank, world) in each; the job's return value (anything
torch.save takes) comes back as a list in rank order. The world is joined
with a time limit, so a hung collective fails the test instead of the
suite; every process group has a timeout too. This module imports neither
jax nor the JAX package, so the ranks start in a few seconds.
"""
from __future__ import annotations

import datetime
import os
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, store: str, out: str, job: Callable, args: tuple):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        result = job(rank, world, *args)
        torch.save(result, f"{out}.{rank}")
    except BaseException:
        with open(f"{out}.{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_world(job: Callable, world: int, tmp, *args, timeout: float = 240.0) -> list:
    """[job(rank, world, *args) for each rank], each run in its own process
    of a `world`-rank gloo group. Raises with the ranks' tracebacks when a
    rank fails, and after `timeout` seconds when the world hangs."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    store, out = os.path.join(tmp, "store"), os.path.join(tmp, "result")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, out, job, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = [open(f"{out}.{r}.err").read() for r in range(world)
            if os.path.exists(f"{out}.{r}.err")]
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still running after {timeout} s\n"
                           + "\n".join(errs))
    if errs or any(p.exitcode for p in procs):
        raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errs))
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
