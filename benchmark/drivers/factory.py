"""Driver of the pair factory from `.nc` files:
`kmsr_tpu_torch.pipeline.factory.run_factory` with one per-band kernel over
a folder of denoised patch files.

Set-up writes `physical_files` seeded patches with the benchmark's own
frozen codec (in `write_workers` processes), in the layout the denoise
stage writes, lists them under `names` distinct names (symbolic links,
name k -> file k mod physical_files) so the window never reaches the
folder's end, and writes the kernel and the noise pool as the pipeline's
`.npy` artifacts.

The window lies inside one `run_factory` call, which also warms the path:
it opens when the call's first batch of pairs is complete and closes
`run.seconds` later, when the input and output folders are renamed: every
later read or write fails at once through the factory's per-file failure
handling, and the call returns. The
codec writes each file to a temporary name and renames it into place when
complete, so the `*_train.nc` files in the renamed output folder, less
those there when the window opened, are the pairs completed inside it.

The check reads a seeded sample of those pairs back with the frozen codec:
hr must equal the input patch bit for bit, lr the plain float64
degrade of it plus its noise-pool draw (`reference.degrade`).
"""
from __future__ import annotations

import multiprocessing
import os
import threading
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

import imagery
from reference import nc
from reference.degrade import degrade as plain_degrade
from reference.degrade import pool_indices


def setup(run) -> dict:
    cfg, tr, dev = run.config["factory"], run.traffic, run.device
    n_phys, size, c = tr["physical_files"], cfg["patch_size"], cfg["bands"]
    ps = cfg["noise_patch"]
    gen = run.generator("patches")
    den = imagery.fields(gen, n_phys, c, size, size, dev)
    sigma = 0.01 * den.mean(dim=(2, 3), keepdim=True)
    geo = den + sigma * torch.randn(den.shape, generator=gen, device=dev)
    ramp = (torch.arange(size, device=dev, dtype=torch.float32) * 2.5e-3)[:, None].expand(size, size)
    lat0 = 33 + 5 * torch.rand(n_phys, 1, 1, generator=gen, device=dev)
    lon0 = 124 + 5 * torch.rand(n_phys, 1, 1, generator=gen, device=dev)
    lat, lon = (lat0 - ramp).cpu().numpy(), (lon0 + ramp.T).cpu().numpy()
    n_pool = cfg["noise_per_file"] * n_phys
    pool = (torch.randn((n_pool, c, ps, ps), generator=gen, device=dev)
            * 0.01 * torch.tensor(imagery.BAND_MEANS[:c], device=dev)[:, None, None])
    kernel = imagery.blur_kernel(gen, c, cfg["kernel_size"], dev)
    den_h, geo_h, sig_h = den.cpu().numpy(), geo.cpu().numpy(), sigma.cpu().numpy()
    del den, geo
    run.note("patches made")

    phys, src = run.tmp / "physical", run.tmp / "input"
    phys.mkdir()
    src.mkdir()

    # the codec is Python-heavy: worker processes, not threads
    tasks = ((str(phys / f"patch_{i:04d}_denoised.nc"), geo_h[i], den_h[i], lat[i], lon[i],
              i, sig_h[i, :, 0, 0]) for i in range(n_phys))
    with ProcessPoolExecutor(tr["write_workers"],
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        list(ex.map(nc.write_denoised_patch, tasks, chunksize=4))
    os.sync()  # their write-back would otherwise land inside the window
    run.note(f"{n_phys} patch files written")
    for k in range(tr["names"]):
        os.symlink(phys / f"patch_{k % n_phys:04d}_denoised.nc", src / f"p{k:05d}_denoised.nc")
    kernel_path, pool_path = run.tmp / "kernel_per_band.npy", run.tmp / "noise_pool.npy"
    np.save(kernel_path, kernel.cpu().numpy())
    np.save(pool_path, pool.cpu().numpy())
    return {"denoised": den_h, "kernel": kernel, "pool": pool,
            "kernel_path": kernel_path, "pool_path": pool_path}


def _factory(run, src, out, kernel_path, pool_path):
    from kmsr_tpu_torch.pipeline.factory import run_factory

    cfg = run.config["factory"]
    return run_factory(str(src), str(kernel_path), str(pool_path), str(out),
                       factor=cfg["factor"], batch_size=cfg["batch_size"],
                       seed=cfg["seed"], progress=False, input_format="nc",
                       device=run.device)


def window(run, state) -> None:
    from kmsr_tpu_torch.utils.profiling import timing_report

    src, out = run.tmp / "input", run.tmp / "out"
    mark, ended = {}, threading.Event()

    def watch():
        # the window opens when the call's first batch of pairs is complete:
        # priming the pipeline (the kernel's build and launch, the first
        # batches read while the reader fills its lookahead, the first
        # writeback) is set-up, and every window starts at the same point
        # of the steady read/write cycle
        first = run.config["factory"]["batch_size"]
        while sum(n.endswith("_train.nc") for n in os.listdir(out)) < first:
            if ended.wait(0.01):
                return
        mark["t0"], mark["open_ns"] = run.begin_window(), time.time_ns()
        mark["opened"] = {p.name for p in out.glob("*_train.nc")}
        mark["timers0"] = timing_report()
        time.sleep(max(0.0, mark["t0"] + run.seconds - time.perf_counter()))
        mark["t1"], mark["close_ns"] = time.perf_counter(), time.time_ns()
        mark["timers1"] = timing_report()
        os.rename(src, run.tmp / "input_closed")
        os.rename(out, run.tmp / "out_closed")

    timing_report(reset=True)
    out.mkdir()
    run.trace_start()  # before the call: starting the profiler takes seconds
    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        _factory(run, src, out, state["kernel_path"], state["pool_path"])
    finally:
        ended.set()
        watcher.join()
    if "t1" not in mark:
        raise RuntimeError("the factory ended before its window closed")
    run.trace_stop(since_ns=mark["open_ns"], until_ns=mark["close_ns"],
                   window_s=mark["t1"] - mark["t0"])
    run.window_s = mark["t1"] - mark["t0"]
    files = [p for p in sorted((run.tmp / "out_closed").glob("*_train.nc"))
             if p.name not in mark["opened"]]
    t0_wall = mark["open_ns"] / 1e9
    ends = np.array([p.stat().st_mtime - t0_wall for p in files])
    run.note("pairs completed in each 5 s of the window: "
             f"{np.bincount((ends.clip(0) // 5).astype(int)).tolist()}")
    idx = [int(p.name[1:6]) for p in files]
    run.attempted = max(idx) - min(idx) + 1 if idx else 0
    run.failed = run.attempted - len(idx)

    def delta(name, key):
        return (mark["timers1"].get(name, {}).get(key, 0)
                - mark["timers0"].get(name, {}).get(key, 0))

    run.counts.update(
        pairs=len(idx), done_idx=idx, batches=delta("factory.dispatch", "calls"),
        write_s=delta("factory.host_write", "total_s"),
        write_batches=delta("factory.host_write", "calls"),
        read_s=delta("factory.host_read_bg", "total_s"),
        reads=delta("factory.host_read_bg", "calls"))


def _sample(run, idx: list) -> list:
    """A seeded sample of the completed pairs, with the first and the last."""
    n = run.traffic["check_pairs"]
    if len(idx) <= n:
        return list(idx)
    pick = run.rng("check").choice(len(idx) - 2, size=n - 2, replace=False) + 1
    return [idx[0], *sorted(idx[i] for i in pick), idx[-1]]


def compare(run, state, tf32: bool = False) -> dict:
    """The compared numbers over the sampled pairs: hr's largest difference
    from its input, and lr's largest difference from the plain degrade +
    noise over the pair's largest |lr|. tf32=True puts the control (the
    plain degrade in TF32) in the program's place for lr."""
    cfg, tr = run.config["factory"], run.traffic
    n_phys = tr["physical_files"]
    draws = pool_indices(cfg["seed"], tr["names"], state["pool"].shape[0])
    hr_err, lr_err = 0.0, 0.0
    out = run.tmp / "out_closed"
    for k in _sample(run, run.counts["done_idx"]):
        name = out / f"p{k:05d}_denoised_train.nc"
        hr_in = state["denoised"][k % n_phys]
        ref = (plain_degrade(torch.from_numpy(hr_in)[None].to(run.device), state["kernel"],
                             cfg["factor"])[0]
               + state["pool"][draws[k]].to(torch.float64))
        if tf32:
            got = (plain_degrade(torch.from_numpy(hr_in)[None].to(run.device),
                                 state["kernel"], cfg["factor"], tf32=True)[0]
                   + state["pool"][draws[k]]).double()
        else:
            hr = nc.read_bands(str(name), "hr")
            hr_err = max(hr_err, float(np.abs(hr.astype(np.float64) - hr_in).max()))
            got = torch.from_numpy(nc.read_bands(str(name), "lr")).to(run.device, torch.float64)
        lr_err = max(lr_err, float((got - ref).abs().max() / ref.abs().max()))
    return {"hr_max_abs": hr_err, "lr_max_rel": lr_err}


def verify(run, state) -> None:
    lim = run.traffic["limits"]
    got = compare(run, state)
    run.check("pairs_in_window", run.counts["pairs"], 1, at_least=True)
    run.check("missing_pairs", run.failed, 0)
    run.check("hr_max_abs", got["hr_max_abs"], lim["hr_max_abs"])
    run.check("lr_max_rel", got["lr_max_rel"], lim["lr_max_rel"])


def control(run, state) -> dict:
    return compare(run, state, tf32=True)
