"""Driver of SR inference on LR tiles: `kmsr_tpu_torch.pipeline.sr_infer.
run_batches`, the stage's device loop, fed from memory.

Set-up makes the network's weights and a pool of `pool_tiles` GOCI-like LR
tiles from the seed, and warms the loop with `warm_batches` batches. The
window is one `run_batches` call on a closed loop: its source hands over
the next chunk of `batch_size` tiles when the loop asks for one (tiles in
pool order, cycling), until `run.seconds` have passed; a batch counts when
its predictions reached the callback inside the window. There is no hr, as
in GOCI-2 inference.

The callback keeps a seeded reservoir sample of `check_tiles` predictions,
one candidate tile a batch, over the whole window; the check runs the
plain float32 forward (`reference.sr`) on the same tiles.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import imagery
from reference import sr as plain_sr


def _params(run, cfg: dict) -> dict:
    """Fan-in uniform weights in the program's layout (HWIO), drawn on the
    device in one call and cut into tensors."""
    c, w, f = cfg["bands"], cfg["sr_width"], cfg["factor"]
    shapes = [("head", c, w)] + [(f"b{i}{j}", w, w) for i in range(cfg["sr_blocks"])
                                 for j in (1, 2)]
    shapes += [("body_tail", w, w)]
    shapes += [(f"up{i}", w, 4 * w) for i in range(f.bit_length() - 2)]
    shapes += [("tail", w, 4 * c)]
    sizes = [9 * i * o + o for _, i, o in shapes]
    flat = imagery.uniform(run.generator("sr_weights"), (sum(sizes),), 1.0, run.device)
    convs, at = {}, 0
    for (name, i, o), n in zip(shapes, sizes):
        bound = 1.0 / np.sqrt(9 * i)
        chunk = flat[at:at + n] * bound
        convs[name] = {"w": chunk[:9 * i * o].reshape(3, 3, i, o), "b": chunk[9 * i * o:]}
        at += n
    return {"head": convs["head"],
            "blocks": [{"c1": convs[f"b{i}1"], "c2": convs[f"b{i}2"]}
                       for i in range(cfg["sr_blocks"])],
            "body_tail": convs["body_tail"],
            "ups": [convs[f"up{i}"] for i in range(f.bit_length() - 2)],
            "tail": convs["tail"]}


def _sr_config(cfg: dict):
    from kmsr_tpu_torch.models.sr import SRConfig

    return SRConfig(in_ch=cfg["bands"], width=cfg["sr_width"], n_blocks=cfg["sr_blocks"],
                    factor=cfg["factor"], res_scale=cfg["res_scale"],
                    upsampler=cfg["sr_upsampler"])


def setup(run) -> dict:
    from kmsr_tpu_torch.pipeline.sr_infer import run_batches

    cfg, tr = run.config["sr"], run.traffic
    n, s = tr["pool_tiles"], cfg["lr_size"]
    tiles = imagery.fields(run.generator("tiles"), n, cfg["bands"], s, s, run.device)
    state = {"params": _params(run, cfg), "tiles": tiles.cpu().numpy(),
             "sr_cfg": _sr_config(cfg)}
    run.note("weights and tiles made")
    b = cfg["batch_size"]
    warm = [([f"w{j}" for j in range(b)],
             [(state["tiles"][(k * b + j) % n], None) for j in range(b)], [])
            for k in range(tr["warm_batches"])]
    run_batches(warm, state["params"], state["sr_cfg"], lambda *a: None, run.device)
    run.note("warm")
    return state


def window(run, state) -> None:
    from kmsr_tpu_torch.pipeline.sr_infer import run_batches
    from kmsr_tpu_torch.utils.profiling import timing_report

    cfg, tr = run.config["sr"], run.traffic
    b, n, f = cfg["batch_size"], tr["pool_tiles"], cfg["factor"]
    tiles = state["tiles"]
    handed, done, cb_s = {}, [], [0.0]
    reservoir, pick = [], run.rng("check")
    seen = [0]

    def source():
        k = 0
        while True:
            now = time.perf_counter()
            if now >= deadline:
                return
            if run.trace_t0 is not None and now >= run.trace_t0 + tr["trace_s"]:
                run.trace_stop()
            idx = [(k * b + j) % n for j in range(b)]
            handed[k] = time.perf_counter()
            yield [f"{k}:{i}" for i in idx], [(tiles[i], None) for i in idx], []
            k += 1

    def on_batch(paths, preds, _metrics):
        t = time.perf_counter()
        k = int(paths[0].split(":")[0])
        done.append((k, t))
        j = int(pick.integers(0, len(paths)))
        slot = len(reservoir) if len(reservoir) < tr["check_tiles"] else \
            int(pick.integers(0, seen[0] + 1))
        if slot < tr["check_tiles"]:
            item = (t, int(paths[j].split(":")[1]), preds[j].copy())
            if slot == len(reservoir):
                reservoir.append(item)
            else:
                reservoir[slot] = item
        seen[0] += 1
        cb_s[0] += time.perf_counter() - t

    timing_report(reset=True)
    run.trace_start()  # before the window: starting the profiler takes seconds
    t0 = run.begin_window()
    deadline = t0 + run.seconds
    fails = run_batches(source(), state["params"], state["sr_cfg"], on_batch, run.device)
    run.trace_stop()
    run.window_s = run.seconds
    timers = timing_report()
    inside = [(k, t) for k, t in done if t <= deadline]
    out_px = (cfg["lr_size"] * f) ** 2
    run.attempted = len(inside) * b
    run.failed = len(fails)
    lat = [(t - handed[k]) * 1e3 for k, t in inside]
    # the batches dispatched while the trace ran: its stop drained them
    traced = ([] if run.trace_t1 is None else
              [k for k, t in handed.items() if t <= run.trace_t1])
    run.counts.update(
        tiles=len(inside) * b, mpix=len(inside) * b * out_px / 1e6,
        batch_ms=lat,
        traced_tiles=len(traced) * b,
        host_s=(timers.get("sr_infer.dispatch", {}).get("total_s", 0.0)
                + timers.get("sr_infer.device_sync", {}).get("total_s", 0.0) + cb_s[0]),
        batches_all=len(done))
    state["sample"] = [(i, p) for t, i, p in reservoir if t <= deadline]


def compare(run, state, fp8: bool = False) -> dict:
    """The largest error over the sampled tiles, relative to the network's
    own part of the output: |pred - ref| / |ref - bilinear skip| (2-norms
    over a tile). fp8=True puts the control (the plain forward in float8)
    in the program's place."""
    cfg = run.config["sr"]
    worst = 0.0
    sample = state["sample"]
    for lo in range(0, len(sample), 16):
        part = sample[lo:lo + 16]
        x = torch.from_numpy(np.stack([state["tiles"][i] for i, _ in part])).to(run.device)
        ref = plain_sr.forward(state["params"], x, cfg["factor"], cfg["res_scale"])
        size = ref.shape[-2:]
        skip = torch.nn.functional.interpolate(x, size=size, mode="bilinear",
                                               align_corners=False)
        if fp8:
            got = plain_sr.forward(state["params"], x, cfg["factor"], cfg["res_scale"], fp8=True)
        else:
            got = torch.from_numpy(np.stack([p for _, p in part])).to(run.device)
        err = (got - ref).flatten(1).norm(dim=1) / (ref - skip).flatten(1).norm(dim=1)
        worst = max(worst, float(err.max()))
    return {"sr_rel_err": worst}


def verify(run, state) -> None:
    run.check("batches_in_window", run.counts["tiles"] // run.config["sr"]["batch_size"],
              1, at_least=True)
    run.check("failed_tiles", run.failed, 0)
    run.check("tiles_checked", len(state["sample"]), 1, at_least=True)
    run.check("sr_rel_err", compare(run, state)["sr_rel_err"], run.traffic["limits"]["sr_rel_err"])


def control(run, state) -> dict:
    return compare(run, state, fp8=True)
