"""Stage: SR inference over a folder of .nc files.

Counterpart of `kmsr_tpu.pipeline.sr_infer`, with the same flags plus
`--device` (cuda by default; without a card it raises unless `--device
cpu`). It reads the `lr` group of each file (and its `hr` group where
there is one) in chunks on a background thread, runs the SR CNN in
bfloat16 per shape group, writes an `sr` group (dims y_sr / x_sr, attrs
`model_file` and `factor`) into a copy of each file, and reports
PSNR/SSIM against `hr` (data range nanmax - nanmin of each file's hr).

The device loop (`run_batches`) takes any source of chunks, so it runs on
in-memory stacks too. It keeps a one-deep pipeline: group k+1 is staged
(pinned memory), uploaded and dispatched before group k is synchronized,
and each group's predictions and metrics are copied, on the same stream,
into one pinned host buffer a group, which the callback receives as numpy
views (no copy on the host; a callback that keeps them keeps that
buffer), so the host's file writes overlap the next forward.
A failed group fails its files only; `DeviceSyncGuard` aborts the run
when the device keeps failing. Each group is split over the host's cards
(`parallel.local_dp`: the SR forward has no cross-sample state), as JAX
shards the file batch over its local devices.

Three networks (`--arch`): the compact EDSR (`models.sr`, default),
SwinIR-M (`models.swinir`) and HAT-SRx4 (`models.hat`), the last two at
their published widths; `sr_forward` routes by the configuration's type.

Usage:
    python -m kmsr_tpu_torch.pipeline.sr_infer --input-dir TRAIN_DATA \
        --model sr_model.npz --output-dir OUT [--arch edsr|swinir|hat] \
        [--factor 8 (4 for hat)] [--batch-size 128] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from contextlib import nullcontext
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..data.sampler import list_patch_files
from ..device import resolve_device
from ..io.ncio import NCFile, copied, read_band_stack, write_bands
from ..io.schema import GROUP_HR, GROUP_LR
from ..models.sr import SRConfig, init_sr, sr_forward
from ..models.hat import HATConfig, init_hat
from ..models.swinir import SwinIRConfig, init_swinir
from ..ops.metrics import psnr, ssim
from ..utils.params_io import load_params
from ..utils.profiling import stage_timer
from ..utils.tree import tree_map
from .common import DeviceSyncGuard, RunReport, chunked_reader, local_batch_dp

#: one chunk of input: (paths, [(lr [C,h,w], hr [C,H,W] or None)], failures)
Chunk = tuple[list, list, list]


#: the SR networks' configurations
SRConfigs = SRConfig | SwinIRConfig | HATConfig


def load_sr_model(model_path: str, cfg: SRConfigs,
                  device: str | torch.device = "cuda") -> dict:
    """The `.npz` model at model_path on `device`: an EDSR (either
    package's) for an `SRConfig`, a SwinIR or a HAT (published names) for a
    `SwinIRConfig` or a `HATConfig`."""
    dev = resolve_device(device)
    init = (init_hat if isinstance(cfg, HATConfig) else
            init_swinir if isinstance(cfg, SwinIRConfig) else init_sr)
    return load_params(model_path, init(cfg, device="cpu"), dev)


def _staged(arrays: list, dev: torch.device) -> torch.Tensor:
    """np.stack(arrays) on `dev`, through pinned memory when dev is a card."""
    host = torch.empty((len(arrays), *arrays[0].shape), dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    np.stack(arrays, axis=0, out=host.numpy())
    return host.to(dev, non_blocking=True)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t`, queued (pinned, non-blocking) when t is on a card."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    return host.copy_(t, non_blocking=True)


def queued_event(dev: torch.device) -> Optional[torch.cuda.Event]:
    """An event recorded behind the work queued so far on a card (None on
    the CPU, where every copy has already happened)."""
    if dev.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record()
    return done


def data_range(hr: torch.Tensor) -> torch.Tensor:
    """nanmax - nanmin of each [C, H, W] sample, 1.0 where it is 0 (the
    JAX stage's `float(np.nanmax(hr) - np.nanmin(hr)) or 1.0`)."""
    nan = torch.isnan(hr)
    hi = torch.where(nan, -torch.inf, hr).amax(dim=(1, 2, 3))
    lo = torch.where(nan, torch.inf, hr).amin(dim=(1, 2, 3))
    dr = hi - lo
    return torch.where(dr == 0, 1.0, dr)


def _landed(t: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """`to_host(t)`, or t's copy queued into the host tensor `out`."""
    return to_host(t) if out is None else out.copy_(t, non_blocking=True)


def dispatch(params: dict, lrs: list, hrs: Optional[list], cfg: SRConfigs,
             dev: torch.device, item=None, out: Optional[torch.Tensor] = None,
             metrics_out: Optional[torch.Tensor] = None) -> tuple:
    """Queue one shape group on `dev`: upload, bfloat16 forward, PSNR/SSIM
    against hrs (when given) on the device, and the copies back. Returns
    (preds host tensor, metrics host tensor [b, 2] or None, done event or
    None); the host tensors are valid once the event has completed. The
    copies land in the host tensors `out` ([b, C, H, W]) and `metrics_out`
    ([b, 2]) where given (pinned, when dev is a card, for the copies to be
    asynchronous), else in new host tensors. Spans
    `sr_infer.stage` (the uploads) and `sr_infer.launch` (the rest), with
    `item`."""
    with stage_timer("sr_infer.stage", item=item):
        lr = _staged(lrs, dev)
        hr = None if hrs is None else _staged(hrs, dev)
    with stage_timer("sr_infer.launch", item=item):
        pred = sr_forward(params, lr, cfg, item=item)
        metrics = None
        if hr is not None:
            if hr.shape != pred.shape:
                raise ValueError(f"{GROUP_HR} {tuple(hr.shape[1:])} != sr "
                                 f"{tuple(pred.shape[1:])}")
            dr = data_range(hr)
            metrics = _landed(torch.stack([psnr(pred, hr, dr), ssim(pred, hr, dr)], dim=1),
                              metrics_out)
        return _landed(pred, out), metrics, queued_event(dev)


def _blocks(arrays: list, n_dev: int) -> list[list]:
    """`arrays` padded with zero arrays to an n_dev multiple and cut into
    n_dev contiguous blocks (one block, unpadded, for one device)."""
    if n_dev == 1:
        return [arrays]
    step = -(-len(arrays) // n_dev)
    padded = arrays + [np.zeros_like(arrays[0])] * (step * n_dev - len(arrays))
    return [padded[i * step:(i + 1) * step] for i in range(n_dev)]


def run_batches(
    chunks: Iterable[Chunk],
    params: dict,
    cfg: SRConfigs,
    on_batch: Callable[[list, np.ndarray, Optional[np.ndarray]], None],
    device: str | torch.device = "cuda",
    devices=None,
) -> list:
    """The device loop: each chunk split into groups of one (lr, hr)
    shape, each group dispatched, and on_batch(paths, preds [b, C, H, W],
    metrics [b, 2] (psnr, ssim) or None) called once it is on the host,
    after the next group was dispatched. Returns the failures [(path,
    error)] of the chunks and of failed groups.

    Each group is split over the host's cards (for device "cuda", every
    visible card; `devices` names them explicitly), one contiguous block a
    card with the model copied to each. Each block's results are copied
    into its own rows of one host buffer a group (pinned when the devices
    are cards, from torch's caching host allocator), and preds and
    metrics are numpy views of that buffer's first b rows: no copy is made
    on the host. Holding preds holds the group's buffer; its memory goes
    back to the allocator only when the caller drops every view, so a
    kept preds is never overwritten."""
    devs, n_dev = local_batch_dp(device, devices)
    params_on = {d: tree_map(lambda t, d=d: t.to(d), params) for d in devs}
    pin = any(d.type == "cuda" for d in devs)
    fail: list = []
    sync_guard = DeviceSyncGuard()

    def finish(paths, buf, mbuf, events, k):
        # device-side failures surface at this sync: fail the group, not
        # the run (unless the guard sees the device persistently wedged)
        try:
            with stage_timer("sr_infer.device_sync", item=k):
                for done in events:
                    if done is not None:
                        done.synchronize()
            sync_guard.succeeded()
        except Exception as e:  # per-group failure isolation
            fail.extend((p, f"{type(e).__name__}: {e}") for p in paths)
            sync_guard.failed(e)
            return
        b = len(paths)
        with stage_timer("sr_infer.assemble", item=k) as counts:
            preds = buf[:b].numpy()
            metrics = None if mbuf is None else mbuf[:b].numpy()
            counts["bytes"] = preds.nbytes + (0 if metrics is None else metrics.nbytes)
        with stage_timer("sr_infer.deliver", item=k):
            on_batch(paths, preds, metrics)

    # group g's spans carry item=g; source_wait carries the next group's
    pending, k, source = None, 0, iter(chunks)
    while True:
        with stage_timer("sr_infer.source_wait", item=k):
            chunk = next(source, None)
        if chunk is None:
            break
        paths, items, chunk_fail = chunk
        fail.extend(chunk_fail)
        # per-shape groups: mixed-size inputs must not kill the run
        groups: dict = {}
        for p, (lr, hr) in zip(paths, items):
            key = (lr.shape, None if hr is None else hr.shape)
            groups.setdefault(key, []).append((p, lr, hr))
        for (lr_shape, hr_shape), items_g in groups.items():
            paths_g = [p for p, _, _ in items_g]
            g, k = k, k + 1
            try:
                with stage_timer("sr_infer.dispatch", item=g):
                    lrs = _blocks([lr for _, lr, _ in items_g], n_dev)
                    hrs = (_blocks([hr for _, _, hr in items_g], n_dev)
                           if hr_shape is not None else [None] * n_dev)
                    step = len(lrs[0])
                    c, h, w = lr_shape
                    buf = torch.empty((step * n_dev, c, h * cfg.factor, w * cfg.factor),
                                      dtype=torch.float32, pin_memory=pin)
                    mbuf = (None if hr_shape is None else
                            torch.empty((step * n_dev, 2), dtype=torch.float32, pin_memory=pin))
                    events = []
                    for i, (d, lr_b, hr_b) in enumerate(zip(devs, lrs, hrs)):
                        rows = slice(i * step, (i + 1) * step)
                        with torch.cuda.device(d) if d.type == "cuda" else nullcontext():
                            events.append(dispatch(
                                params_on[d], lr_b, hr_b, cfg, d, item=g, out=buf[rows],
                                metrics_out=None if mbuf is None else mbuf[rows])[2])
            except Exception as e:  # per-group failure isolation
                fail.extend((p, f"{type(e).__name__}: {e}") for p in paths_g)
                continue
            if pending is not None:
                finish(*pending)
            pending = (paths_g, buf, mbuf, events, g)
    if pending is not None:
        finish(*pending)
    return fail


def _read_pair(path: str, in_group: str, ref_group: str) -> tuple:
    lr = read_band_stack(path, in_group)
    with NCFile(path, "r") as f:
        has_ref = f.has_group(ref_group)
    return lr, read_band_stack(path, ref_group) if has_ref else None


def sr_infer_folder(
    input_dir: str,
    model_path: str,
    output_dir: str,
    cfg: SRConfigs = SRConfig(),
    in_group: str = GROUP_LR,
    ref_group: str = GROUP_HR,
    batch_size: int = 32,
    progress: bool = True,
    device: str | torch.device = "cuda",
) -> RunReport:
    t0 = time.time()
    dev = resolve_device(device)
    params = load_sr_model(model_path, cfg, dev)
    files = list_patch_files(input_dir, "*.nc")
    os.makedirs(output_dir, exist_ok=True)
    ok, fail, metrics = [], [], []

    reader = chunked_reader(files, batch_size, lambda p: _read_pair(p, in_group, ref_group))
    if progress:
        try:
            from tqdm import tqdm

            reader = tqdm(reader, desc="SR inference", unit="batch",
                          total=-(-len(files) // batch_size))
        except ImportError:
            pass

    def write(paths, preds, mets):
        for i, (path, pred) in enumerate(zip(paths, preds)):
            try:
                with stage_timer("sr_infer.host_write"):
                    base = os.path.splitext(os.path.basename(path))[0]
                    out_path = os.path.join(output_dir, f"{base}_sr.nc")
                    with copied(path, out_path) as f:  # the pair + the SR group
                        write_bands(f, "sr", pred, dims=("y_sr", "x_sr"),
                                    group_attrs={"model_file": os.path.basename(model_path),
                                                 "factor": cfg.factor})
                if mets is not None:
                    metrics.append(mets[i])
                ok.append(out_path)
            except Exception as e:
                fail.append((path, str(e)))

    fail.extend(run_batches(reader, params, cfg, write, dev))
    report = RunReport(succeeded=ok, failed=fail, seconds=time.time() - t0)
    msg = f"sr_infer: {report.summary()} -> {output_dir}"
    if metrics:
        arr = np.asarray(metrics, np.float64)
        msg += f" | PSNR {arr[:, 0].mean():.2f} dB, SSIM {arr[:, 1].mean():.4f}"
    print(msg)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="SR inference over .nc folder")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--arch", choices=["edsr", "swinir", "hat"], default="edsr",
                   help="edsr (default): the compact EDSR, sized by --width, --n-blocks "
                        "and --upsampler; swinir: SwinIR-M, hat: HAT-SRx4, each at its "
                        "published widths")
    p.add_argument("--factor", type=int, default=None,
                   help="the upscale: 8 by default, 4 (HAT-SRx4's) for --arch hat")
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--n-blocks", type=int, default=8)
    p.add_argument(
        "--upsampler", choices=["progressive", "oneshot"], default="progressive"
    )
    p.add_argument("--in-group", default=GROUP_LR)
    p.add_argument("--ref-group", default=GROUP_HR)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    factor = a.factor or (4 if a.arch == "hat" else 8)
    if a.arch == "hat":
        cfg = HATConfig(factor=factor)
    elif a.arch == "swinir":
        cfg = SwinIRConfig(factor=factor)
    else:
        cfg = SRConfig(width=a.width, n_blocks=a.n_blocks, factor=factor,
                       upsampler=a.upsampler)
    report = sr_infer_folder(
        a.input_dir, a.model, a.output_dir, cfg,
        in_group=a.in_group, ref_group=a.ref_group, batch_size=a.batch_size,
        device=a.device,
    )
    return 0 if report.n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
