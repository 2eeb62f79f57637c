"""Per-host batch data parallelism for the file-batched stages.

Counterpart of `kmsr_tpu.parallel.local_dp`. One process drives every card
of its host: a host batch is padded to a multiple of the card count, its
contiguous blocks go to cuda:0, cuda:1, ... through pinned, non-blocking
copies, the stage's function is launched on each block on that block's
card (the launches are asynchronous, so the cards work at once), and the
outputs are gathered back in order. There is no communication between the
cards. The multi-process input layer (`parallel.multihost`) already
shards FILES across ranks; these helpers never span processes.

With one card (or one device given) the batch goes up whole and unpadded,
and the stage runs as it does without these helpers.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


def local_batch_dp(
    device: str | torch.device = "cuda",
    devices: Optional[Sequence[str | torch.device]] = None,
) -> tuple[list[torch.device], int]:
    """(devices, n_dev) for per-host batch DP: `devices` when given (the
    tests pass [cpu, cpu]); for device "cuda" with no index, every visible
    card; else [device] alone."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("devices must name at least one device")
        for d in devs:
            resolve_device(d)
        return devs, len(devs)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return devs, len(devs)
    return [dev], 1


def _upload(host: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if dev.type == "cuda" and host.device.type == "cpu":
        if not (host.is_pinned() and host.is_contiguous()):
            host = host.contiguous().pin_memory()
        return host.to(dev, non_blocking=True)
    return host.to(dev)


def pad_put(host, devices: Optional[Sequence[torch.device]], n_dev: int,
            axis: int = 0) -> tuple[list[torch.Tensor], int]:
    """Pad `axis` (the batch axis) with zeros to an n_dev multiple and place
    one contiguous block of it on each of `devices`; returns (blocks,
    original_b). Callers gather the outputs and slice them back to
    original_b. With `devices` None or a single device: one block, the
    whole unpadded batch (on the CPU when `devices` is None)."""
    t = torch.as_tensor(host) if isinstance(host, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(host))
    axis = axis % t.ndim
    b = t.shape[axis]
    if devices is None:
        return [t], b
    if n_dev != len(devices):
        raise ValueError(f"n_dev {n_dev} != {len(devices)} devices")
    if n_dev == 1:
        return [_upload(t, devices[0])], b
    b_pad = -(-b // n_dev) * n_dev
    if b_pad != b:
        pad_shape = list(t.shape)
        pad_shape[axis] = b_pad - b
        t = torch.cat([t, t.new_zeros(pad_shape)], dim=axis)
    step = b_pad // n_dev
    return [_upload(t.narrow(axis, i * step, step), d)
            for i, d in enumerate(devices)], b


def local_map(fn: Callable, *block_lists: Sequence[torch.Tensor]) -> list:
    """[fn(*blocks_i) for each device i], each call made with its blocks'
    card current, so every launch and allocation lands on that card; the
    calls return without waiting, and the cards run concurrently."""
    outs = []
    for args in zip(*block_lists):
        dev = args[0].device
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                outs.append(fn(*args))
        else:
            outs.append(fn(*args))
    return outs


def gather(outs: Sequence[torch.Tensor], b: int, axis: int = 0,
           device: Optional[torch.device] = None) -> torch.Tensor:
    """The per-device outputs concatenated in device order along `axis` on
    `device` (default: the first output's), sliced back to b rows. One
    output is returned as it is (sliced only when it was padded)."""
    if len(outs) == 1 and device is None:
        out = outs[0]
    else:
        dst = outs[0].device if device is None else device
        out = torch.cat([o.to(dst, non_blocking=True) for o in outs], dim=axis)
    return out if out.shape[axis] == b else out.narrow(axis, 0, b)
