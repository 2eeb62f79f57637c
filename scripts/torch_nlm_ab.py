#!/usr/bin/env python3
"""The NLM shift sweep's plain-PyTorch spellings on one CUDA card: A/B.

    python3 scripts/torch_nlm_ab.py [--files 8] [--runs 5]

Times spellings of `kmsr_tpu_torch.ops.nlm.nlm_denoise_2d` at the
denoise stage's full width (`--files` x 5 bands of 256x256, patch 7,
distance 11, per-image h and sigma) on one card: CUDA-event median of
`--runs` calls after one warm-up call, kernel launches per call (the
profiler), peak device memory, and each spelling's largest difference
from the module's own function. All spellings sweep the 23 lattice rows
with the row's 23 column shifts stacked on a new axis; they differ in

* layout: "nhwc" keeps the squared difference in the layout the stacked
  views give it (the shift axis innermost, channels_last), "nchw" writes
  it into a contiguous [L, S, H+6, W+6] buffer;
* box: "pool2" two `avg_pool2d` passes (7x1 then 1x7), "pool1" one 7x7
  `avg_pool2d`, "slices" JAX's 12 slice-adds then a divide;
* mask: "row" builds the border mask of each lattice row from index
  comparisons, "table" indexes a [S, S, H, W] table built once.

Prints one JSON line at the end. Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sweep(img, h, sigma, layout: str, box: str, mask: str, ps: int = 7, pd: int = 11):
    """nlm_denoise_2d spelled with the given layout / box / mask choice."""
    import torch
    import torch.nn.functional as F

    from kmsr_tpu_torch.ops.nlm import _per_image
    from kmsr_tpu_torch.ops.sigma import pad_index

    dev = img.device
    *lead, hgt, wid = img.shape
    x = img.reshape(-1, hgt, wid)
    n = x.shape[0]
    o, pad, s = ps // 2, pd + ps // 2, 2 * pd + 1
    up = x.index_select(1, pad_index(hgt, pad, "reflect", dev)).index_select(
        2, pad_index(wid, pad, "reflect", dev))
    var2 = 2.0 * _per_image(sigma, tuple(lead), dev) ** 2
    neg_h2 = -torch.clamp_min(_per_image(h, tuple(lead), dev) ** 2, 1e-12)
    hb, wb = hgt + 2 * o, wid + 2 * o
    a = up[:, pd:pd + hb, pd:pd + wb].unsqueeze(1)
    rows = torch.arange(hgt, device=dev)
    cols = torch.arange(wid, device=dev)
    t = torch.arange(-pd, pd + 1, device=dev)
    col_ok = ((cols + t[:, None] >= 0) & (cols + t[:, None] < wid)).unsqueeze(1)
    row_ok_all = ((rows + t[:, None] >= 0) & (rows + t[:, None] < hgt))[:, :, None]
    table = (row_ok_all[:, None] & col_ok[None]) if mask == "table" else None
    buf = torch.empty(n, s, hb, wb, device=dev) if layout == "nchw" else None
    out = torch.zeros_like(x)
    wsum = torch.zeros_like(x)
    for t1 in range(s):
        b = up[:, t1:t1 + hb, :].unfold(2, wb, 1).permute(0, 2, 1, 3)
        if layout == "nchw":
            sq = torch.sub(a, b, out=buf).square_()
        else:
            sq = F.mse_loss(a.expand_as(b), b, reduction="none").contiguous(
                memory_format=torch.channels_last)
        if box == "pool2":
            dist = F.avg_pool2d(F.avg_pool2d(sq, (ps, 1), stride=1), (1, ps), stride=1)
        elif box == "pool1":
            dist = F.avg_pool2d(sq, ps, stride=1)
        else:
            r = sq[..., 0:hgt, :]
            for d in range(1, ps):
                r = r + sq[..., d:d + hgt, :]
            dist = r[..., 0:wid]
            for d in range(1, ps):
                dist = dist + r[..., d:d + wid]
            dist = dist / (ps * ps)
        w = dist.sub_(var2).clamp_(min=0.0).div_(neg_h2).exp_()
        if table is not None:
            w.mul_(table[t1])
        else:
            w.mul_(((rows + (t1 - pd) >= 0) & (rows + (t1 - pd) < hgt))[:, None] & col_ok)
        shifted = up[:, t1 + o:t1 + o + hgt, o:o + wid + 2 * pd].unfold(
            2, wid, 1).permute(0, 2, 1, 3)
        out.add_((w * shifted).sum(1))
        wsum.add_(w.sum(1))
    return ((out + x) / (wsum + 1.0)).reshape(img.shape)


def launches(fn) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if (getattr(ev, "device_time_total", 0) or 0) > 0
               and not ev.key.startswith(("Memcpy", "Memset")))


def main() -> int:
    import numpy as np
    import torch

    from kmsr_tpu_torch.ops.nlm import nlm_denoise_2d
    from kmsr_tpu_torch.ops.sigma import estimate_sigma
    from kmsr_tpu_torch.utils.profiling import cuda_time_ms

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--files", type=int, default=8)
    p.add_argument("--runs", type=int, default=5)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_nlm_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(2.0, 0.1, (a.files, 5, 256, 256)).astype(np.float32)).to(dev)
    sig = estimate_sigma(x)
    h = sig * 1.0
    want = nlm_denoise_2d(x, h, sig)
    variants = {"module": lambda: nlm_denoise_2d(x, h, sig)}
    for layout in ("nhwc", "nchw"):
        for box in ("pool2", "pool1", "slices"):
            for mask in ("row", "table"):
                if mask == "table" and (layout, box) != ("nchw", "pool2"):
                    continue
                variants[f"{layout}/{box}/{mask}"] = (
                    lambda lay=layout, bx=box, m=mask: sweep(x, h, sig, lay, bx, m))
    result = {"card": torch.cuda.get_device_name(0), "shape": list(x.shape), "variants": {}}
    for name, fn in variants.items():
        torch.cuda.reset_peak_memory_stats(dev)
        got = fn()
        rec = {"max_abs_diff": float((got - want).abs().max()),
               "ms": cuda_time_ms(fn, runs=a.runs)["median_ms"],
               "launches": launches(fn),
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        result["variants"][name] = rec
        print(f"{name}: {rec}", flush=True)
        del got
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
