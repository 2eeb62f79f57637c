#!/usr/bin/env python3
"""What deterministic algorithms cost the generator chains on one CUDA card.

    python3 scripts/torch_det_ab.py [--runs 7]

The trainers run their steps under `device.deterministic` on the card.
This times the grouped generator chain's forward + backward (every layer's
weight gradient) at the trainers' full widths -- KernelGAN's generator
(mid_ch 32, 7,5,3,1,1,1) at batch 16 and the dynamic model's modulated
chain at batch 8, both on 5x256x256 channels_last -- with and without
those algorithms, each layer spelt two ways: the package's
(`ops.kernel_algebra.chain_conv`: the first and the 1x1 layers' weight
gradients as GEMMs) and cuDNN's (plain `F.conv2d` autograd). CUDA-event
median of `--runs` calls after 2 warm-up calls; each spelling's largest
weight-gradient difference from a float64 chain on the card, over that
layer's largest gradient; and the profiler's top device ops under the
deterministic algorithms. Prints one JSON line at the end. Needs a card;
exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def chain_grads(layers, x, gy, scales, package: bool):
    """Weight gradients of the grouped chain (reflect pad, grouped conv,
    optional per-sample output scales) for the output cotangent gy."""
    import torch
    import torch.nn.functional as F

    from kmsr_tpu_torch.ops.degrade import fp32_convs
    from kmsr_tpu_torch.ops.kernel_algebra import chain_conv

    ws = [w.detach().requires_grad_(True) for w in layers]
    h = x.contiguous(memory_format=torch.channels_last)
    with fp32_convs():
        for i, w in enumerate(ws):
            bands, out_c, in_c, k, _ = w.shape
            if k > 1:
                p = k // 2
                h = F.pad(h, (p, p, p, p), mode="reflect").contiguous(
                    memory_format=torch.channels_last)
            wr = w.reshape(bands * out_c, in_c, k, k)
            h = chain_conv(h, wr, bands) if package else F.conv2d(h, wr, groups=bands)
            if scales is not None:
                h = h * scales[i].reshape(scales[i].shape[0], bands * out_c, 1, 1)
        grads = torch.autograd.grad((h * gy).sum(), ws)
    return grads


def top_ops(call, dev, n: int = 6) -> list:
    """The n aten ops with the most device time in one call (profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        call()
        torch.cuda.synchronize(dev)
    ops = []
    for ev in prof.key_averages(group_by_input_shape=True):
        us = getattr(ev, "self_device_time_total", None)
        us = us if us is not None else getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and ev.key.startswith("aten::"):
            ops.append({"op": ev.key, "shapes": str(ev.input_shapes)[:160], "ms": us / 1e3})
    return sorted(ops, key=lambda o: -o["ms"])[:n]


def main() -> int:
    import torch

    from kmsr_tpu_torch.device import deterministic
    from kmsr_tpu_torch.utils.profiling import cuda_time_ms

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=7)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_det_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    ks, mid = (7, 5, 3, 1, 1, 1), 32
    out = {"nvidia_smi": smi, "runs": a.runs}
    for label, batch, modulated in (("kernelgan_chain", 16, False), ("dynamic_chain", 8, True)):
        layers, in_c = [], 1
        for i, k in enumerate(ks):
            o = 1 if i == len(ks) - 1 else mid
            layers.append(0.1 * torch.randn(5, o, in_c, k, k, generator=gen, device=dev))
            in_c = o
        x = torch.randn(batch, 5, 256, 256, generator=gen, device=dev) * 2 + 5
        gy = torch.randn(batch, 5, 256, 256, generator=gen, device=dev)
        scales = ([1 + 0.1 * torch.randn(batch, 5, w.shape[1], generator=gen, device=dev)
                   for w in layers] if modulated else None)
        want = chain_grads([w.double() for w in layers], x.double(), gy.double(),
                           None if scales is None else [s.double() for s in scales], True)
        rec = {}
        for spelling in ("package", "cudnn"):
            for det in (False, True):
                def call():
                    return chain_grads(layers, x, gy, scales, spelling == "package")

                if det:
                    with deterministic(dev):
                        t = cuda_time_ms(call, runs=a.runs)
                        got = call()
                        top = top_ops(call, dev)
                else:
                    t = cuda_time_ms(call, runs=a.runs)
                    got = call()
                err = [float((g.double() - w).abs().max() / w.abs().max())
                       for g, w in zip(got, want)]
                name = f"{spelling}_{'deterministic' if det else 'default'}"
                rec[name] = {"median_ms": t["median_ms"], "min_ms": t["min_ms"],
                             "max_ms": t["max_ms"], "rel_err_vs_f64": err}
                print(f"{label} batch {batch}: {name}: {t['median_ms']:.3f} ms "
                      f"({t['min_ms']:.3f}-{t['max_ms']:.3f}); weight-gradient error vs "
                      f"float64 per layer {[f'{e:.2e}' for e in err]}", flush=True)
                if det:
                    rec[name]["top_ops"] = top
                    print("  top device ops: " + "; ".join(
                        f"{o['op']} {o['shapes'][:70]} {o['ms']:.2f} ms" for o in top), flush=True)
        out[label] = rec
        del layers, x, gy, scales, want
        torch.cuda.empty_cache()
    print(json.dumps({"det_ab": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
