#!/usr/bin/env python3
"""KernelGAN's generator chain on one CUDA card: precision and layout A/B.

    python3 scripts/torch_kernelgan_ab.py [--batch 16] [--runs 5]

1. precision: one `make_base_step` at the default widths (batch 2,
   real_is_lr, the G init perturbed by N(0, 0.005)) on the card in float32
   and float64 and on the CPU in float32; prints each float32 run's
   relative error against the card's float64 run for the losses, the grad
   norms and each G layer's gradient, with cuDNN's TF32 off for the whole
   step (forward and backward) and, for comparison, off only around the
   forward convs (TF32 allowed in the backward, the PyTorch default), and
   with cuDNN off (PyTorch's own convolutions).
2. layout: G's grouped chain forward + backward (weight gradients) at
   batch `--batch` of 5x256x256, mid_ch 32, TF32 off, as NCHW (the
   trainer's layout) and as channels_last, each with and without
   `cudnn.benchmark`: CUDA-event median of `--runs` calls after 2 warm-up
   calls, the profiler's top kernels, and each variant's largest
   difference from the NCHW gradients.

Prints one JSON line at the end. Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def step_metrics(dev, dtype, tf32_backward: bool, cudnn: bool = True, seed: int = 9) -> dict:
    import numpy as np
    import torch

    from kmsr_tpu_torch.models import (DiscriminatorConfig, GeneratorConfig,
                                       init_discriminator, init_generator)
    from kmsr_tpu_torch.train import SingleKernelConfig, init_gan_state, make_base_step
    from kmsr_tpu_torch.train.state import make_gan_optimizers, tree_map

    rng = np.random.default_rng(seed)
    g = {"layers": [w + torch.from_numpy(rng.normal(0, 0.005, w.shape).astype(np.float32))
                    for w in init_generator(GeneratorConfig(), device="cpu")["layers"]]}
    d, ds = init_discriminator(DiscriminatorConfig(), seed=0, device="cpu")
    hr = torch.from_numpy(rng.normal(5, 2, (2, 5, 256, 256)).astype(np.float32))
    real = torch.from_numpy(rng.normal(5, 2, (2, 5, 32, 32)).astype(np.float32))
    to = lambda t: t.to(dev, dtype)  # noqa: E731
    g, d, ds = tree_map(to, g), tree_map(to, d), tree_map(to, ds)
    tx = make_gan_optimizers()
    state = init_gan_state(torch.Generator(device=dev).manual_seed(0), g, d, ds, tx, tx)
    cfg = SingleKernelConfig(batch_size=2, real_is_lr=True, outdir="unused")
    torch.backends.cudnn.allow_tf32 = tf32_backward
    torch.backends.cudnn.enabled = cudnn
    try:
        _, m = make_base_step(cfg)(state, to(hr), to(real))
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.enabled = True
    out = {k: float(m[k]) for k in ("loss_D", "loss_G_adv", "loss_reg",
                                    "grad_norm_D", "grad_norm_G")}
    out["g_layer_grads"] = [t.double().cpu() for t in m["grads_G"]["layers"]]
    return out


def precision(dev) -> dict:
    import torch

    ref = step_metrics(dev, torch.float64, False)
    runs = {"card f32, TF32 off": step_metrics(dev, torch.float32, False),
            "card f32, TF32 in backward": step_metrics(dev, torch.float32, True),
            "card f32, cuDNN off": step_metrics(dev, torch.float32, False, cudnn=False),
            "cpu f32": step_metrics(torch.device("cpu"), torch.float32, False)}
    result = {}
    for name, m in runs.items():
        rel = {k: abs(m[k] - ref[k]) / abs(ref[k]) for k in ref if k != "g_layer_grads"}
        rel["g_layer_grads"] = [float((a - b).norm() / b.norm())
                                for a, b in zip(m["g_layer_grads"], ref["g_layer_grads"])]
        result[name] = rel
        print(f"[precision] {name} vs card f64: " + ", ".join(
            f"{k} {v:.2e}" for k, v in rel.items() if k != "g_layer_grads")
            + f"; G layer grads {[f'{v:.1e}' for v in rel['g_layer_grads']]}", flush=True)
    return result


def chain(layers, x, channels_last: bool):
    import torch
    import torch.nn.functional as F

    fmt = torch.channels_last if channels_last else torch.contiguous_format
    h = x.contiguous(memory_format=fmt)
    for w in layers:
        bands, out_c, in_c, k, _ = w.shape
        if k > 1:
            h = F.pad(h, (k // 2,) * 4, mode="reflect").contiguous(memory_format=fmt)
        h = F.conv2d(h, w.reshape(bands * out_c, in_c, k, k).contiguous(memory_format=fmt),
                     groups=bands)
    return h


def layout(dev, batch: int, runs: int) -> dict:
    import numpy as np
    import torch

    from kmsr_tpu_torch.models import GeneratorConfig, init_generator
    from kmsr_tpu_torch.ops.degrade import block_mean, fp32_convs
    from kmsr_tpu_torch.utils.profiling import cuda_device_ms, cuda_time_ms

    rng = np.random.default_rng(1)
    layers = [(w + 0.005 * torch.randn(w.shape, generator=torch.Generator().manual_seed(i)))
              .to(dev).requires_grad_(True)
              for i, w in enumerate(init_generator(GeneratorConfig(), device="cpu")["layers"])]
    x = torch.from_numpy(rng.normal(5, 2, (batch, 5, 256, 256)).astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.normal(0, 1, (batch, 5, 32, 32)).astype(np.float32)).to(dev)
    result, base = {}, None
    for channels_last in (False, True):
        for bench in (False, True):
            name = f"{'channels_last' if channels_last else 'nchw'}" + ("+benchmark" if bench else "")
            torch.backends.cudnn.benchmark = bench

            def fwd_bwd():
                with fp32_convs():
                    y = block_mean(chain(layers, x, channels_last), 8)
                    return torch.autograd.grad((y * r).sum(), layers)

            grads = fwd_bwd()
            ms = cuda_time_ms(fwd_bwd, runs=runs)
            dev_t = cuda_device_ms(fwd_bwd, runs=2)
            top = sorted(dev_t["kernels"].items(), key=lambda kv: -kv[1])[:5]
            if base is None:
                base = grads
            diff = max(float(((a - b).abs().max() / b.abs().max())) for a, b in zip(grads, base))
            result[name] = {"ms": ms["median_ms"], "min_ms": ms["min_ms"],
                            "device_ms": dev_t["device_ms"], "max_rel_diff_vs_nchw": diff,
                            "top_kernels": {k[:90]: v for k, v in top}}
            print(f"[layout] {name}: fwd+bwd {ms['median_ms']:.2f} ms (min {ms['min_ms']:.2f}; "
                  f"device {dev_t['device_ms']:.2f}); grads vs nchw max rel {diff:.1e}; top "
                  + "; ".join(f"{k[:60]} {v:.2f}" for k, v in top), flush=True)
    torch.backends.cudnn.benchmark = False
    return result


def main() -> int:
    import subprocess

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--runs", type=int, default=5)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out = {"card": smi, "precision": precision(dev), "layout": layout(dev, a.batch, a.runs)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
