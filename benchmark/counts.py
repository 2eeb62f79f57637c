"""The yardstick's arithmetic: published peaks of the card, and the
operations and bytes of the work the cells time, counted from shapes.

Peaks are NVIDIA's data-sheet numbers (dense, no sparsity) at the card's
full power limit; a share of them is stated beside the card's
`power.limit`. Each count is of what the algorithm needs, not of what an
implementation happens to do: every input byte read once, every output
byte written once, 2 operations a multiply-add.
"""
from __future__ import annotations

#: (substring of the card's name, HBM bytes/s, float32 FLOP/s outside the
#: tensor cores, bf16 dense tensor-core FLOP/s)
PEAKS = [
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100", 3.35e12, 67e12, 989e12),
]


def peaks(kind: str) -> dict | None:
    """The peaks of the card named `kind`, or None for another device."""
    for sub, bw, fp32, bf16 in PEAKS:
        if sub in kind:
            return {"bytes_per_s": bw, "fp32": fp32, "bf16": bf16}
    return None


def degrade_cost(batch: int, bands: int, size: int, kernel: int, factor: int) -> dict:
    """One fused degrade call, lr = blur(hr) decimated by block mean +
    noise: bytes of hr, noise and lr once; operations of the composed
    (kernel + factor - 1)-wide stencil, 2 a tap, per lr value."""
    lr_vals = batch * bands * (size // factor) ** 2
    span = kernel + factor - 1
    return {"bytes": 4 * (batch * bands * size * size + 2 * lr_vals),
            "flops": 2 * span * span * lr_vals}


def roofline_s(cost: dict, peaks_: dict, flops_peak: str) -> float:
    """The least time of `cost` on the card: the larger of its bytes at the
    HBM rate and its operations at the named peak."""
    return max(cost["bytes"] / peaks_["bytes_per_s"], cost["flops"] / peaks_[flops_peak])


def conv_flops(out_positions: int, k: int, c_in: int, c_out: int) -> int:
    return 2 * out_positions * k * k * c_in * c_out


def sr_flops_per_tile(cfg: dict, h: int, w: int) -> int:
    """One tile through the SR network: the head, 2 convs a residual block,
    the body's tail, the upsampler's convs (progressive: one width ->
    4 width conv a x2 stage but the last, at that stage's input size; the
    last stage's conv width -> 4 bands at factor/2; oneshot: one width ->
    bands factor^2 conv at LR) and the bilinear skip's two matmuls a band."""
    c, wd, f = cfg["bands"], cfg["sr_width"], cfg["factor"]
    px = h * w
    flops = conv_flops(px, 3, c, wd) + (2 * cfg["sr_blocks"] + 1) * conv_flops(px, 3, wd, wd)
    if cfg["sr_upsampler"] == "oneshot":
        flops += conv_flops(px, 3, wd, c * f * f)
    else:
        stages = f.bit_length() - 1
        for i in range(stages - 1):
            flops += conv_flops(px * 4 ** i, 3, wd, 4 * wd)
        flops += conv_flops(px * 4 ** (stages - 1), 3, wd, 4 * c)
    H, W = h * f, w * f
    flops += c * (2 * H * h * w + 2 * H * w * W)
    return flops


def kernelgan_flops_per_scene_it(tk: dict) -> int:
    """One KernelGAN iteration of one scene in compose form: G as its
    composed per-band kernel applied once to the HR batch (the block mean's
    adds left out), D's convs on three batches (real, fake for D's step,
    fake for G's), and the backward passes as twice the forward."""
    b, c, f = tk["batch_size"], tk["bands"], tk["factor"]
    span = sum(tk["g_kernel_sizes"]) - len(tk["g_kernel_sizes"]) + 1
    hr_px = b * tk["hr_patch_size"] ** 2
    g = 2 * span * span * c * hr_px
    px = b * tk["lr_crop_size"] ** 2
    d = conv_flops(px, tk["d_first_kernel"], c, tk["d_base_ch"])
    d += tk["d_blocks"] * conv_flops(px, 1, tk["d_base_ch"], tk["d_base_ch"])
    d += conv_flops(px, 1, tk["d_base_ch"], 1)
    return 3 * (g + 3 * d)
