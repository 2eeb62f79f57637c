"""The yardstick's counts against hand counts at small shapes."""
from __future__ import annotations

import pytest

import counts


def test_degrade_cost_by_hand():
    # 2 patches x 1 band of 16^2, x4, a 3x3 kernel: lr 2 x 4^2 = 32 values;
    # bytes: hr 512 + noise 32 + lr 32 floats; a 6x6 composed stencil a value
    cost = counts.degrade_cost(2, 1, 16, 3, 4)
    assert cost == {"bytes": 4 * (512 + 32 + 32), "flops": 2 * 36 * 32}


def test_roofline_picks_the_longer_bound():
    p = {"bytes_per_s": 100.0, "fp32": 10.0}
    assert counts.roofline_s({"bytes": 200, "flops": 10}, p, "fp32") == 2.0
    assert counts.roofline_s({"bytes": 100, "flops": 50}, p, "fp32") == 5.0


def test_peaks_of_the_h100():
    p = counts.peaks("NVIDIA H100 80GB HBM3")
    assert p == {"bytes_per_s": 3.35e12, "fp32": 67e12, "bf16": 989e12}
    assert counts.peaks("cpu") is None


def test_sr_flops_by_hand():
    # 1 band, width 2, 1 block, x4 progressive, a 2x2 tile: 4 LR positions
    cfg = {"bands": 1, "sr_width": 2, "sr_blocks": 1, "factor": 4,
           "sr_upsampler": "progressive"}
    head = 2 * 4 * 9 * 1 * 2
    trunk = 3 * 2 * 4 * 9 * 2 * 2          # two block convs and the body's tail
    up = 2 * 4 * 9 * 2 * 8                 # width -> 4 width at 2x2
    tail = 2 * 16 * 9 * 2 * 4              # width -> 4 bands at 4x4
    skip = 2 * 8 * 2 * 2 + 2 * 8 * 2 * 8   # [8,2]@[2,2], then [8,2]@[2,8]
    assert counts.sr_flops_per_tile(cfg, 2, 2) == head + trunk + up + tail + skip


def test_kernelgan_flops_by_hand():
    tk = {"batch_size": 1, "bands": 1, "factor": 2, "g_kernel_sizes": [3, 1],
          "hr_patch_size": 4, "lr_crop_size": 2, "d_first_kernel": 3, "d_base_ch": 2,
          "d_blocks": 1}
    g = 2 * 9 * 16                          # a 3x3 composed kernel on 16 HR pixels
    d = 2 * 4 * 9 * 2 + 2 * 4 * 2 * 2 + 2 * 4 * 2   # 3x3 1->2, 1x1 2->2, 1x1 2->1
    assert counts.kernelgan_flops_per_scene_it(tk) == 3 * (g + 3 * d)


@pytest.mark.parametrize("cfg,lo,hi", [
    ({"bands": 5, "sr_width": 64, "sr_blocks": 8, "factor": 8, "sr_upsampler": "progressive"},
     3.0e9, 3.4e9),
])
def test_sr_flops_at_the_shipped_width(cfg, lo, hi):
    # 1.55 M multiply-adds an LR pixel in the convs, 1,024 pixels a tile
    assert lo < counts.sr_flops_per_tile(cfg, 32, 32) < hi
