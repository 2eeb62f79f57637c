"""Plain SR network forward, float32 with TF32 off.

The architecture of the pipeline's SR CNN (`configs/quality_x8.json`'s
`sr_train`): a 3x3 head conv bands -> width; residual blocks x + 0.1 *
conv(relu(conv(x))); a 3x3 conv closing the body plus the head's output;
progressive x2 stages, each a width -> 4 width conv and a pixel shuffle,
the last one a width -> 4 bands conv; plus the input upsampled bilinearly
(half-pixel centres, edges clamped) to the output size. Weights are given
as {"head", "blocks": [{"c1", "c2"}], "body_tail", "ups": [...], "tail"},
each {"w": [3, 3, in, out], "b": [out]}.

`fp8=True` is the control: every conv's and the skip's operands rounded to
float8 e4m3 (each tensor scaled to the format's range first), products
accumulated in float32, one precision step below the bfloat16 the
configuration serves in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 after scaling its largest |value| to 448."""
    scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _conv(x: torch.Tensor, p: dict, fp8: bool) -> torch.Tensor:
    w = p["w"].float().permute(3, 2, 0, 1)
    if fp8:
        x, w = round_fp8(x), round_fp8(w)
    return F.conv2d(x, w, p["b"].float(), padding=1)


def forward(params: dict, x: torch.Tensor, factor: int, res_scale: float = 0.1,
            fp8: bool = False) -> torch.Tensor:
    """x [n, bands, h, w] -> [n, bands, h * factor, w * factor], float32."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = x.float()
        h = _conv(x, params["head"], fp8)
        body = h
        for blk in params["blocks"]:
            body = body + res_scale * _conv(F.relu(_conv(body, blk["c1"], fp8)), blk["c2"], fp8)
        up = _conv(body, params["body_tail"], fp8) + h
        for p in params["ups"]:
            up = F.pixel_shuffle(_conv(up, p, fp8), 2)
        out = F.pixel_shuffle(_conv(up, params["tail"], fp8), 2)
        size = (x.shape[-2] * factor, x.shape[-1] * factor)
        skip = F.interpolate(round_fp8(x) if fp8 else x, size=size, mode="bilinear",
                             align_corners=False)
        return skip + out
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
