"""SwinIR's operations a tile, counted from shapes as `counts.py` counts
the EDSR's: 2 operations a multiply-add; LayerNorm, softmax, GELU, the
bias and mask adds, the residual adds and the shuffles are not counted.
The network runs on the map padded to a multiple of the window, so that is
the map counted."""
from __future__ import annotations

from counts import conv_flops


def swinir_flops_per_tile(cfg: dict, h: int, w: int) -> int:
    """One tile of h x w LR pixels through SwinIR (classical SR,
    pixel-shuffle upsampler), for a configuration's `sr` section:
    per STL the four linears (qkv, proj, fc1, fc2) on every token and the
    two attention products (q k^T and A v, N x head dim a head and token);
    the 3x3 convs conv_first, one an RSTB, conv_after_body and
    conv_before_upsample at LR; each upsample conv at its stage's input
    size; conv_last at the output size."""
    ws, e, f = cfg["window_size"], cfg["embed_dim"], cfg["factor"]
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    tokens, n = hp * wp, ws * ws
    hidden = int(e * cfg["mlp_ratio"])
    stls = sum(cfg["depths"])
    linears = 2 * tokens * (3 * e * e + e * e + 2 * e * hidden)
    attention = 2 * tokens * 2 * n * e
    flops = stls * (linears + attention)
    flops += conv_flops(tokens, 3, cfg["bands"], e)
    flops += (len(cfg["depths"]) + 1) * conv_flops(tokens, 3, e, e)
    flops += conv_flops(tokens, 3, e, cfg["num_feat"])
    px = tokens
    for _ in range(f.bit_length() - 1):  # x2 stages
        flops += conv_flops(px, 3, cfg["num_feat"], 4 * cfg["num_feat"])
        px *= 4
    flops += conv_flops(px, 3, cfg["num_feat"], cfg["bands"])
    return flops
