"""HAT's operations a tile, counted from shapes as `counts_swinir.py`
counts SwinIR's: 2 operations a multiply-add; LayerNorm, softmax, GELU, the
channel gate (a pool and two 1x1 convs a tile, not a token), the bias and
residual adds and the shuffles are not counted. The network runs on the
map padded to a multiple of the window, so that is the map counted."""
from __future__ import annotations

from counts import conv_flops


def hat_flops_per_tile(cfg: dict, h: int, w: int) -> int:
    """One tile of h x w LR pixels through HAT (classical SR, pixel-shuffle
    upsampler), for a configuration's `sr` section: per HAB token the four
    linears (qkv, proj, fc1, fc2), the two window-attention products (q k^T
    and A v, N = window^2 keys a head dim a head) and the conv branch's two
    3x3 convs (C -> C / compress_ratio -> C); per OCAB token its four
    linears and the two products at M = (window + int(overlap_ratio *
    window))^2 keys; the 3x3 convs conv_first, one an RHAG, conv_after_body
    and conv_before_upsample at LR; each upsample conv at its stage's input
    size; conv_last at the output size."""
    ws, e, f = cfg["window_size"], cfg["embed_dim"], cfg["factor"]
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    tokens = hp * wp
    n, m = ws * ws, (ws + int(ws * cfg["overlap_ratio"])) ** 2
    hidden, mid = int(e * cfg["mlp_ratio"]), e // cfg["compress_ratio"]
    linears = 2 * tokens * (3 * e * e + e * e + 2 * e * hidden)
    cab = conv_flops(tokens, 3, e, mid) + conv_flops(tokens, 3, mid, e)
    flops = sum(cfg["depths"]) * (linears + 2 * tokens * 2 * n * e + cab)
    flops += len(cfg["depths"]) * (linears + 2 * tokens * 2 * m * e)
    flops += conv_flops(tokens, 3, cfg["bands"], e)
    flops += (len(cfg["depths"]) + 1) * conv_flops(tokens, 3, e, e)
    flops += conv_flops(tokens, 3, e, cfg["num_feat"])
    px = tokens
    for _ in range(f.bit_length() - 1):  # x2 stages
        flops += conv_flops(px, 3, cfg["num_feat"], 4 * cfg["num_feat"])
        px *= 4
    flops += conv_flops(px, 3, cfg["num_feat"], cfg["bands"])
    return flops
