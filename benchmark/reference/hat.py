"""Plain HAT forward (classical SR, pixel-shuffle upsampler), float32 with
TF32 off: a frozen copy of the repository's test reference
(`tests/helpers/hat_reference.py`), written from `hat/archs/hat_arch.py` of
https://github.com/XPixelGroup/HAT (Chen et al., "Activating More Pixels
in Image Super-Resolution Transformer", arXiv:2205.04437) module by module:
torch.roll, window partition and reverse, an explicit softmax with the -100
shift mask, `F.unfold` for the OCAB's overlapping windows,
`AdaptiveAvgPool2d` for the channel attention; no fused attention, no
cache, no token gathers. Imports torch only (not the port, not JAX).

Parameters are the published state dict's names and shapes
(`param_shapes`); `relative_position_index_SA`,
`relative_position_index_OCA` and `attn_mask` are built here, as the
published modules build them (`calculate_rpi_sa`, `calculate_rpi_oca`,
`calculate_mask`).

Departures from `hat_arch.py`:
- any number of bands in and out, with `mean` 0 (HAT's own rule when
  in_chans != 3; its RGB mean applies to 3 bands only);
- no drop-path, dropout or attention dropout (identities at inference);
- window `window_size` with shift `window_size // 2` on odd HABs at every
  map size (the published model's construction; the map is
  reflect-padded to a multiple of the window, as HAT's test-time
  `pre_process` pads it);
- `upsampler='pixelshuffle'` with a power-of-2 scale and
  `resi_connection='1conv'` only, `ape` False, `patch_norm` True,
  `patch_size` 1, qkv with bias, no qk_scale.

`fp8=True` is the control: the operands of every linear, conv and
attention matmul (q and k, the probabilities and v) rounded to float8
e4m3 (each tensor scaled to the format's range first), products
accumulated in float32, one precision step below the bfloat16 the port
serves in.

The helpers `shift_mask`, `channel_attention`, `cab` and
`overlap_attention` are module functions, so a test can replace one (a
knock-out) and see the output move.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: float8 e4m3's largest finite value
_E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 after scaling its largest |value| to 448."""
    scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _r(x, fp8):
    return round_fp8(x) if fp8 else x


def overlap_size(window_size: int, overlap_ratio: float) -> int:
    """OCAB's `overlap_win_size`."""
    return int(window_size * overlap_ratio) + window_size


def param_shapes(in_ch: int, embed_dim: int, depths, num_heads, window_size: int,
                 overlap_ratio: float, compress_ratio: int, squeeze_factor: int,
                 mlp_ratio: float, num_feat: int, factor: int) -> dict:
    """{published name: shape} of HAT's parameters."""
    e, hid, ws = embed_dim, int(embed_dim * mlp_ratio), window_size
    ows = overlap_size(ws, overlap_ratio)
    mid, sq = e // compress_ratio, e // squeeze_factor

    def pair(name, shape):
        return {name + ".weight": shape, name + ".bias": shape[:1]}

    out = {**pair("conv_first", (e, in_ch, 3, 3)), **pair("patch_embed.norm", (e,))}
    for i, (depth, heads) in enumerate(zip(depths, num_heads)):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}."
            out.update({**pair(b + "norm1", (e,)),
                        b + "attn.relative_position_bias_table": ((2 * ws - 1) ** 2, heads),
                        **pair(b + "attn.qkv", (3 * e, e)), **pair(b + "attn.proj", (e, e)),
                        **pair(b + "conv_block.cab.0", (mid, e, 3, 3)),
                        **pair(b + "conv_block.cab.2", (e, mid, 3, 3)),
                        **pair(b + "conv_block.cab.3.attention.1", (sq, e, 1, 1)),
                        **pair(b + "conv_block.cab.3.attention.3", (e, sq, 1, 1)),
                        **pair(b + "norm2", (e,)), **pair(b + "mlp.fc1", (hid, e)),
                        **pair(b + "mlp.fc2", (e, hid))})
        o = f"layers.{i}.residual_group.overlap_attn."
        out.update({o + "relative_position_bias_table": ((ws + ows - 1) ** 2, heads),
                    **pair(o + "norm1", (e,)), **pair(o + "qkv", (3 * e, e)),
                    **pair(o + "proj", (e, e)), **pair(o + "norm2", (e,)),
                    **pair(o + "mlp.fc1", (hid, e)), **pair(o + "mlp.fc2", (e, hid))})
        out.update(pair(f"layers.{i}.conv", (e, e, 3, 3)))
    out.update({**pair("norm", (e,)), **pair("conv_after_body", (e, e, 3, 3)),
                **pair("conv_before_upsample.0", (num_feat, e, 3, 3))})
    for k in range(int(math.log2(factor))):
        out.update(pair(f"upsample.{2 * k}", (4 * num_feat, num_feat, 3, 3)))
    out.update(pair("conv_last", (in_ch, num_feat, 3, 3)))
    return out


# ------------------------------------------------------------ derived tensors
def calculate_rpi_sa(ws: int) -> torch.Tensor:
    """HAT.calculate_rpi_sa: [N, N], N = ws^2."""
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def calculate_rpi_oca(ws: int, ows: int) -> torch.Tensor:
    """HAT.calculate_rpi_oca: [ws^2, ows^2], entries negative as well."""
    ori = torch.flatten(torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)],
                                                   indexing="ij")), 1)
    ext = torch.flatten(torch.stack(torch.meshgrid([torch.arange(ows), torch.arange(ows)],
                                                   indexing="ij")), 1)
    rel = (ext[:, None, :] - ori[:, :, None]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - ows + 1
    rel[:, :, 1] += ws - ows + 1
    rel[:, :, 0] *= ws + ows - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, ws, ws, C]."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B * nW, ws, ws, C] -> [B, H, W, C]."""
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def shift_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """HAT.calculate_mask: [nW, N, N], 0 or -100."""
    img_mask = torch.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0,
                                                                              float(0.0))


# ------------------------------------------------------------------ modules
def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], 1e-5)


def _linear(x, p, name, fp8=False):
    return F.linear(_r(x, fp8), _r(p[name + ".weight"], fp8), p[name + ".bias"])


def _conv(x, p, name, fp8=False, padding=1):
    return F.conv2d(_r(x, fp8), _r(p[name + ".weight"], fp8), p[name + ".bias"],
                    padding=padding)


def channel_attention(y, p, name, fp8=False):
    """ChannelAttention.forward: y * sigmoid(conv1x1(ReLU(conv1x1(pool(y)))))."""
    a = torch.nn.AdaptiveAvgPool2d(1)(y)
    a = F.relu(_conv(a, p, name + ".attention.1", fp8, padding=0))
    return y * torch.sigmoid(_conv(a, p, name + ".attention.3", fp8, padding=0))


def cab(x, p, name, fp8=False):
    """CAB.forward on the map x [B, C, H, W]."""
    y = _conv(F.gelu(_conv(x, p, name + ".0", fp8)), p, name + ".2", fp8)
    return channel_attention(y, p, name + ".3", fp8)


def window_attention(x, p, b, heads, ws, mask, fp8=False):
    """WindowAttention.forward on x [B * nW, N, C]."""
    bw, n, c = x.shape
    qkv = _linear(x, p, b + "attn.qkv", fp8).reshape(bw, n, 3, heads, c // heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    attn = _r(q, fp8) @ _r(k, fp8).transpose(-2, -1)
    table = p[b + "attn.relative_position_bias_table"]
    bias = table[calculate_rpi_sa(ws).view(-1)].view(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.contiguous().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    x = (_r(attn, fp8) @ _r(v, fp8)).transpose(1, 2).reshape(bw, n, c)
    return _linear(x, p, b + "attn.proj", fp8)


def hab(x, hw, p, b, heads, ws, shift, conv_scale, fp8=False):
    """HAB.forward on x [B, H*W, C]."""
    h, w = hw
    bsz, _, c = x.shape
    shortcut = x
    x = _ln(x, p, b + "norm1").view(bsz, h, w, c)
    conv_x = cab(x.permute(0, 3, 1, 2), p, b + "conv_block.cab", fp8)
    conv_x = conv_x.permute(0, 2, 3, 1).contiguous().view(bsz, h * w, c)
    shifted = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift else x
    windows = window_partition(shifted, ws).view(-1, ws * ws, c)
    mask = shift_mask(h, w, ws, shift).to(x.device) if shift else None
    attn = window_attention(windows, p, b, heads, ws, mask, fp8).view(-1, ws, ws, c)
    shifted = window_reverse(attn, ws, h, w)
    attn_x = torch.roll(shifted, shifts=(shift, shift), dims=(1, 2)) if shift else shifted
    x = shortcut + attn_x.reshape(bsz, h * w, c) + conv_x * conv_scale
    return x + _linear(F.gelu(_linear(_ln(x, p, b + "norm2"), p, b + "mlp.fc1", fp8)), p,
                       b + "mlp.fc2", fp8)


def overlap_attention(q, k, v, bias, fp8=False):
    """softmax(q k^T + bias) v for q [b_, heads, nq, d] (scaled already), k
    and v [b_, heads, nk, d], bias [heads, nq, nk]."""
    attn = _r(q, fp8) @ _r(k, fp8).transpose(-2, -1) + bias.unsqueeze(0)
    return _r(torch.softmax(attn, dim=-1), fp8) @ _r(v, fp8)


def ocab(x, hw, p, o, heads, ws, ows, fp8=False):
    """OCAB.forward on x [B, H*W, C]."""
    h, w = hw
    bsz, _, c = x.shape
    shortcut = x
    x = _ln(x, p, o + "norm1").view(bsz, h, w, c)
    qkv = _linear(x, p, o + "qkv", fp8).reshape(bsz, h, w, 3, c).permute(3, 0, 4, 1, 2)
    q = qkv[0].permute(0, 2, 3, 1)
    kv = torch.cat((qkv[1], qkv[2]), dim=1)
    q_windows = window_partition(q, ws).view(-1, ws * ws, c)
    kv_windows = F.unfold(kv, kernel_size=(ows, ows), stride=ws, padding=(ows - ws) // 2)
    # 'b (nc ch owh oww) nw -> nc (b nw) (owh oww) ch'
    nw = kv_windows.shape[-1]
    kv_windows = kv_windows.view(bsz, 2, c, ows * ows, nw).permute(1, 0, 4, 3, 2)
    kv_windows = kv_windows.reshape(2, bsz * nw, ows * ows, c)
    k_windows, v_windows = kv_windows[0], kv_windows[1]
    b_, nq, _ = q_windows.shape
    n = k_windows.shape[1]
    d = c // heads
    q = q_windows.reshape(b_, nq, heads, d).permute(0, 2, 1, 3) * d ** -0.5
    k = k_windows.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    v = v_windows.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    table = p[o + "relative_position_bias_table"]
    bias = table[calculate_rpi_oca(ws, ows).view(-1)].view(ws * ws, ows * ows, -1)
    attn = overlap_attention(q, k, v, bias.permute(2, 0, 1).contiguous(), fp8)
    attn_windows = attn.transpose(1, 2).reshape(b_, nq, c).view(-1, ws, ws, c)
    x = window_reverse(attn_windows, ws, h, w).view(bsz, h * w, c)
    x = _linear(x, p, o + "proj", fp8) + shortcut
    return x + _linear(F.gelu(_linear(_ln(x, p, o + "norm2"), p, o + "mlp.fc1", fp8)), p,
                       o + "mlp.fc2", fp8)


def forward(params: dict, x: torch.Tensor, *, factor: int, window_size: int, depths,
            num_heads, overlap_ratio: float = 0.5, conv_scale: float = 0.01,
            img_range: float = 1.0, fp8: bool = False) -> torch.Tensor:
    """x [B, C, h, w] -> [B, C, h * factor, w * factor], float32."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p = {k: v.float() for k, v in params.items()}
        x = x.float()
        h0, w0 = x.shape[2:]
        ws = window_size
        ows = overlap_size(ws, overlap_ratio)
        x = F.pad(x, (0, (ws - w0 % ws) % ws, 0, (ws - h0 % ws) % ws), "reflect")
        x = x * img_range  # (x - mean) * img_range, mean 0
        x = _conv(x, p, "conv_first", fp8)
        bsz, c, h, w = x.shape
        f = _ln(x.flatten(2).transpose(1, 2), p, "patch_embed.norm")
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            g = f
            for j in range(depth):
                g = hab(g, (h, w), p, f"layers.{i}.residual_group.blocks.{j}.", heads, ws,
                        0 if j % 2 == 0 else ws // 2, conv_scale, fp8)
            g = ocab(g, (h, w), p, f"layers.{i}.residual_group.overlap_attn.", heads, ws, ows,
                     fp8)
            g = _conv(g.transpose(1, 2).view(bsz, c, h, w), p, f"layers.{i}.conv", fp8)
            f = g.flatten(2).transpose(1, 2) + f
        f = _ln(f, p, "norm").transpose(1, 2).view(bsz, c, h, w)
        x = _conv(f, p, "conv_after_body", fp8) + x
        x = F.leaky_relu(_conv(x, p, "conv_before_upsample.0", fp8), 0.01)
        for k in range(int(math.log2(factor))):
            x = F.pixel_shuffle(_conv(x, p, f"upsample.{2 * k}", fp8), 2)
        x = _conv(x, p, "conv_last", fp8) / img_range
        return x[:, :, :h0 * factor, :w0 * factor]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
