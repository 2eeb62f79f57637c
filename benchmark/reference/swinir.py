"""Plain SwinIR forward (classical SR, pixel-shuffle upsampler), float32
with TF32 off: a frozen copy of the repository's test reference
(`tests/helpers/swinir_reference.py`), written from `models/network_swinir.py`
of https://github.com/JingyunLiang/SwinIR (arXiv:2108.10257) module by
module: no cache, no fused attention, no token gathers. Imports torch only.

Parameters are the published state dict's names and shapes
(`param_shapes`); `relative_position_index` and `attn_mask` are built
here, as the published modules build them.

Departures from `network_swinir.py`:
- any number of bands in and out, with `mean` 0 (SwinIR's own rule when
  in_chans != 3; its RGB mean applies to 3 bands only);
- no drop-path, dropout or attention dropout (identities at inference);
- window `window_size` with shift `window_size // 2` on odd blocks at
  every map size (the published model's `img_size` 64 construction; the
  published code narrows the window only for maps no larger than it);
- `upsampler='pixelshuffle'` with a power-of-2 scale and
  `resi_connection='1conv'` only, `ape` False, `patch_norm` True,
  `patch_size` 1, qkv with bias, no qk_scale.

`fp8=True` is the control: the operands of every linear, conv and
attention matmul (q and k, the probabilities and v) rounded to float8
e4m3 (each tensor scaled to the format's range first, as `reference.sr`
does), products accumulated in float32, one precision step below the
bfloat16 the configuration serves in.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .sr import round_fp8


def param_shapes(in_ch: int, embed_dim: int, depths, num_heads, window_size: int,
                 mlp_ratio: float, num_feat: int, factor: int) -> dict:
    """{published name: shape} of SwinIR's parameters."""
    e, hid = embed_dim, int(embed_dim * mlp_ratio)
    out = {"conv_first.weight": (e, in_ch, 3, 3), "conv_first.bias": (e,),
           "patch_embed.norm.weight": (e,), "patch_embed.norm.bias": (e,)}
    for i, (depth, heads) in enumerate(zip(depths, num_heads)):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}."
            out.update({b + "norm1.weight": (e,), b + "norm1.bias": (e,),
                        b + "attn.relative_position_bias_table": ((2 * window_size - 1) ** 2,
                                                                  heads),
                        b + "attn.qkv.weight": (3 * e, e), b + "attn.qkv.bias": (3 * e,),
                        b + "attn.proj.weight": (e, e), b + "attn.proj.bias": (e,),
                        b + "norm2.weight": (e,), b + "norm2.bias": (e,),
                        b + "mlp.fc1.weight": (hid, e), b + "mlp.fc1.bias": (hid,),
                        b + "mlp.fc2.weight": (e, hid), b + "mlp.fc2.bias": (e,)})
        out.update({f"layers.{i}.conv.weight": (e, e, 3, 3), f"layers.{i}.conv.bias": (e,)})
    out.update({"norm.weight": (e,), "norm.bias": (e,),
                "conv_after_body.weight": (e, e, 3, 3), "conv_after_body.bias": (e,),
                "conv_before_upsample.0.weight": (num_feat, e, 3, 3),
                "conv_before_upsample.0.bias": (num_feat,)})
    for k in range(int(math.log2(factor))):
        out.update({f"upsample.{2 * k}.weight": (4 * num_feat, num_feat, 3, 3),
                    f"upsample.{2 * k}.bias": (4 * num_feat,)})
    out.update({"conv_last.weight": (in_ch, num_feat, 3, 3), "conv_last.bias": (in_ch,)})
    return out


def _r(x, fp8):
    return round_fp8(x) if fp8 else x


def relative_position_index(ws: int) -> torch.Tensor:
    """WindowAttention's relative_position_index: [N, N], N = ws^2."""
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
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
    """SwinTransformerBlock.calculate_mask: [nW, N, N], 0 or -100."""
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


def roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """torch.roll over the map's two axes of [B, H, W, C]."""
    return torch.roll(x, shifts=(shift, shift), dims=(1, 2))


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], 1e-5)


def _linear(x, p, name, fp8=False):
    return F.linear(_r(x, fp8), _r(p[name + ".weight"], fp8), p[name + ".bias"])


def _conv(x, p, name, fp8=False):
    return F.conv2d(_r(x, fp8), _r(p[name + ".weight"], fp8), p[name + ".bias"], padding=1)


def window_attention(x, p, b, heads, ws, mask, fp8=False):
    """WindowAttention.forward on x [B * nW, N, C]."""
    bw, n, c = x.shape
    qkv = _linear(x, p, b + "attn.qkv", fp8).reshape(bw, n, 3, heads, c // heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    attn = _r(q, fp8) @ _r(k, fp8).transpose(-2, -1)
    table = p[b + "attn.relative_position_bias_table"]
    bias = table[relative_position_index(ws).view(-1)].view(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.contiguous().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    x = (_r(attn, fp8) @ _r(v, fp8)).transpose(1, 2).reshape(bw, n, c)
    return _linear(x, p, b + "attn.proj", fp8)


def swin_block(x, hw, p, b, heads, ws, shift, fp8=False):
    """SwinTransformerBlock.forward on x [B, H*W, C]."""
    h, w = hw
    bsz, _, c = x.shape
    shortcut = x
    x = _ln(x, p, b + "norm1").view(bsz, h, w, c)
    shifted = roll(x, -shift) if shift else x
    windows = window_partition(shifted, ws).view(-1, ws * ws, c)
    mask = shift_mask(h, w, ws, shift).to(x.device) if shift else None
    attn = window_attention(windows, p, b, heads, ws, mask, fp8).view(-1, ws, ws, c)
    shifted = window_reverse(attn, ws, h, w)
    x = roll(shifted, shift) if shift else shifted
    x = shortcut + x.reshape(bsz, h * w, c)
    return x + _linear(F.gelu(_linear(_ln(x, p, b + "norm2"), p, b + "mlp.fc1", fp8)), p,
                       b + "mlp.fc2", fp8)


def forward(params: dict, x: torch.Tensor, *, factor: int, window_size: int, depths,
            num_heads, img_range: float = 1.0, fp8: bool = False) -> torch.Tensor:
    """x [B, C, h, w] -> [B, C, h * factor, w * factor], float32."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p = {k: v.float() for k, v in params.items()}
        x = x.float()
        h0, w0 = x.shape[2:]
        ws = window_size
        x = F.pad(x, (0, (ws - w0 % ws) % ws, 0, (ws - h0 % ws) % ws), "reflect")
        x = x * img_range  # (x - mean) * img_range, mean 0
        x = _conv(x, p, "conv_first", fp8)
        bsz, c, h, w = x.shape
        f = _ln(x.flatten(2).transpose(1, 2), p, "patch_embed.norm")
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            g = f
            for j in range(depth):
                g = swin_block(g, (h, w), p, f"layers.{i}.residual_group.blocks.{j}.", heads,
                               ws, 0 if j % 2 == 0 else ws // 2, fp8)
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
