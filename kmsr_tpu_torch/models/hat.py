"""HAT, the Hybrid Attention Transformer (Chen, Wang, Zhou, Qiao, Dong,
"Activating More Pixels in Image Super-Resolution Transformer", CVPR 2023,
arXiv:2205.04437), the classical-SR network with the pixel-shuffle
upsampler, as a function on a dict of tensors, at HAT-SRx4's widths by
default (`options/test/HAT_SRx4.yml` of https://github.com/XPixelGroup/HAT).

The parameters are a flat dict keyed by the published module names
(`hat/archs/hat_arch.py`), in their published shapes (convs OIHW, linears
[out, in]), so a published `params` state dict loads by name
(`from_state_dict`): SwinIR's trunk (`conv_first`, `patch_embed.norm`,
`layers.{i}.conv`, `norm`, `conv_after_body`, `conv_before_upsample.0`,
`upsample.{0,2}`, `conv_last`), in group i the HABs
`layers.{i}.residual_group.blocks.{j}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, conv_block.cab.0, conv_block.cab.2,
conv_block.cab.3.attention.1, conv_block.cab.3.attention.3, norm2, mlp.fc1,
mlp.fc2}` and the OCAB `layers.{i}.residual_group.overlap_attn.{norm1, qkv,
proj, relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}`. The buffers
`relative_position_index_SA`, `relative_position_index_OCA` and
`attn_mask` are derived, never loaded.

The forward, one residual stream f [B, H*W, C] at LR resolution, window w
(N = w^2 tokens), shift s = w / 2 on odd HABs, overlap window
w_o = w + int(overlap_ratio * w) (M = w_o^2 keys):

    SwinIR's trunk (`models.swinir`), its groups RHAGs:
    RHAG: f = conv3x3(OCAB(HAB^depth(f))) + f
    HAB:  x = LN1(f)
          c = CA(conv3x3_{C/3 -> C}(GELU(conv3x3_{C -> C/3}(x as a map))))
          CA(y) = y * sigmoid(conv1x1(ReLU(conv1x1_{C -> C/30}(mean_HW(y)))))
          a = SwinIR's window attention of x (rolled on odd HABs, B_rel + M)
          f = f + a + conv_scale * c;  f = f + fc2(GELU(fc1(LN2(f))))
    OCAB: x = LN1(f); q, k, v = qkv(x)
          queries: w x w windows of q; keys and values: nn.Unfold(w_o,
          stride w, padding (w_o - w) / 2) of the k and v maps, the border
          keys zero vectors (not masked);
          B_rel[h, i, j] = table[rpi_oca(i, j) mod rows, h]
          f = f + proj(softmax(q k^T / sqrt(d) + B_rel) v)
          f = f + fc2(GELU(fc1(LN2(f))))

Arithmetic and layout are SwinIR's (`models.swinir`'s docstring): the
stream, matmuls and convs in the compute dtype (bfloat16 by default) with
float32 accumulation, LayerNorm statistics and softmax in float32,
conv_first in float32, the head dim zero-padded to a multiple of 8 in the
weights, the stream carried `stream_width(C)` channels wide with its pad
zero (184 for 180), every weight cast, padded and each bias built once a
parameter set (`models.swinir._prepared`). HAT's own parts:

- LN1 is read in two orders: rolled and in windows for the attention, in
  the map's order for the conv branch, so a HAB runs the row norm twice on
  the same rows (`norm_rows`, with and without the window order).
- The conv branch runs on the channels_last map of the stream in the
  compute dtype, its middle channels padded as the stream's (C / 3 = 60 at
  64) and its convs' pad weights and biases zero, so GELU(0) = 0 keeps the
  pad zero and no width is one cuDNN pads itself; the channel gate's pool
  and its two 1x1 convs run in float32 on [B, Cp] (a pool a tile), the
  first reading no pad channel and the second writing 0 there, so the gate
  is sigmoid(0) = 0.5 on a branch that is 0. The HAB's three-way residual is one
  `torch.addcmul` (f + y * (conv_scale * gate), the gate rounded to the
  compute dtype), then `add_norm_rows` adds the attention back through the
  window order's inverse and takes LN2, as SwinIR's.
- The OCAB's LN1 rows are in window order, so its queries are windows
  with no gather; its keys and values are one `index_select` of the k and
  v rows padded with one zero row, through `_oca_gather`, the overlapping
  windows' token of each key, the zero row for a key outside the map. The
  bias is [1, heads, N, M], no mask; the padded keys take part in the
  softmax as zero vectors (score = bias, value 0), as published.

Spans (`utils.profiling.stage_timer`): `hat.forward` (item: the caller's;
counts `tiles`, `windows`, the HABs' attention windows, `ocab_windows`,
the OCABs' query windows, and `norm_kernels`, the row-norm kernel's
launches in the forward: 3 a HAB, 2 an OCAB and 2 more on a card, 122 at
HAT-SRx4, 0 on the CPU, and `stream_width`, the Cp the stream ran at), and
inside it `hat.rhag` (item: the RHAG's index
i) with `hat.ocab` (item i) inside that, and `hat.upsample`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import stage_timer
from .sr import _conv
from .swinir import (
    _attend,
    _cl_map,
    _linear_in,
    _linear_out,
    _mlp,
    _oihw,
    _pair,
    _pair_in,
    _prepare_trunk,
    _proj_weights,
    _qkv_weights,
    _stl_weights,
    _stream,
    _trunk_forward,
    _trunk_shapes,
    _window_attention,
    _window_order,
    add_norm_rows,
    init_params,
    load_state,
    norm_rows,
    stream_width,
    upsample_stages,
)

#: state-dict entries HAT registers as buffers: derived, never loaded
DERIVED = ("relative_position_index_SA", "relative_position_index_OCA", "attn_mask")


@dataclasses.dataclass(frozen=True)
class HATConfig:
    """HAT-SRx4 classical SR (`HAT_SRx4.yml`) with `in_ch` bands in and out."""
    in_ch: int = 5
    embed_dim: int = 180
    depths: tuple = (6,) * 6
    num_heads: tuple = (6,) * 6
    window_size: int = 16
    overlap_ratio: float = 0.5
    compress_ratio: int = 3
    squeeze_factor: int = 30
    conv_scale: float = 0.01
    mlp_ratio: float = 2.0
    num_feat: int = 64
    factor: int = 4
    img_range: float = 1.0
    resi_connection: str = "1conv"
    upsampler: str = "pixelshuffle"

    def __post_init__(self):
        if self.resi_connection != "1conv" or self.upsampler != "pixelshuffle":
            raise ValueError("HATConfig runs resi_connection '1conv' with upsampler "
                             f"'pixelshuffle', not {self.resi_connection!r} / "
                             f"{self.upsampler!r}")
        upsample_stages(self.factor)
        if len(self.depths) != len(self.num_heads):
            raise ValueError(f"depths {self.depths} and num_heads {self.num_heads} differ "
                             "in length")
        for h in self.num_heads:
            if self.embed_dim % h:
                raise ValueError(f"embed_dim {self.embed_dim} is not a multiple of {h} heads")
        if self.window_size % 2 or (self.overlap_size - self.window_size) % 2:
            raise ValueError(f"window {self.window_size} and overlap window "
                             f"{self.overlap_size} must be even, for the shift and the "
                             "unfold's padding")
        if self.embed_dim // self.compress_ratio < 1 or self.embed_dim // self.squeeze_factor < 1:
            raise ValueError(f"embed_dim {self.embed_dim} leaves the conv branch no channels "
                             f"at compress_ratio {self.compress_ratio} / squeeze_factor "
                             f"{self.squeeze_factor}")

    @property
    def overlap_size(self) -> int:
        """The OCAB's key window, int(window * overlap_ratio) + window."""
        return int(self.window_size * self.overlap_ratio) + self.window_size


def param_shapes(cfg: HATConfig = HATConfig()) -> dict[str, tuple]:
    """{published name: shape} of every parameter, in the published order."""
    e, hid = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    ws, ows = cfg.window_size, cfg.overlap_size
    squeeze = e // cfg.squeeze_factor

    def rhag(i):
        heads = cfg.num_heads[i]
        shapes = {}
        for j in range(cfg.depths[i]):
            b = f"layers.{i}.residual_group.blocks.{j}."
            cab = b + "conv_block.cab."
            shapes.update({**_pair(b + "norm1", (e,)),
                           b + "attn.relative_position_bias_table": ((2 * ws - 1) ** 2, heads),
                           **_pair(b + "attn.qkv", (3 * e, e)), **_pair(b + "attn.proj", (e, e)),
                           **_pair(cab + "0", (e // cfg.compress_ratio, e, 3, 3)),
                           **_pair(cab + "2", (e, e // cfg.compress_ratio, 3, 3)),
                           **_pair(cab + "3.attention.1", (squeeze, e, 1, 1)),
                           **_pair(cab + "3.attention.3", (e, squeeze, 1, 1)),
                           **_pair(b + "norm2", (e,)), **_pair(b + "mlp.fc1", (hid, e)),
                           **_pair(b + "mlp.fc2", (e, hid))})
        o = f"layers.{i}.residual_group.overlap_attn."
        shapes.update({o + "relative_position_bias_table": ((ws + ows - 1) ** 2, heads),
                       **_pair(o + "norm1", (e,)), **_pair(o + "qkv", (3 * e, e)),
                       **_pair(o + "proj", (e, e)), **_pair(o + "norm2", (e,)),
                       **_pair(o + "mlp.fc1", (hid, e)), **_pair(o + "mlp.fc2", (e, hid))})
        return shapes
    return _trunk_shapes(cfg, rhag)


def init_hat(cfg: HATConfig = HATConfig(), seed: int = 0,
             device: str | torch.device = "cuda") -> dict:
    """HAT's own initialisation (`models.swinir.init_params`: linears and
    tables trunc-normal(0.02), LayerNorms 1 / 0, convs PyTorch's default)."""
    return init_params(param_shapes(cfg), seed, device)


def from_state_dict(state: dict, cfg: HATConfig = HATConfig(),
                    device: str | torch.device = "cpu") -> dict:
    """The parameters of a published HAT state dict (its `params` entry,
    or the dict itself) as float32 tensors on `device`; the derived buffers
    are dropped. A missing, extra or misshapen entry raises ValueError."""
    return load_state(state, param_shapes(cfg), DERIVED, cfg, device)


# ------------------------------------------------------------ derived tensors
@functools.lru_cache(maxsize=8)
def oca_relative_position_index(ws: int, ows: int) -> np.ndarray:
    """[ws^2, ows^2] int64, the published `calculate_rpi_oca`: for query
    token i of a w x w window and key token j of its w_o x w_o window, with
    rel = coords_ext[j] - coords_ori[i] on each axis, each axis + (w - w_o +
    1), the row axis times (w + w_o - 1), the two summed. Its entries run
    negative (-880 ... 640 at w 16, w_o 24), which table indexing wraps: it
    is a bijection onto the (w + w_o - 1)^2 rows mod their count. Callers
    must not write to the cached array."""
    yo, xo = np.divmod(np.arange(ws * ws), ws)
    ye, xe = np.divmod(np.arange(ows * ows), ows)
    dy = ye[None, :] - yo[:, None] + ws - ows + 1
    dx = xe[None, :] - xo[:, None] + ws - ows + 1
    return dy * (ws + ows - 1) + dx


@functools.lru_cache(maxsize=16)
def _device_oca_index(ws: int, ows: int, rows: int, device: torch.device) -> torch.Tensor:
    """`oca_relative_position_index` wrapped onto the table's rows, flat, on
    `device`."""
    return torch.from_numpy(oca_relative_position_index(ws, ows).reshape(-1) % rows).to(device)


def oca_bias(table: torch.Tensor, ws: int, ows: int, dtype: torch.dtype) -> torch.Tensor:
    """The OCAB's B_rel in `dtype`: [1, heads, ws^2, ows^2], contiguous."""
    rel = table[_device_oca_index(ws, ows, table.shape[0], table.device)]
    rel = rel.view(ws * ws, ows * ows, -1).permute(2, 0, 1)
    return rel.to(dtype, memory_format=torch.contiguous_format)[None]


@functools.lru_cache(maxsize=32)
def _oca_gather(h: int, w: int, ws: int, ows: int, device: torch.device) -> torch.Tensor:
    """int64 [nW * ows^2] on `device`: for each w x w window (row-major) of
    the (h, w) map and each key of its ows x ows window (row-major; the
    unfold's window, padded by (ows - ws) / 2 a side), the key's row in the
    map's window order (`models.swinir._window_order` at shift 0), or h * w
    (the zero row) for a key outside the map."""
    pad = (ows - ws) // 2
    wy, wx, ky, kx = np.meshgrid(np.arange(h // ws), np.arange(w // ws), np.arange(ows),
                                 np.arange(ows), indexing="ij")
    y, x = wy * ws - pad + ky, wx * ws - pad + kx
    inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    # token (y, x) sits in window (y // ws, x // ws) at (y % ws, x % ws)
    row = ((y // ws) * (w // ws) + x // ws) * ws * ws + (y % ws) * ws + x % ws
    return torch.from_numpy(np.where(inside, row, h * w).reshape(-1)).to(device)


# ----------------------------------------------------------------- forward
def _hab_weights(p: dict, b: str, heads: int, ws: int, shift: int, hw: tuple,
                 dt: torch.dtype) -> dict:
    """The HAB `b`'s weights as `_hab` reads them: SwinIR's STL's
    (`_stl_weights`, the same names) and the conv branch's, its convs in dt
    and the channel gate's 1x1 convs as float32 linears, each padded with
    zeros for the stream's width and the branch's (`stream_width`: 180 ->
    184 and 60 -> 64 at HAT-SRx4), so the pad channels stay 0 through it."""
    cab = b + "conv_block.cab."
    mid, e = p[cab + "0.weight"].shape[:2]
    cp, mp = stream_width(e), stream_width(mid)
    out = _stl_weights(p, b, heads, ws, shift, hw, dt)
    out.update({"cab0": _oihw(p, cab + "0", dt, mp, cp), "cab2": _oihw(p, cab + "2", dt, cp, mp),
                "ca1": _linear_in(p, cab + "3.attention.1", torch.float32),
                "ca3": _linear_out(p, cab + "3.attention.3", torch.float32)})
    return out


def _ocab_weights(p: dict, o: str, heads: int, ws: int, ows: int, dt: torch.dtype) -> dict:
    """The OCAB `o`'s weights as `_ocab` reads them, in dt, the linears
    padded for the stream's width as the HAB's."""
    e = p[o + "norm1.weight"].shape[0]
    return {"norm1": _pair_in(p, o + "norm1", dt), "qkv": _qkv_weights(p, o + "qkv", heads, dt),
            "scale": (e // heads) ** -0.5,
            "bias": oca_bias(p[o + "relative_position_bias_table"], ws, ows, dt),
            "proj": _proj_weights(p, o + "proj", heads, dt),
            "norm2": _pair_in(p, o + "norm2", dt), "fc1": _linear_in(p, o + "mlp.fc1", dt),
            "fc2": _linear_out(p, o + "mlp.fc2", dt)}


def _prepare(params: dict, cfg: HATConfig, dt: torch.dtype, hw: tuple) -> dict:
    """Every weight of the forward as it reads them at compute dtype dt on
    the padded map hw: the trunk's, each HAB's and each OCAB's under its
    prefix."""
    ws, ows = cfg.window_size, cfg.overlap_size
    out = _prepare_trunk(params, cfg, dt)
    for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}."
            out[b] = _hab_weights(params, b, heads, ws, ws // 2 if j % 2 else 0, hw, dt)
        o = f"layers.{i}.residual_group.overlap_attn."
        out[o] = _ocab_weights(params, o, heads, ws, ows, dt)
    return out


def _channel_gate(y: torch.Tensor, s: dict) -> torch.Tensor:
    """CA's gate of the map y [B, C, H, W], float32 [B, C]:
    sigmoid(conv1x1(ReLU(conv1x1(mean over the map))))."""
    pooled = y.mean(dim=(2, 3), dtype=torch.float32)
    return torch.sigmoid(F.linear(F.relu(F.linear(pooled, *s["ca1"])), *s["ca3"]))


def _cab(x: torch.Tensor, s: dict, hw: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """The conv branch of the normed rows x [B, H*W, C] in the map's order:
    (y, gate), y the stream of conv3x3(GELU(conv3x3(x))) before the channel
    gate, in x's dtype, and gate [B, 1, C] float32, so CAB(x) = y * gate."""
    dt = x.dtype
    y = _conv(F.gelu(_conv(_cl_map(x, hw), s["cab0"], dt)), s["cab2"], dt)
    return _stream(y), _channel_gate(y, s)[:, None, :]


def _hab(f: torch.Tensor, s: dict, heads: int, ws: int, shift: int, hw: tuple,
         conv_scale: float) -> torch.Tensor:
    """One hybrid attention block on the stream f [B, H*W, C], with its
    weights s (`_hab_weights`, in f's dtype)."""
    fwd, inv = _window_order(*hw, ws, shift, f.device)
    a = _window_attention(norm_rows(f, *s["norm1"], fwd), s, heads, ws * ws)  # rolled, windowed
    y, gate = _cab(norm_rows(f, *s["norm1"]), s, hw)
    f = torch.addcmul(f, y, (gate * conv_scale).to(f.dtype))
    f, z = add_norm_rows(f, a, inv, *s["norm2"])
    return f + _mlp(z, s)


def _ocab(f: torch.Tensor, s: dict, heads: int, ws: int, ows: int,
          hw: tuple) -> torch.Tensor:
    """The overlapping cross-attention block on the stream f [B, H*W, C],
    with its weights s (`_ocab_weights`, in f's dtype)."""
    bsz, p, _ = f.shape
    fwd, inv = _window_order(*hw, ws, 0, f.device)
    wq, bq = s["qkv"]
    hd = wq.shape[0] // 3
    d = hd // heads
    qkv = F.linear(norm_rows(f, *s["norm1"], fwd), wq, bq)  # in windows
    q = qkv[..., :hd].view(-1, ws * ws, heads, d).transpose(1, 2)
    kv = F.pad(qkv[..., hd:], (0, 0, 0, 1)).index_select(1, _oca_gather(*hw, ws, ows, f.device))
    k, v = kv.view(-1, ows * ows, 2, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    a = _attend(q, k, v, s["bias"], bsz, s["scale"])
    a = F.linear(a.transpose(1, 2).reshape(bsz, p, hd), *s["proj"])
    f, z = add_norm_rows(f, a, inv, *s["norm2"])
    return f + _mlp(z, s)


def hat_forward(params: dict, x: torch.Tensor, cfg: HATConfig = HATConfig(),
                compute_dtype: torch.dtype = torch.bfloat16,
                item: Optional[object] = None) -> torch.Tensor:
    """x: [B, C, h, w] -> [B, C, h*factor, w*factor], float32 (contiguous)."""
    ws, ows = cfg.window_size, cfg.overlap_size
    n_win = x.shape[0] * -(-x.shape[2] // ws) * -(-x.shape[3] // ws)

    def rhag(f, wts, i, hw):
        heads = cfg.num_heads[i]
        for j in range(cfg.depths[i]):
            f = _hab(f, wts[f"layers.{i}.residual_group.blocks.{j}."], heads, ws,
                     ws // 2 if j % 2 else 0, hw, cfg.conv_scale)
        with stage_timer("hat.ocab", item=i):
            return _ocab(f, wts[f"layers.{i}.residual_group.overlap_attn."], heads, ws, ows, hw)

    return _trunk_forward(params, x, cfg, compute_dtype, _prepare, rhag,
                          ("hat.forward", "hat.rhag", "hat.upsample"), item,
                          windows=n_win * sum(cfg.depths), ocab_windows=n_win * len(cfg.depths))
