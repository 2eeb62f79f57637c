"""SwinIR (Liang et al., "SwinIR: Image Restoration Using Swin
Transformer", arXiv:2108.10257), the classical-SR network with the
pixel-shuffle upsampler, as a function on a dict of tensors.

The parameters are a flat dict keyed by the published module names
(`models/network_swinir.py` of https://github.com/JingyunLiang/SwinIR):
`conv_first.weight`, `layers.{i}.residual_group.blocks.{j}.attn.qkv.weight`,
`...attn.relative_position_bias_table`, `layers.{i}.conv.weight`,
`norm.weight`, `conv_before_upsample.0.weight`, `upsample.{0,2,4}.weight`,
`conv_last.weight`, ... in their published shapes (convs OIHW, linears
[out, in]), so a published `params` state dict loads by name
(`from_state_dict`). `relative_position_index` and `attn_mask` are
derived from the shapes, never loaded.

The forward, one residual stream at LR resolution:

    x = pad_reflect(x, to a multiple of window_size) * img_range   (mean 0)
    x = conv_first(x)
    f = LN(x)                                            (patch_embed)
    6 RSTBs: f = conv3x3(STL^depth(f)) + f
      STL j: f = f + proj(WMSA(LN1(f))); f = f + fc2(GELU(fc1(LN2(f))))
      WMSA: odd j rolls the map by (-s, -s), s = window_size // 2; 8x8
        windows of N tokens; A = softmax(q k^T / sqrt(d) + B_rel + M) v,
        B_rel[h, i, j] = table[idx(i, j), h], M = -100 between the shift's
        regions (odd j only); the roll undone after
    x = conv_after_body(LN(f)) + x
    x = LeakyReLU_0.01(conv_before_upsample(x))
    x = PixelShuffle_2(conv 64 -> 256 (x)), log2(factor) times
    y = conv_last(x) / img_range, cropped to (h * factor, w * factor)

Window `window_size` with shift `window_size // 2` on odd STLs at every
input size: the published model's construction at its `img_size` 64.

Arithmetic: the residual stream, matmuls and convs run in the compute
dtype (bfloat16 by default) with float32 accumulation; LayerNorm's
statistics and the softmax run in float32 (float64 under compute_dtype
float64): the norms in `norm_rows` / `add_norm_rows` (on a card the row-norm
kernel, two sums in registers, within an ulp of `F.layer_norm`; on the CPU
`F.layer_norm` itself), the softmax in `F.scaled_dot_product_attention`.
The attention branch's add is rounded to the compute dtype before LN2
reads it, on both paths alike. conv_first alone runs in float32 (TF32
off) on the unrounded input: with mean 0 the network reads radiances of
8-60 whose 1 % noise and texture are what it resolves, and bfloat16 would
round a radiance of 60 by up to 0.125 (0.07 of the tile's operations).
Under compute_dtype=float32 TF32 is off (`models.sr.precision`). The
convs are the EDSR's `_conv` (bias added after the rounding), the
shuffles its `_pixel_shuffle_cl`.

Layout: the stream is [B, H, W, Cp] (channels_last storage of the convs'
[B, Cp, H, W]), so patch_embed and unembed are views (a copy where a conv
leaves its map NCHW). Cp = `stream_width(C)`, the smallest multiple of 8 at
or above C (184 for SwinIR-M's 180): the channels past C are a pad that
stays exactly zero, so a bfloat16 row is a multiple of 16 bytes and the
linears that read (qkv, fc1: K = Cp) and write (proj, fc2: N = Cp) the
stream run cuBLAS's Hopper kernels, where 180-wide rows fall back to its
sm80 align2 kernels (PERF.md). The weights carry the pad as zeros: the
linears' and convs' extra input columns and output rows and biases are 0,
so every product adds exact zeros and every pad output is 0; the norms keep
C channels of weight, take their statistics over the first C, and write 0
past them. A C that is already a multiple of 8 runs unpadded. Roll and window partition are one token permutation
(`_window_order`), read by the norms rather than gathered on its own: an
STL's LN1 writes its rows already rolled and in windows (`norm_rows` with
fwd), and LN2 reads the attention branch back through inv as it adds it to
the stream (`add_norm_rows`), so on a card one kernel pass each replaces
F.layer_norm, index_select and the add (`kernels/swin_norm.cu`); on the
CPU the same three ops run as before. The attention runs
through `F.scaled_dot_product_attention` with B_rel and M folded into one
additive tensor in the compute dtype, the head dim zero-padded to a
multiple of 8 (in the weights, so q, k and v come out padded) because
the fused backends refuse other head dims (SwinIR-M's 30 falls to the
plain math path, in float32); the padding adds zero to every product,
and the scale stays 1/sqrt(head dim). `_SDPA_BACKENDS` says which kernels.

Weights: every weight the forward reads is cast to the compute dtype (and
padded, for the heads and the stream, and B_rel + M built) once a parameter set, compute dtype and map
size (`_prepared`), not at every forward: the same ops on the same values,
so the output is the same bit for bit, and a forward launches about half
as many host ops. A parameter set is the dict `params` itself, its tensors
unreplaced and unwritten (their version counters), so a weight written in
place or a new dict is prepared anew; the last few sets are kept.

Spans (`utils.profiling.stage_timer`): `swinir.forward` (item: the
caller's; counts `tiles`, `windows`, the attention windows of all STLs,
`norm_kernels`, the row-norm kernel's launches in the forward: 2 an STL and
2 more on a card, 74 at SwinIR-M, 0 on the CPU, and `stream_width`, the Cp
the stream ran at), and inside it
`swinir.rstb` (item: the RSTB's index i) and `swinir.upsample`.

HAT (`models.hat`) is SwinIR's trunk with other blocks in its groups, so
it runs this module's parts: the trunk's forward (`_trunk_forward`: pad,
conv_first, the norms, the groups' convs and skips, the upsampler and the
spans), its parameter shapes and initialisation, the state-dict loading,
the weights prepared once a parameter set (`_prepared`, keyed by the
configuration too), the window attention (`_window_attention`,
`_attend`, `_mlp`, the head padding) and the row norms.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from .. import kernels
from ..device import resolve_device
from ..utils.profiling import stage_timer
from .sr import _conv, _pixel_shuffle_cl, precision

#: LayerNorm's epsilon (nn.LayerNorm's default, as published)
LN_EPS = 1e-5
#: the shift mask's value between tokens of different regions (published)
MASK_VALUE = -100.0
#: state-dict entries SwinIR registers as buffers: derived, never loaded
DERIVED = ("relative_position_index", "attn_mask")
#: the attention's backends, in order: on the card the memory-efficient
#: (CUTLASS) kernel, which took SwinIR-M's batch (2,048 windows x 6 heads,
#: head dim 32, a bias) in 0.19 ms against cuDNN's 0.32 (cuDNN is first in
#: PyTorch's own order); flash attention on the CPU; the plain math last
#: (float64, and any shape the others refuse)
_SDPA_BACKENDS = [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.FLASH_ATTENTION, SDPBackend.MATH]


@dataclasses.dataclass(frozen=True)
class SwinIRConfig:
    """SwinIR-M x8 classical SR (`001_classicalSR_DF2K_s64w8_SwinIR-M_x8`)
    with `in_ch` bands in and out."""
    in_ch: int = 5
    embed_dim: int = 180
    depths: tuple = (6,) * 6
    num_heads: tuple = (6,) * 6
    window_size: int = 8
    mlp_ratio: float = 2.0
    num_feat: int = 64
    factor: int = 8
    img_range: float = 1.0
    resi_connection: str = "1conv"
    upsampler: str = "pixelshuffle"

    def __post_init__(self):
        if self.resi_connection != "1conv" or self.upsampler != "pixelshuffle":
            raise ValueError("SwinIRConfig runs resi_connection '1conv' with upsampler "
                             f"'pixelshuffle', not {self.resi_connection!r} / "
                             f"{self.upsampler!r}")
        upsample_stages(self.factor)
        if len(self.depths) != len(self.num_heads):
            raise ValueError(f"depths {self.depths} and num_heads {self.num_heads} differ "
                             "in length")
        for h in self.num_heads:
            if self.embed_dim % h:
                raise ValueError(f"embed_dim {self.embed_dim} is not a multiple of {h} heads")


def upsample_stages(factor: int) -> int:
    """The x2 pixel-shuffle stages of SwinIR's `Upsample`: log2(factor)
    (its x3 variant is not ported)."""
    if factor < 2 or factor & (factor - 1):
        raise ValueError(f"SwinIR's pixel-shuffle upsampler here takes a power of 2, not {factor}")
    return factor.bit_length() - 1


def _pair(name: str, weight: tuple) -> dict:
    """A module's weight shape and its bias's (the weight's first axis)."""
    return {f"{name}.weight": weight, f"{name}.bias": weight[:1]}


def _trunk_shapes(cfg, group) -> dict[str, tuple]:
    """{published name: shape} of the trunk SwinIR and HAT share, in the
    published order, with `group(i)` the shapes of group i's residual group."""
    e, nf = cfg.embed_dim, cfg.num_feat
    shapes = {**_pair("conv_first", (e, cfg.in_ch, 3, 3)), **_pair("patch_embed.norm", (e,))}
    for i in range(len(cfg.depths)):
        shapes.update(group(i))
        shapes.update(_pair(f"layers.{i}.conv", (e, e, 3, 3)))
    shapes.update({**_pair("norm", (e,)), **_pair("conv_after_body", (e, e, 3, 3)),
                   **_pair("conv_before_upsample.0", (nf, e, 3, 3))})
    for k in range(upsample_stages(cfg.factor)):
        shapes.update(_pair(f"upsample.{2 * k}", (4 * nf, nf, 3, 3)))
    shapes.update(_pair("conv_last", (cfg.in_ch, nf, 3, 3)))
    return shapes


def param_shapes(cfg: SwinIRConfig = SwinIRConfig()) -> dict[str, tuple]:
    """{published name: shape} of every parameter, in the published order."""
    e, hid = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)

    def rstb(i):
        shapes = {}
        for j in range(cfg.depths[i]):
            b = f"layers.{i}.residual_group.blocks.{j}."
            shapes.update({**_pair(b + "norm1", (e,)),
                           b + "attn.relative_position_bias_table":
                               ((2 * cfg.window_size - 1) ** 2, cfg.num_heads[i]),
                           **_pair(b + "attn.qkv", (3 * e, e)), **_pair(b + "attn.proj", (e, e)),
                           **_pair(b + "norm2", (e,)), **_pair(b + "mlp.fc1", (hid, e)),
                           **_pair(b + "mlp.fc2", (e, hid))})
        return shapes
    return _trunk_shapes(cfg, rstb)


def init_params(shapes: dict, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """The published initialisation of SwinIR and HAT for the parameters
    `shapes`, drawn in their order from a CPU `torch.Generator` seeded with
    `seed`, then moved to `device`: linears and the relative-position tables
    trunc-normal(0.02) with zero biases, LayerNorms 1 / 0, convs PyTorch's
    default (uniform +-1/sqrt(fan_in), weight and bias)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, shape in shapes.items():
        module, kind = name.rsplit(".", 1)
        layer = module.rsplit(".", 1)[-1]
        t = torch.empty(shape)
        if layer in ("norm", "norm1", "norm2"):
            t.fill_(1.0 if kind == "weight" else 0.0)
        elif kind == "relative_position_bias_table" or (
                layer in ("qkv", "proj", "fc1", "fc2") and kind == "weight"):
            torch.nn.init.trunc_normal_(t, std=0.02, generator=gen)
        elif layer in ("qkv", "proj", "fc1", "fc2"):
            t.zero_()
        else:  # a conv's weight or bias
            bound = 1.0 / math.sqrt(math.prod(shapes[module + ".weight"][1:]))
            t.uniform_(-bound, bound, generator=gen)
        params[name] = t.to(dev)
    return params


def init_swinir(cfg: SwinIRConfig = SwinIRConfig(), seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """SwinIR's own initialisation (`init_params`)."""
    return init_params(param_shapes(cfg), seed, device)


def load_state(state: dict, shapes: dict, derived: tuple, what,
               device: str | torch.device = "cpu") -> dict:
    """The parameters `shapes` of a published state dict (its `params`
    entry, or the dict itself) as float32 tensors on `device`; the entries
    whose last name is in `derived` are dropped. A missing, extra or
    misshapen entry raises ValueError (naming `what`)."""
    state = state.get("params", state)
    given = {k: v for k, v in state.items() if k.rsplit(".", 1)[-1] not in derived}
    if set(given) != set(shapes):
        missing, extra = sorted(set(shapes) - set(given)), sorted(set(given) - set(shapes))
        raise ValueError(f"state dict does not fit {what}: missing {missing[:4]}, "
                         f"unexpected {extra[:4]}")
    out = {}
    for name, shape in shapes.items():
        t = torch.as_tensor(given[name])
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        out[name] = t.detach().to(resolve_device(device), torch.float32)
    return out


def from_state_dict(state: dict, cfg: SwinIRConfig = SwinIRConfig(),
                    device: str | torch.device = "cpu") -> dict:
    """The parameters of a published SwinIR state dict (`load_state`); the
    derived buffers are dropped."""
    return load_state(state, param_shapes(cfg), DERIVED, cfg, device)


# ------------------------------------------------------------ derived tensors
@functools.lru_cache(maxsize=8)
def relative_position_index(ws: int) -> np.ndarray:
    """[N, N] int64, N = ws^2: (dy + ws - 1) * (2 ws - 1) + (dx + ws - 1) for
    query token i and key token j of a window (dy = y_i - y_j, dx = x_i -
    x_j). Callers must not write to the cached array."""
    y, x = np.divmod(np.arange(ws * ws), ws)
    return (y[:, None] - y[None, :] + ws - 1) * (2 * ws - 1) + (x[:, None] - x[None, :] + ws - 1)


@functools.lru_cache(maxsize=16)
def shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """[nW, N, N] float32: 0 between tokens of one region of the rolled
    (h, w) map's 3 x 3 labelling, MASK_VALUE between regions; windows in
    row-major order. Callers must not write to the cached array."""
    label = np.zeros((h, w), np.int64)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for a, rows in enumerate(cuts):
        for b, cols in enumerate(cuts):
            label[rows, cols] = 3 * a + b
    win = label.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(win[:, None, :] != win[:, :, None], MASK_VALUE, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _window_order(h: int, w: int, ws: int, shift: int,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(fwd, inv), int64 on `device`: the windowed order's token p (windows
    row-major, tokens row-major in each) is token fwd[p] of the (h, w) map
    rolled by (-shift, -shift), i.e. torch.roll then window partition as
    one gather; inv undoes it (window reverse, then the roll back)."""
    wy, wx, iy, ix = np.meshgrid(np.arange(h // ws), np.arange(w // ws), np.arange(ws),
                                 np.arange(ws), indexing="ij")
    fwd = (((wy * ws + iy + shift) % h) * w + (wx * ws + ix + shift) % w).reshape(-1)
    return (torch.from_numpy(fwd).to(device),
            torch.from_numpy(np.argsort(fwd)).to(device))


@functools.lru_cache(maxsize=16)
def _device_index(ws: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(relative_position_index(ws).reshape(-1)).to(device)


@functools.lru_cache(maxsize=16)
def _device_mask(h: int, w: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    """`shift_mask` on `device` as [nW, 1, N, N], uploaded once."""
    return torch.from_numpy(shift_mask(h, w, ws, shift))[:, None].to(device)


def attn_bias(table: torch.Tensor, h: int, w: int, ws: int, shift: int,
              dtype: torch.dtype) -> torch.Tensor:
    """B_rel (+ M when shift) in `dtype`: [1, heads, N, N] unshifted,
    [nW, heads, N, N] shifted."""
    n = ws * ws
    rel = table[_device_index(ws, table.device)].view(n, n, -1).permute(2, 0, 1)
    if not shift:  # contiguous: the fused attention refuses a strided last dim
        return rel.to(dtype, memory_format=torch.contiguous_format)[None]
    return (_device_mask(h, w, ws, shift, table.device) + rel).to(dtype)


# ----------------------------------------------------------------- forward
def stream_width(c: int) -> int:
    """The width the residual stream of C channels is carried at: the
    smallest multiple of 8 at or above C (184 for 180), so a row of 2-byte
    elements is a multiple of 16 bytes (module docstring)."""
    return -(-c // 8) * 8


def _padded(t: torch.Tensor, *size: int) -> torch.Tensor:
    """t with zeros after its entries on each axis up to `size` (a size an
    axis); t itself where it has that shape."""
    pad = [z for n, s in zip(reversed(size), reversed(t.shape)) for z in (0, n - s)]
    return F.pad(t, pad) if any(pad) else t


def _head_pad(e: int, heads: int) -> tuple[int, int]:
    """(head dim, zeros to pad it with up to a multiple of 8)."""
    hd = e // heads
    return hd, -hd % 8


def _qkv_weights(p: dict, name: str, heads: int, dtype: torch.dtype) -> tuple:
    """The qkv linear `name`'s weight and bias in `dtype` with each head's
    rows zero-padded (`_head_pad`), so q, k and v come out [.., 3, heads,
    padded], and zero columns for the stream's pad (`stream_width`)."""
    w, bias = p[name + ".weight"], p[name + ".bias"]
    e = w.shape[1]
    hd, pad = _head_pad(e, heads)
    w = F.pad(w.to(dtype).view(3, heads, hd, e), (0, 0, 0, pad)).reshape(-1, e)
    return (_padded(w, w.shape[0], stream_width(e)),
            F.pad(bias.to(dtype).view(3, heads, hd), (0, pad)).reshape(-1))


def _proj_weights(p: dict, name: str, heads: int, dtype: torch.dtype) -> tuple:
    """The proj linear `name`'s weight and bias in `dtype`: zero columns
    where the heads are padded, zero rows and bias for the stream's pad."""
    w, bias = _pair_in(p, name, dtype)
    e = w.shape[0]
    hd, pad = _head_pad(e, heads)
    w, cp = F.pad(w.view(e, heads, hd), (0, pad)).reshape(e, -1), stream_width(e)
    return _padded(w, cp, w.shape[1]), _padded(bias, cp)


def _linear_in(p: dict, name: str, dtype: torch.dtype) -> tuple:
    """A linear (or 1x1 conv, flattened) that reads the stream, in `dtype`:
    zero columns for the stream's pad."""
    w, bias = _pair_in(p, name, dtype)
    w = w.flatten(1)
    return _padded(w, w.shape[0], stream_width(w.shape[1])), bias


def _linear_out(p: dict, name: str, dtype: torch.dtype) -> tuple:
    """A linear (or 1x1 conv, flattened) that writes the stream, in `dtype`:
    zero rows and bias for the stream's pad."""
    w, bias = _pair_in(p, name, dtype)
    w, cp = w.flatten(1), stream_width(w.shape[0])
    return _padded(w, cp, w.shape[1]), _padded(bias, cp)


def _layer_norm(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """F.layer_norm over f's first C = len(w) channels, zeros past them."""
    c = w.shape[0]
    return _padded(F.layer_norm(f[..., :c], (c,), w, b, LN_EPS), *f.shape)


def norm_rows(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[:, p] = LN(f[:, idx[p]]) (idx None: LN(f)) for the stream f [B, P,
    Cp], LN over its first C = len(w) channels (C <= Cp) with weight w and
    bias b (taken in f's dtype), epsilon LN_EPS; y's channels past C are 0.
    On a card the hand-written kernel (`kernels.swin_norm_rows`; the tensors
    contiguous, on f's card); on the CPU its plain version, F.layer_norm
    (zero-padded past C) then index_select."""
    w, b = w.to(f.dtype), b.to(f.dtype)
    if f.device.type == "cuda":
        return kernels.swin_norm_rows(f, w, b, idx, LN_EPS)
    y = _layer_norm(f, w, b)
    return y if idx is None else y.index_select(1, idx)


def add_norm_rows(f: torch.Tensor, a: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(f_new, y): f_new[:, q] = f[:, q] + a[:, idx[q]] in f's dtype in the
    first C = len(w) channels, 0 past them (a new tensor: f is never
    written), y = LN(f_new) as in `norm_rows`. On a card the hand-written
    kernel (`kernels.swin_add_norm_rows`; a in f's dtype); on the CPU its
    plain version, the add then F.layer_norm."""
    w, b = w.to(f.dtype), b.to(f.dtype)
    if f.device.type == "cuda":
        return kernels.swin_add_norm_rows(f, a, idx, w, b, LN_EPS)
    f = f + a.index_select(1, idx)
    f[..., w.shape[0]:] = 0
    return f, _layer_norm(f, w, b)


def _pair_in(p: dict, name: str, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The module `name`'s weight and bias in `dtype`."""
    return p[name + ".weight"].to(dtype), p[name + ".bias"].to(dtype)


def _stl_weights(p: dict, b: str, heads: int, ws: int, shift: int, hw: tuple,
                 dt: torch.dtype) -> dict:
    """The STL `b`'s weights as `_stl` reads them, in dt, the linears padded
    for the stream's width (HAT's HAB keeps the same names, and reads them so
    too); `scale` is the attention's, 1/sqrt(head dim) unpadded."""
    e = p[b + "norm1.weight"].shape[0]
    return {"norm1": _pair_in(p, b + "norm1", dt),
            "qkv": _qkv_weights(p, b + "attn.qkv", heads, dt),
            "scale": (e // heads) ** -0.5,
            "bias": attn_bias(p[b + "attn.relative_position_bias_table"], *hw, ws, shift, dt),
            "proj": _proj_weights(p, b + "attn.proj", heads, dt),
            "norm2": _pair_in(p, b + "norm2", dt), "fc1": _linear_in(p, b + "mlp.fc1", dt),
            "fc2": _linear_out(p, b + "mlp.fc2", dt)}


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, bsz: int,
           scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v over the windows of bsz maps, q [B *
    nW, heads, Nq, d], k and v [B * nW, heads, Nk, d]; bias [1, heads, Nq,
    Nk] for every window, or [nW, heads, Nq, Nk], one a window of each map."""
    n_win = q.shape[0]
    if bias.shape[0] == 1:
        bias = bias.expand(n_win, -1, -1, -1)
    else:  # one mask a window of each map
        bias = bias.expand(bsz, *bias.shape).reshape(n_win, *bias.shape[1:])
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)


def _window_attention(x: torch.Tensor, s: dict, heads: int, n: int) -> torch.Tensor:
    """proj(WMSA(x)) for the normed rows x [B, P, Cp], already rolled and in
    windows of n tokens, with the weights s (`_stl_weights`); the result in
    x's order."""
    bsz, p, _ = x.shape
    wq, bq = s["qkv"]
    d = wq.shape[0] // (3 * heads)
    q, k, v = F.linear(x, wq, bq).view(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    a = _attend(q, k, v, s["bias"], bsz, s["scale"])
    return F.linear(a.transpose(1, 2).reshape(bsz, p, heads * d), *s["proj"])


def _mlp(y: torch.Tensor, s: dict) -> torch.Tensor:
    """fc2(GELU(fc1(y)))."""
    return F.linear(F.gelu(F.linear(y, *s["fc1"])), *s["fc2"])


def _stl(f: torch.Tensor, s: dict, heads: int, ws: int, shift: int,
         hw: tuple) -> torch.Tensor:
    """One Swin transformer layer on the stream f [B, H*W, C], with its
    weights s (`_stl_weights`, in f's dtype)."""
    fwd, inv = _window_order(*hw, ws, shift, f.device)
    a = _window_attention(norm_rows(f, *s["norm1"], fwd), s, heads, ws * ws)  # rolled, windowed
    f, y = add_norm_rows(f, a, inv, *s["norm2"])
    return f + _mlp(y, s)


def _norm_launches() -> int:
    """The row-norm kernel's launches so far, both entry points."""
    return kernels.LAUNCHES["swin_norm_rows"] + kernels.LAUNCHES["swin_add_norm_rows"]


def _oihw(p: dict, name: str, dtype: torch.dtype, out_ch: Optional[int] = None,
          in_ch: Optional[int] = None) -> dict:
    """The conv `name` as `models.sr._conv` takes it ({"w": HWIO, "b"}), in
    `dtype`, its output channels (and bias) and input channels zero-padded
    up to out_ch and in_ch where given."""
    w, b = _pair_in(p, name, dtype)
    o, i = out_ch or w.shape[0], in_ch or w.shape[1]
    return {"w": _padded(w, o, i, *w.shape[2:]).permute(2, 3, 1, 0), "b": _padded(b, o)}


def _prepare_trunk(params: dict, cfg, dt: torch.dtype) -> dict:
    """The weights of the trunk SwinIR and HAT share (`_trunk_forward`) at
    compute dtype dt: the convs (`_oihw`; conv_first in float32), those on
    the stream padded to its width (`stream_width`), and the two plain
    norms."""
    cp = stream_width(cfg.embed_dim)
    convs = {"conv_after_body": (cp, cp), "conv_before_upsample.0": (None, cp),
             "conv_last": (None, None)}
    convs.update({f"layers.{i}.conv": (cp, cp) for i in range(len(cfg.depths))})
    convs.update({f"upsample.{2 * k}": (None, None)
                  for k in range(upsample_stages(cfg.factor))})
    out = {name: _oihw(params, name, dt, *ch) for name, ch in convs.items()}
    out["conv_first"] = _oihw(params, "conv_first", torch.float32, cp)
    for name in ("patch_embed.norm", "norm"):
        out[name] = _pair_in(params, name, dt)
    return out


def _prepare(params: dict, cfg: SwinIRConfig, dt: torch.dtype, hw: tuple) -> dict:
    """Every weight of the forward as it reads them at compute dtype dt on
    the padded map hw: the trunk's (`_prepare_trunk`) and each STL's
    (`_stl_weights`) under its prefix."""
    ws = cfg.window_size
    out = _prepare_trunk(params, cfg, dt)
    for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}."
            out[b] = _stl_weights(params, b, heads, ws, ws // 2 if j % 2 else 0, hw, dt)
    return out


#: the prepared weights of the last `_PREPARED_KEPT` parameter sets used,
#: oldest first: {(id(params), cfg, dtype, hw): (params, stamp, weights)};
#: holding params keeps its id from being reused while its entry lives
_PREPARED: dict = {}
_PREPARED_KEPT = 4


def _prepared(prepare, params: dict, cfg, dt: torch.dtype, hw: tuple) -> dict:
    """`prepare(params, cfg, dt, hw)`, computed once while `params` holds
    the same tensors at the same versions (a tensor replaced or written in
    place prepares it anew); inference tensors, which keep no version, are
    prepared at every call. The configuration is part of the key, so one
    parameter dict read as another network's is prepared for each."""
    if any(t.is_inference() for t in params.values()):
        return prepare(params, cfg, dt, hw)
    key = (id(params), cfg, dt, hw)
    stamp = [(id(t), t._version) for t in params.values()]
    hit = _PREPARED.pop(key, None)
    if hit is None or hit[1] != stamp:
        hit = (params, stamp, prepare(params, cfg, dt, hw))
    _PREPARED[key] = hit
    while len(_PREPARED) > _PREPARED_KEPT:
        del _PREPARED[next(iter(_PREPARED))]
    return hit[2]


def _cl_map(f: torch.Tensor, hw: tuple) -> torch.Tensor:
    """The stream [B, H*W, C] as a channels_last [B, C, H, W] view."""
    return f.view(f.shape[0], *hw, f.shape[-1]).permute(0, 3, 1, 2)


def _stream(x: torch.Tensor) -> torch.Tensor:
    """A [B, C, H, W] map as the contiguous stream [B, H*W, C]: a view of a
    channels_last map, a copy of another (a float64 conv on the card leaves
    its map NCHW), as the row-norm kernel reads whole rows."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()


def _trunk_forward(params: dict, x: torch.Tensor, cfg, dt: torch.dtype, prepare, group,
                  names: tuple, item: Optional[object] = None,
                  **counts: int) -> torch.Tensor:
    """The forward SwinIR and HAT share, x [B, C, h, w] -> [B, C, h*factor,
    w*factor], float32 (contiguous): reflect-pad to the window, conv_first,
    patch_embed's norm, for each group i `f = conv3x3(group(f, wts, i, hw))
    + f`, the last norm, conv_after_body + skip and the upsampler; `wts` is
    `_prepared(prepare, params, cfg, dt, hw)` on the padded map hw. Spans
    `names` = (forward, group, upsample): the forward's (item: the caller's)
    counts `tiles`, `counts`, `norm_kernels` and `stream_width`; a group's
    item is i."""
    bsz, _, h0, w0 = x.shape
    ws = cfg.window_size
    ph, pw = -h0 % ws, -w0 % ws
    hw = (h0 + ph, w0 + pw)
    launched = _norm_launches()
    with stage_timer(names[0], item=item, tiles=bsz, **counts) as counted, \
            precision(dt), sdpa_kernel(_SDPA_BACKENDS):
        wts = _prepared(prepare, params, cfg, dt, hw)
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        if cfg.img_range != 1.0:
            x = x * cfg.img_range
        with precision(torch.float32):  # the radiances unrounded (module docstring)
            x = _conv(x.float().contiguous(memory_format=torch.channels_last),
                      wts["conv_first"], torch.float32).to(dt)
        f = norm_rows(_stream(x), *wts["patch_embed.norm"])
        counted["stream_width"] = f.shape[-1]
        for i in range(len(cfg.depths)):
            with stage_timer(names[1], item=i):
                g = group(f, wts, i, hw)
                f = _stream(_conv(_cl_map(g, hw), wts[f"layers.{i}.conv"], dt)) + f
        x = _conv(_cl_map(norm_rows(f, *wts["norm"]), hw), wts["conv_after_body"], dt) + x
        counted["norm_kernels"] = _norm_launches() - launched
        with stage_timer(names[2]):
            x = F.leaky_relu(_conv(x, wts["conv_before_upsample.0"], dt), 0.01)
            for k in range(upsample_stages(cfg.factor)):
                x = _pixel_shuffle_cl(_conv(x, wts[f"upsample.{2 * k}"], dt), 2)
            y = _conv(x, wts["conv_last"], dt)
            y = y[:, :, :h0 * cfg.factor, :w0 * cfg.factor]
            if cfg.img_range != 1.0:
                y = y / cfg.img_range
            return y.to(torch.float32, memory_format=torch.contiguous_format)


def swinir_forward(params: dict, x: torch.Tensor, cfg: SwinIRConfig = SwinIRConfig(),
                   compute_dtype: torch.dtype = torch.bfloat16,
                   item: Optional[object] = None) -> torch.Tensor:
    """x: [B, C, h, w] -> [B, C, h*factor, w*factor], float32 (contiguous)."""
    ws = cfg.window_size
    n_win = -(-x.shape[2] // ws) * -(-x.shape[3] // ws)

    def rstb(f, wts, i, hw):
        for j in range(cfg.depths[i]):
            f = _stl(f, wts[f"layers.{i}.residual_group.blocks.{j}."], cfg.num_heads[i], ws,
                     ws // 2 if j % 2 else 0, hw)
        return f

    return _trunk_forward(params, x, cfg, compute_dtype, _prepare, rstb,
                         ("swinir.forward", "swinir.rstb", "swinir.upsample"), item,
                         windows=x.shape[0] * n_win * sum(cfg.depths))
