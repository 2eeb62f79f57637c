"""Robust noise-sigma estimation (wavelet-detail MAD).

The port's counterpart of `kmsr_tpu.ops.sigma`. Semantics follow
skimage's `estimate_sigma`: a single-level 2-D Daubechies-2 DWT in
PyWavelets' convention (mode='symmetric': half-sample symmetric extension,
the edge sample repeated), the diagonal (HH) detail subband, exact-zero
coefficients dropped (constant NaN-filled regions emit exact zeros that
would bias the median low), and

    sigma = median(|HH|) / 0.67448975   (1 / norm.ppf(0.75)).

pywt's downsampling convolution keeps output o of the extended signal
x_ext (padded by F-1 = 3 on each side) at position 2o+1 of the VALID
convolution:

    out[o] = sum_j filt[j] * x_ext[2o + 4 - j],   o < (N + 3) // 2.

Divergence kept from the JAX package: an image whose HH subband is all
exact zeros (a constant image) gives 0.0, where skimage gives NaN.

Two versions: the numpy host one (float64, the plain reference) and
`estimate_sigma`, batched over the leading dims of a torch tensor on any
device. The torch one differs from the JAX one in three spellings, each
chosen to give JAX's numbers:

* torch's `F.pad` has no 'symmetric' mode ('reflect' does not repeat the
  edge sample), so the extension is an index gather (`pad_index`, numpy's
  rule for any pad width);
* the filter is four explicit float32 taps (JAX runs a conv at
  Precision.HIGHEST; a torch conv would run in TF32 on the card unless
  guarded);
* `torch.nanmedian` returns the lower of the two middle values, numpy and
  `jnp.nanmedian` their mean, and the zero drop leaves a different count
  per image: each row is sorted with the dropped entries last and the
  median taken as (s[(k-1)//2] + s[k//2]) * 0.5 of its k kept values.
"""
from __future__ import annotations

import numpy as np
import torch

# Daubechies-2 decomposition filters (orthonormal).
_DB2_LO = np.array(
    [-0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025]
)
_DB2_HI = np.array(
    [-0.48296291314469025, 0.836516303737469, -0.22414386804185735, -0.12940952255092145]
)
_MAD_TO_SIGMA = 1.0 / 0.67448975  # 1 / norm.ppf(0.75)


def _dwt_rows_np(x: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Filter rows (symmetric pad, stride-2 downsample)."""
    flen = len(filt)
    xp = np.pad(x, ((0, 0), (flen - 1, flen - 1)), mode="symmetric")
    full = np.apply_along_axis(lambda r: np.convolve(r, filt, mode="valid"), 1, xp)
    return full[:, 1::2]


def hh_subband_np(img: np.ndarray) -> np.ndarray:
    """Diagonal detail coefficients of a single-level db2 DWT."""
    d = _dwt_rows_np(np.asarray(img, np.float64), _DB2_HI)
    d = _dwt_rows_np(d.T, _DB2_HI).T
    return d


def estimate_sigma_np(img: np.ndarray) -> float:
    """Host-side sigma estimate; NaNs must be filled by the caller."""
    hh = hh_subband_np(img)
    hh = hh[hh != 0]  # skimage drops exact zeros before the median
    if hh.size == 0:
        return 0.0  # constant image (skimage: NaN — see module docstring)
    return float(np.median(np.abs(hh)) * _MAD_TO_SIGMA)


def pad_index(n: int, pad: int, mode: str, dev: torch.device) -> torch.Tensor:
    """Source index of each sample of a side-n axis padded by `pad` on both
    ends, as `np.pad(np.arange(n), pad, mode)` gives it for mode "reflect"
    (edge sample not repeated) or "symmetric" (repeated), pads wider than
    the side included (`F.pad` refuses those). Built by arithmetic on dev:
    a map copied from the host would be a pageable copy queued behind the
    device's earlier work, and the caller would wait for it."""
    i = torch.arange(-pad, n + pad, device=dev)
    period = 2 * n if mode == "symmetric" else 2 * (n - 1)
    if period == 0:  # reflect of a single sample
        return torch.zeros_like(i)
    i = i.remainder(period)
    return torch.where(i < n, i, period - 1 - i if mode == "symmetric" else period - i)


def _dwt_last_axis(x: torch.Tensor) -> torch.Tensor:
    """db2 high-pass + stride-2 downsample along the last axis:
    [..., N] -> [..., (N + 3) // 2]."""
    flen = len(_DB2_HI)
    n = x.shape[-1]
    xp = x.index_select(-1, pad_index(n, flen - 1, "symmetric", x.device))
    n_out = (n + flen - 1) // 2
    taps = torch.tensor(_DB2_HI, dtype=torch.float32).tolist()
    out = None
    # the taps in the order of JAX's flipped-filter correlation
    for j in reversed(range(flen)):
        start = flen - j  # x_ext[2o + 1 + (F - 1) - j] at o = 0
        term = xp[..., start:start + 2 * n_out - 1:2] * taps[j]
        out = term if out is None else out + term
    return out


def hh_subband(img: torch.Tensor) -> torch.Tensor:
    """HH subband of each image of `img` [..., H, W] (float32)."""
    d = _dwt_last_axis(img.to(torch.float32))
    return _dwt_last_axis(d.transpose(-1, -2)).transpose(-1, -2)


def estimate_sigma(img: torch.Tensor) -> torch.Tensor:
    """Sigma estimate of each NaN-free image of `img` [..., H, W], on its
    device: a float32 tensor of the leading shape."""
    lead = img.shape[:-2]
    hh = hh_subband(img).flatten(-2)
    mag = hh.reshape(-1, hh.shape[-1]).abs()
    kept = mag != 0
    k = kept.sum(dim=1)
    s, _ = torch.where(kept, mag, torch.inf).sort(dim=1)
    lo = ((k - 1).clamp_min(0) // 2).unsqueeze(1)
    hi = (k // 2).clamp_max(s.shape[1] - 1).unsqueeze(1)
    med = (s.gather(1, lo) + s.gather(1, hi)).squeeze(1) * 0.5
    sig = torch.where(k > 0, med * _MAD_TO_SIGMA, torch.zeros_like(med))
    return sig.reshape(lead)
