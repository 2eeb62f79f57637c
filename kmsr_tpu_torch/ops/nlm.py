"""Non-local means denoising — dense shifted-window formulation.

The port's counterpart of `kmsr_tpu.ops.nlm`, with the same semantics:
float NLM with patch_size=7, patch_distance=11 and fast-mode weights

    w_t(p) = exp(-max(mean_sq_patch_diff(p, p+t) - 2*sigma^2, 0) / h^2),

NaN pixels filled with the band mean before denoising and restored after,
h = h_factor * estimate_sigma(band). skimage's border rules: a candidate
counts only when its centre p+t lies inside the image (patch windows may
reach into an offset-wide reflect ring), and the null shift is counted
twice (self-weight 2). The true exp, with no distance cutoff (skimage
uses an approximation and a cutoff; the goldens in
tests/fixtures/denoise_golden/ bound the difference).

`nlm_denoise_2d` is plain PyTorch on either device. It sweeps the
(2d+1)^2 shift lattice one lattice row at a time, with the row's 2d+1
column shifts stacked on a new axis (views of the padded image, no
copies): per row the squared difference, written into one contiguous
[L, S, H+6, W+6] buffer, the patch mean (one 7x7 `avg_pool2d`), the exp
weight, the border mask (a table built once) and the weighted sums — 13
launches a row, 23 rows at the defaults. The buffer keeps the shift axis
outside the image axes: left in the layout the stacked views give it
(shift axis innermost, channels_last), the patch mean runs PyTorch's
NHWC pooling kernel, 1.4x slower for the whole sweep on the card
(`scripts/torch_nlm_ab.py`).

The numpy reference (`nlm_denoise_np`, float64) backs the parity tests
and the CLI's `--cpu-reference` (`denoise_band_np`, `denoise_stack_np`).
One repair against the JAX package's copy: where the patch distance
reaches past the image (a side <= patch_distance), its border mask sliced
with a negative stop and kept rows it had to drop; here the bounds are
clamped, which gives what the JAX device path and the brute-force
definition give.

`denoise_batch_dispatch` / `denoise_batch_finalize` split a batch into
its asynchronous half (NaN fill on the host, upload through a pinned
buffer, sigma pass and sweep launched, the copy back into pinned memory
queued right behind them) and its sync point (waiting for that copy),
so a folder loop keeps one chunk in flight while it writes the
previous one out. A plain `.cpu()` in finalize would be queued behind
the next chunk's sweep as well, and the card would idle while the host
dispatches the chunk after it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel.local_dp import gather, local_batch_dp, local_map, pad_put
from .sigma import estimate_sigma, estimate_sigma_np, pad_index

PATCH_SIZE = 7
PATCH_DISTANCE = 11


def _box_filter_np(x: np.ndarray, size: int) -> np.ndarray:
    """VALID box sum via cumulative sums. [H,W] -> [H-size+1, W-size+1]."""
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    return (
        c[size:, size:] - c[:-size, size:] - c[size:, :-size] + c[:-size, :-size]
    )


def nlm_denoise_np(
    img: np.ndarray,
    h: float,
    sigma: float = 0.0,
    patch_size: int = PATCH_SIZE,
    patch_distance: int = PATCH_DISTANCE,
) -> np.ndarray:
    """Reference (numpy) fast NLM on a NaN-free 2-D image."""
    img = np.asarray(img, np.float64)
    hgt, wid = img.shape
    o = patch_size // 2
    pad = patch_distance + o
    up = np.pad(img, pad, mode="reflect")
    out = np.zeros((hgt, wid))
    wsum = np.zeros((hgt, wid))
    var2 = 2.0 * sigma * sigma
    h2 = h * h if h > 0 else 1e-12
    n_pix = patch_size * patch_size
    for t1 in range(-patch_distance, patch_distance + 1):
        for t2 in range(-patch_distance, patch_distance + 1):
            # squared diff on the region covering all patch windows
            a = up[pad - o : pad + hgt + o, pad - o : pad + wid + o]
            b = up[
                pad + t1 - o : pad + t1 + hgt + o,
                pad + t2 - o : pad + t2 + wid + o,
            ]
            sq = (a - b) ** 2
            dist = _box_filter_np(sq, patch_size) / n_pix  # [H, W]
            w = np.exp(-np.maximum(dist - var2, 0.0) / h2)
            # skimage border semantics: a candidate only counts when its
            # center p+t is inside the image — zero the weight elsewhere
            # (bounds clamped at 0: a shift longer than the side keeps none)
            wm = np.zeros_like(w)
            r0, r1 = max(0, -t1), max(0, hgt - max(0, t1))
            c0, c1 = max(0, -t2), max(0, wid - max(0, t2))
            wm[r0:r1, c0:c1] = w[r0:r1, c0:c1]
            shifted = up[pad + t1 : pad + t1 + hgt, pad + t2 : pad + t2 + wid]
            out += wm * shifted
            wsum += wm
    # skimage's symmetric-pair accumulation double-counts the null shift:
    # one extra self contribution with weight exp(0) = 1
    out += img
    wsum += 1.0
    return out / wsum


def _per_image(v, lead: tuple, dev: torch.device) -> torch.Tensor:
    """A scalar or an array broadcastable to the leading dims, as one
    float32 value per image: [n_images, 1, 1, 1]."""
    v = torch.as_tensor(v, dtype=torch.float32, device=dev)
    return v.expand(lead).reshape(-1, 1, 1, 1)


def nlm_denoise_2d(
    img: torch.Tensor,
    h,
    sigma=0.0,
    patch_size: int = PATCH_SIZE,
    patch_distance: int = PATCH_DISTANCE,
) -> torch.Tensor:
    """Fast NLM on NaN-free images: [..., H, W] -> [..., H, W] float32, on
    img's device.

    Accepts leading batch dims; `h`/`sigma` may be scalars or tensors
    broadcastable to the leading dims (per-band h over a [C, H, W] stack).
    """
    img = torch.as_tensor(img, dtype=torch.float32)
    dev = img.device
    *lead, hgt, wid = img.shape
    x = img.reshape(-1, hgt, wid)
    o = patch_size // 2
    pd = patch_distance
    pad = pd + o
    n_shift = 2 * pd + 1
    # numpy's reflect (as jnp.pad's), pads wider than the side included
    up = x.index_select(1, pad_index(hgt, pad, "reflect", dev)).index_select(
        2, pad_index(wid, pad, "reflect", dev))
    var2 = 2.0 * _per_image(sigma, tuple(lead), dev) ** 2
    neg_h2 = -torch.clamp_min(_per_image(h, tuple(lead), dev) ** 2, 1e-12)

    hb, wb = hgt + 2 * o, wid + 2 * o
    a = up[:, pd : pd + hb, pd : pd + wb].unsqueeze(1)  # [L, 1, hb, wb]
    # skimage border semantics: a candidate counts only when its centre
    # p + t lies inside the image — one [S, S, H, W] table for the lattice
    t = torch.arange(-pd, pd + 1, device=dev)
    rows, cols = torch.arange(hgt, device=dev), torch.arange(wid, device=dev)
    row_ok = (rows + t[:, None] >= 0) & (rows + t[:, None] < hgt)  # [S, H]
    col_ok = (cols + t[:, None] >= 0) & (cols + t[:, None] < wid)  # [S, W]
    border = row_ok[:, None, :, None] & col_ok[None, :, None, :]
    sq = torch.empty((x.shape[0], n_shift, hb, wb), dtype=torch.float32, device=dev)
    out = torch.zeros_like(x)
    wsum = torch.zeros_like(x)
    for t1 in range(n_shift):
        # the lattice row's n_shift column shifts as views: [L, S, hb, wb]
        b = up[:, t1 : t1 + hb, :].unfold(2, wb, 1).permute(0, 2, 1, 3)
        torch.sub(a, b, out=sq).square_()
        dist = F.avg_pool2d(sq, patch_size, stride=1)  # patch means [L, S, H, W]
        w = dist.sub_(var2).clamp_(min=0.0).div_(neg_h2).exp_().mul_(border[t1])
        shifted = up[:, t1 + o : t1 + o + hgt, o : o + wid + 2 * pd].unfold(
            2, wid, 1).permute(0, 2, 1, 3)
        out.add_((w * shifted).sum(1))
        wsum.add_(w.sum(1))
    # skimage double-counts the null shift (symmetric-pair accumulation):
    # one extra self contribution with weight exp(0) = 1
    return ((out + x) / (wsum + 1.0)).reshape(img.shape)


def denoise_band(
    band: np.ndarray,
    h_factor: float = 1.8,
    patch_size: int = PATCH_SIZE,
    patch_distance: int = PATCH_DISTANCE,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, float]:
    """Full per-band contract (`denoise/denoise.py:34-67`): NaN-fill with
    the band mean, estimate sigma, h = h_factor * sigma, NLM, restore NaNs.

    Returns (denoised with NaNs restored, estimated sigma). An all-NaN
    band comes back untouched with sigma 0.0.
    """
    dev = resolve_device(device)
    band = np.asarray(band, np.float32)
    valid = ~np.isnan(band)
    if not valid.any():
        return band, 0.0
    fill = float(np.nanmean(band))
    filled = torch.from_numpy(np.where(valid, band, fill).astype(np.float32)).to(dev)
    sig = estimate_sigma(filled)
    den = nlm_denoise_2d(filled, sig * h_factor, sig, patch_size, patch_distance)
    return np.where(valid, den.cpu().numpy(), np.nan).astype(np.float32), float(sig)


def denoise_band_np(
    band: np.ndarray,
    h_factor: float = 1.8,
    patch_size: int = PATCH_SIZE,
    patch_distance: int = PATCH_DISTANCE,
) -> tuple[np.ndarray, float]:
    """`denoise_band` on the numpy reference (float64 sigma and NLM): what
    the JAX package runs with use_device=False."""
    band = np.asarray(band, np.float32)
    valid = ~np.isnan(band)
    if not valid.any():
        return band, 0.0
    fill = float(np.nanmean(band))
    filled = np.where(valid, band, fill).astype(np.float32)
    sig = estimate_sigma_np(filled)
    den = nlm_denoise_np(
        filled, h_factor * sig, sig, patch_size, patch_distance
    ).astype(np.float32)
    return np.where(valid, den, np.nan).astype(np.float32), sig


@dataclasses.dataclass
class DenoiseHandle:
    """A dispatched batch: the sweep's outputs on their way to the host, and
    what the host needs to finish it."""
    denoised: torch.Tensor      # [N*C, H, W] host tensor (pinned on a card)
    sigma: torch.Tensor         # [N*C] host tensor (pinned on a card)
    copied: list                # one event a card, recorded after its copies
    #                             (empty on the CPU)
    staging: torch.Tensor       # the (pinned) upload buffer, kept until the sync
    stacks: np.ndarray          # [N, C, H, W] float32 input, NaNs included
    valid: np.ndarray           # ~isnan(stacks)
    any_valid: np.ndarray       # [N, C]


def _sigma_and_nlm(filled: torch.Tensor, h_factor: float):
    sig = estimate_sigma(filled)
    return nlm_denoise_2d(filled, sig * h_factor, sig), sig


def denoise_batch_dispatch(
    stacks: np.ndarray, h_factor: float = 1.8, device: str | torch.device = "cuda",
    devices=None,
) -> DenoiseHandle:
    """Async half of `denoise_batch`: NaN-fill each (file, band) with its
    mean on the host, upload through a pinned buffer (non-blocking on a
    card), launch the sigma pass and the shift sweep and queue their copy
    back; returns the in-flight handle. `denoise_batch_finalize` is the
    sync point.

    Batch DP: every (file, band) image is independent, so the flattened
    leading axis is split over the host's cards (`parallel.local_dp`; for
    device "cuda", every visible card; `devices` names them explicitly);
    the zero padding is inert (sigma 0, h clamp, self-weight 1) and is
    sliced back off."""
    devs, n_dev = local_batch_dp(device, devices)
    dev = devs[0]
    stacks = np.asarray(stacks, np.float32)
    n, c, hgt, wid = stacks.shape
    valid = ~np.isnan(stacks)
    any_valid = valid.any(axis=(2, 3))  # [N, C]
    flat = stacks.reshape(n * c, hgt, wid)
    fills = np.zeros(n * c, np.float32)
    for i in np.nonzero(any_valid.reshape(-1))[0]:
        fills[i] = np.nanmean(flat[i])
    staging = torch.empty((n * c, hgt, wid), dtype=torch.float32,
                          pin_memory=dev.type == "cuda")
    host = staging.numpy()
    np.copyto(host, flat)
    np.copyto(host, fills[:, None, None], where=~valid.reshape(flat.shape))
    blocks, nb = pad_put(staging, devs, n_dev)
    outs = local_map(lambda x: _sigma_and_nlm(x, h_factor), blocks)
    copied = []
    if dev.type == "cuda":
        step = blocks[0].shape[0]
        den = torch.empty((step * n_dev, hgt, wid), dtype=torch.float32, pin_memory=True)
        sig = torch.empty(step * n_dev, dtype=torch.float32, pin_memory=True)
        for i, (d_i, s_i) in enumerate(outs):
            with torch.cuda.device(d_i.device):
                den[i * step:(i + 1) * step].copy_(d_i, non_blocking=True)
                sig[i * step:(i + 1) * step].copy_(s_i, non_blocking=True)
                copied.append(torch.cuda.Event())
                copied[-1].record()
        den, sig = den[:nb], sig[:nb]
    else:
        den = gather([o[0] for o in outs], nb)
        sig = gather([o[1] for o in outs], nb)
    return DenoiseHandle(den, sig, copied, staging, stacks, valid, any_valid)


def denoise_batch_finalize(handle: DenoiseHandle) -> tuple[np.ndarray, np.ndarray]:
    """Sync half of `denoise_batch`: wait for the sweep's copy back, then
    restore NaNs and pass all-NaN bands through on the host."""
    for done in handle.copied:
        done.synchronize()
    stacks = handle.stacks
    n, c = stacks.shape[:2]
    den = handle.denoised.numpy().reshape(stacks.shape)
    sig = handle.sigma.numpy().reshape(n, c)
    out = np.where(handle.valid, den, np.nan).astype(np.float32)
    dead = ~handle.any_valid
    out[dead] = stacks[dead]
    sigmas = np.where(handle.any_valid, sig, 0.0)
    return out, sigmas.astype(np.float32)


def denoise_batch(
    stacks: np.ndarray, h_factor: float = 1.8, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """Denoise a batch of band stacks [N, C, H, W] in one sweep
    (per-(file, band) sigma/h, NaN fill/restore as in `denoise_band`).

    Returns (denoised [N, C, H, W], sigmas [N, C] float32).
    """
    return denoise_batch_finalize(denoise_batch_dispatch(stacks, h_factor, device))


def denoise_stack(
    stack: np.ndarray, h_factor: float = 1.8, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, list[float]]:
    """Denoise a [C, H, W] band stack in one sweep over all bands; returns
    (denoised, per-band sigmas)."""
    den, sig = denoise_batch(np.asarray(stack, np.float32)[None], h_factor, device)
    return den[0], [float(s) for s in sig[0]]


def denoise_stack_np(
    stack: np.ndarray, h_factor: float = 1.8
) -> tuple[np.ndarray, list[float]]:
    """`denoise_stack` on the numpy reference, band by band."""
    outs, sigmas = [], []
    for c in range(stack.shape[0]):
        den, sig = denoise_band_np(stack[c], h_factor=h_factor)
        outs.append(den)
        sigmas.append(sig)
    return np.stack(outs, axis=0), sigmas
