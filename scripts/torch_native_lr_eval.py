"""Cross-sensor SR evaluation on GENUINE native-LR scenes, on the PyTorch port.

The port's counterpart of `scripts/native_lr_eval.py`: the same flags (and
`--device`, default cuda), printed lines and appended section; only the
model row names `kmsr_tpu_torch`. It regenerates the clean fields with
`torch_make_quality_scenes` and super-resolves through
`kmsr_tpu_torch.pipeline.sr_scene`; `evaluate_scene` is the device part on
arrays.

The factory-pairs holdout (docs/QUALITY_real_lr.md main table) measures
SR against pairs manufactured with the LEARNED kernel — internally
consistent, but blind to kernel error. This script runs the true
cross-sensor test the flagship configuration exists for: super-resolve
the NATIVE LR-sensor scenes themselves (never seen by SR training,
degraded by the GROUND-TRUTH PSF, carrying real LR sensor noise) and
score against the clean HR field (regenerated deterministically from
`make_quality_scenes`' seeded stream — same ocean, no HR sensor noise).
If the learned degradation kernel is wrong, SR transfers badly to the
real sensor and this number falls; the factory-pairs number would not.

Usage:
    python scripts/torch_native_lr_eval.py --lr-dir quality_run/scenes_lr \
        --model quality_run/work_real_lr/sr_run/sr_model.npz \
        --width 64 --n-blocks 8 [--append docs/QUALITY_real_lr.md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def evaluate_scene(params, lr: np.ndarray, clean: np.ndarray, cfg, tile: int = 64,
                   device="cuda") -> tuple:
    """(SR psnr, SR ssim, bilinear psnr, bilinear ssim, hole share) of one
    native-LR scene [C, h, w] against its clean HR field [C, H, W].

    Cloud holes: the matmul-spelled bilinear would propagate NaN
    everywhere (0*NaN), so the LR is band-mean-filled BEFORE upsampling
    (same treatment sr_scene applies internally) and the hole footprint is
    excluded from scoring by filling it with the truth: zero error for
    both methods over the hole area."""
    import torch

    from kmsr_tpu_torch.device import resolve_device
    from kmsr_tpu_torch.models.sr import bilinear_upsample
    from kmsr_tpu_torch.ops.metrics import psnr, ssim
    from kmsr_tpu_torch.pipeline.sr_scene import sr_scene

    dev = resolve_device(device)
    factor = cfg.factor
    lr_hole = ~np.isfinite(lr[0])
    fills = np.nanmean(lr, axis=(1, 2))
    lr_filled = np.where(np.isfinite(lr), lr, fills[:, None, None]).astype(np.float32)
    sr = np.asarray(sr_scene(params, lr, cfg, tile=tile, device=dev))
    bil = bilinear_upsample(torch.from_numpy(lr_filled[None]).to(dev), factor)[0].cpu().numpy()
    hole = np.kron(lr_hole, np.ones((factor, factor), bool))
    hole = hole[None] | ~np.isfinite(sr) | ~np.isfinite(bil)
    sr = np.where(hole, clean, sr)
    bil = np.where(hole, clean, bil)
    dr = float(clean.max() - clean.min())
    c = torch.from_numpy(np.ascontiguousarray(clean, np.float32)).to(dev)
    s = torch.from_numpy(sr.astype(np.float32)).to(dev)
    b = torch.from_numpy(bil.astype(np.float32)).to(dev)
    return (float(psnr(s, c, dr)), float(ssim(s, c, dr)), float(psnr(b, c, dr)),
            float(ssim(b, c, dr)), float(hole[0].mean()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lr-dir", required=True,
                   help="native-LR scenes (make_quality_scenes --lr-outdir)")
    p.add_argument("--model", required=True, help="sr_model.npz")
    p.add_argument("--factor", type=int, default=8)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--n-blocks", type=int, default=8)
    p.add_argument("--upsampler", default="progressive")
    p.add_argument("--seed", type=int, default=20260819,
                   help="make_quality_scenes seed (clean-field regeneration)")
    p.add_argument("--size", type=int, default=896)
    p.add_argument("--tile", type=int, default=64)
    p.add_argument("--append", default=None,
                   help="append the results section to this markdown report")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda raises without a card")
    a = p.parse_args(argv)

    import torch_make_quality_scenes as mqs
    from kmsr_tpu_torch.device import resolve_device
    from kmsr_tpu_torch.io.ncio import NCFile
    from kmsr_tpu_torch.io.schema import GROUP_GEO
    from kmsr_tpu_torch.models.sr import SRConfig, init_sr
    from kmsr_tpu_torch.utils.params_io import load_params

    dev = resolve_device(a.device)
    bands = mqs.BANDS
    lr_files = sorted(glob.glob(os.path.join(a.lr_dir, "scene_*.nc")))
    if not lr_files:
        raise SystemExit(f"no scene_*.nc under {a.lr_dir}")

    cfg = SRConfig(width=a.width, n_blocks=a.n_blocks, factor=a.factor,
                   upsampler=a.upsampler)
    params = load_params(a.model, init_sr(cfg, device="cpu"), device=dev)

    # clean HR fields: replay the seeded generator stream (scene i's
    # clean field depends on all draws before it, so walk in order)
    rng = np.random.default_rng(a.seed)
    cleans = [mqs.make_scene(rng, a.size)[1] for _ in range(len(lr_files))]

    rows = []
    for i, lf in enumerate(lr_files):
        with NCFile(lf, "r") as nc:
            lr = np.stack([nc.group(GROUP_GEO)[b][:] for b in bands])
        *m, hole_share = evaluate_scene(params, lr, cleans[i], cfg, tile=a.tile,
                                        device=dev)
        rows.append(tuple(m))
        print(f"{os.path.basename(lf)}: SR {m[0]:.2f}/{m[1]:.4f} "
              f"bilinear {m[2]:.2f}/{m[3]:.4f} (hole {hole_share:.1%})")
    arr = np.asarray(rows)
    sr_p, sr_s, bl_p, bl_s = arr.mean(axis=0)
    result = {
        "metric": "native_lr_sr_psnr",
        "sr_psnr": round(float(sr_p), 2),
        "sr_ssim": round(float(sr_s), 4),
        "bilinear_psnr": round(float(bl_p), 2),
        "bilinear_ssim": round(float(bl_s), 4),
        "delta_psnr": round(float(sr_p - bl_p), 2),
        "delta_ssim": round(float(sr_s - bl_s), 4),
        "scenes": len(lr_files),
    }
    print(json.dumps(result))

    if a.append:
        lines = [
            "",
            "## Cross-sensor transfer: SR on the NATIVE LR scenes",
            "",
            "The table above scores SR on factory-manufactured pairs —",
            "internally consistent but blind to kernel error (the holdout",
            "LR was made with the same learned kernel SR trained on).",
            "This section is the true cross-sensor test: the trained SR",
            "model super-resolves the GENUINE native-LR scenes (degraded",
            "by the ground-truth PSF with real LR sensor noise, never",
            "seen in training) and is scored against the clean HR field",
            "(regenerated from the seeded stream; cloud holes excluded",
            "identically for both methods). A wrong learned kernel makes",
            "this number fall while leaving the factory-pairs number",
            "intact.",
            "",
            "| method | PSNR (dB) | SSIM |",
            "|---|---|---|",
            f"| bilinear x{a.factor} | {bl_p:.2f} | {bl_s:.4f} |",
            f"| kmsr_tpu_torch SR | **{sr_p:.2f}** | **{sr_s:.4f}** |",
            f"| delta | {sr_p - bl_p:+.2f} | {sr_s - bl_s:+.4f} |",
            "",
            f"(mean over {len(lr_files)} scenes; reproduce: "
            f"`python scripts/torch_native_lr_eval.py --lr-dir {a.lr_dir} "
            f"--model {a.model} --width {a.width} --n-blocks "
            f"{a.n_blocks}`)",
            "",
        ]
        with open(a.append, "a", encoding="utf-8") as f:
            f.write("\n".join(lines))
        print(f"section appended -> {a.append}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
