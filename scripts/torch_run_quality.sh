#!/usr/bin/env bash
# One-command reproduction of the SR quality reports through the PyTorch
# port (kmsr_tpu_torch): synthetic Landsat-like scenes -> full pipeline
# DAG -> SR training with a held-out eval split -> quality report vs the
# bilinear baseline. The same three variants as scripts/run_quality.sh,
# each stage run by the port's runner and scripts.
#
# Usage: bash scripts/torch_run_quality.sh [x8|x4_moe|x8_real_lr]   (default x8)
# DEVICE=cpu runs every stage on the CPU (default cuda).
#
#   x8         configs/quality_x8.json      -> docs/QUALITY_torch.md
#              (single trainer disabled; the reference's shipped
#              KernelGAN kernel drives the factory)
#   x4_moe     configs/quality_x4_moe.json  -> docs/QUALITY_x4_torch.md
#              (trains the 10-expert MoE bank in-pipeline, per-expert
#              factory routing at x4)
#   x8_real_lr configs/quality_x8_real_lr.json -> docs/QUALITY_real_lr_torch.md
#              (FLAGSHIP: per-scene fleet KernelGAN with genuine
#              native-LR scenes as the D's real side; the factory uses
#              each scene's learned kernel)
set -euo pipefail
cd "$(dirname "$0")/.."

variant="${1:-x8}"
device="${DEVICE:-cuda}"
if [ "$variant" != "x8_real_lr" ]; then
    python scripts/torch_make_quality_scenes.py quality_run/scenes --n 8 --size 896
fi

case "$variant" in
  x8)
    python -m kmsr_tpu_torch.pipeline.run_all --config configs/quality_x8.json --resume --device "$device"
    python scripts/torch_quality_report.py --device "$device" \
        --pairs quality_run/work/train_pairs \
        --sr quality_run/work/sr_run \
        --holdout 24 --width 64 --n-blocks 8 \
        --config configs/quality_x8.json --out docs/QUALITY_torch.md
    ;;
  x4_moe)
    python -m kmsr_tpu_torch.pipeline.run_all --config configs/quality_x4_moe.json --resume --device "$device"
    python scripts/torch_quality_report.py --device "$device" \
        --pairs quality_run/work_x4/train_pairs \
        --sr quality_run/work_x4/sr_run \
        --holdout 24 --factor 4 --width 64 --n-blocks 8 \
        --config configs/quality_x4_moe.json \
        --moe-dir quality_run/work_x4/kernel_run \
        --out docs/QUALITY_x4_torch.md
    ;;
  x8_real_lr)
    # native-LR scenes (GOCI-like, ground-truth anisotropic kernel +
    # LR-sensor noise) are the fleet D's real side
    python scripts/torch_make_quality_scenes.py quality_run/scenes \
        --n 8 --size 896 --lr-outdir quality_run/scenes_lr
    python -m kmsr_tpu_torch.pipeline.run_all --config configs/quality_x8_real_lr.json --resume --device "$device"
    python scripts/torch_quality_report.py --device "$device" \
        --pairs quality_run/work_real_lr/train_pairs \
        --sr quality_run/work_real_lr/sr_run \
        --holdout 24 --width 64 --n-blocks 8 \
        --config configs/quality_x8_real_lr.json \
        --kernel-root quality_run/work_real_lr/kernel_run \
        --gt-kernel quality_run/scenes_lr/gt_kernel.npy \
        --out docs/QUALITY_real_lr_torch.md
    python scripts/torch_native_lr_eval.py --device "$device" \
        --lr-dir quality_run/scenes_lr \
        --model quality_run/work_real_lr/sr_run/sr_model.npz \
        --width 64 --n-blocks 8 --append docs/QUALITY_real_lr_torch.md
    ;;
  *)
    echo "unknown variant: $variant (expected x8 | x4_moe | x8_real_lr)" >&2
    exit 2
    ;;
esac
