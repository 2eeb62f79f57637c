"""Degradation ops: the plain PyTorch path (`degrade`), the fused Hopper
kernel's entry points (`degrade_fused`) and the whole-scene slab stencil
(`degrade_scene_fast`); the noise-sigma estimate (`sigma`) and the NLM
denoiser (`nlm`)."""
from .nlm import (
    PATCH_DISTANCE,
    PATCH_SIZE,
    denoise_band,
    denoise_band_np,
    denoise_batch,
    denoise_batch_dispatch,
    denoise_batch_finalize,
    denoise_stack,
    denoise_stack_np,
    nlm_denoise_2d,
    nlm_denoise_np,
)
from .sigma import estimate_sigma, estimate_sigma_np, hh_subband, hh_subband_np
