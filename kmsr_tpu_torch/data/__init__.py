"""Host-side data: patch pools and samplers, patch file listing, the
noise pool, the water mask and the patch cutter."""
from .mask import MaskStats, apply_water_mask, invalid_to_nan
from .noise_pool import (
    NoisePoolResult,
    add_noise_np,
    build_noise_pool,
    load_noise_pool,
    noise_crops,
    noise_pool_stats,
    random_crops_np,
    sample_noise_device,
    validate_noise_pool,
)
from .patches import (
    CutConfig,
    CutResult,
    cut_scene,
    cut_to_files,
    group_by_scene,
    iter_kept_patches,
    nan_ratio_gate,
    scene_prefix,
)
from .sampler import (
    NaNPatchError,
    PatchPool,
    StreamingPatchPool,
    gradient_weight_map,
    list_patch_files,
    load_scene_bands,
    sample_scene_patches,
    synthetic_pool,
)
