"""Host-side data: patch pools and samplers, patch file listing and the
noise pool."""
from .noise_pool import add_noise_np, load_noise_pool, validate_noise_pool
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
