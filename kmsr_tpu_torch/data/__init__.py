"""Host-side data: patch file listing and the noise pool."""
from .noise_pool import add_noise_np, load_noise_pool, validate_noise_pool
from .sampler import list_patch_files
