"""Patch file listing for the file-in/file-out pipeline stages.

Counterpart of `kmsr_tpu.data.sampler.list_patch_files`; `PatchPool` and
the scene samplers come with the trainer slice (ROADMAP.md).
"""
from __future__ import annotations

import glob
import os


def list_patch_files(
    patch_dir: str, pattern: str = "*.nc", host_shard: bool = True
) -> list[str]:
    """Sorted file list; when `torch.distributed` is initialized with more
    than one process, each rank gets its own deterministic strided shard
    (files[rank::world_size]; identity for a single process), so every
    file-in/file-out stage scales across processes with no flag."""
    files = sorted(glob.glob(os.path.join(patch_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no {pattern} files in {patch_dir}")
    if host_shard:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
            files = files[rank::world]
            if not files:
                raise FileNotFoundError(
                    f"rank {rank}'s shard of {patch_dir} is empty"
                )
    return files
