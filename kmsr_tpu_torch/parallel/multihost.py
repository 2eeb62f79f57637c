"""Multi-process input side: per-rank file shards, global batch assembly
and the process group's start.

Counterpart of `kmsr_tpu.parallel.multihost`. JAX's hosts become
`torch.distributed` ranks, one process per card (`torchrun`): a file-in /
file-out stage gives each rank its own strided shard of the sorted file
list, and `global_batch` assembles every rank's rows into one batch.

A single process (no group, no launcher environment) is rank 0 of 1, so
every stage and trainer can call these helpers unconditionally.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")

#: how long a collective may wait for its peers before the process group
#: raises, unless the caller gives another
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def host_shard(
    items: Sequence[T],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> list[T]:
    """Deterministic strided shard of a (sorted) work list for this rank.

    Strided (round-robin) rather than contiguous, so a size- or
    date-ordered listing load-balances across ranks. Every rank must pass
    the same `items` order (`data.sampler.list_patch_files` sorts)."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} outside process_count {pc}")
    return list(items[pi::pc])


def host_batch_size(global_batch_size: int, process_count: Optional[int] = None) -> int:
    """The per-rank slice of a global batch; validates divisibility."""
    pc = world_size() if process_count is None else process_count
    if global_batch_size % pc:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {pc} hosts"
        )
    return global_batch_size // pc


def global_batch(mesh, local_batch, dim: int = 0) -> torch.Tensor:
    """Every rank's rows [B_local, ...] assembled in rank order into the
    global batch [B_local * world, ...] on this rank's device (an
    all-gather; the identity for a mesh without a group). `dim` names the
    axis the ranks split (a scene's rows: 1)."""
    t = torch.as_tensor(local_batch).to(mesh.device).contiguous()
    if mesh.group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=dim)


def _launched() -> bool:
    """A launcher (torchrun) set this process's rank and world size."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize_if_needed(
    device: str | torch.device = "cuda",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Start the default process group from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) when this process
    was launched as one of several; returns True if it did.

    A no-op for a plain single process and when a group already exists.
    The backend is NCCL for a card and gloo for the CPU; a card run never
    falls back to gloo. Each rank takes the card of its LOCAL_RANK, and a
    launch of more ranks on a host than it has cards raises.
    """
    if is_initialized() or not _launched():
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        local_card(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, timeout=timeout)
    return True


def local_card(local_rank: int) -> torch.device:
    """cuda:<local_rank>, made the current device; raises when the host has
    no such card (two ranks never share one)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"local rank {local_rank} asked for a card, but CUDA is not "
            f"available; pass --device cpu to train on the host (gloo)")
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own: this host has "
            f"{n} visible card(s); launch at most {n} processes per host "
            "(two ranks never share a card)")
    dev = torch.device("cuda", local_rank)
    torch.cuda.set_device(dev)
    return dev
