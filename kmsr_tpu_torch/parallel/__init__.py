"""Parallelism: process meshes and the data-parallel step's collectives
(`mesh`), the multi-process input side (`multihost`), per-host batch data
parallelism over local cards (`local_dp`) and the whole scene in row slabs,
one per rank (`spatial`)."""
from .mesh import batch_sharding, make_mesh, replicated, shard_batch
from .multihost import (
    global_batch,
    host_batch_size,
    host_shard,
    initialize_if_needed,
)
