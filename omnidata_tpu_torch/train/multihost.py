"""Multi-process scaffolding, the port's counterpart of the JAX package's
``train/multihost.py``: one process per device, launched as torch jobs are
(``torchrun --nproc_per_node N -m omnidata_tpu_torch.train_depth``).

- ``initialize()``: ``init_process_group`` from torchrun's environment
  (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK); NCCL for a
  CUDA device, gloo for the CPU
- ``stripe(items)``: host-side work lists (buildings to annotate, views to
  render) — disjoint, covering, order-stable
- ``local_batch_to_global(mesh, batch)``: the global view of each rank's
  shard of the batch (a DTensor split over 'data')
- ``barrier(tag)``: every process reaches this point

Everything is a no-op in a single process, so the same drivers run on one
device and on many.
"""
from __future__ import annotations

import os
from typing import Any, Sequence

import torch
import torch.distributed as dist

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def local_rank() -> int:
    """This process's index on its host (torchrun's LOCAL_RANK; 0 alone)."""
    return int(os.environ.get("LOCAL_RANK", "0")) if _initialized() else 0


def initialize(device: str | torch.device = "cuda") -> bool:
    """Start the process group from torchrun's variables; True if a group
    of more than one process runs (already, or now). A no-op returning
    False when the variables are absent or WORLD_SIZE is 1. The backend is
    NCCL for a CUDA device, gloo otherwise."""
    if _initialized():
        return dist.get_world_size() > 1
    if any(v not in os.environ for v in _TORCHRUN_VARS) or int(os.environ["WORLD_SIZE"]) == 1:
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def stripe(items: Sequence, process_index: int | None = None,
           process_count: int | None = None) -> list:
    """This process's slice items[rank::world_size]: disjoint and covering
    across processes, stable in the input order. Rank and world size come
    from torch.distributed when it is initialised, else 0 and 1."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} outside [0, {pc})")
    return list(items[pi::pc])


def local_batch_to_global(mesh, batch: Any) -> Any:
    """Each rank's shard of the batch (a dict of tensors, or one tensor)
    as one global DTensor split over 'data' and replicated over 'model'
    (``DTensor.from_local``); in one process, the batch itself. Collective:
    every rank calls it with equally shaped shards."""
    if world_size() == 1:
        return batch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from .parallel import batch_sharding

    tensors = batch.values() if isinstance(batch, dict) else [batch]
    layout = torch.arange(world_size()).reshape(mesh.n_data, mesh.n_model)
    dmesh = DeviceMesh(next(iter(tensors)).device.type, layout,
                       mesh_dim_names=("data", "model"))

    def to_global(x):
        return DTensor.from_local(x, dmesh, batch_sharding(mesh), run_check=False)

    if isinstance(batch, dict):
        return {k: to_global(v) for k, v in batch.items()}
    return to_global(batch)


def barrier(tag: str = "sync") -> None:
    """Block until every process reaches this point (pool-join
    equivalent). No-op in one process. tag names the point for the
    reader; torch's barrier takes none."""
    del tag
    if world_size() > 1:
        dist.barrier()


def process_local_batch_size(global_batch: int) -> int:
    """Each process's share of an evenly divided global batch."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n}")
    return global_batch // n
