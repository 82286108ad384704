"""Work striping across processes: each process of a ``torch.distributed``
group takes its round-robin slice of a host-side work list (buildings to
annotate, views to render). A run without an initialised process group is
one process that takes everything."""
from __future__ import annotations

from typing import Sequence


def stripe(items: Sequence, process_index: int | None = None,
           process_count: int | None = None) -> list:
    """This process's slice items[rank::world_size]: disjoint and covering
    across processes, stable in the input order. Rank and world size come
    from torch.distributed when it is initialised, else 0 and 1."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if initialized else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if initialized else 1)
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} outside [0, {pc})")
    return list(items[pi::pc])
