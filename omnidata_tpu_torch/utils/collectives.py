"""The two collectives the sharded training step needs outside autograd,
over a ``torch.distributed`` group; a group of None is one process and
leaves the tensor as it is. Gloo carries both on CPU and CUDA tensors, NCCL
on the card."""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over group (a new tensor; x itself when group is None).
    Not differentiable: for counts and detached values."""
    if group is None:
        return x
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, group=group)
    return y


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equally shaped x concatenated along dim 0 in group-rank
    order. Not differentiable."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts)
