"""The (data, model) grid of ranks and the Megatron splits of DPT's ViT, the
port's counterpart of the JAX package's ``train/parallel.py``.

JAX lays the parameters on a device mesh and XLA inserts the collectives.
Here every rank is one process on one device, holds plain local tensors and
runs the collectives itself:

- the batch is split over the ``data`` axis; each rank computes its share
  of the global loss (local numerators over all-reduced denominators, the
  ``group`` argument of ``losses``), and the gradients are *summed* over
  the data group (``TrainState.apply_gradients``), which is JAX's psum of
  the gradient of the global loss;
- the ViT's big matmuls are split over the ``model`` axis, Megatron-style:
  qkv and mlp.fc1 by output rows (column-parallel), attn.proj and mlp.fc2
  by input columns (row-parallel), carried by two autograd functions, f
  (identity forward, all-reduce backward) before the column split and g
  (all-reduce forward, identity backward) after the row split. Everything
  else is replicated, the biases of proj and fc2 included; they are added
  once, after g.

Only ``all_reduce``, ``all_gather``, ``broadcast`` and ``barrier`` are
used: gloo carries them on CPU and CUDA tensors, NCCL on the card.

One divergence from JAX by design: JAX leaves devices past n_data·n_model
idle, while here n_data·n_model must equal the world size (one process per
device), else ``make_mesh`` raises.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.layers import Attention, EncoderBlock, Mlp


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, model) grid: global rank = data_index·n_model +
    model_index, as JAX's ``devices.reshape(n_data, n_model)`` orders
    devices. A group of one rank is None, so code with a mesh of one rank
    runs exactly as without one."""

    n_data: int
    n_model: int
    rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The grid over the initialised process group (one process, world 1,
    without one). n_data None takes the remaining ranks. Collective: every
    rank calls it with the same arguments."""
    world, rank = (dist.get_world_size(), dist.get_rank()) if _initialized() else (1, 0)
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(
            f"data_parallel {n_data} x model_parallel {n_model} = {n_data * n_model} "
            f"ranks, but the process group has world size {world}: one process "
            "runs each device, so the grid must cover the group exactly")
    data_group = model_group = None
    # dist.new_group is collective: every rank creates every group, in order
    if n_data > 1:
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if rank % n_model == m:
                data_group = g
    if n_model > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if rank // n_model == d:
                model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group)


# ---------------- Megatron's f and g ----------------

class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


# ---------------- the tensor-parallel rules ----------------

# JAX's _TP_RULES with the layout flipped: a Flax kernel is (in, out), a
# torch weight (out, in). -> the dimension split over 'model'.
_TP_RULES = [
    (re.compile(r".*attn\.qkv\.(weight|bias)$"), 0),
    (re.compile(r".*mlp\.fc1\.(weight|bias)$"), 0),
    (re.compile(r".*attn\.proj\.weight$"), 1),
    (re.compile(r".*mlp\.fc2\.weight$"), 1),
]


def split_dim(name: str) -> int | None:
    """The dimension of tensor `name` split over 'model', None when it is
    replicated."""
    for rx, dim in _TP_RULES:
        if rx.match(name):
            return dim
    return None


def _shard_index(name: str, size: int, n_model: int, index: int) -> torch.Tensor:
    """Positions along the split dimension held by model rank `index`. The
    fused qkv rows [q; k; v] are taken head-contiguously from each third,
    so a shard is [q_r; k_r; v_r] of its heads (JAX splits the 3·dim rows
    evenly instead; both steps are the unsharded step)."""
    if name.endswith("attn.qkv.weight") or name.endswith("attn.qkv.bias"):
        third = size // 3
        w = third // n_model
        return torch.cat([torch.arange(p * third + index * w, p * third + (index + 1) * w)
                          for p in range(3)])
    w = size // n_model
    return torch.arange(index * w, (index + 1) * w)


def shard_tensor(name: str, full: torch.Tensor, n_model: int, index: int) -> torch.Tensor:
    """Model rank `index`'s shard of the unsharded tensor `name`."""
    dim = split_dim(name)
    if dim is None or n_model == 1:
        return full
    idx = _shard_index(name, full.shape[dim], n_model, index).to(full.device)
    return full.index_select(dim, idx).contiguous()


def gather_tensor(name: str, local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The unsharded tensor `name` from every model rank's shard (collective
    over the model group); a replicated tensor as it is."""
    dim = split_dim(name)
    if dim is None or mesh.model_group is None:
        return local.detach()
    parts = [torch.empty_like(local) for _ in range(mesh.n_model)]
    dist.all_gather(parts, local.detach().contiguous(), group=mesh.model_group)
    shape = list(local.shape)
    shape[dim] *= mesh.n_model
    full = local.new_empty(shape)
    for index, part in enumerate(parts):
        full.index_copy_(dim, _shard_index(name, shape[dim], mesh.n_model, index)
                         .to(local.device), part)
    return full


def param_sharding(net: nn.Module, mesh: Mesh, tensor_parallel: bool = True) -> dict:
    """name -> DTensor placements over (data, model) of each parameter: the
    TP rules where they match and the model axis is wider than one, else
    replicated."""
    from torch.distributed.tensor import Replicate, Shard

    out = {}
    for name, _ in net.named_parameters():
        dim = split_dim(name) if tensor_parallel and mesh.n_model > 1 else None
        out[name] = (Replicate(), Replicate() if dim is None else Shard(dim))
    return out


def batch_sharding(mesh: Mesh | None = None) -> tuple:
    """The batch's placements on any grid: its leading dimension split
    over 'data', replicated over 'model' (mesh is JAX's argument)."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh: Mesh | None = None) -> tuple:
    """The placements of a tensor every rank holds whole, on any grid."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


# ---------------- the sharded ViT ----------------

class ParallelAttention(nn.Module):
    """``layers.Attention`` over the model group: qkv column-split by heads
    (each rank holds [q; k; v] of heads / n_model heads), proj row-split,
    its bias added after the all-reduce."""

    def __init__(self, attn: Attention, mesh: Mesh, prefix: str = "attn"):
        super().__init__()
        n, r = mesh.n_model, mesh.model_index
        if attn.num_heads % n:
            raise ValueError(f"{attn.num_heads} heads do not split over "
                             f"model_parallel {n}")
        dim = attn.proj.weight.shape[0]
        self.group = mesh.model_group
        self.head_dim = dim // attn.num_heads
        self.num_heads = attn.num_heads // n
        local = self.num_heads * self.head_dim
        kw = dict(device=attn.qkv.weight.device, dtype=attn.qkv.weight.dtype)
        self.qkv = nn.Linear(dim, 3 * local, **kw)
        self.proj = nn.Linear(local, dim, **kw)
        with torch.no_grad():
            for sub, mod in (("qkv", attn.qkv), ("proj", attn.proj)):
                for leaf in ("weight", "bias"):
                    key = f"{prefix}.{sub}.{leaf}"
                    getattr(getattr(self, sub), leaf).copy_(
                        shard_tensor(key, getattr(mod, leaf), n, r))

    def forward(self, x):
        B, N, _ = x.shape
        x = _CopyToModel.apply(x, self.group)
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(self.head_dim)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        y = (attn @ v).transpose(1, 2).reshape(B, N, self.num_heads * self.head_dim)
        return _ReduceFromModel.apply(F.linear(y, self.proj.weight), self.group) + self.proj.bias


class ParallelMlp(nn.Module):
    """``layers.Mlp`` over the model group: fc1 column-split, fc2
    row-split, fc2's bias added after the all-reduce."""

    def __init__(self, mlp: Mlp, mesh: Mesh, prefix: str = "mlp"):
        super().__init__()
        n, r = mesh.n_model, mesh.model_index
        hidden, dim = mlp.fc1.weight.shape
        if hidden % n:
            raise ValueError(f"mlp width {hidden} does not split over model_parallel {n}")
        self.group = mesh.model_group
        kw = dict(device=mlp.fc1.weight.device, dtype=mlp.fc1.weight.dtype)
        self.fc1 = nn.Linear(dim, hidden // n, **kw)
        self.fc2 = nn.Linear(hidden // n, dim, **kw)
        with torch.no_grad():
            for sub, mod in (("fc1", mlp.fc1), ("fc2", mlp.fc2)):
                for leaf in ("weight", "bias"):
                    key = f"{prefix}.{sub}.{leaf}"
                    getattr(getattr(self, sub), leaf).copy_(
                        shard_tensor(key, getattr(mod, leaf), n, r))

    def forward(self, x):
        x = _CopyToModel.apply(x, self.group)
        h = F.gelu(self.fc1(x))
        return _ReduceFromModel.apply(F.linear(h, self.fc2.weight), self.group) + self.fc2.bias


def shard_module(net: nn.Module, mesh: Mesh) -> nn.Module:
    """Swap, in place, every EncoderBlock's attn and mlp for their
    model-parallel versions holding this rank's shards (parameter names
    unchanged). A model axis of one, or a net without EncoderBlocks (the
    UNet: replicated, its model ranks repeat the work, as JAX's do), is
    left as it is. -> net."""
    if mesh.n_model == 1:
        return net
    for block in net.modules():
        if isinstance(block, EncoderBlock):
            block.attn = ParallelAttention(block.attn, mesh)
            block.mlp = ParallelMlp(block.mlp, mesh)
    return net


def gather_state_dict(net: nn.Module, mesh: Mesh) -> dict:
    """The unsharded published-schema state dict of a sharded net
    (collective over the model group)."""
    return {k: gather_tensor(k, v, mesh) for k, v in net.state_dict().items()}


def broadcast_module(net: nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of net from global rank src (a no-op
    without a process group): the ranks start from the same weights."""
    if not _initialized() or dist.get_world_size() == 1:
        return
    with torch.no_grad():
        for t in net.state_dict().values():
            dist.broadcast(t, src)
