"""Masked pixel losses (reference: omnidata_tools/torch/losses/masked_losses.py:4-30),
the port's counterpart of the JAX package's ``losses/masked.py``.

All functions take NCHW tensors and a boolean mask broadcastable to the
input; invalid pixels contribute exactly zero to both value and gradient.

``group``: the data group of a sharded step (``train/parallel``; ``utils/collectives``), None in
one process. With a group each rank holds some rows of the global batch
and returns its share of the global loss, its local sum over the
all-reduced count; the shares summed over the group are the one-process
loss, and so are their gradients.
"""
from __future__ import annotations

import torch

from ..utils.collectives import all_sum


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: minimum(maximum(x, lo), hi). Its gradient at exactly
    lo or hi is 0.5, as JAX's is (``torch.clamp`` gives 1 there)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _masked_mean(err: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    denom = all_sum(mask.sum(), group)
    return (err.sum() / torch.maximum(denom, denom.new_tensor(1.0))
            * (denom > 0).to(err.dtype))


def masked_l1_loss(preds: torch.Tensor, target: torch.Tensor,
                   mask_valid: torch.Tensor, group=None) -> torch.Tensor:
    """sum(|pred - target| over valid) / count(valid); the count is taken
    over the mask broadcast to the input, so a (B,1,H,W) mask on (B,3,H,W)
    preds gives the true masked mean."""
    mask = torch.broadcast_to(mask_valid, preds.shape).to(preds.dtype)
    return _masked_mean(torch.abs(preds - target) * mask, mask, group)


def masked_mse_loss(preds: torch.Tensor, target: torch.Tensor,
                    mask_valid: torch.Tensor, group=None) -> torch.Tensor:
    mask = torch.broadcast_to(mask_valid, preds.shape).to(preds.dtype)
    return _masked_mean(torch.square(preds - target) * mask, mask, group)


def masked_cosine_angular_loss(preds: torch.Tensor, target: torch.Tensor,
                               mask_valid: torch.Tensor, group=None) -> torch.Tensor:
    """mean(-cos(pred, target)) over valid pixels. Normals encoded in [0, 1]
    (NCHW, C=3) are mapped to [-1, 1], L2-normalized per pixel and compared
    by negative cosine; the mask's first channel selects valid pixels."""
    p = clip(2.0 * preds - 1.0, -1.0, 1.0)
    t = clip(2.0 * target - 1.0, -1.0, 1.0)
    m = mask_valid[:, 0].to(preds.dtype)

    def normalize(x):
        n = torch.sqrt(torch.sum(x * x, 1, keepdim=True))
        return x / torch.maximum(n, n.new_tensor(1e-12))

    cos = torch.sum(normalize(p) * normalize(t), 1)
    return _masked_mean(-cos * m, m, group)
