"""Validity masks (reference: omnidata_tools/torch/data/masks.py:11-58 and
train_*.py make_valid_mask:205-242), the port's counterpart of the JAX
package's ``data/masks.py``: mask from a sentinel value, then the
*invalid* region is dilated by max-pooling so the loss ignores a safety
band around holes. NCHW tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _dilate_same(invalid: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 k x k max window with "SAME" padding (the odd pixel after),
    as ``lax.reduce_window(..., "SAME")``; padding never wins (-inf)."""
    lo = (k - 1) // 2
    x = F.pad(invalid, (lo, k - 1 - lo, lo, k - 1 - lo), value=float("-inf"))
    return F.max_pool2d(x, k, 1)


def build_mask(target: torch.Tensor, val: float = 0.0, max_pool_size: int = 4,
               tol: float = 1e-3) -> torch.Tensor:
    """NCHW target -> boolean mask (N,1,H,W); pixels within ``tol`` of
    ``val`` on EVERY channel are invalid, with the invalid region dilated
    by a max_pool_size window (reference masks.py:14: val±1e-3)."""
    near = (target >= val - tol) & (target <= val + tol)
    invalid = near.all(1, keepdim=True).float()
    return _dilate_same(invalid, max_pool_size) < 0.5


def dilate_invalid(mask_valid: torch.Tensor, max_pool_size: int = 8) -> torch.Tensor:
    """Dilate the invalid region of a boolean NCHW mask with a stride-1 max
    window (generic safety band; the training mask is make_valid_mask)."""
    return _dilate_same((~mask_valid).float(), max_pool_size) < 0.5


def make_valid_mask(mask_valid: torch.Tensor, max_pool_size: int = 4) -> torch.Tensor:
    """The reference's training-time valid mask (train_*.py
    make_valid_mask:215-242): any max_pool_size² tile (kernel == stride)
    holding an invalid pixel is wholly invalid. Reshape-max, then repeat
    back to full size."""
    B, C, H, W = mask_valid.shape
    mp = max_pool_size
    if H % mp or W % mp:
        raise ValueError(f"mask {H}x{W} is not a multiple of {mp}")
    inv = ~mask_valid.bool()
    blocked = inv.reshape(B, C, H // mp, mp, W // mp, mp).any(5).any(3)
    return ~blocked.repeat_interleave(mp, 2).repeat_interleave(mp, 3)
