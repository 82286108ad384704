"""Rotation helpers in the reference's (Blender) conventions: right-handed
axes, a camera looks down its local ``-Z`` with ``+Y`` up. All functions
are batched over leading dimensions.
"""
from __future__ import annotations

import torch


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Norm of (...,3) vectors, keepdim: sqrt(x0² + x1² + x2²) summed left
    to right, so every device rounds alike."""
    return torch.sqrt(x[..., 0:1] * x[..., 0:1] + x[..., 1:2] * x[..., 1:2]
                      + x[..., 2:3] * x[..., 2:3])


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(...,3,3) @ (...,3,3) as explicit float32 sums: no TF32 and the same
    summation order on every device."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _rot(a: torch.Tensor, rows) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    env = {"c": c, "s": s, "-s": -s, "o": o, "z": z}
    return torch.stack(
        [torch.stack([env[k] for k in row], -1) for row in rows], -2)


def rot_x(a: torch.Tensor) -> torch.Tensor:
    """Rotation about +X by angle ``a`` (radians). Batched over a's shape."""
    return _rot(a, (("o", "z", "z"), ("z", "c", "-s"), ("z", "s", "c")))


def rot_y(a: torch.Tensor) -> torch.Tensor:
    return _rot(a, (("c", "z", "s"), ("z", "o", "z"), ("-s", "z", "c")))


def rot_z(a: torch.Tensor) -> torch.Tensor:
    return _rot(a, (("c", "-s", "z"), ("s", "c", "z"), ("z", "z", "o")))
