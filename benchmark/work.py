"""The work a batch of views needs, whoever computes it: the yardstick of
``raster_roofline`` and ``annotate_mfu``.

Computed from the benchmark's own scene arrays and cameras in plain torch
(the reference's screen boxes), never from the program's admission:

- pairs: the (pixel, face) pairs whose face's screen box overlaps the
  pixel's tile (box and tile edges inclusive, no slack), the only pairs in
  which a winner can be found;
- operations: FLOPS_PER_PAIR FP32 operations a pair (the intersection test
  with its determinant, two barycentric coordinates and t);
- bytes: each vertex (3 float32) and face (3 int32) read once and each
  pixel's winner (one int32) written once.

The least time of a batch is the larger of operations at FP32_PEAK and
bytes at HBM_BYTES_PER_S (one NVIDIA H100 SXM at 700 W).
"""
from __future__ import annotations

import torch

from .reference.render import screen_boxes

FLOPS_PER_PAIR = 20
FP32_PEAK = 67e12  # FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def view_pairs(V, Fc, loc, R, fov, res: int, tile: int) -> int:
    """Pixel-face pairs of one view."""
    lo, hi, live = screen_boxes(V[Fc], loc, R, fov, res)
    n1d = res // tile
    edges = torch.arange(n1d, dtype=torch.float32, device=V.device) * tile
    # tiles [e, e + tile] each box meets, per axis
    nx = ((hi[:, 0:1] >= edges) & (lo[:, 0:1] <= edges + tile)).sum(1)
    ny = ((hi[:, 1:2] >= edges) & (lo[:, 1:2] <= edges + tile)).sum(1)
    return int(torch.where(live, nx * ny, 0).sum()) * tile * tile


def batch_work(V, Fc, cams, idx, res: int, tile: int) -> dict:
    """pairs, ops, bytes and the least seconds of the views ``idx`` of the
    camera arrays ``cams`` (locations, rotations, fovs on V's device)."""
    locs, Rs, fovs = cams
    pairs = sum(view_pairs(V, Fc, locs[i], Rs[i], fovs[i], res, tile) for i in idx)
    ops = pairs * FLOPS_PER_PAIR
    n_bytes = V.shape[0] * 12 + Fc.shape[0] * 12 + len(idx) * res * res * 4
    return {"pairs": pairs, "ops": ops, "bytes": n_bytes,
            "least_s": max(ops / FP32_PEAK, n_bytes / HBM_BYTES_PER_S)}
