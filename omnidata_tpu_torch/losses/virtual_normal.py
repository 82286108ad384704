"""Virtual Normal Loss (reference: omnidata_tools/torch/losses/virtual_normal_loss.py:7-205),
the port's counterpart of the JAX package's ``losses/virtual_normal.py``.

Unprojects depth maps to point clouds, samples random pixel triplets, filters
degenerate triangles (near-collinear, tiny depth, all-coordinates-near pairs),
and penalizes the L1 difference between the unit normals of the gt and
predicted virtual planes, with the easiest 25% of triplets dropped.

Everything is fixed-shape: triplet filtering gives a boolean validity mask,
and the 25% hard-example selection is a masked rank threshold over the
losses sorted stably (as ``jnp.sort``), so that the gradient reaches the
same triplets as JAX's. Sampling takes an explicit ``torch.Generator``;
``vnl_from_indices`` takes the triplets themselves.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class VNLParams(NamedTuple):
    focal_x: float
    focal_y: float
    input_size: tuple  # (H, W)
    delta_cos: float = 0.867
    delta_diff_x: float = 0.005
    delta_diff_y: float = 0.005
    delta_diff_z: float = 0.005
    delta_z: float = 0.0001
    sample_ratio: float = 0.15


def transfer_xyz(depth: torch.Tensor, params: VNLParams) -> torch.Tensor:
    """Depth (B,1,H,W) -> camera-space points (B,H,W,3) with pixel-index
    intrinsics (u0 = W//2, v0 = H//2; virtual_normal_loss.py:29-50)."""
    H, W = params.input_size
    u = torch.arange(W, dtype=depth.dtype, device=depth.device) - (W // 2)
    v = torch.arange(H, dtype=depth.dtype, device=depth.device) - (H // 2)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = depth[:, 0]
    x = uu * torch.abs(d) / params.focal_x
    y = vv * torch.abs(d) / params.focal_y
    return torch.stack([x, y, d], -1)


def sample_triplets(generator: torch.Generator, params: VNLParams,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """Three flat pixel-index sets, shape (3, N) with N = ratio * H * W,
    drawn with replacement from ``generator`` (which lives on ``device``)."""
    H, W = params.input_size
    num = H * W
    n = int(num * params.sample_ratio)
    return torch.randint(0, num, (3, n), generator=generator, device=device)


def _form_groups(pw: torch.Tensor, p123: torch.Tensor) -> torch.Tensor:
    """pw (B,H,W,3), indices (3,N) -> groups (B,N,3(xyz),3(points))."""
    B, H, W, _ = pw.shape
    g = pw.reshape(B, H * W, 3)[:, p123, :]  # (B,3,N,3)
    return g.permute(0, 2, 3, 1)


def _valid_mask(pw: torch.Tensor, params: VNLParams) -> torch.Tensor:
    """Boolean (B,N) triplet validity (virtual_normal_loss.py:101-133)."""
    pw12 = pw[..., 1] - pw[..., 0]
    pw13 = pw[..., 2] - pw[..., 0]
    pw23 = pw[..., 2] - pw[..., 1]
    pw_diff = torch.stack([pw12, pw13, pw23], -1)  # (B,N,3(xyz),3(pairs))

    # pairwise cosine similarity of the three edge vectors
    q = pw_diff.transpose(-1, -2)  # (B,N,pairs,xyz)
    norms = torch.sqrt(torch.sum(q * q, -1))  # (B,N,3)
    nm = norms[..., :, None] * norms[..., None, :]
    energy = q @ q.transpose(-1, -2)
    norm_energy = energy / (nm + 1e-8)
    flat_e = norm_energy.reshape(norm_energy.shape[:-2] + (9,))
    mask_cos = ((flat_e > params.delta_cos) | (flat_e < -params.delta_cos)).sum(-1) > 3

    mask_pad = (pw[..., 2, :] > params.delta_z).sum(-1) == 3

    def near(i, d):
        return (torch.abs(pw_diff[..., i, :]) < d).sum(-1) > 0

    mask_near_all = (near(0, params.delta_diff_x) & near(1, params.delta_diff_y)
                     & near(2, params.delta_diff_z))
    return mask_pad & ~(mask_near_all | mask_cos)


def _unit_normals(groups: torch.Tensor) -> torch.Tensor:
    """Triangle normals for groups (B,N,xyz,points); a zero normal is
    divided by 0.01 (the reference's +0.01 trick, virtual_normal_loss.py:
    176-189), and sqrt never sees the zero, whose gradient is NaN."""
    p12 = groups[..., 1] - groups[..., 0]
    p13 = groups[..., 2] - groups[..., 0]
    n = torch.linalg.cross(p12, p13, dim=-1)
    s = torch.sum(n * n, -1, keepdim=True)
    zero = s == 0.0
    norm = torch.sqrt(torch.where(zero, s.new_tensor(1.0), s))
    norm = torch.where(zero, s.new_tensor(0.01), norm)
    return n / norm


def vnl_from_indices(gt_depth: torch.Tensor, pred_depth: torch.Tensor,
                     p123: torch.Tensor, params: VNLParams,
                     select: bool = True) -> torch.Tensor:
    """VNL given explicit triplet indices (3,N). Fixed-shape equivalent of
    VNL_Loss.forward (virtual_normal_loss.py:154-200)."""
    g_gt = _form_groups(transfer_xyz(gt_depth, params), p123)
    g_pred = _form_groups(transfer_xyz(pred_depth, params), p123)
    valid = _valid_mask(g_gt, params)  # (B,N)

    # z==0 guard on predictions (intent of virtual_normal_loss.py:146)
    z = g_pred[..., 2, :]
    z = torch.where(z == 0.0, z.new_tensor(1e-4), z)
    g_pred = torch.cat([g_pred[..., :2, :], z[..., None, :]], -2)

    loss_per_group = torch.abs(_unit_normals(g_gt) - _unit_normals(g_pred)).sum(-1)

    lf = loss_per_group.reshape(-1)
    vf = valid.reshape(-1)
    n_valid = vf.sum()
    if not select:
        return (lf * vf).sum() / torch.clamp(n_valid, min=1)

    # hard-example mining: drop the smallest 25% of valid losses, average rest
    big = torch.finfo(lf.dtype).max
    ls, _ = torch.sort(torch.where(vf, lf, lf.new_tensor(big)), stable=True)
    start = (n_valid.to(torch.float32) * 0.25).to(torch.int64)
    idx = torch.arange(lf.shape[0], device=lf.device)
    keep = (idx >= start) & (idx < n_valid)
    cnt = keep.sum()
    return torch.where(keep, ls, ls.new_tensor(0.0)).sum() / torch.clamp(cnt, min=1)


def virtual_normal_loss(gt_depth: torch.Tensor, pred_depth: torch.Tensor,
                        generator: torch.Generator, params: VNLParams,
                        select: bool = True) -> torch.Tensor:
    """Full VNL: sample triplets from ``generator`` then score. Shapes
    (B,1,H,W)."""
    p123 = sample_triplets(generator, params, gt_depth.device)
    return vnl_from_indices(gt_depth, pred_depth, p123, params, select=select)
