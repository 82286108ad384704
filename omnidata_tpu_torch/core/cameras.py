"""Camera models: intrinsics, extrinsics and ray generation.

Conventions (as in ``omnidata_tpu.core.cameras``):
- World/Blender: right-handed, Z up. A camera is (location, R) where R is
  the camera object's rotation; the camera looks down its local -Z, +Y up.
- CV camera frame: x right, y down, z forward, related to the Blender
  camera frame by ``R_bcam2cv = diag(1, -1, -1)``.
- Pixel (u, v): u right, v down, origin top-left, sampled at pixel centres.

Small 3-vector products are written out as sums so that CPU and GPU round
them alike (no TF32, no device-chosen summation order).
"""
from __future__ import annotations

import dataclasses

import torch

from .rotations import _mm, _norm

DEFAULT_RESOLUTION = 512

_BCAM2CV_SIGNS = (1.0, -1.0, -1.0)


@dataclasses.dataclass(frozen=True)
class Camera:
    """A batch of pinhole cameras.

    location: (...,3) world-space position.
    R:        (...,3,3) object rotation (world-from-camera, Blender frame).
    fov:      (...) horizontal field of view in radians.
    resolution: square image size in pixels.
    """

    location: torch.Tensor
    R: torch.Tensor
    fov: torch.Tensor
    resolution: int = DEFAULT_RESOLUTION


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(...,3,3) @ (...,3) with the sum written out."""
    return (M[..., :, 0] * v[..., 0:1] + M[..., :, 1] * v[..., 1:2]
            + M[..., :, 2] * v[..., 2:3])


def focal_px_from_fov(fov: torch.Tensor, resolution: int) -> torch.Tensor:
    """Focal length in pixels from horizontal FOV: f = (W/2) / tan(fov/2)."""
    return (resolution / 2.0) / torch.tan(fov / 2.0)


def intrinsic_matrix(fov: torch.Tensor, resolution: int) -> torch.Tensor:
    """K (...,3,3): f_px on both axes, principal point at the image centre."""
    f = focal_px_from_fov(fov, resolution)
    z = torch.zeros_like(f)
    o = torch.ones_like(f)
    c = torch.full_like(f, resolution / 2.0)
    return torch.stack(
        [torch.stack([f, z, c], -1), torch.stack([z, f, c], -1),
         torch.stack([z, z, o], -1)], -2)


def extrinsic_RT(location: torch.Tensor, R_obj: torch.Tensor) -> torch.Tensor:
    """World -> CV-camera 3x4 [R|t]: R = R_bcam2cv @ R_obj^T,
    t = -R @ location."""
    signs = torch.tensor(_BCAM2CV_SIGNS, dtype=R_obj.dtype,
                         device=R_obj.device)
    R_bcam2cv = torch.diag(signs).expand(R_obj.shape)
    R = _mm(R_bcam2cv, R_obj.transpose(-1, -2))
    t = -_matvec(R, location)
    return torch.cat([R, t[..., None]], -1)


def camera_rays(camera: Camera) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world-space rays: (origins (...,3), dirs (...,H,W,3) unit).

    Pixel centres, u right / v down, so projecting ``origin + t*dir`` lands
    back on pixel (u+0.5, v+0.5)."""
    res = camera.resolution
    fov = camera.fov
    f = focal_px_from_fov(fov, res)
    u = torch.arange(res, dtype=torch.float32, device=fov.device) + 0.5
    vv, uu = torch.meshgrid(u, u, indexing="ij")  # (H,W): uu along W
    c = res / 2.0
    x = (uu - c) / f[..., None, None]
    y = (vv - c) / f[..., None, None]
    # CV frame (x, y, 1) -> Blender camera frame (x, -y, -1) -> world
    d_bcam = torch.stack([x, -y, -torch.ones_like(x)], -1)  # (...,H,W,3)
    R = camera.R[..., None, None, :, :]
    d_world = _matvec(R, d_bcam)
    d_world = d_world / _norm(d_world)
    return camera.location, d_world


def look_at_rotation(location: torch.Tensor, target: torch.Tensor,
                     up: torch.Tensor | None = None) -> torch.Tensor:
    """Rotation of a camera at ``location`` fixated on ``target``
    (Blender TRACK_TO, track -Z, up Y): R @ [0,0,-1] == normalize(target -
    location)."""
    if up is None:
        up = torch.tensor([0.0, 0.0, 1.0], dtype=location.dtype,
                          device=location.device)
    fwd = target - location
    fwd = fwd / _norm(fwd)
    zaxis = -fwd
    xaxis = torch.linalg.cross(up.expand(zaxis.shape), zaxis)
    xn = _norm(xaxis)
    # looking straight up/down: fall back to world X
    world_x = torch.tensor([1.0, 0.0, 0.0], dtype=location.dtype,
                           device=location.device)
    xaxis = torch.where(xn < 1e-8, world_x,
                        xaxis / torch.where(xn < 1e-8, 1.0, xn))
    yaxis = torch.linalg.cross(zaxis, xaxis)
    yaxis = yaxis / _norm(yaxis)
    return torch.stack([xaxis, yaxis, zaxis], -1)  # columns are camera axes
