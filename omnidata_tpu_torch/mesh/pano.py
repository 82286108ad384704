"""Equirectangular panoramas: rays on the spherical grid, cast against the
mesh in blocks with the brute-force raycaster (panoramas are rare beside
pinhole views, so no tile admission over the sphere).

Convention: longitude sweeps left to right over [-pi, pi) with the camera's
-Z forward at longitude 0; latitude sweeps from +pi/2 (top row) to -pi/2
(bottom row).
"""
from __future__ import annotations

import math

import torch

from ..core.cameras import Camera, _matvec
from .mesh import TriangleMesh
from .raster import _BIG, Fragments
from .raycast import raycast


def pano_rays(location: torch.Tensor, R: torch.Tensor, width: int = 2048,
              height: int = 1024):
    """-> (origin (3,), unit dirs (H,W,3)) of an equirectangular camera."""
    dev = location.device
    u = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    v = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
    lam = u * 2.0 * math.pi - math.pi  # (W,)
    phi = math.pi / 2.0 - v * math.pi  # (H,)
    pp, ll = torch.meshgrid(phi, lam, indexing="ij")  # (H,W)
    d_cam = torch.stack([torch.sin(ll) * torch.cos(pp), torch.sin(pp),
                         -torch.cos(ll) * torch.cos(pp)], -1)
    return location, _matvec(R, d_cam)


def render_pano(location: torch.Tensor, R: torch.Tensor, mesh: TriangleMesh,
                width: int = 2048, height: int = 1024,
                block: int = 65536) -> Fragments:
    """Panoramic Fragments (H,W); z == t (there is no planar z-buffer on a
    sphere). Rays are cast ``block`` at a time."""
    origin, dirs = pano_rays(location, R, width, height)
    flat = dirs.reshape(-1, 3)
    hits = [raycast(origin[None], flat[s:s + block], mesh)
            for s in range(0, flat.shape[0], block)]
    t = torch.cat([h.t for h in hits]).reshape(height, width)
    f = torch.cat([h.face for h in hits]).reshape(height, width)
    uv = torch.cat([h.bary for h in hits]).reshape(height, width, 2)
    valid = f >= 0
    t = torch.where(valid, t, _BIG)
    return Fragments(t=t, z=t, face=f, bary=uv, valid=valid)


def pano_camera(location: torch.Tensor, R: torch.Tensor | None = None) -> Camera:
    """A Camera holding a panorama's pose, for the shading helpers
    (normals_to_camera etc.); fov and resolution are placeholders."""
    if R is None:
        R = torch.eye(3, device=location.device)
    return Camera(location, R, torch.ones((), device=location.device), 0)
