"""Fragment shading: mesh attributes gathered or interpolated at the face
each pixel hit (smooth and flat normals, vertex and face colours, texture,
face labels). Works on Fragments of any leading shape: a pinhole view
(H,W), a batch (K,H,W) or a panorama."""
from __future__ import annotations

import torch

from ..core.cameras import Camera, _matvec, camera_rays
from .mesh import TriangleMesh
from .raster import Fragments


def _face_index(frag: Fragments) -> torch.Tensor:
    return torch.clamp(frag.face, min=0).long()


def interpolate_vertex_attribute(frag: Fragments, mesh: TriangleMesh,
                                 attr: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of a per-vertex attribute (V,C) ->
    (...,C): w0 = 1 - u - v on the face's first vertex, u and v on the
    others."""
    a = attr[mesh.faces[_face_index(frag)].long()]  # (...,3,C)
    u, v = frag.bary[..., 0:1], frag.bary[..., 1:2]
    return a[..., 0, :] * (1.0 - u - v) + a[..., 1, :] * u + a[..., 2, :] * v


def smooth_normals_world(frag: Fragments, mesh: TriangleMesh) -> torch.Tensor:
    """Unit world-space normals interpolated from the vertex normals."""
    n = interpolate_vertex_attribute(frag, mesh, mesh.vertex_normals)
    norm = torch.sqrt(n[..., 0:1] * n[..., 0:1] + n[..., 1:2] * n[..., 1:2]
                      + n[..., 2:3] * n[..., 2:3])
    return n / torch.clamp(norm, min=1e-12)


def flat_normals_world(frag: Fragments, mesh: TriangleMesh) -> torch.Tensor:
    return mesh.face_normals[_face_index(frag)]


def normals_to_camera(n_world: torch.Tensor, camera: Camera) -> torch.Tensor:
    """World -> Blender camera frame (x right, y up, z toward the viewer),
    n_cam = R^T n, for one camera (R (3,3))."""
    return _matvec(camera.R.transpose(-1, -2), n_world)


def face_labels(frag: Fragments, mesh: TriangleMesh,
                background: int = 0) -> torch.Tensor:
    """Label image from per-face labels, int32; background where no hit."""
    lab = mesh.face_labels[_face_index(frag)]
    return torch.where(frag.valid, lab, background)


def face_flat_colors(frag: Fragments, mesh: TriangleMesh,
                     background: float = 0.0) -> torch.Tensor:
    """Per-face material colours (...,3) in [0,1]."""
    col = mesh.face_colors[_face_index(frag)]
    return torch.where(frag.valid[..., None], col, background)


def vertex_colors(frag: Fragments, mesh: TriangleMesh,
                  background: float = 0.0) -> torch.Tensor:
    """Interpolated vertex colours (...,3)."""
    c = interpolate_vertex_attribute(frag, mesh, mesh.vertex_colors)
    return torch.where(frag.valid[..., None], c, background)


def hit_points_world(frag: Fragments, camera: Camera) -> torch.Tensor:
    """World-space hit positions origin + t * dir (H,W,3)."""
    origin, dirs = camera_rays(camera)
    return origin + frag.t[..., None] * dirs


def sample_texture(uv: torch.Tensor, tex: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of tex (th,tw,3) at uvs (...,2) in [0,1], v up (OBJ
    convention)."""
    th, tw = tex.shape[0], tex.shape[1]
    x = torch.clamp(uv[..., 0], 0.0, 1.0) * (tw - 1)
    y = (1.0 - torch.clamp(uv[..., 1], 0.0, 1.0)) * (th - 1)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=tw - 1)
    y1 = torch.clamp(y0 + 1, max=th - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    return (tex[y0, x0] * (1 - wx) * (1 - wy) + tex[y0, x1] * wx * (1 - wy)
            + tex[y1, x0] * (1 - wx) * wy + tex[y1, x1] * wx * wy)


def textured_colors(frag: Fragments, mesh: TriangleMesh,
                    background: float = 0.0) -> torch.Tensor:
    """RGB from the texture atlas at the interpolated uvs (needs
    vertex_uvs and texture)."""
    uv = interpolate_vertex_attribute(frag, mesh, mesh.vertex_uvs)
    c = sample_texture(uv, mesh.texture)
    return torch.where(frag.valid[..., None], c, background)
