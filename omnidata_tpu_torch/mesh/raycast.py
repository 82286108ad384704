"""Brute-force ray-triangle intersection (Möller–Trumbore) of rays against
every face: the closest hit, an occlusion test and a crossing count. The
annotator's samplers use it for line of sight, inside-mesh parity and
clearance, the panorama renderer for its rays, and the tests as the referee
of the raster kernels.

Rays meet the faces one chunk of faces at a time, with a running minimum,
``any`` or sum across chunks, so the (rays, chunk) temporaries stay bounded
whatever the mesh size. Products are summed left to right, component by
component, as the JAX package's ``mesh/raycast.py`` does, with the same
epsilons and tie rule: the first minimum within a chunk, and a strictly
closer hit across chunks, which together keep the lowest face index among
equal distances whatever the chunk size. Degenerate (padding) faces have a
zero determinant and never hit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .mesh import TriangleMesh, gathered_triangles

_EPS = 1e-7
_BIG = 1e30
_EDGE_SLACK = 1e-5  # a ray on a shared edge hits at least one of its faces
_CHUNK_ELEMS = 1 << 22  # rays x faces per chunk (each temporary)


class RayHits(NamedTuple):
    """t: ray length to the hit (BIG if none) · face: face index (-1 if
    none) · bary: (u, v) barycentrics of the hit · valid: hit mask."""

    t: torch.Tensor
    face: torch.Tensor
    bary: torch.Tensor
    valid: torch.Tensor


def _split(a: torch.Tensor, lead: bool):
    """(n,3) -> three (n,1) columns (lead) or (1,n) rows."""
    return tuple(a[:, i:i + 1] if lead else a[None, :, i] for i in range(3))


def _intersect_chunk(origins, dirs, v0, e1, e2):
    """Möller–Trumbore of rays (N,3) (origins may be one (1,3) row) against
    a face chunk (C,3) each -> t, u, v and the hit mask, (N,C) each. No
    backface culling."""
    dx, dy, dz = _split(dirs, True)
    ox, oy, oz = _split(origins, True)
    e1x, e1y, e1z = _split(e1, False)
    e2x, e2y, e2z = _split(e2, False)
    vx, vy, vz = _split(v0, False)
    px = dy * e2z - dz * e2y  # pvec = dir x e2
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    # near-parallel pairs get inv_det 0, hence t = 0, which fails t > EPS:
    # the hit test needs no separate |det| >= EPS term
    inv_det = torch.where(torch.abs(det) < _EPS, 0.0, 1.0 / det)
    tx, ty, tz = ox - vx, oy - vy, oz - vz  # tvec = origin - v0
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y  # qvec = tvec x e1
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ((u >= -_EDGE_SLACK) & (v >= -_EDGE_SLACK)
           & (u + v <= 1.0 + _EDGE_SLACK) & (t > _EPS))
    return t, u, v, hit


def _face_chunks(mesh: TriangleMesh, n_rays: int, chunk: int | None):
    """Yield (first face, v0, e1, e2) per chunk of faces; by default each
    chunk holds about _CHUNK_ELEMS / n_rays faces (at least 256)."""
    tris = gathered_triangles(mesh)
    F = tris.shape[0]
    chunk = chunk or max(256, _CHUNK_ELEMS // max(n_rays, 1))
    for c0 in range(0, F, chunk):
        tri = tris[c0:c0 + chunk]
        yield c0, tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]


def raycast(origins: torch.Tensor, dirs: torch.Tensor, mesh: TriangleMesh,
            chunk: int | None = None) -> RayHits:
    """Closest hit of rays (N,3) + (N,3) against the whole mesh; origins
    may be one (1,3) row shared by every ray."""
    N = dirs.shape[0]
    dev = dirs.device
    best_t = torch.full((N,), _BIG, device=dev)
    best_f = torch.full((N,), -1, dtype=torch.int32, device=dev)
    best_uv = torch.zeros((N, 2), device=dev)
    for c0, v0, e1, e2 in _face_chunks(mesh, N, chunk):
        t, u, v, hit = _intersect_chunk(origins, dirs, v0, e1, e2)
        t = torch.where(hit, t, _BIG)
        j = torch.argmin(t, -1, keepdim=True)  # first minimum
        tj = torch.gather(t, 1, j)[:, 0]
        closer = tj < best_t
        best_f = torch.where(closer, (j[:, 0] + c0).to(torch.int32), best_f)
        uv = torch.cat([torch.gather(u, 1, j), torch.gather(v, 1, j)], 1)
        best_uv = torch.where(closer[:, None], uv, best_uv)
        best_t = torch.minimum(best_t, tj)
    return RayHits(t=best_t, face=best_f, bary=best_uv, valid=best_f >= 0)


def any_hit_within(origins: torch.Tensor, dirs: torch.Tensor,
                   max_t: torch.Tensor, mesh: TriangleMesh,
                   chunk: int | None = None) -> torch.Tensor:
    """(N,) bool: does any face cut the segment origin -> origin + max_t *
    dir? Line-of-sight callers pass max_t = distance - tolerance."""
    blocked = torch.zeros(dirs.shape[0], dtype=torch.bool, device=dirs.device)
    for _, v0, e1, e2 in _face_chunks(mesh, dirs.shape[0], chunk):
        t, _, _, hit = _intersect_chunk(origins, dirs, v0, e1, e2)
        blocked |= (hit & (t < max_t[:, None])).any(-1)
    return blocked


def count_crossings(origins: torch.Tensor, dirs: torch.Tensor,
                    mesh: TriangleMesh, chunk: int | None = None) -> torch.Tensor:
    """(N,) int32 number of surface crossings along each ray (inside-mesh
    parity)."""
    count = torch.zeros(dirs.shape[0], dtype=torch.int32, device=dirs.device)
    for _, v0, e1, e2 in _face_chunks(mesh, dirs.shape[0], chunk):
        count += _intersect_chunk(origins, dirs, v0, e1, e2)[3].sum(
            -1, dtype=torch.int32)
    return count
