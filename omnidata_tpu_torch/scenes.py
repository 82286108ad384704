"""The annotator benchmark's scenes and cameras, numpy-only host prep.

``build_scene`` assembles a procedural interior (a 10 m x 10 m x 3.2 m room,
4 uv-spheres, 5 boxes) with random vertex colours, splits every edge longer
than 0.8 m and bakes curvature colours: 39,760 faces, padded to 39,936
(312 chunks of 128), 19,900 vertices. ``build_large_scene`` is the
Replica-scan-scale interior (8 denser spheres, 12 boxes, edges split at
0.08 m): 584,704 faces, padded to 584,960 (4,570 chunks of 128).
``build_xl_scene`` is the size of a real Replica scan (10 spheres of
128 x 256, 12 boxes, edges split at 0.055 m): 1,423,360 faces, padded to
1,423,616 (11,122 chunks of 128). ``sample_cameras_np`` draws fixated
cameras inside the room. Same seeds, same arrays as ``bench.py``'s
``build_scene``, ``build_large_scene``, ``build_xl_scene`` and
``sample_cameras_np``. Nothing is cached on disk here
(``omnidata_tpu_torch.bench`` caches the arrays).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.cameras import Camera
from .cues.curvature import bake_curvature_colors
from .mesh.mesh import (
    TriangleMesh,
    cube,
    from_arrays,
    room,
    split_long_edges,
    uv_sphere,
)


def _look_at_np(loc: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """Batched numpy look-at rotation (Blender TRACK_TO, track -Z, up Y)."""
    fwd = tgt - loc
    fwd /= np.maximum(np.linalg.norm(fwd, axis=-1, keepdims=True), 1e-30)
    z = -fwd
    up = np.array([0.0, 0.0, 1.0], np.float32)
    x = np.cross(np.broadcast_to(up, z.shape), z)
    xn = np.linalg.norm(x, axis=-1, keepdims=True)
    x = np.where(xn < 1e-8, np.array([1.0, 0.0, 0.0], np.float32),
                 x / np.where(xn < 1e-8, 1.0, xn))
    y = np.cross(z, x)
    y /= np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), 1e-30)
    return np.stack([x, y, z], -1).astype(np.float32)


def _assemble(parts, rng, edge: float):
    """Concatenate meshes, colour vertices from ``rng``, split long edges."""
    vs, fs = [], []
    off = 0
    for p in parts:
        vs.append(p.vertices.cpu().numpy())
        fs.append(p.faces[: p.num_faces].cpu().numpy() + off)
        off += p.vertices.shape[0]
    v = np.concatenate(vs)
    f = np.concatenate(fs)
    colors = rng.rand(v.shape[0], 3).astype(np.float32) * 0.6 + 0.2
    v, f, colors, _, _, _ = split_long_edges(v, f, edge, vertex_colors=colors)
    return v, f, colors


def _build_interior(seed: int, n_spheres: int, n_boxes: int, n_lat: int,
                    edge: float, device) -> tuple[TriangleMesh, TriangleMesh]:
    rng = np.random.RandomState(seed)
    parts = [room(size=10.0, height=3.2)]
    for _ in range(n_spheres):
        c = (rng.uniform(-3.5, 3.5), rng.uniform(-3.5, 3.5), rng.uniform(0.4, 1.2))
        parts.append(uv_sphere(radius=rng.uniform(0.25, 0.6), center=c,
                               n_lat=n_lat, n_lon=2 * n_lat))
    for _ in range(n_boxes):
        c = (rng.uniform(-4.0, 4.0), rng.uniform(-4.0, 4.0), rng.uniform(0.3, 1.0))
        parts.append(cube(size=rng.uniform(0.4, 1.2), center=c))
    v, f, colors = _assemble(parts, rng, edge=edge)
    mesh = from_arrays(v, f, vertex_colors=colors, device=device)
    return mesh, bake_curvature_colors(mesh, rings=1)


def build_scene(seed: int = 0, n_spheres: int = 4, n_boxes: int = 5,
                device: torch.device | str = "cpu"
                ) -> tuple[TriangleMesh, TriangleMesh]:
    """-> (mesh with vertex colours, same mesh with curvature colours)."""
    return _build_interior(seed, n_spheres, n_boxes, 48, 0.8, device)


def build_large_scene(seed: int = 0, device: torch.device | str = "cpu"
                      ) -> tuple[TriangleMesh, TriangleMesh]:
    """The 584,704-face scene of ``bench.py``'s large-scene measurement ->
    (mesh with vertex colours, same mesh with curvature colours)."""
    return _build_interior(seed, 8, 12, 96, 0.08, device)


def build_xl_scene(seed: int = 0, device: torch.device | str = "cpu"
                   ) -> tuple[TriangleMesh, TriangleMesh]:
    """The 1,423,360-face scene of ``bench.py``'s xl measurement ->
    (mesh with vertex colours, same mesh with curvature colours)."""
    return _build_interior(seed, 10, 12, 128, 0.055, device)


def sample_cameras_np(n: int, seed: int = 1):
    """(locations (n,3), rotations (n,3,3), fovs (n,)) as float32 numpy."""
    rng = np.random.RandomState(seed)
    locs = np.stack(
        [rng.uniform(-3.0, 3.0, n), rng.uniform(-3.0, 3.0, n),
         rng.uniform(1.2, 2.0, n)], -1).astype(np.float32)
    tgts = np.stack(
        [rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), rng.uniform(0.3, 2.5, n)],
        -1).astype(np.float32)
    fovs = rng.uniform(0.7, 1.4, n).astype(np.float32)
    return locs, _look_at_np(locs, tgts), fovs


def camera_batch(cams_np, idx, resolution: int,
                 device: torch.device | str = "cpu") -> Camera:
    """Camera batch from rows ``idx`` of ``sample_cameras_np``'s arrays."""
    locs, Rs, fovs = cams_np
    idx = np.asarray(list(idx))
    return Camera(torch.as_tensor(locs[idx], device=device),
                  torch.as_tensor(Rs[idx], device=device),
                  torch.as_tensor(fovs[idx], device=device), resolution)
