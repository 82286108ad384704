"""Carry state built elsewhere (host numpy, or the JAX package's arrays via
``np.asarray``) into the port's tensors unchanged: same padding, same face
order, same values."""
from __future__ import annotations

import numpy as np
import torch

from .core.cameras import Camera
from .mesh.mesh import TriangleMesh

_INT_FIELDS = ("faces", "face_labels")


def mesh_from_numpy(fields: dict, num_faces: int,
                    device: torch.device | str = "cpu") -> TriangleMesh:
    """TriangleMesh from a dict of numpy arrays keyed by TriangleMesh's array
    fields (vertices, faces, vertex_normals, face_normals, and optionally
    vertex_colors, face_labels, vertex_uvs, texture, face_colors). Faces
    and labels become int32, everything else float32."""
    arrays = {}
    for name in TriangleMesh._fields:
        a = fields.get(name)
        if name == "num_faces" or a is None:
            continue
        dtype = np.int32 if name in _INT_FIELDS else np.float32
        arrays[name] = torch.as_tensor(np.array(a, dtype), device=device)
    return TriangleMesh(num_faces=int(num_faces), **arrays)


def camera_from_numpy(location, R, fov, resolution: int,
                      device: torch.device | str = "cpu") -> Camera:
    """Camera (batch) from numpy location (...,3), R (...,3,3), fov (...)."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return Camera(f32(location), f32(R), f32(fov), int(resolution))
