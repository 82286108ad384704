"""Mesh format conversion: OBJ -> binary PLY (and back) via the loaders.

    python -m omnidata_tpu_torch.utils.convert_mesh in.obj out.ply
"""
from __future__ import annotations

import sys

import numpy as np


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors: np.ndarray | None = None,
              binary: bool = True) -> None:
    """binary=True writes binary_little_endian (the loader's vectorised
    path), ascii otherwise. Colours in [0,1] are stored as uchar
    (truncated: int(c * 255))."""
    has_c = vertex_colors is not None
    head = (
        "ply\nformat {} 1.0\n".format("binary_little_endian" if binary else "ascii")
        + f"element vertex {len(vertices)}\n"
        + "property float x\nproperty float y\nproperty float z\n"
        + ("property uchar red\nproperty uchar green\nproperty uchar blue\n" if has_c else "")
        + f"element face {len(faces)}\n"
        + "property list uchar int vertex_indices\nend_header\n"
    )
    if binary:
        vt = [("xyz", "<f4", 3)] + ([("rgb", "u1", 3)] if has_c else [])
        varr = np.zeros(len(vertices), dtype=vt)
        varr["xyz"] = vertices
        if has_c:
            varr["rgb"] = (np.clip(vertex_colors, 0, 1) * 255).astype(np.uint8)
        farr = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        farr["n"] = 3
        farr["idx"] = faces
        with open(path, "wb") as fh:
            fh.write(head.encode())
            fh.write(varr.tobytes())
            fh.write(farr.tobytes())
        return
    with open(path, "w") as fh:
        fh.write(head)
        if has_c:
            cols = (np.clip(vertex_colors, 0, 1) * 255).astype(np.uint8)
            for v, c in zip(vertices, cols):
                fh.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in vertices:
                fh.write(f"{v[0]} {v[1]} {v[2]}\n")
        for f in faces:
            fh.write(f"3 {f[0]} {f[1]} {f[2]}\n")


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as fh:
        for v in vertices:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in faces:
            fh.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")


def main(argv=None):
    src, dst = sys.argv[1:] if argv is None else argv
    from ..mesh.mesh import load_obj, load_ply

    mesh = load_obj(src) if src.endswith(".obj") else load_ply(src)
    v = mesh.vertices.numpy()
    f = mesh.faces[: mesh.num_faces].numpy()
    c = None if mesh.vertex_colors is None else mesh.vertex_colors.numpy()
    if dst.endswith(".ply"):
        write_ply(dst, v, f, c)
    else:
        write_obj(dst, v, f)


if __name__ == "__main__":
    main()
