"""Triangle meshes with static (padded) shapes, as tensors.

A mesh is a NamedTuple of fixed-shape tensors that stays on the device for
a whole annotation run. Padding faces are fully degenerate (all three
indices point at vertex 0) so they can never produce a ray hit.

Everything up to the final tensor conversion is host numpy, identical to
``omnidata_tpu.mesh.mesh``: the same inputs give the same padded arrays and
the same (Morton) face order. The loaders read OBJ (with or without an MTL
file) and PLY (ascii and binary_little_endian); textures must be PNG files
(``cues.encode.load_rgb_float``).
"""
from __future__ import annotations

import os
import re
import struct
from typing import NamedTuple

import numpy as np
import torch


class TriangleMesh(NamedTuple):
    """vertices (V,3) f32 · faces (F,3) i32 · per-vertex normals (V,3) ·
    per-face normals (F,3) · optional per-vertex colors (V,3) in [0,1] ·
    optional per-face labels (F,) i32 · num_faces: true face count
    (faces[num_faces:] are degenerate padding)."""

    vertices: torch.Tensor
    faces: torch.Tensor
    vertex_normals: torch.Tensor
    face_normals: torch.Tensor
    vertex_colors: torch.Tensor | None = None
    face_labels: torch.Tensor | None = None
    vertex_uvs: torch.Tensor | None = None  # (V,2) in [0,1]
    texture: torch.Tensor | None = None     # (H,W,3) in [0,1]
    num_faces: int = 0
    face_colors: torch.Tensor | None = None  # (F,3) in [0,1]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def compute_normals(vertices: np.ndarray, faces: np.ndarray):
    """Area-weighted vertex normals + unit face normals (host, numpy)."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)  # length = 2*area
    norm = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn_unit = fn / np.maximum(norm, 1e-20)
    vn = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    vn_norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    vn = vn / np.maximum(vn_norm, 1e-20)
    return vn.astype(np.float32), fn_unit.astype(np.float32)


def _morton_order(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Sort faces along a 3D Morton curve of their centroids (1024^3 grid).

    Spatially coherent face order makes fixed-size face chunks spatially
    tight, which chunk-granular tile admission (raster.py) relies on."""
    c = vertices[faces].mean(1)
    lo = c.min(0)
    span = np.maximum(c.max(0) - lo, 1e-9)
    q = np.minimum((1023 * (c - lo) / span).astype(np.uint64), 1023)

    def spread(v):  # interleave 10 bits with 2-bit gaps
        v = (v | (v << 16)) & np.uint64(0x30000FF)
        v = (v | (v << 8)) & np.uint64(0x300F00F)
        v = (v | (v << 4)) & np.uint64(0x30C30C3)
        v = (v | (v << 2)) & np.uint64(0x9249249)
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    return np.argsort(code, kind="stable")


def _tensor(a, dtype, device):
    return None if a is None else torch.as_tensor(
        np.asarray(a, dtype), device=device)


def from_arrays(
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_colors: np.ndarray | None = None,
    face_labels: np.ndarray | None = None,
    vertex_uvs: np.ndarray | None = None,
    texture: np.ndarray | None = None,
    pad_multiple: int = 256,
    face_colors: np.ndarray | None = None,
    spatial_order: bool = True,
    device: torch.device | str = "cpu",
) -> TriangleMesh:
    """Build a padded mesh on ``device`` from host arrays.

    spatial_order: reorder faces along a Morton curve of their centroids
    (face ids are arbitrary; per-face labels/colors reorder consistently)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    if spatial_order and len(faces):
        order = _morton_order(vertices, faces)
        faces = faces[order]
        if face_labels is not None:
            face_labels = np.asarray(face_labels)[order]
        if face_colors is not None:
            face_colors = np.asarray(face_colors)[order]
    nf = faces.shape[0]
    vn, fn = compute_normals(vertices, faces)

    # always leave at least one degenerate slot past the real faces
    F = _round_up(nf + 1, pad_multiple)
    faces_p = np.zeros((F, 3), np.int32)
    faces_p[:nf] = faces
    fn_p = np.zeros((F, 3), np.float32)
    fn_p[:nf] = fn
    fl_p = None
    if face_labels is not None:
        fl_p = np.zeros((F,), np.int32)
        fl_p[:nf] = np.asarray(face_labels, np.int32)
    fc_p = None
    if face_colors is not None:
        fc_p = np.zeros((F, 3), np.float32)
        fc_p[:nf] = np.asarray(face_colors, np.float32)

    f32 = np.float32
    return TriangleMesh(
        vertices=_tensor(vertices, f32, device),
        faces=_tensor(faces_p, np.int32, device),
        vertex_normals=_tensor(vn, f32, device),
        face_normals=_tensor(fn_p, f32, device),
        vertex_colors=_tensor(vertex_colors, f32, device),
        face_labels=_tensor(fl_p, np.int32, device),
        vertex_uvs=_tensor(vertex_uvs, f32, device),
        texture=_tensor(texture, f32, device),
        num_faces=nf,
        face_colors=_tensor(fc_p, f32, device),
    )


def gathered_triangles(mesh: TriangleMesh) -> torch.Tensor:
    """(F,3,3) triangle vertex positions: the raycaster's working set."""
    return mesh.vertices[mesh.faces.long()]


# ---------------------------------------------------------------------------
# Procedural meshes
# ---------------------------------------------------------------------------

def cube(size: float = 1.0, center=(0.0, 0.0, 0.0),
         device: torch.device | str = "cpu") -> TriangleMesh:
    """Axis-aligned cube, outward normals, 12 triangles."""
    s = size / 2.0
    c = np.asarray(center, np.float32)
    corners = np.array(
        [[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)], np.float32
    ) + c
    quads = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    tris = []
    for a, b, cc, d in quads:
        tris += [(a, b, cc), (a, cc, d)]
    labels = np.repeat(np.arange(6, dtype=np.int32), 2)
    return from_arrays(corners, np.asarray(tris, np.int32), face_labels=labels,
                       device=device)


def quad_plane(size: float = 10.0, z: float = 0.0,
               device: torch.device | str = "cpu") -> TriangleMesh:
    """Square plane in the XY plane at height z, +Z normal."""
    s = size / 2.0
    v = np.array([[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return from_arrays(v, f, device=device)


def room(size: float = 8.0, height: float = 3.0,
         device: torch.device | str = "cpu") -> TriangleMesh:
    """A closed box room with normals pointing inward."""
    s = size / 2.0
    v = np.array(
        [[x, y, z] for z in (0.0, height) for y in (-s, s) for x in (-s, s)],
        np.float32,
    )
    quads = [
        (0, 1, 3, 2),  # floor, +z inward
        (4, 6, 7, 5),  # ceiling, -z inward
        (0, 4, 5, 1),  # -y wall, +y inward
        (2, 3, 7, 6),  # +y wall, -y inward
        (0, 2, 6, 4),  # -x wall, +x inward
        (1, 5, 7, 3),  # +x wall, -x inward
    ]
    tris = []
    for a, b, c, d in quads:
        tris += [(a, b, c), (a, c, d)]
    return from_arrays(v, np.asarray(tris, np.int32), device=device)


def uv_sphere(radius: float = 1.0, center=(0.0, 0.0, 0.0), n_lat: int = 24,
              n_lon: int = 48, device: torch.device | str = "cpu") -> TriangleMesh:
    """UV sphere with outward normals."""
    c = np.asarray(center, np.float32)
    verts = [np.array([0, 0, radius], np.float32) + c]
    for i in range(1, n_lat):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            verts.append(
                c + radius * np.array(
                    [np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)],
                    np.float32,
                )
            )
    verts.append(np.array([0, 0, -radius], np.float32) + c)
    v = np.stack(verts)
    tris = []
    ring = lambda i, j: 1 + (i - 1) * n_lon + (j % n_lon)
    for j in range(n_lon):  # top cap
        tris.append((0, ring(1, j), ring(1, j + 1)))
    for i in range(1, n_lat - 1):
        for j in range(n_lon):
            a, b = ring(i, j), ring(i, j + 1)
            d, e = ring(i + 1, j), ring(i + 1, j + 1)
            tris += [(a, d, e), (a, e, b)]
    bot = len(verts) - 1
    for j in range(n_lon):  # bottom cap
        tris.append((bot, ring(n_lat - 1, j + 1), ring(n_lat - 1, j)))
    return from_arrays(v, np.asarray(tris, np.int32), device=device)


def split_long_edges(
    vertices: np.ndarray,
    faces: np.ndarray,
    max_edge: float,
    vertex_colors: np.ndarray | None = None,
    vertex_uvs: np.ndarray | None = None,
    face_labels: np.ndarray | None = None,
    face_colors: np.ndarray | None = None,
):
    """Host-side longest-edge midpoint subdivision until every edge is
    <= max_edge. Big faces (walls, floors) otherwise overlap every tile and
    drag their whole chunk into every tile's candidate list. Midpoint
    vertices interpolate colors/uvs; children inherit face labels/colors.

    Round-based: each round splits the longest edge of every offending face
    at once; an edge -> midpoint map keeps the result watertight. Returns
    (vertices, faces, vertex_colors, vertex_uvs, face_labels, face_colors)."""
    verts = np.asarray(vertices, np.float32)
    vcol = None if vertex_colors is None else np.asarray(vertex_colors, np.float32)
    vuv = None if vertex_uvs is None else np.asarray(vertex_uvs, np.float32)
    f = np.asarray(faces, np.int64).copy()
    fl = None if face_labels is None else np.asarray(face_labels)
    fc = None if face_colors is None else np.asarray(face_colors, np.float32)
    done_f, done_fl, done_fc = [], [], []
    mid_of: dict = {}  # packed (lo<<32|hi) edge key -> midpoint vertex id

    while len(f):
        p0, p1, p2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
        e = np.stack(
            [
                np.linalg.norm(p1 - p2, axis=1),
                np.linalg.norm(p2 - p0, axis=1),
                np.linalg.norm(p0 - p1, axis=1),
            ],
            1,
        )
        # equal-length edges pick the lexicographically largest
        # (opp, p, q) ids, so the triangulation is deterministic
        opp3 = f
        pp3 = f[:, [1, 2, 0]]
        qq3 = f[:, [2, 0, 1]]

        def _gt(i, j):
            return (e[:, i] > e[:, j]) | (
                (e[:, i] == e[:, j])
                & (
                    (opp3[:, i] > opp3[:, j])
                    | ((opp3[:, i] == opp3[:, j])
                       & ((pp3[:, i] > pp3[:, j])
                          | ((pp3[:, i] == pp3[:, j])
                             & (qq3[:, i] > qq3[:, j]))))
                )
            )

        longest = np.where(_gt(1, 0), 1, 0)
        l2_beats = np.where(longest == 1, _gt(2, 1), _gt(2, 0))
        longest = np.where(l2_beats, 2, longest)
        rows = np.arange(len(f))
        need = e[rows, longest] > max_edge
        if not need.all():
            done_f.append(f[~need])
            if fl is not None:
                done_fl.append(fl[~need])
            if fc is not None:
                done_fc.append(fc[~need])
        if not need.any():
            break
        nf_, lidx = f[need], longest[need]
        rows = np.arange(len(nf_))
        opp = nf_[rows, lidx]
        p = nf_[rows, (lidx + 1) % 3]
        q = nf_[rows, (lidx + 2) % 3]
        keys = (np.minimum(p, q) << 32) | np.maximum(p, q)
        uk, inv = np.unique(keys, return_inverse=True)
        mids = np.array([mid_of.get(int(k), -1) for k in uk], np.int64)
        new = mids < 0
        if new.any():
            nk = uk[new]
            na, nb = nk >> 32, nk & 0xFFFFFFFF
            base = len(verts)
            verts = np.concatenate([verts, (verts[na] + verts[nb]) * 0.5])
            if vcol is not None:
                vcol = np.concatenate([vcol, (vcol[na] + vcol[nb]) * 0.5])
            if vuv is not None:
                vuv = np.concatenate([vuv, (vuv[na] + vuv[nb]) * 0.5])
            mids[new] = base + np.arange(new.sum())
            for k, m in zip(nk.tolist(), mids[new].tolist()):
                mid_of[k] = m
        m = mids[inv]
        # children keep the parent winding: (a,b,c) -> (a,b,m),(a,m,c) with m
        # the midpoint of the longest edge (b,c)
        f = np.concatenate([np.stack([opp, p, m], 1), np.stack([opp, m, q], 1)])
        if fl is not None:
            fl = np.concatenate([fl[need], fl[need]])
        if fc is not None:
            fc = np.concatenate([fc[need], fc[need]])

    return (
        verts,
        (np.concatenate(done_f) if done_f else np.zeros((0, 3))).astype(np.int32),
        vcol,
        vuv,
        None if face_labels is None else np.concatenate(done_fl),
        None if face_colors is None else np.concatenate(done_fc),
    )


def subdivide_mesh(mesh: TriangleMesh, max_edge: float) -> TriangleMesh:
    """Rebuild a mesh (on its device) with every edge <= max_edge
    (``split_long_edges``); the texture is carried through."""
    def host(a, rows=None):
        return None if a is None else a[:rows].cpu().numpy()

    nf = mesh.num_faces
    v, f, vc, vu, fl, fc = split_long_edges(
        host(mesh.vertices), host(mesh.faces, nf), max_edge,
        host(mesh.vertex_colors), host(mesh.vertex_uvs),
        host(mesh.face_labels, nf), host(mesh.face_colors, nf))
    return from_arrays(v, f, vertex_colors=vc, face_labels=fl, vertex_uvs=vu,
                       texture=host(mesh.texture), face_colors=fc,
                       device=mesh.vertices.device)


# ---------------------------------------------------------------------------
# Loaders (host side)
# ---------------------------------------------------------------------------

def _load_texture(path: str) -> np.ndarray:
    from ..cues.encode import load_rgb_float

    return load_rgb_float(path)


def _sibling_png(path: str, texture_path: str | None) -> str | None:
    if texture_path:
        return texture_path
    cand = os.path.splitext(path)[0] + ".png"
    return cand if os.path.exists(cand) else None


def load_obj(path: str, pad_multiple: int = 256,
             texture_path: str | None = None,
             device: torch.device | str = "cpu") -> TriangleMesh:
    """OBJ: v / vt / f lines; polygons fan-triangulated; 1-based indices.

    Texture coordinates are carried per vertex (a vertex with conflicting
    uvs keeps the first). texture_path, or a .png next to the obj, loads the
    texture image."""
    with open(path) as fh:
        content = fh.read()
    if "vt " not in content and "/" not in content:
        # plain scan meshes (v/f only): batch-parse each record type
        vchunks, fchunks = [], []
        for line in content.split("\n"):
            if line.startswith("v "):
                vchunks.append(line[2:])
            elif line.startswith("f "):
                fchunks.append(line[2:])
        if vchunks and fchunks:
            va = np.array(" ".join(vchunks).split(), np.float64)
            fa = np.array(" ".join(fchunks).split(), np.float64)
            if va.size == 3 * len(vchunks) and fa.size == 3 * len(fchunks):
                tp = _sibling_png(path, texture_path)
                return from_arrays(
                    va.reshape(-1, 3), fa.reshape(-1, 3).astype(np.int64) - 1,
                    texture=_load_texture(tp) if tp else None,
                    pad_multiple=pad_multiple, device=device)
    verts, faces, uvs = [], [], []
    uv_of_vertex: dict = {}
    for line in content.split("\n"):
        if line.startswith("v "):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif line.startswith("vt "):
            parts = line.split()
            uvs.append([float(parts[1]), float(parts[2])])
        elif line.startswith("f "):
            vi, ti = [], []
            for ptok in line.split()[1:]:
                comps = ptok.split("/")
                vi.append(int(comps[0]) - 1)
                ti.append(int(comps[1]) - 1 if len(comps) > 1 and comps[1] else None)
            for i in range(1, len(vi) - 1):
                faces.append([vi[0], vi[i], vi[i + 1]])
            for v, t in zip(vi, ti):
                if t is not None and v not in uv_of_vertex:
                    uv_of_vertex[v] = t
    vertex_uvs = None
    if uvs and uv_of_vertex:
        vertex_uvs = np.zeros((len(verts), 2), np.float32)
        for v, t in uv_of_vertex.items():
            vertex_uvs[v] = uvs[t]
    tp = _sibling_png(path, texture_path)
    return from_arrays(np.asarray(verts), np.asarray(faces),
                       vertex_uvs=vertex_uvs,
                       texture=_load_texture(tp) if tp else None,
                       pad_multiple=pad_multiple, device=device)


_PLY_TYPES = {"char": "b", "uchar": "B", "int8": "b", "uint8": "B",
              "short": "h", "ushort": "H", "int16": "h", "uint16": "H",
              "int": "i", "uint": "I", "int32": "i", "uint32": "I",
              "float": "f", "float32": "f", "double": "d", "float64": "d"}


def load_ply(path: str, pad_multiple: int = 256,
             device: torch.device | str = "cpu") -> TriangleMesh:
    """PLY: ascii or binary_little_endian; vertex xyz (+ red/green/blue),
    face vertex lists (fan-triangulated); the first scalar face property
    after the list, when nonzero somewhere, becomes the face labels."""
    with open(path, "rb") as fh:
        data = fh.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    fmt = None
    elements = []  # (name, count, [(type, name) or ("list", cnt_t, idx_t, name)])
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property":
            if t[1] == "list":
                elements[-1][2].append(("list", t[2], t[3], t[4]))
            else:
                elements[-1][2].append((t[1], t[2]))

    verts = colors = None
    faces: list = []
    face_labels: list = []
    if fmt == "ascii":
        lines = data[header_end:].decode("ascii").split("\n")
        li = 0
        for name, count, props in elements:
            rows = lines[li: li + count]
            li += count
            if name == "vertex":
                arr = np.array([r.split() for r in rows], dtype=np.float64)
                names = [p[1] for p in props]
                verts = arr[:, [names.index(k) for k in "xyz"]].astype(np.float32)
                if all(k in names for k in ("red", "green", "blue")):
                    ci = [names.index(k) for k in ("red", "green", "blue")]
                    colors = (arr[:, ci] / 255.0).astype(np.float32)
            elif name == "face":
                has_label = len(props) > 1 and props[-1][0] != "list"
                for r in rows:
                    t = [int(float(x)) for x in r.split()]
                    n, idx = t[0], t[1: 1 + t[0]]
                    lab = t[1 + n] if has_label and len(t) > 1 + n else 0
                    for i in range(1, n - 1):
                        faces.append([idx[0], idx[i], idx[i + 1]])
                        face_labels.append(lab)
    elif fmt == "binary_little_endian":
        off = header_end
        for name, count, props in elements:
            if name == "vertex" and all(p[0] != "list" for p in props):
                dt = np.dtype([(p[1], "<" + _PLY_TYPES[p[0]]) for p in props])
                arr = np.frombuffer(data, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                verts = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
                if all(k in dt.names for k in ("red", "green", "blue")):
                    colors = (np.stack([arr["red"], arr["green"], arr["blue"]], -1)
                              .astype(np.float32) / 255.0)
            elif name == "face":
                cnt_t, idx_t = props[0][1], props[0][2]
                csz = struct.calcsize(_PLY_TYPES[cnt_t])
                isz = struct.calcsize(_PLY_TYPES[idx_t])
                if all(p[0] != "list" for p in props[1:]):
                    # all triangles (the scan-mesh norm): one record array
                    rec = [("n", "<" + _PLY_TYPES[cnt_t]),
                           ("idx", "<" + _PLY_TYPES[idx_t], (3,))]
                    rec += [(f"x{j}", "<" + _PLY_TYPES[p[0]])
                            for j, p in enumerate(props[1:])]
                    dt = np.dtype(rec)
                    if off + dt.itemsize * count <= len(data):
                        arr = np.frombuffer(data, dtype=dt, count=count, offset=off)
                        if (arr["n"] == 3).all():
                            faces = arr["idx"].astype(np.int64)
                            if len(props) > 1:
                                face_labels = arr["x0"].astype(np.int64)
                            off += dt.itemsize * count
                            continue
                for _ in range(count):  # variable-length lists: walk
                    n = struct.unpack_from("<" + _PLY_TYPES[cnt_t], data, off)[0]
                    off += csz
                    idx = struct.unpack_from("<" + str(n) + _PLY_TYPES[idx_t], data, off)
                    off += isz * n
                    lab, got_label = 0, False
                    for p in props[1:]:
                        if p[0] == "list":
                            m = struct.unpack_from("<" + _PLY_TYPES[p[1]], data, off)[0]
                            off += (struct.calcsize(_PLY_TYPES[p[1]])
                                    + m * struct.calcsize(_PLY_TYPES[p[2]]))
                        else:
                            if not got_label:
                                lab = int(struct.unpack_from(
                                    "<" + _PLY_TYPES[p[0]], data, off)[0])
                                got_label = True
                            off += struct.calcsize(_PLY_TYPES[p[0]])
                    for i in range(1, n - 1):
                        faces.append([idx[0], idx[i], idx[i + 1]])
                        face_labels.append(lab)
    else:
        raise ValueError(f"unsupported PLY format {fmt!r}")

    labels = (np.asarray(face_labels, np.int32)
              if len(face_labels) and np.any(face_labels) else None)
    return from_arrays(verts, np.asarray(faces, np.int32),
                       vertex_colors=colors, face_labels=labels,
                       pad_multiple=pad_multiple, device=device)


def parse_mtl(path: str) -> dict:
    """Minimal .mtl parser: {material_name: {'Kd': (3,), 'map_Kd': path}}."""
    mats: dict = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                cur = parts[1]
                mats[cur] = {"Kd": (0.8, 0.8, 0.8), "map_Kd": None}
            elif parts[0] == "Kd" and cur:
                mats[cur]["Kd"] = tuple(float(x) for x in parts[1:4])
            elif parts[0] == "map_Kd" and cur:
                mats[cur]["map_Kd"] = os.path.join(os.path.dirname(path), parts[-1])
    return mats


def load_obj_mtl(path: str, pad_multiple: int = 256, label_map=None,
                 device: torch.device | str = "cpu"):
    """OBJ with per-face materials (mtllib/usemtl) -> (mesh, material names).

    face_colors: each face's material colour (Kd, or its map_Kd texture
    sampled at the face's uv centroid). face_labels: label_map (dict or
    callable name -> int) when given, else a trailing integer of the
    material name ('mat_12' -> 12), else the material's index."""
    verts, uvs, faces = [], [], []
    face_mat: list[int] = []
    face_uvs: list[tuple] = []
    mats: dict = {}
    mat_order: list[str] = []
    cur_mat = -1
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "mtllib":
                mats.update(parse_mtl(os.path.join(os.path.dirname(path), parts[-1])))
            elif tag == "usemtl":
                if parts[1] not in mat_order:
                    mat_order.append(parts[1])
                cur_mat = mat_order.index(parts[1])
            elif tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(parts[1]), float(parts[2])])
            elif tag == "f":
                vi, ti = [], []
                for ptok in parts[1:]:
                    comps = ptok.split("/")
                    vi.append(int(comps[0]) - 1)
                    ti.append(int(comps[1]) - 1 if len(comps) > 1 and comps[1] else None)
                for i in range(1, len(vi) - 1):
                    faces.append([vi[0], vi[i], vi[i + 1]])
                    face_mat.append(cur_mat)
                    face_uvs.append((ti[0], ti[i], ti[i + 1]))

    n_faces = len(faces)
    face_colors = np.full((n_faces, 3), 0.8, np.float32)
    textures: dict = {}
    uvs_np = np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32)
    for fi in range(n_faces):
        mi = face_mat[fi]
        name = mat_order[mi] if 0 <= mi < len(mat_order) else None
        m = mats.get(name, {"Kd": (0.8, 0.8, 0.8), "map_Kd": None})
        if m["map_Kd"] and os.path.exists(m["map_Kd"]) and all(
                t is not None for t in face_uvs[fi]):
            if m["map_Kd"] not in textures:
                textures[m["map_Kd"]] = _load_texture(m["map_Kd"])
            tex = textures[m["map_Kd"]]
            uv = uvs_np[list(face_uvs[fi])].mean(0)
            th, tw = tex.shape[:2]
            x = int(np.clip(uv[0], 0, 1) * (tw - 1))
            y = int((1.0 - np.clip(uv[1], 0, 1)) * (th - 1))
            face_colors[fi] = tex[y, x]
        else:
            face_colors[fi] = m["Kd"]

    def label_of(name, idx):
        if label_map is not None:
            if callable(label_map):
                return int(label_map(name))
            return int(label_map.get(name, 0))
        m = re.search(r"(\d+)$", name or "")
        return int(m.group(1)) if m else idx

    face_labels = np.asarray(
        [label_of(mat_order[mi] if 0 <= mi < len(mat_order) else "", mi)
         for mi in face_mat], np.int32)
    mesh = from_arrays(np.asarray(verts), np.asarray(faces, np.int32),
                       face_labels=face_labels, face_colors=face_colors,
                       pad_multiple=pad_multiple, device=device)
    return mesh, mat_order
