"""The benchmark's scenes, made on the host with numpy alone.

A frozen copy of the port's procedural interior (``scenes._build_interior``
with the primitives, the Morton face order and the edge split it calls): a
10 m x 10 m x 3.2 m room, uv-spheres and boxes placed from a seeded
``RandomState``, random vertex colours, every edge longer than ``edge``
split at its midpoint. The copy is kept here so that a change to the
program cannot move the scenes the benchmark measures on.

``build(params)`` takes a configuration's ``scene`` entry and returns the
host arrays (vertices (V,3) float32, faces (F,3) int32, vertex colours
(V,3) float32) that a mesh file of the scene would hold.
"""
from __future__ import annotations

import numpy as np


def morton_order(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Face order along a 3D Morton curve of the centroids (1024^3 grid)."""
    c = vertices[faces].mean(1)
    lo = c.min(0)
    span = np.maximum(c.max(0) - lo, 1e-9)
    q = np.minimum((1023 * (c - lo) / span).astype(np.uint64), 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x30000FF)
        v = (v | (v << 8)) & np.uint64(0x300F00F)
        v = (v | (v << 4)) & np.uint64(0x30C30C3)
        v = (v | (v << 2)) & np.uint64(0x9249249)
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def _part(v, tris):
    """A primitive as its mesh holds it: faces in Morton order."""
    v = np.asarray(v, np.float32)
    f = np.asarray(tris, np.int32)
    return v, f[morton_order(v, f)]


def room(size: float, height: float):
    s = size / 2.0
    v = [[x, y, z] for z in (0.0, height) for y in (-s, s) for x in (-s, s)]
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, c, d in quads:
        tris += [(a, b, c), (a, c, d)]
    return _part(v, tris)


def cube(size: float, center):
    s = size / 2.0
    c = np.asarray(center, np.float32)
    corners = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                        for z in (-s, s)], np.float32) + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, cc, d in quads:
        tris += [(a, b, cc), (a, cc, d)]
    return _part(corners, tris)


def uv_sphere(radius: float, center, n_lat: int, n_lon: int):
    c = np.asarray(center, np.float32)
    verts = [np.array([0, 0, radius], np.float32) + c]
    for i in range(1, n_lat):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            verts.append(c + radius * np.array(
                [np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)],
                np.float32))
    verts.append(np.array([0, 0, -radius], np.float32) + c)

    def ring(i, j):
        return 1 + (i - 1) * n_lon + (j % n_lon)

    tris = [(0, ring(1, j), ring(1, j + 1)) for j in range(n_lon)]
    for i in range(1, n_lat - 1):
        for j in range(n_lon):
            a, b = ring(i, j), ring(i, j + 1)
            d, e = ring(i + 1, j), ring(i + 1, j + 1)
            tris += [(a, d, e), (a, e, b)]
    bot = len(verts) - 1
    tris += [(bot, ring(n_lat - 1, j + 1), ring(n_lat - 1, j))
             for j in range(n_lon)]
    return _part(np.stack(verts), tris)


def split_long_edges(verts: np.ndarray, faces: np.ndarray, max_edge: float,
                     vcol: np.ndarray):
    """Longest-edge midpoint subdivision in rounds until every edge is at
    most max_edge; midpoints interpolate the colours and are shared by the
    faces on both sides of an edge. -> (vertices, faces, colours)."""
    verts = np.asarray(verts, np.float32)
    vcol = np.asarray(vcol, np.float32)
    f = np.asarray(faces, np.int64).copy()
    done_f = []
    mid_of: dict = {}
    while len(f):
        p0, p1, p2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
        e = np.stack([np.linalg.norm(p1 - p2, axis=1),
                      np.linalg.norm(p2 - p0, axis=1),
                      np.linalg.norm(p0 - p1, axis=1)], 1)
        opp3, pp3, qq3 = f, f[:, [1, 2, 0]], f[:, [2, 0, 1]]

        def gt(i, j):  # equal lengths: the larger (opp, p, q) ids win
            return (e[:, i] > e[:, j]) | ((e[:, i] == e[:, j]) & (
                (opp3[:, i] > opp3[:, j]) | ((opp3[:, i] == opp3[:, j]) & (
                    (pp3[:, i] > pp3[:, j]) | ((pp3[:, i] == pp3[:, j])
                                               & (qq3[:, i] > qq3[:, j]))))))

        longest = np.where(gt(1, 0), 1, 0)
        longest = np.where(np.where(longest == 1, gt(2, 1), gt(2, 0)), 2, longest)
        rows = np.arange(len(f))
        need = e[rows, longest] > max_edge
        if not need.all():
            done_f.append(f[~need])
        if not need.any():
            break
        nf, lidx = f[need], longest[need]
        rows = np.arange(len(nf))
        opp = nf[rows, lidx]
        p = nf[rows, (lidx + 1) % 3]
        q = nf[rows, (lidx + 2) % 3]
        keys = (np.minimum(p, q) << 32) | np.maximum(p, q)
        uk, inv = np.unique(keys, return_inverse=True)
        mids = np.array([mid_of.get(int(k), -1) for k in uk], np.int64)
        new = mids < 0
        if new.any():
            nk = uk[new]
            na, nb = nk >> 32, nk & 0xFFFFFFFF
            base = len(verts)
            verts = np.concatenate([verts, (verts[na] + verts[nb]) * 0.5])
            vcol = np.concatenate([vcol, (vcol[na] + vcol[nb]) * 0.5])
            mids[new] = base + np.arange(new.sum())
            for k, m in zip(nk.tolist(), mids[new].tolist()):
                mid_of[k] = m
        m = mids[inv]
        f = np.concatenate([np.stack([opp, p, m], 1), np.stack([opp, m, q], 1)])
    faces = (np.concatenate(done_f) if done_f else np.zeros((0, 3))).astype(np.int32)
    return verts, faces, vcol


def build(params: dict):
    """A configuration's ``scene`` entry (seed, spheres, boxes, sphere_lat,
    edge_m, room_m, room_height_m) -> (vertices, faces, colours)."""
    rng = np.random.RandomState(int(params["seed"]))
    parts = [room(float(params["room_m"]), float(params["room_height_m"]))]
    n_lat = int(params["sphere_lat"])
    for _ in range(int(params["spheres"])):
        c = (rng.uniform(-3.5, 3.5), rng.uniform(-3.5, 3.5), rng.uniform(0.4, 1.2))
        parts.append(uv_sphere(rng.uniform(0.25, 0.6), c, n_lat, 2 * n_lat))
    for _ in range(int(params["boxes"])):
        c = (rng.uniform(-4.0, 4.0), rng.uniform(-4.0, 4.0), rng.uniform(0.3, 1.0))
        parts.append(cube(rng.uniform(0.4, 1.2), c))
    vs, fs, off = [], [], 0
    for v, f in parts:
        vs.append(v)
        fs.append(f + off)
        off += v.shape[0]
    v = np.concatenate(vs)
    f = np.concatenate(fs)
    colors = rng.rand(v.shape[0], 3).astype(np.float32) * 0.6 + 0.2
    return split_long_edges(v, f, float(params["edge_m"]), colors)
