"""Per-vertex quantities of the plain reference, worked out from the raw
scene arrays on the host: area-weighted vertex normals and the principal
curvature colours that the annotator bakes (a quadric fit over each
vertex's 2-ring, the eigenvalues of its shape operator clipped to +-1/r
with r = 0.03 m and mapped to 255 levels in R and G).

numpy and scipy only. The formulas are those of omnidata's annotator as
the port states them; nothing here is imported from the port.
"""
from __future__ import annotations

import numpy as np


def vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Unit area-weighted vertex normals (V,3) float32."""
    v0, v1, v2 = (v[f[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    vn = np.zeros_like(v)
    for i in range(3):
        np.add.at(vn, f[:, i], fn)
    vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-20)
    return vn.astype(np.float32)


def kring(f: np.ndarray, n_vertices: int, rings: int = 2):
    """k-ring adjacency (CSR indptr, indices), a vertex not its own
    neighbour."""
    import scipy.sparse as sp

    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    A = sp.coo_matrix((np.ones(len(e) * 2),
                       (np.concatenate([e[:, 0], e[:, 1]]),
                        np.concatenate([e[:, 1], e[:, 0]]))),
                      shape=(n_vertices, n_vertices)).tocsr()
    A.data[:] = 1.0
    reach = A.copy()
    for _ in range(rings - 1):
        reach = reach + reach @ A
    reach = reach.tocsr()
    reach.setdiag(0)
    reach.eliminate_zeros()
    reach.sort_indices()
    return reach.indptr, reach.indices


def curvature_colors(v: np.ndarray, vn: np.ndarray, ring, which: np.ndarray,
                     min_radius: float = 0.03) -> np.ndarray:
    """Curvature colours (len(which), 3) float32 of the vertices ``which``
    (ring: ``kring``'s 2-ring adjacency of the whole mesh):
    K1 >= K2 from z = a x^2 + b xy + c y^2 fitted in each vertex's tangent
    frame (float64 normal equations with a 1e-12 Tikhonov floor; 0 where the
    ring has fewer than 5 vertices), clipped to +-1/r, mapped
    round(((k r) + 1) / 2 * 254) / 255."""
    indptr, indices = ring
    n = vn[which].astype(np.float64)
    t1 = np.cross(n, np.array([1.0, 0.0, 0.0]))
    deg = np.linalg.norm(t1, axis=1) < 1e-6
    t1[deg] = np.cross(n[deg], np.array([0.0, 1.0, 0.0]))
    t1 /= np.maximum(np.linalg.norm(t1, axis=1, keepdims=True), 1e-30)
    t2 = np.cross(n, t1)
    k1 = np.zeros(len(which))
    k2 = np.zeros(len(which))
    counts = np.diff(indptr)[which]
    # vertices of one ring size at a time: no padding
    for size in np.unique(counts[counts >= 5]):
        sel = np.nonzero(counts == size)[0]
        vid = which[sel]
        nb = indices[indptr[vid][:, None] + np.arange(size)]  # (B, size)
        d = v[nb].astype(np.float64) - v[vid][:, None].astype(np.float64)
        x = np.einsum("bck,bk->bc", d, t1[sel])
        y = np.einsum("bck,bk->bc", d, t2[sel])
        z = np.einsum("bck,bk->bc", d, n[sel])
        M = np.stack([x * x, x * y, y * y], -1)
        MtM = np.einsum("bci,bcj->bij", M, M)
        tr = np.trace(MtM, axis1=1, axis2=2)
        MtM = MtM + (1e-12 * np.maximum(tr, 1e-30))[:, None, None] * np.eye(3)
        coef = np.linalg.solve(MtM, np.einsum("bci,bc->bi", M, z)[..., None])[..., 0]
        a, b, c = coef[:, 0], coef[:, 1], coef[:, 2]
        mean, root = -(a + c), np.sqrt((a - c) ** 2 + b * b)
        k1[sel], k2[sel] = mean + root, mean - root
    m = 1.0 / min_radius
    k1, k2 = np.clip(k1, -m, m), np.clip(k2, -m, m)
    r1 = np.round(((k1 * min_radius) + 1.0) / 2.0 * 254.0) / 255.0
    r2 = np.round(((k2 * min_radius) + 1.0) / 2.0 * 254.0) / 255.0
    return np.stack([r1, r2, np.zeros_like(r1)], -1).astype(np.float32)
