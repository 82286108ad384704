"""Principal curvature: per-vertex (K1, K2) -> clipped -> RG vertex colors,
then rasterized with the mesh renderer.

Host numpy, as in ``omnidata_tpu.cues.curvature``: a local quadric patch is
fit per vertex over its k-ring; the principal curvatures are the
eigenvalues of -[[2a, b], [b, 2c]] (positive where the surface bends away
from the oriented normal, K1 >= K2). Colors follow the reference's clip and
remap: clip to ±1/r with r = 0.03 m, map [-1/r, 1/r] -> [0,254]/255 into R
(K1) and G (K2), B = 0. Only ``bake_curvature_colors`` touches tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def _kring_csr(faces: np.ndarray, V: int, rings: int):
    """k-ring vertex adjacency as CSR (indptr, indices)."""
    import scipy.sparse as sp

    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    A = sp.coo_matrix(
        (np.ones(len(e) * 2), (np.concatenate([e[:, 0], e[:, 1]]),
                               np.concatenate([e[:, 1], e[:, 0]]))),
        shape=(V, V),
    ).tocsr()
    A.data[:] = 1.0
    reach = A.copy()
    for _ in range(rings - 1):
        reach = reach + reach @ A
    reach = reach.tocsr()
    reach.setdiag(0)  # A@A has a nonzero diagonal: a vertex is not its own
    reach.eliminate_zeros()  # neighbor (keeps the cnt >= 5 guard honest)
    reach.sort_indices()
    return reach.indptr, reach.indices


def vertex_principal_curvatures(
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_normals: np.ndarray,
    rings: int = 2,
    block: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """(K1, K2) per vertex, K1 >= K2.

    Vectorized: per-vertex neighbor lists are padded to the block's max
    ring size (mask-weighted), the quadric z = ax² + bxy + cy² is solved
    as batched 3x3 normal equations, and the shape operator's eigenvalues
    come from the closed-form symmetric-2x2 formula. Blocks of `block`
    vertices bound the padded memory (pole vertices of a uv-sphere can
    have hundreds of neighbors). ~100x the per-vertex Python loop."""
    V = vertices.shape[0]
    indptr, indices = _kring_csr(faces, V, rings)
    counts = np.diff(indptr)

    # tangent frames (batched; matches the loop reference: t1 = n x e_x,
    # or n x e_y where n ~ e_x)
    n = vertex_normals
    t1 = np.cross(n, np.array([1.0, 0.0, 0.0]))
    deg = np.linalg.norm(t1, axis=1) < 1e-6
    if deg.any():
        t1[deg] = np.cross(n[deg], np.array([0.0, 1.0, 0.0]))
    t1 /= np.maximum(np.linalg.norm(t1, axis=1, keepdims=True), 1e-30)
    t2 = np.cross(n, t1)

    k1 = np.zeros(V)
    k2 = np.zeros(V)
    # process in ascending-ring-size order so each block's padded cap tracks
    # its own max (a uv-sphere pole has n_lon neighbors vs a median of ~6 —
    # unsorted blocks would pad everything to the pole's cap)
    order = np.argsort(counts, kind="stable")
    for s in range(0, V, block):
        vid = order[s:min(s + block, V)]
        cnt = counts[vid]
        cap = int(cnt.max()) if len(cnt) else 0
        if cap == 0:
            continue
        B = len(vid)
        # padded neighbor ids (pad = self -> d = 0, masked out anyway)
        mask = np.arange(cap)[None, :] < cnt[:, None]
        nbr = np.repeat(vid, cap).reshape(B, cap)  # self-padding default
        flat_rows = np.repeat(np.arange(B), cnt)
        flat_cols = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        nbr[flat_rows, flat_cols] = indices[
            np.repeat(indptr[vid], cnt) + flat_cols
        ]

        d = vertices[nbr] - vertices[vid, None]          # (B, cap, 3)
        x = np.einsum("bck,bk->bc", d, t1[vid])
        y = np.einsum("bck,bk->bc", d, t2[vid])
        z = np.einsum("bck,bk->bc", d, n[vid])
        w = mask.astype(np.float64)
        M = np.stack([x * x, x * y, y * y], -1)          # (B, cap, 3)
        Mw = M * w[..., None]
        MtM = np.einsum("bci,bcj->bij", Mw, M)           # (B, 3, 3)
        Mtz = np.einsum("bci,bc->bi", Mw, z)             # (B, 3)
        # Tikhonov floor keeps near-rank-deficient fits solvable (flat or
        # collinear rings -> quadric ~ 0 there, matching lstsq's minimum-norm
        # behavior up to the tiny regularizer)
        tr = np.trace(MtM, axis1=1, axis2=2)
        lam = (1e-12 * np.maximum(tr, 1e-30))[:, None]
        MtM = MtM + lam[..., None] * np.eye(3)
        coef = np.linalg.solve(MtM, Mtz[..., None])[..., 0]  # (B,3) = a,b,c
        a, b, c = coef[:, 0], coef[:, 1], coef[:, 2]
        # eigenvalues of -[[2a, b], [b, 2c]] in closed form
        # (minus: convex-positive — bend away from the normal, module doc)
        mean = -(a + c)
        root = np.sqrt((a - c) ** 2 + b * b)
        hi, lo = mean + root, mean - root
        ok = cnt >= 5
        k1[vid] = np.where(ok, hi, 0.0)
        k2[vid] = np.where(ok, lo, 0.0)
    return k1, k2


def clip_curvatures(vals: np.ndarray, radius: float = 0.03) -> np.ndarray:
    """Clip to ±1/radius (create_curvature_images.py:183-198)."""
    m = 1.0 / radius
    return np.clip(vals, -m, m)


def curvature_colors(k1: np.ndarray, k2: np.ndarray,
                     min_radius: float = 0.03) -> np.ndarray:
    """map_to_color 'principal' (create_curvature_images.py:201-222):
    [-1/r, 1/r] -> round(((k*r)+1)/2 * 254)/255 into R=K1, G=K2, B=0."""
    max_val = 254.0
    r1 = np.round(((k1 * min_radius) + 1.0) / 2.0 * max_val) / (max_val + 1.0)
    r2 = np.round(((k2 * min_radius) + 1.0) / 2.0 * max_val) / (max_val + 1.0)
    return np.stack([r1, r2, np.zeros_like(r1)], -1).astype(np.float32)


def bake_curvature_colors(mesh, rings: int = 2, min_radius: float = 0.03):
    """TriangleMesh -> TriangleMesh with curvature RG vertex colors (on the
    mesh's device)."""
    v = mesh.vertices.cpu().numpy()
    f = mesh.faces[: mesh.num_faces].cpu().numpy()
    vn = mesh.vertex_normals.cpu().numpy()
    k1, k2 = vertex_principal_curvatures(v, f, vn, rings=rings)
    k1 = clip_curvatures(k1, min_radius)
    k2 = clip_curvatures(k2, min_radius)
    colors = curvature_colors(k1, k2, min_radius)
    return mesh._replace(
        vertex_colors=torch.as_tensor(colors, device=mesh.vertices.device))
