"""Device half of the split NARF pipeline (keypoints3d): the
convolution-shaped border prefix — range-image pyramid, PCA surface
normals, 4-direction border probability, obstacle/shadow classification,
surface-change score and direction, blur — as plain torch ops on a (K, H, W)
batch of views, so it runs on the card beside the render.

The reference pipeline is PCL's (pcl_narf.hpp:205-470, ``native/narf.cpp``).
Its stages 1-3 are fixed-radius stencils over the range image (shifted
tensors and elementwise math); stage 4, region growing over the metric
support radius, depends on the data in frontier size and shape and stays on
the host (``keypoints3d.narf_interest_with_maps`` consumes these maps). On
one host core the border stages are 74% of keypoints3d's time on a 512²
depth (the JAX package's measurement), which this module takes off the host.

Numerics follow the numpy twin (``keypoints3d._extract_borders``) with two
deviations that stay inside its tolerance: float32 accumulation and
closed-form symmetric 3x3 eigensolvers (Cardano + cross-product
eigenvectors) in place of ``np.linalg.eigh``; eigenvector signs are
arbitrary in every implementation, and everything downstream aligns or
folds them. Both are kept deliberately: the JAX package's batched CLI
computes its labels this way, and the port's CLI must write the same ones.

The maps leave as codes — uint16 change (1/65535 steps of a [0, 1] score),
int8 direction components, uint8 shadow flags, 6 B a pixel — because the
host interest stage (``narf_interest_with_maps``) consumes exactly these
codes; float maps would give it other inputs than the JAX path's.

Square roots go through ``_sqrt`` and divisions by a constant through
``_div``, so that both round as IEEE float32 on the card and on the CPU
(PyTorch's CPU square root is not correctly rounded, and its CUDA kernels
multiply by the reciprocal of a host scalar); the transcendental functions
(the per-view angle, the eigensolver's arccos and cos) are taken in
float64 and rounded once. Every code is then equal on the card and the
CPU: the algorithm is ill-conditioned where a normal is near-orthogonal to
its view ray (its sign flips, and the neighbours' surface change jumps),
so an ulp of difference there would move a change code by far more than
the 2e-3 tolerance elsewhere.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_JUMP_FACTOR = 4.0
_SPACING_FACTOR = 1.5
_MIN_BORDER_PROB = 0.8
_DEG2 = math.radians(2.0)


def n_levels_for(focal: float, H: int, W: int, max_levels: int = 99) -> int:
    """Pyramid depth for one view, the native loop's rule (narf.cpp:626-631):
    add a half level while the current coarsest is >= 16 px and its angular
    resolution is still finer than 4 deg/px."""
    S, ar, h, w = 1, math.atan(1.0 / focal), H, W
    while 0.5 * ar < _DEG2 and w >= 16 and h >= 16 and S < max_levels:
        S += 1
        ar *= 2.0
        h //= 2
        w //= 2
    return S


def max_levels_for(H: int, W: int) -> int:
    """Upper bound on n_levels_for over all focals (the angle clause only
    shortens): levels until the coarsest drops below 16 px."""
    S, h, w = 1, H, W
    while w >= 16 and h >= 16:
        S += 1
        h //= 2
        w //= 2
    return S


def focal_px(fov: torch.Tensor, resolution: int) -> torch.Tensor:
    """(K,) field of view in radians -> float32 focal length in pixels,
    computed in float64 and rounded once, so the card and the CPU agree."""
    return (resolution / (2.0 * torch.tan(fov.double() / 2.0))).float()


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s rounded as an IEEE division on every device (PyTorch's CUDA
    kernels multiply by the reciprocal of a host scalar)."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (taken in float64, rounded once)."""
    return torch.sqrt(a.double()).float()


def _shift(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[:, y, x, ...] = a[:, y + dy, x + dx, ...], ``fill`` outside; the
    spatial dims of a (K, H, W[, C]) tensor are 1 and 2."""
    H, W = a.shape[1], a.shape[2]
    out = torch.full_like(a, fill)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    out[:, max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = \
        a[:, max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)]
    return out


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over a trailing axis of 3, added left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return _sqrt(_dot(v, v))


def _outer6(n: torch.Tensor) -> torch.Tensor:
    """Upper triangle [xx, xy, xz, yy, yz, zz] of n n^T."""
    return torch.stack([n[..., 0] * n[..., 0], n[..., 0] * n[..., 1],
                        n[..., 0] * n[..., 2], n[..., 1] * n[..., 1],
                        n[..., 1] * n[..., 2], n[..., 2] * n[..., 2]], -1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


# ---------------------------------------------------------------------------
# closed-form symmetric 3x3 eigensolvers (C = [xx, xy, xz, yy, yz, zz])
# ---------------------------------------------------------------------------

def _eigvals3(C: torch.Tensor):
    """All three eigenvalues, descending (Cardano / trigonometric form)."""
    xx, xy, xz, yy, yz, zz = C.unbind(-1)
    q = _div(xx + yy + zz, 3.0)
    p1 = xy * xy + xz * xz + yz * yz
    dxx, dyy, dzz = xx - q, yy - q, zz - q
    p2 = dxx * dxx + dyy * dyy + dzz * dzz + 2.0 * p1
    p = _sqrt(_div(torch.clamp(p2, min=0.0), 6.0))
    ps = torch.clamp(p, min=1e-20)
    bxx, byy, bzz = dxx / ps, dyy / ps, dzz / ps
    bxy, bxz, byz = xy / ps, xz / ps, yz / ps
    detB = (bxx * (byy * bzz - byz * byz) - bxy * (bxy * bzz - byz * bxz)
            + bxz * (bxy * byz - byy * bxz))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    # the angle's cosines in float64, rounded once: the same on every device
    phi = torch.arccos(r.double()) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi).float()
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0).float()
    e2 = 3.0 * q - e1 - e3
    return e1, e2, e3


def _eigvec3(C: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric C for eigenvalue lam: the largest of the
    three row cross products of (C - lam I) (any two independent rows span
    the orthogonal complement of the eigenspace); +x where C is isotropic."""
    xx, xy, xz, yy, yz, zz = C.unbind(-1)
    r0 = torch.stack([xx - lam, xy, xz], -1)
    r1 = torch.stack([xy, yy - lam, yz], -1)
    r2 = torch.stack([xz, yz, zz - lam], -1)
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n01, n02, n12 = _dot(c01, c01), _dot(c02, c02), _dot(c12, c12)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    nb = _sqrt(torch.maximum(n01, torch.maximum(n02, n12)))
    fallback = torch.zeros_like(best)
    fallback[..., 0] = 1.0
    return torch.where((nb > 1e-18)[..., None],
                       best / torch.clamp(nb, min=1e-18)[..., None], fallback)


# ---------------------------------------------------------------------------
# pyramid
# ---------------------------------------------------------------------------

def _level0(depth: torch.Tensor, focal: torch.Tensor, max_range: float):
    """(K, H, W) metric depth + (K,) focal -> level 0 (pts, rng, valid, ar)."""
    K, H, W = depth.shape
    f = focal[:, None, None]
    valid = (depth > 1e-6) & (depth < max_range)
    xs = torch.arange(W, dtype=torch.float32, device=depth.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=depth.device)[None, :, None]
    px = (xs - W / 2.0) / f * depth
    py = (ys - H / 2.0) / f * depth
    pts = torch.where(valid[..., None], torch.stack([px, py, depth], -1), 0.0)
    rng = torch.where(valid, _sqrt(px * px + py * py + depth * depth), 1e30)
    # float64 then rounded once: the same angle on the card and the CPU
    ar = torch.atan(1.0 / focal.double()).float()
    return pts, rng, valid, ar


def _half(pts, rng, valid, ar):
    """Min-range 2x2 pooling (PCL getHalfImage); the first minimum in the
    native scan order (0,0), (0,1), (1,0), (1,1) wins ties."""
    H2, W2 = rng.shape[1] // 2, rng.shape[2] // 2
    best_r = best_p = None
    valid2 = torch.zeros_like(valid[:, :H2, :W2])
    for dy in (0, 1):
        for dx in (0, 1):
            v = valid[:, dy:2 * H2:2, dx:2 * W2:2]
            r = torch.where(v, rng[:, dy:2 * H2:2, dx:2 * W2:2], 1e30)
            p = pts[:, dy:2 * H2:2, dx:2 * W2:2]
            if best_r is None:
                best_r, best_p = r, p
            else:
                better = r < best_r
                best_r = torch.where(better, r, best_r)
                best_p = torch.where(better[..., None], p, best_p)
            valid2 = valid2 | v
    rng2 = torch.where(valid2, best_r, 1e30)
    p2 = torch.where(valid2[..., None], best_p, 0.0)
    return p2, rng2, valid2, ar * 2.0


# ---------------------------------------------------------------------------
# border extraction (one level)
# ---------------------------------------------------------------------------

_DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1))  # (dx, dy), the native DX/DY order


def _extract_borders(p, r, valid, ar):
    """(change, cdir, shadow) of one pyramid level; ar is (K,)."""
    vf = valid.to(torch.float32)
    rar = r * ar[:, None, None]

    # typical spacing: jump-excluded mean distance to the 8 direct neighbours
    thresh = _JUMP_FACTOR * r * ar[:, None, None]
    acc = torch.zeros_like(r)
    cnt = torch.zeros_like(r)
    for i in range(9):
        dy, dx = i // 3 - 1, i % 3 - 1
        d = _norm(_shift(p, dy, dx, 0.0) - p)
        ok = (_shift(vf, dy, dx, 0.0) > 0) & (d < thresh) & (i != 4)
        acc = acc + torch.where(ok, d, 0.0)
        cnt = cnt + ok
    spacing = torch.where(cnt > 0, acc / torch.clamp(cnt, min=1.0), rar)
    max_nb = _SPACING_FACTOR * torch.maximum(spacing, rar)
    spacing2 = max_nb * max_nb

    # PCA normals over the 5x5 window, excluding jumps
    n_sum = torch.zeros_like(p)
    o_sum = torch.zeros(p.shape[:-1] + (6,), dtype=p.dtype, device=p.device)
    n_cnt = torch.zeros_like(r)
    for i in range(25):
        dy, dx = i // 5 - 2, i % 5 - 2
        rel = _shift(p, dy, dx, 0.0) - p
        ok = (_shift(vf, dy, dx, 0.0) > 0) & valid & (_dot(rel, rel) <= 4.0 * spacing2)
        rel = torch.where(ok[..., None], rel, 0.0)
        n_sum = n_sum + rel
        o_sum = o_sum + _outer6(rel)
        n_cnt = n_cnt + ok
    inv = 1.0 / torch.clamp(n_cnt, min=1.0)
    mean = n_sum * inv[..., None]
    cov = o_sum * inv[..., None] - _outer6(mean)
    _, _, emin = _eigvals3(cov)
    normal = _eigvec3(cov, emin)
    normal = torch.where((_dot(normal, p) > 0)[..., None], -normal, normal)
    has_normal = (n_cnt >= 3) & valid

    # 4-direction border probabilities from 1d point averages
    bscores, nbs, nbcnts, fars = [], [], [], []
    for dx, dy in _DIRS:
        nb_sum = torch.zeros_like(p)
        nb_cnt = torch.zeros_like(r)
        alive = torch.ones_like(valid)
        far = torch.zeros_like(valid)
        for i in range(1, 4):  # kBorderLookPx
            vq = _shift(vf, i * dy, i * dx, 0.0) > 0
            rq = _shift(r, i * dy, i * dx, 0.0)  # out of bounds: not far
            far = far | (alive & ~vq & (rq >= 5e29))
            add = alive & vq
            nb_sum = nb_sum + torch.where(add[..., None],
                                          _shift(p, i * dy, i * dx, 0.0), 0.0)
            nb_cnt = nb_cnt + add
            alive = add
        nb = nb_sum / torch.clamp(nb_cnt, min=1.0)[..., None]
        dnb = nb - p
        d2 = _dot(dnb, dnb)
        s = torch.where(d2 > spacing2,
                        1.0 - _sqrt(spacing2 / torch.clamp(d2, min=1e-20)), 0.0)
        s = torch.where(_norm(nb) < r, -s, s)
        s = torch.where(nb_cnt > 0, s, far.to(torch.float32))
        bscores.append(torch.where(valid, s, 0.0))
        nbs.append(nb)
        nbcnts.append(nb_cnt)
        fars.append(far)

    # obstacle borders (direction-local maxima above threshold); the
    # background side of each jump becomes a shadow border
    obstacle = torch.zeros_like(valid)
    shadow = torch.zeros_like(valid)
    for d, (dx, dy) in enumerate(_DIRS):
        s = bscores[d]
        is_max = torch.ones_like(valid)
        for k in (1, 2):
            is_max = is_max & (_shift(s, k * dy, k * dx, -1.0) <= s)
        hit = valid & (s >= _MIN_BORDER_PROB) & is_max
        obstacle = obstacle | hit
        moved = _shift(hit.to(torch.float32), -dy, -dx, 0.0) > 0
        shadow = shadow | (moved & valid & (r > _shift(r, -dy, -dx, 1e30)))

    # surface change scores and directions: PCA of the normals along the
    # 8 beams of 2 steps (a step 2 only past a step 1 that is no shadow)
    usable = (valid & ~shadow & has_normal).to(torch.float32)
    shf = shadow.to(torch.float32)
    nn_sum = torch.zeros_like(p)
    no_sum = torch.zeros_like(o_sum)
    nn_cnt = torch.zeros_like(r)
    for j in (0, 1, 2, 3, 5, 6, 7, 8):  # the 3x3 beam grid without its centre
        by, bx = j // 3 - 1, j % 3 - 1
        u1 = _shift(usable, by, bx, 0.0) > 0
        sh1 = _shift(shf, by, bx, 0.0) > 0
        n1 = _shift(normal, by, bx, 0.0)
        nn_sum = nn_sum + torch.where(u1[..., None], n1, 0.0)
        no_sum = no_sum + torch.where(u1[..., None], _outer6(n1), 0.0)
        nn_cnt = nn_cnt + u1
        u2 = (_shift(usable, 2 * by, 2 * bx, 0.0) > 0) & ~sh1
        n2 = _shift(normal, 2 * by, 2 * bx, 0.0)
        nn_sum = nn_sum + torch.where(u2[..., None], n2, 0.0)
        no_sum = no_sum + torch.where(u2[..., None], _outer6(n2), 0.0)
        nn_cnt = nn_cnt + u2
    ninv = 1.0 / torch.clamp(nn_cnt, min=1.0)
    nmean = nn_sum * ninv[..., None]
    ncov = no_sum * ninv[..., None] - _outer6(nmean)
    emax, _, _ = _eigvals3(ncov)
    vmax = _eigvec3(ncov, emax)
    ok = (nn_cnt >= 3) & valid & ~shadow & ~obstacle
    change = torch.where(ok, torch.clamp(_sqrt(torch.clamp(emax, min=0.0)),
                                         max=1.0), 0.0)
    cdir = torch.where(ok[..., None], vmax, 0.0)

    # border pixels: score 1, direction across the border projected into
    # the tangent plane
    bacc = torch.zeros_like(p)
    ray = p / torch.clamp(_norm(p), min=1e-12)[..., None]
    for d in range(4):
        s = torch.where(bscores[d] >= _MIN_BORDER_PROB, bscores[d], 0.0)
        v = nbs[d] - p
        v = v / torch.clamp(_norm(v), min=1e-12)[..., None]
        v = torch.where((nbcnts[d] > 0)[..., None], v,
                        torch.where(fars[d][..., None], ray, 0.0))
        bacc = bacc + s[..., None] * v
    proj = bacc - _dot(bacc, normal)[..., None] * normal
    proj = torch.where(has_normal[..., None], proj, bacc)
    pn = _norm(proj)
    bdir = torch.where((pn > 1e-12)[..., None],
                       proj / torch.clamp(pn, min=1e-12)[..., None], 0.0)
    change = torch.where(obstacle, 1.0, change)
    cdir = torch.where(obstacle[..., None], bdir, cdir)

    # blur: 3x3 score mean + radius-2 sign-aligned direction smoothing
    live = valid & ~shadow
    lf = live.to(torch.float32)
    ssum = torch.zeros_like(r)
    scnt = torch.zeros_like(r)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            lv = _shift(lf, dy, dx, 0.0) > 0
            ssum = ssum + torch.where(lv, _shift(change, dy, dx, 0.0), 0.0)
            scnt = scnt + lv
    dsum = torch.zeros_like(p)
    for i in range(25):
        dy, dx = i // 5 - 2, i % 5 - 2
        lv = _shift(lf, dy, dx, 0.0) > 0
        v = _shift(cdir, dy, dx, 0.0)
        sgn = torch.where(_dot(v, cdir) < 0, -1.0, 1.0)
        c = _shift(change, dy, dx, 0.0)
        dsum = dsum + torch.where(lv[..., None], (c * sgn)[..., None] * v, 0.0)
    change_b = torch.where(live, ssum / torch.clamp(scnt, min=1.0), 0.0)
    dn = _norm(dsum)
    cdir_b = torch.where((dn > 1e-12)[..., None],
                         dsum / torch.clamp(dn, min=1e-12)[..., None], 0.0)
    return change_b, cdir_b, shadow


def _u16_codes(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint16 codes: clip, scale, round half to even."""
    q = torch.round(torch.clamp(x, 0.0, 1.0) * 65535.0)
    return q.to(torch.int32).to(torch.uint16)


def _quantize(change, cdir, shadow):
    cd = torch.round(torch.clamp(cdir, -1.0, 1.0) * 127.0)
    return _u16_codes(change), cd.to(torch.int8), shadow.to(torch.uint8)


@torch.no_grad()
def narf_border_maps(depth_m: torch.Tensor, focal: torch.Tensor,
                     n_levels: int, max_range: float = 128.0):
    """(K, H, W) metric depth + (K,) per-view focal -> tuple over pyramid
    levels of (change uint16 (K, h, w), cdir int8 (K, h, w, 3), shadow
    uint8 (K, h, w)) codes, on depth_m's device.

    All levels are computed for every view (coarse levels are cheap); the
    caller keeps each view's own ``n_levels_for(focal)`` prefix."""
    depth_m = depth_m.to(torch.float32)
    focal = focal.to(device=depth_m.device, dtype=torch.float32)
    pts, rng, valid, ar = _level0(depth_m, focal, max_range)
    out = [_quantize(*_extract_borders(pts, rng, valid, ar))]
    for _ in range(1, n_levels):
        pts, rng, valid, ar = _half(pts, rng, valid, ar)
        out.append(_quantize(*_extract_borders(pts, rng, valid, ar)))
    return tuple(out)


def border_maps_for_views(depth_m, focal, max_range: float = 128.0):
    """(K, H, W) metric depth + per-view focals, numpy -> per view a list of
    numpy (change, cdir, shadow) tuples, cut to that view's pyramid depth
    (n_levels_for); computed on the CPU."""
    depth_m = torch.from_numpy(np.asarray(depth_m, np.float32))
    focal_np = np.asarray(focal, np.float64)
    K, H, W = depth_m.shape
    n_levels = max_levels_for(H, W)
    maps = narf_border_maps(depth_m, torch.from_numpy(focal_np), n_levels,
                            max_range)
    maps = [tuple(m.cpu().numpy() for m in lvl) for lvl in maps]
    per_view = []
    for k in range(K):
        S = min(n_levels, n_levels_for(float(focal_np[k]), H, W))
        per_view.append([(lvl[0][k], lvl[1][k], lvl[2][k]) for lvl in maps[:S]])
    return per_view
