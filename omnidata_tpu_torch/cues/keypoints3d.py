"""3D keypoints: multi-scale NARF interest image from a depth map.

Counterpart of the reference's native keypoints3d path
(create_keypoints_3d_images.py:53-113 shelling out to the PCL NARF binary;
scripts/narf_interest_image.cpp + pcl_narf.{h,hpp}). The native component is
native/narf.cpp of this package (self-contained C++, built on first use with
g++ -O3 -shared into build/native/), driven through ctypes — plus a numpy twin of the same
operator (_narf_numpy) used as the fallback and for cross-validation.

The operator (Steder et al., ICRA 2011, matching pcl_narf.hpp:205-470):
recursive half-resolution range-image scale space, per-scale border
extraction (obstacle/shadow classification against the local point spacing,
surface-change magnitude/direction from beam-blocked normal covariance,
border direction projected into the tangent plane), region-grown 18-bin
direction histograms with the optimal-distance profile, and bilinear
coarse-to-fine combination (close points read the next-coarser scale).
Golden corr 0.60-0.68 vs the published hm3d interest images under the
reference's own decode configuration (see test_golden_labels.py).

Contract matches the reference's script: depth in meters (16-bit code *
sensitivity), focal from FOV, support size in meters (settings.py:115),
output interest in [0,1], scaled by 2^16 into a 16-bit PNG.

Why this cue stays on the host (device-path analysis, round 4): the
pyramid + border extraction + surface-change stages are convolution-shaped
and would map to the TPU cleanly, but the interest computation itself
(_interest_level, pcl_narf.hpp:330-470) is a per-pixel region growing: a
BFS from each seed over the range image that stops at border pixels and at
the support_size/2 3D radius, feeding 18-bin direction histograms of the
GROWN region. The frontier is data-dependent in both size and shape —
under jit it would need a bounded lax.while_loop over a worst-case
(support-radius)^2 window per pixel with a connectivity mask recomputed
per step, i.e. O(window^2) work per pixel of mostly-masked lanes, and the
golden-parity contract (corr 0.60-0.68 vs published hm3d labels) rules out
the cheap approximation (fixed-window gather without connectivity, which
bleeds interest across occlusion borders — exactly the structure NARF
exists to respect). Measured host split on 512^2 (1 core): keypoints3d
native 1.9 s vs segment_25d 1.7 s + segment_2d 0.5 s — so round 4 instead
removed the scipy.sparse overhead from the ncut recursion shared by BOTH
segmentation cues (segmentation.py cut_normalized dense path: 2.5x each),
which moves the full13 rate more than a NARF device port of the
convolution prefix (~30% of its 1.9 s) would.
"""
from __future__ import annotations

import ctypes

import numpy as np

def _build_and_load():
    """The native NARF core, built from this package's native/narf.cpp on
    first use (``_build.load_host_library``)."""
    from .._build import load_host_library

    lib = load_host_library("narf")
    lib.narf_interest_image.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
    ]
    lib.narf_interest_image.restype = None
    lib.narf_interest_image_from_maps.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ushort), ctypes.POINTER(ctypes.c_byte),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_float),
    ]
    lib.narf_interest_image_from_maps.restype = ctypes.c_int
    return lib


def narf_interest_image(
    depth_m: np.ndarray,
    focal_px: float,
    support_size: float = 0.3,
    max_range: float = 128.0,
    backend: str = "native",
) -> np.ndarray:
    """Dense NARF-style interest image in [0,1] from metric depth (H,W)."""
    depth_m = np.ascontiguousarray(depth_m, np.float32)
    H, W = depth_m.shape
    if backend == "native":
        try:
            lib = _build_and_load()
        except Exception:
            backend = "numpy"
        else:
            out = np.empty((H, W), np.float32)
            lib.narf_interest_image(
                depth_m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                H, W, float(focal_px), float(focal_px),
                W / 2.0, H / 2.0, float(support_size), float(max_range),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return out
    return _narf_numpy(depth_m, focal_px, support_size, max_range)


def narf_interest_with_maps(
    depth_m: np.ndarray,
    focal_px: float,
    border_maps,
    support_size: float = 0.3,
    max_range: float = 128.0,
) -> np.ndarray:
    """Split-pipeline NARF: the convolution-shaped border prefix (74% of
    the host cost, measured) was computed on a device (``narf_device``:
    per-level quantized (change u16, cdir i8, shadow u8) tuples); only the
    data-dependent region-growing interest stage runs here. Falls back to
    the full native path on level-count mismatch (wrong focal/resolution
    pairing) or when the native library is unavailable."""
    depth_m = np.ascontiguousarray(depth_m, np.float32)
    H, W = depth_m.shape
    try:
        lib = _build_and_load()
    except Exception:
        return _narf_numpy(depth_m, focal_px, support_size, max_range)
    ch = np.ascontiguousarray(
        np.concatenate([np.asarray(m[0], np.uint16).ravel()
                        for m in border_maps]))
    cd = np.ascontiguousarray(
        np.concatenate([np.asarray(m[1], np.int8).reshape(-1, 3)
                        for m in border_maps]).ravel())
    sh = np.ascontiguousarray(
        np.concatenate([np.asarray(m[2], np.uint8).ravel()
                        for m in border_maps]))
    out = np.empty((H, W), np.float32)
    rc = lib.narf_interest_image_from_maps(
        depth_m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        H, W, float(focal_px), float(focal_px), W / 2.0, H / 2.0,
        float(support_size), float(max_range), len(border_maps),
        ch.ctypes.data_as(ctypes.POINTER(ctypes.c_ushort)),
        cd.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
        sh.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:  # pyramid mismatch: recompute fully natively
        lib.narf_interest_image(
            depth_m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            H, W, float(focal_px), float(focal_px), W / 2.0, H / 2.0,
            float(support_size), float(max_range),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    return out


_MIN_CHANGE = 0.2
_OPT_DIST = 0.25
_MIN_BORDER_PROB = 0.8
_ANGLE_BINS = 18
_JUMP_FACTOR = 4.0
_SPACING_FACTOR = 1.5
_OPT_PATCH = 10


class _Level:
    """One pyramid level of the planar range image (numpy twin of
    native/narf.cpp RangeLevel)."""

    def __init__(self, pts, rng, valid, ar):
        self.pts, self.rng, self.valid, self.ar = pts, rng, valid, ar
        self.H, self.W = valid.shape


def _level0(depth, f, cx, cy, max_range):
    H, W = depth.shape
    valid = (depth > 1e-6) & (depth < max_range)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    z = depth.astype(np.float32)
    pts = np.stack([(xs - cx) / f * z, (ys - cy) / f * z, z], -1)
    pts = np.where(valid[..., None], pts, 0.0)
    rng = np.where(valid, np.linalg.norm(pts, axis=-1), 1e30)
    return _Level(pts, rng.astype(np.float32), valid, float(np.arctan(1.0 / f)))


def _half(L: _Level) -> _Level:
    """min-range 2x2 pooling (PCL getHalfImage semantics)."""
    H2, W2 = L.H // 2, L.W // 2
    r4 = np.stack([L.rng[dy : 2 * H2 : 2, dx : 2 * W2 : 2]
                   for dy in (0, 1) for dx in (0, 1)])
    p4 = np.stack([L.pts[dy : 2 * H2 : 2, dx : 2 * W2 : 2]
                   for dy in (0, 1) for dx in (0, 1)])
    v4 = np.stack([L.valid[dy : 2 * H2 : 2, dx : 2 * W2 : 2]
                   for dy in (0, 1) for dx in (0, 1)])
    rr = np.where(v4, r4, 1e30)
    k = rr.argmin(0)
    ii, jj = np.mgrid[0:H2, 0:W2]
    return _Level(p4[k, ii, jj], rr[k, ii, jj], v4[k, ii, jj], L.ar * 2.0)


def _shift(a, dy, dx, fill=0.0):
    out = np.full_like(a, fill)
    ys0, ys1 = max(0, -dy), a.shape[0] - max(0, dy)
    xs0, xs1 = max(0, -dx), a.shape[1] - max(0, dx)
    out[ys0:ys1, xs0:xs1] = a[ys0 + dy : ys1 + dy, xs0 + dx : xs1 + dx]
    return out


def _extract_borders(L: _Level):
    """Borders + surface change (numpy twin of narf.cpp extract_borders)."""
    H, W = L.H, L.W
    p, r, valid = L.pts, L.rng, L.valid

    # typical spacing (jump-excluded mean distance to the 8 direct nbrs)
    acc = np.zeros((H, W), np.float32)
    cnt = np.zeros((H, W), np.float32)
    thresh = _JUMP_FACTOR * r * L.ar
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if not dy and not dx:
                continue
            q = np.stack([_shift(p[..., k], dy, dx) for k in range(3)], -1)
            vq = _shift(valid.astype(np.float32), dy, dx) > 0
            d = np.linalg.norm(q - p, axis=-1)
            ok = vq & (d < thresh)
            acc += np.where(ok, d, 0.0)
            cnt += ok
    spacing = np.where(cnt > 0, acc / np.maximum(cnt, 1), r * L.ar)
    max_nb = _SPACING_FACTOR * np.maximum(spacing, r * L.ar)
    spacing2 = (max_nb * max_nb).astype(np.float32)

    # PCA normals over the 5x5 window, excluding jumps (d^2 > 4*spacing2)
    n_sum = np.zeros((H, W, 3), np.float64)
    o_sum = np.zeros((H, W, 3, 3), np.float64)
    n_cnt = np.zeros((H, W), np.float64)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            q = np.stack([_shift(p[..., k], dy, dx) for k in range(3)], -1)
            vq = _shift(valid.astype(np.float32), dy, dx) > 0
            rel = q - p
            ok = vq & valid & (np.sum(rel * rel, -1) <= 4.0 * spacing2)
            rel = np.where(ok[..., None], rel, 0.0)
            n_sum += rel
            o_sum += rel[..., :, None] * rel[..., None, :]
            n_cnt += ok
    mean = n_sum / np.maximum(n_cnt, 1)[..., None]
    cov = o_sum / np.maximum(n_cnt, 1)[..., None, None] - (
        mean[..., :, None] * mean[..., None, :]
    )
    w_, v_ = np.linalg.eigh(cov + 1e-18 * np.eye(3))
    normal = v_[..., 0]  # smallest-eigenvalue eigenvector
    flip = np.sum(normal * p, -1) > 0
    normal = np.where(flip[..., None], -normal, normal).astype(np.float32)
    has_normal = (n_cnt >= 3) & valid

    # 4-direction border probabilities from 1d point averages (the per-
    # direction neighbor averages are reused by the border-direction pass
    # below — they're the most expensive dense loops in the extractor)
    DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1))  # (dx, dy)
    bscore = np.zeros((4, H, W), np.float32)
    nbs, nbcnts, fars = [], [], []
    for d, (dx, dy) in enumerate(DIRS):
        nb_sum = np.zeros((H, W, 3), np.float32)
        nb_cnt = np.zeros((H, W), np.float32)
        alive = np.ones((H, W), bool)
        far = np.zeros((H, W), bool)
        for i in range(1, 4):  # kBorderLookPx
            q = np.stack([_shift(p[..., k], i * dy, i * dx) for k in range(3)], -1)
            vq = _shift(valid.astype(np.float32), i * dy, i * dx, 0.0) > 0
            rq = _shift(L.rng, i * dy, i * dx, 0.0)  # OOB: not far
            hit_far = alive & ~vq & (rq >= 5e29)
            far |= hit_far
            add = alive & vq
            nb_sum += np.where(add[..., None], q, 0.0)
            nb_cnt += add
            alive = add
        nb = nb_sum / np.maximum(nb_cnt, 1)[..., None]
        nbs.append(nb)
        nbcnts.append(nb_cnt)
        fars.append(far)
        d2 = np.sum((nb - p) ** 2, -1)
        s = np.where(d2 > spacing2, 1.0 - np.sqrt(spacing2 / np.maximum(d2, 1e-20)), 0.0)
        s = np.where(np.linalg.norm(nb, axis=-1) < r, -s, s)
        s = np.where(nb_cnt > 0, s, np.where(far, 1.0, 0.0))
        bscore[d] = np.where(valid, s, 0.0)

    # obstacle borders (direction-local maxima above the probability
    # threshold); the background side of each jump becomes a shadow border
    obstacle = np.zeros((H, W), bool)
    shadow = np.zeros((H, W), bool)
    for d, (dx, dy) in enumerate(DIRS):
        s = bscore[d]
        is_max = np.ones((H, W), bool)
        for k in (1, 2):
            is_max &= _shift(s, k * dy, k * dx, -1.0) <= s
        hit = valid & (s >= _MIN_BORDER_PROB) & is_max
        obstacle |= hit
        moved = _shift(hit.astype(np.float32), -dy, -dx) > 0
        src_rng = _shift(L.rng, -dy, -dx, 1e30)  # the obstacle pixel's range
        shadow |= moved & valid & (L.rng > src_rng)

    # surface change scores + directions
    change = np.zeros((H, W), np.float32)
    cdir = np.zeros((H, W, 3), np.float32)
    # non-border: normal covariance over 8 beams blocked at shadow pixels
    nn_sum = np.zeros((H, W, 3), np.float64)
    no_sum = np.zeros((H, W, 3, 3), np.float64)
    nn_cnt = np.zeros((H, W), np.float64)
    usable = (valid & ~shadow & has_normal).astype(np.float32)
    for by in (-1, 0, 1):
        for bx in (-1, 0, 1):
            if not by and not bx:
                continue
            u1 = _shift(usable, by, bx) > 0
            sh1 = _shift(shadow.astype(np.float32), by, bx) > 0
            n1 = np.stack([_shift(normal[..., k], by, bx) for k in range(3)], -1)
            add1 = u1
            nn_sum += np.where(add1[..., None], n1, 0.0)
            no_sum += np.where(add1[..., None, None], n1[..., :, None] * n1[..., None, :], 0.0)
            nn_cnt += add1
            # step 2 only if step-1 pixel was not a shadow border
            u2 = (_shift(usable, 2 * by, 2 * bx) > 0) & ~sh1
            n2 = np.stack([_shift(normal[..., k], 2 * by, 2 * bx) for k in range(3)], -1)
            nn_sum += np.where(u2[..., None], n2, 0.0)
            no_sum += np.where(u2[..., None, None], n2[..., :, None] * n2[..., None, :], 0.0)
            nn_cnt += u2
    nmean = nn_sum / np.maximum(nn_cnt, 1)[..., None]
    ncov = no_sum / np.maximum(nn_cnt, 1)[..., None, None] - (
        nmean[..., :, None] * nmean[..., None, :]
    )
    wn, vn = np.linalg.eigh(ncov + 1e-18 * np.eye(3))
    ok = (nn_cnt >= 3) & valid & ~shadow & ~obstacle
    change = np.where(ok, np.minimum(1.0, np.sqrt(np.maximum(wn[..., 2], 0.0))), 0.0).astype(np.float32)
    cdir = np.where(ok[..., None], vn[..., 2], 0.0).astype(np.float32)

    # border pixels: score 1, direction across the border projected into the
    # tangent plane
    bacc = np.zeros((H, W, 3), np.float32)
    for d, (dx, dy) in enumerate(DIRS):
        s = np.where(bscore[d] >= _MIN_BORDER_PROB, bscore[d], 0.0)
        nb, nb_cnt, far = nbs[d], nbcnts[d], fars[d]
        v = nb - p
        v /= np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        ray = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-12)
        v = np.where((nb_cnt > 0)[..., None], v, np.where(far[..., None], ray, 0.0))
        bacc += s[..., None] * v
    proj = bacc - np.sum(bacc * normal, -1, keepdims=True) * normal
    proj = np.where(has_normal[..., None], proj, bacc)
    pn = np.linalg.norm(proj, axis=-1, keepdims=True)
    bdir = np.where(pn > 1e-12, proj / np.maximum(pn, 1e-12), 0.0)
    change = np.where(obstacle, 1.0, change)
    cdir = np.where(obstacle[..., None], bdir, cdir).astype(np.float32)

    # blur: 3x3 score mean + radius-2 sign-aligned direction smoothing
    ssum = np.zeros((H, W), np.float32)
    scnt = np.zeros((H, W), np.float32)
    live = (valid & ~shadow).astype(np.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            lv = _shift(live, dy, dx) > 0
            ssum += np.where(lv, _shift(change, dy, dx), 0.0)
            scnt += lv
    dsum = np.zeros((H, W, 3), np.float32)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            lv = _shift(live, dy, dx) > 0
            v = np.stack([_shift(cdir[..., k], dy, dx) for k in range(3)], -1)
            sgn = np.where(np.sum(v * cdir, -1) < 0, -1.0, 1.0)
            c = _shift(change, dy, dx)
            dsum += np.where(lv[..., None], (c * sgn)[..., None] * v, 0.0)
    change = np.where(live > 0, ssum / np.maximum(scnt, 1), 0.0)
    dn = np.linalg.norm(dsum, axis=-1, keepdims=True)
    cdir = np.where(dn > 1e-12, dsum / np.maximum(dn, 1e-12), 0.0).astype(np.float32)
    return change.astype(np.float32), cdir, shadow, spacing2


def _direction_angle(p, d):
    """nkdGetDirectionAngle: fold into [-pi/2, pi/2] in the viewer frame."""
    ez = p / max(np.linalg.norm(p), 1e-12)
    ex = np.cross([0.0, -1.0, 0.0], ez)
    n = np.linalg.norm(ex)
    ex = ex / n if n > 1e-6 else np.array([1.0, 0.0, 0.0])
    ey = np.cross(ez, ex)
    rx, ry = float(np.dot(ex, d)), float(np.dot(ey, d))
    ln = np.hypot(rx, ry)
    if ln < 1e-12:
        return 0.0
    a = 2.0 * np.arccos(np.clip(rx / ln, -1.0, 1.0))
    while a > np.pi:
        a -= 2 * np.pi
    while a < -np.pi:
        a += 2 * np.pi
    return 0.5 * a


def _interest_level(L, change, cdir, shadow, support_size, coarser, coarser_interest,
                    start_usage):
    H, W = L.H, L.W
    radius = 0.5 * support_size
    radius2 = radius * radius
    interest = np.zeros((H, W), np.float32)
    valid = L.valid
    for y in range(H):
        for x in range(W):
            if not valid[y, x] or shadow[y, x]:
                continue
            if coarser is not None and L.rng[y, x] < start_usage:
                fy, fx2 = y / 2.0, x / 2.0
                y0 = min(int(fy), coarser.H - 1)
                x0 = min(int(fx2), coarser.W - 1)
                y1 = min(y0 + 1, coarser.H - 1)
                x1 = min(x0 + 1, coarser.W - 1)
                ty, tx = fy - y0, fx2 - x0
                ci = coarser_interest
                interest[y, x] = (
                    (1 - ty) * ((1 - tx) * ci[y0, x0] + tx * ci[y0, x1])
                    + ty * ((1 - tx) * ci[y1, x0] + tx * ci[y1, x1])
                )
                continue
            p = L.pts[y, x]
            hist = np.zeros(_ANGLE_BINS, np.float32)
            neg = 1.0
            frontier = [(y, x)]
            touched = {(y, x)}
            fi = 0
            while fi < len(frontier):
                y2, x2 = frontier[fi]
                fi += 1
                if not valid[y2, x2] or shadow[y2, x2]:
                    continue
                px_dist = max(abs(x2 - x), abs(y2 - y))
                q = L.pts[y2, x2] - p
                d2 = float(np.dot(q, q))
                if px_dist > 2 and d2 > radius2:
                    continue
                for y3 in range(max(0, y2 - 1), min(y2 + 2, H)):
                    for x3 in range(max(0, x2 - 1), min(x2 + 2, W)):
                        if (y3, x3) not in touched:
                            touched.add((y3, x3))
                            frontier.append((y3, x3))
                s = change[y2, x2]
                if s < _MIN_CHANGE:
                    continue
                dist_factor = np.sqrt(d2) / radius
                n = 1.0 - 0.5 * s * max(1.0 - dist_factor / _OPT_DIST, 0.0)
                neg = min(neg, n * n)
                pos = s if px_dist < 2 else s * (1.0 - dist_factor)
                a = _direction_angle(p, cdir[y2, x2])
                cell = min(_ANGLE_BINS - 1,
                           int(np.floor((a + np.pi / 2) / np.pi * _ANGLE_BINS)))
                cell = max(0, cell)
                hist[cell] = max(hist[cell], pos)
            ac = 0.0
            nz = np.nonzero(hist)[0]
            for ii in range(len(nz)):
                for jj in range(ii + 1, len(nz)):
                    nd = 2.0 * (nz[jj] - nz[ii]) / _ANGLE_BINS
                    nd = nd if nd <= 1.0 else 2.0 - nd
                    ac = max(ac, hist[nz[ii]] * hist[nz[jj]] * nd)
            interest[y, x] = neg * np.sqrt(ac)
    return interest


def _narf_numpy(depth: np.ndarray, f: float, support_size: float,
                max_range: float) -> np.ndarray:
    """Numpy twin of native/narf.cpp — the same multi-scale border-aware
    operator (scale pyramid, border extraction, normal-covariance surface
    change, region-grown 18-bin interest). Used as the g++-less fallback and
    for cross-validation in tests."""
    H, W = depth.shape
    levels = [_level0(depth, f, W / 2.0, H / 2.0, max_range)]
    while 0.5 * levels[-1].ar < np.deg2rad(2.0) and min(
        levels[-1].W, levels[-1].H
    ) >= 16:
        levels.append(_half(levels[-1]))
    maps = [_extract_borders(L) for L in levels]
    S = len(levels)
    start_usage = [0.0] * S
    for s in range(S - 2, -1, -1):
        start_usage[s] = support_size / np.tan(_OPT_PATCH * levels[s + 1].ar)
    interest = [None] * S
    for s in range(S - 1, -1, -1):
        ch, cd, shd, _ = maps[s]
        coarser = levels[s + 1] if s + 1 < S else None
        ci = interest[s + 1] if s + 1 < S else None
        interest[s] = _interest_level(levels[s], ch, cd, shd, support_size,
                                      coarser, ci, start_usage[s])
    return np.clip(interest[0], 0.0, 1.0)


def keypoints3d_from_depth_code(
    depth_code_u16: np.ndarray,
    fov_rads: float,
    resolution: int,
    support_size: float = 0.3,
    max_meters: float = 128.0,
    backend: str = "native",
    border_maps=None,
) -> np.ndarray:
    """The reference script's contract (create_keypoints_3d_images.py:53-113):
    16-bit depth codes -> interest -> uint16 (x 2^16, clipped).

    border_maps: optional per-level device-computed border maps
    (narf_device.border_maps_for_views) — runs only the host interest
    stage (narf_interest_with_maps)."""
    depth_m = depth_code_u16.astype(np.float32) * (max_meters / 65535.0)
    import math

    focal = resolution / (2.0 * math.tan(fov_rads / 2.0))
    if border_maps is not None:
        interest = narf_interest_with_maps(
            depth_m, focal, border_maps, support_size, max_meters)
    else:
        interest = narf_interest_image(
            depth_m, focal, support_size, max_meters, backend)
    return np.clip(interest * 65536.0, 0, 65535).astype(np.uint16)
