"""The plain reference of the annotator's device labels, one view at a time,
in plain PyTorch on any device.

From the raw scene arrays and one camera it casts a ray through every pixel
centre, intersects it (Moller-Trumbore) with every face whose screen
bounding box touches the pixel's tile, keeps the nearest hit (the lowest
face id on a tie of t), and derives the ten label images of omnidata's
annotator from the winning face: z-buffer and euclidean depth, the valid
mask, camera-frame normals, reshading, RGB, principal curvature, occlusion
edges, texture edges and 2D keypoints. The formulas and encodings are the
annotator's as the port documents them; nothing is imported from the port.

``dtype`` is the precision of every step (bounding boxes excepted, which
only choose the candidates and carry a pixel of slack): float32 is the
reference; a lower one is the control that the comparison must reject.
Convolutions run with TF32 off.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEAR = 1e-4
EPS = 1e-7
EDGE_EPS = 1e-5
DEPTH_MAX_M = 128.0
LAMP_ENERGY = 2.5
LAMP_HALF_LIFE_M = 8.0
MISS = torch.iinfo(torch.int64).max
PAIRS_PER_BLOCK = 1 << 22  # pixel-face tests per step (memory bound)


def camera_rays(loc, R, fov, res: int, dtype):
    """Unit world-space rays through the pixel centres (H,W,3); the camera
    looks down its -Z with +Y up (Blender's frame)."""
    f = (res / 2.0) / torch.tan(fov.to(dtype) / 2.0)
    u = torch.arange(res, dtype=dtype, device=R.device) + 0.5
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    x, y = (uu - res / 2.0) / f, (vv - res / 2.0) / f
    d = torch.stack([x, -y, -torch.ones_like(x)], -1)
    d = (d[..., None, :] * R.to(dtype)).sum(-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def screen_boxes(tris, loc, R, fov, res: int):
    """Per-face screen boxes lo, hi (F,2) in pixels (float32) and a live
    mask: faces wholly behind the near plane, or off screen, are dead; a
    face crossing it is boxed over its vertices in front and the points
    where its edges cross the plane."""
    f = (res / 2.0) / torch.tan(fov / 2.0)
    cam = (tris - loc) @ R  # camera frame (Blender): x right, y up, -z ahead
    x, y, z = cam[..., 0], -cam[..., 1], -cam[..., 2]  # z: depth ahead

    def uv(px, py, pz):
        pz = torch.clamp(pz, min=NEAR)
        return torch.stack([f * px / pz + res / 2.0, f * py / pz + res / 2.0], -1)

    front = z > NEAR
    big = torch.tensor(1e9, device=tris.device)
    pts = uv(x, y, z)  # (F,3,2)
    lo = torch.where(front[..., None], pts, big).amin(1)
    hi = torch.where(front[..., None], pts, -big).amax(1)
    for i in range(3):
        j = (i + 1) % 3
        za, zb = z[:, i], z[:, j]
        cross = (za > NEAR) != (zb > NEAR)
        s = (NEAR - za) / torch.where(zb == za, 1.0, zb - za)
        pc = uv(x[:, i] + s * (x[:, j] - x[:, i]), y[:, i] + s * (y[:, j] - y[:, i]),
                torch.full_like(za, NEAR))
        lo = torch.minimum(lo, torch.where(cross[:, None], pc, big))
        hi = torch.maximum(hi, torch.where(cross[:, None], pc, -big))
    live = front.any(1) & (hi >= 0).all(1) & (lo <= res).all(1)
    return lo, hi, live


def face_tile_pairs(lo, hi, live, res: int, tile: int):
    """(face, tile) pairs whose box, widened by one pixel, meets the tile."""
    n1d = res // tile
    t0 = torch.clamp(torch.floor((lo - 1.0) / tile), 0, n1d - 1).long()
    t1 = torch.clamp(torch.floor((hi + 1.0) / tile), 0, n1d - 1).long()
    nx = t1[:, 0] - t0[:, 0] + 1
    ny = t1[:, 1] - t0[:, 1] + 1
    n = torch.where(live, nx * ny, 0)
    face = torch.repeat_interleave(torch.arange(len(n), device=lo.device), n)
    k = torch.arange(len(face), device=lo.device) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    tx = t0[face, 0] + k % nx[face]
    ty = t0[face, 1] + k // nx[face]
    return face, ty * n1d + tx


def intersect(o, d, v0, e1, e2):
    """Moller-Trumbore: (t, u, v, hit) of rays d from o with faces
    (v0, e1, e2), broadcast."""
    p = torch.linalg.cross(d, e2.expand_as(d))
    det = (e1 * p).sum(-1)
    tv = o - v0
    q = torch.linalg.cross(tv, e1.expand_as(tv))
    ok = det.abs() >= EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    u = (tv * p).sum(-1) * inv
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    hit = ok & (u >= -EDGE_EPS) & (v >= -EDGE_EPS) & (u + v <= 1.0 + EDGE_EPS) & (t > EPS)
    return t, u, v, hit


def rasterize(V, Fc, loc, R, fov, res: int, tile: int, dtype):
    """Nearest hit per pixel -> (face (H,W) int64, -1 on a miss; rays
    (H,W,3) in dtype)."""
    dev = V.device
    n1d, P = res // tile, tile * tile
    tris32 = V[Fc]
    lo, hi, live = screen_boxes(tris32, loc, R, fov, res)
    face, tid = face_tile_pairs(lo, hi, live, res, tile)
    dirs = camera_rays(loc, R, fov, res, dtype)
    tdirs = dirs.reshape(n1d, tile, n1d, tile, 3).transpose(1, 2).reshape(
        n1d * n1d, P, 3)
    tris = tris32.to(dtype)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    o = loc.to(dtype)
    best = torch.full((n1d * n1d * P,), MISS, dtype=torch.int64, device=dev)
    pix = torch.arange(P, device=dev)
    step = max(1, PAIRS_PER_BLOCK // P)
    for s in range(0, len(face), step):
        fb, tb = face[s:s + step], tid[s:s + step]
        d = tdirs[tb]  # (B,P,3)
        t, _, _, hit = intersect(o, d, v0[fb, None], e1[fb, None], e2[fb, None])
        key = (t.float().view(torch.int32).long() << 32) | fb[:, None]
        key = torch.where(hit, key, MISS)
        best.scatter_reduce_(0, (tb[:, None] * P + pix).reshape(-1),
                             key.reshape(-1), "amin")
    win = torch.where(best == MISS, -1, best & 0xFFFFFFFF)
    win = win.reshape(n1d, n1d, tile, tile).transpose(1, 2).reshape(res, res)
    return win, dirs


# ---- the label images ------------------------------------------------------

def _u16(x):
    return torch.round(torch.clamp(x.float(), 0.0, 1.0) * 65535).to(torch.int32)


def _u8(x):
    return torch.round(torch.clamp(x.float(), 0.0, 1.0) * 255).to(torch.int32)


def _depth_code(m, valid):
    code = torch.round(torch.clamp(m.float() / DEPTH_MAX_M, 0.0, 1.0) * 65535)
    return torch.where(valid, code, 65535.0).to(torch.int32)


def _gauss_1d(sigma: float) -> np.ndarray:
    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _conv(img, k: np.ndarray, pad):
    w = torch.as_tensor(k, dtype=img.dtype, device=img.device)[None, None]
    return F.conv2d(img[None, None], w, padding=pad)[0, 0]


def _blur(img, sigma: float):
    """Separable gaussian, zero outside (scipy's mode='constant')."""
    k = _gauss_1d(sigma)
    r = (len(k) - 1) // 2
    return _conv(_conv(img, k[:, None], (r, 0)), k[None, :], (0, r))


_SOBEL = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float64) / 4.0


def _sobel(img, mask):
    """skimage's sobel: magnitude / sqrt 2, zero where the 3x3 neighbourhood
    leaves the mask (the image frame included)."""
    h = _conv(img, _SOBEL, (1, 1))
    v = _conv(img, _SOBEL.T.copy(), (1, 1))
    mag = torch.sqrt(h * h + v * v) / math.sqrt(2.0)
    m = F.pad(mask.float(), (1, 1, 1, 1))
    inner = -F.max_pool2d(-m[None, None], 3, stride=1)[0, 0] > 0.5
    return torch.where(inner, mag, 0.0)


def edge_texture(gray):
    """Masked smoothing (sigma 3, all pixels in the mask) then sobel."""
    ones = torch.ones_like(gray)
    sm = _blur(gray, 3.0) / (_blur(ones, 3.0) + torch.finfo(gray.dtype).eps)
    return _sobel(sm, ones > 0)


def edge_occlusion(depth_code, dtype):
    """Sobel of sqrt(code) / 256 inside the mask code < 65036."""
    x = torch.sqrt(depth_code.to(dtype)) / 256.0
    return _sobel(x, depth_code < 65536 - 500)


def keypoints2d(gray):
    """SURF determinant-of-Hessian interest image, the maximum over 10 sigmas
    in [1, 30], box sums from an integral image (zero before the image,
    edge values past it)."""
    H, W = gray.shape
    pad = 128
    ii = torch.cumsum(torch.cumsum(gray, 0), 1)
    ii = F.pad(ii[None, None], (0, pad, 0, pad), mode="replicate")[0, 0]
    ii = F.pad(ii, (pad, 0, pad, 0))

    def box(r0, c0, rl, cl):
        def at(dr, dc):
            return ii[pad + dr:pad + dr + H, pad + dc:pad + dc + W]
        r1, c1, r2, c2 = r0 - 1, c0 - 1, r0 + rl - 1, c0 + cl - 1
        return at(r2, c2) - at(r1, c2) - at(r2, c1) + at(r1, c1)

    resp = None
    for s in np.linspace(1.0, 30.0, 10):
        size = int(3 * float(s))
        s2, s3, wi = (size - 1) // 2, size // 3, 1.0 / (size * size)
        dxy = -(box(1, -s3, s3, s3) + box(-s3, 1, s3, s3)
                - box(-s3, -s3, s3, s3) - box(1, 1, s3, s3)) * wi
        dxx = -(box(-s3 + 1, -s2, 2 * s3 - 1, size)
                - 3.0 * box(-s3 + 1, -(s3 // 2), 2 * s3 - 1, s3)) * wi
        dyy = -(box(-s2, -s3 + 1, size, 2 * s3 - 1)
                - 3.0 * box(-(s3 // 2), -s3 + 1, s3, 2 * s3 - 1)) * wi
        r = dxx * dyy - 0.81 * (dxy * dxy)
        resp = r if resp is None else torch.maximum(resp, r)
    return resp


def labels(V, Fc, attrs, loc, R, fov, res: int, tile: int, dtype=torch.float32,
           raster=None):
    """The ten label images of one view -> ({name: (H,W[,C]) int32 tensor},
    winning faces). attrs: per-vertex (normals (V,3), colours (V,3),
    curvature colours (V,3)); rows not needed by the view may be zero.
    raster: ``rasterize``'s result for this view, if already made."""
    win, dirs = raster or rasterize(V, Fc, loc, R, fov, res, tile, dtype)
    valid = win >= 0
    fi = win.clamp(min=0)
    tri = V[Fc[fi]].to(dtype)  # (H,W,3,3)
    o = loc.to(dtype)
    t, u, v, _ = intersect(o, dirs, tri[..., 0, :], tri[..., 1, :] - tri[..., 0, :],
                           tri[..., 2, :] - tri[..., 0, :])
    t = torch.where(valid, t, 1e30)
    w = torch.stack([1.0 - u - v, u, v], -1)[..., None]  # (H,W,3,1)

    def interp(a):
        return (a[Fc[fi]].to(dtype) * w).sum(-2)

    normals, colors, curv = attrs
    out = {}
    fwd = -R[:, 2].to(dtype)
    z = t * (dirs * fwd).sum(-1)
    out["depth_zbuffer"] = _depth_code(z, valid)
    out["depth_euclidean"] = _depth_code(t, valid)
    out["mask_valid"] = valid.to(torch.int32) * 255
    n = interp(normals)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    nc = (n[..., None, :] * R.to(dtype).T).sum(-1)  # R^T n
    col = torch.stack([0.5 - 0.5 * nc[..., 0], 0.5 + 0.5 * nc[..., 1],
                       0.5 + 0.5 * nc[..., 2]], -1)
    col = torch.where(valid[..., None], torch.clamp(col, 0.0, 1.0), 0.5)
    out["normal"] = _u8(col)
    cos = torch.abs((n * -dirs).sum(-1))
    d2 = LAMP_HALF_LIFE_M ** 2
    shade = LAMP_ENERGY * (d2 / (d2 + t * t)) * cos
    out["reshading"] = _u8(torch.where(valid, torch.clamp(shade, 0.0, 1.0), 0.0))
    rgb = torch.where(valid[..., None], torch.clamp(interp(colors), 0.0, 1.0), 0.0)
    out["rgb"] = _u8(rgb)
    gray = rgb.mean(-1)
    out["edge_texture"] = _u16(edge_texture(gray))
    out["keypoints2d"] = _u16(keypoints2d(gray))
    cc = torch.where(valid[..., None], torch.clamp(interp(curv), 0.0, 1.0), 0.0)
    out["principal_curvature"] = _u8(cc)
    out["edge_occlusion"] = _u16(edge_occlusion(out["depth_zbuffer"], dtype))
    return out, win
