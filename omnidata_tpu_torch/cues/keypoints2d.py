"""2D keypoints: SURF determinant-of-Hessian "interest image".

The reference's _blob_doh without NMS: integral image -> box-filter Hessian
determinant (skimage _hessian_det_appx, the SURF approximation) at 10
sigmas linspace(1, 30, 10) -> max over scales. Every box sum is four
shifted slices of a padded integral image: top/left zero-padded (indices
< 0 contribute 0), bottom/right edge-padded (indices clipped).

The float32 integral image sums in a device-dependent order, so codes near
a quantisation edge can differ between CPU and GPU by one step.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_PAD = 128  # covers offsets for sigma <= 30 (size = 90, offsets < 92)


def integral_image(img: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(torch.cumsum(img, -2), -1)


def _pad_integral(ii: torch.Tensor) -> torch.Tensor:
    """(N,H,W) -> (N,H+2P,W+2P): zero top/left, edge bottom/right."""
    x = F.pad(ii[:, None], (0, _PAD, 0, _PAD), mode="replicate")[:, 0]
    return F.pad(x, (_PAD, 0, _PAD, 0))


def _box_sum(padded: torch.Tensor, H: int, W: int, r0: int, c0: int,
             rl: int, cl: int) -> torch.Tensor:
    """Sum of img[p+r0 : p+r0+rl, q+c0 : q+c0+cl] for every pixel (p,q)."""

    def at(dr, dc):
        return padded[:, _PAD + dr:_PAD + dr + H, _PAD + dc:_PAD + dc + W]

    r1, c1 = r0 - 1, c0 - 1
    r2, c2 = r0 + rl - 1, c0 + cl - 1
    return at(r2, c2) - at(r1, c2) - at(r2, c1) + at(r1, c1)


def hessian_det_appx(padded: torch.Tensor, H: int, W: int,
                     sigma: float) -> torch.Tensor:
    """SURF box-filter Hessian determinant at one scale."""
    size = int(3 * sigma)
    s2 = (size - 1) // 2
    s3 = size // 3
    w = size
    w_i = 1.0 / (size * size)

    def box(r0, c0, rl, cl):
        return _box_sum(padded, H, W, r0, c0, rl, cl)

    # Dxy: four s3 x s3 corner boxes
    tl = box(-s3, -s3, s3, s3)
    br = box(1, 1, s3, s3)
    bl = box(1, -s3, s3, s3)
    tr = box(-s3, 1, s3, s3)
    dxy = -(bl + tr - tl - br) * w_i

    # Dxx: wide middle band minus 3x the central lobe
    mid = box(-s3 + 1, -s2, 2 * s3 - 1, w)
    side = box(-s3 + 1, -(s3 // 2), 2 * s3 - 1, s3)
    dxx = -(mid - 3.0 * side) * w_i

    mid = box(-s2, -s3 + 1, w, 2 * s3 - 1)
    side = box(-(s3 // 2), -s3 + 1, s3, 2 * s3 - 1)
    dyy = -(mid - 3.0 * side) * w_i

    return dxx * dyy - 0.81 * (dxy * dxy)


def keypoints2d(gray: torch.Tensor, min_sigma: float = 1.0,
                max_sigma: float = 30.0, num_sigma: int = 10) -> torch.Tensor:
    """DoH interest image from (N,H,W) grayscale in [0,1]."""
    H, W = gray.shape[-2:]
    padded = _pad_integral(integral_image(gray.to(torch.float32)))
    resp = None
    for s in np.linspace(min_sigma, max_sigma, num_sigma):
        r = hessian_det_appx(padded, H, W, float(s))
        resp = r if resp is None else torch.maximum(resp, r)
    return resp
