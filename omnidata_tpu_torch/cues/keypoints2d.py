"""2D keypoints: SURF determinant-of-Hessian "interest image".

The reference's _blob_doh without NMS: integral image -> box-filter Hessian
determinant (skimage _hessian_det_appx, the SURF approximation) at 10
sigmas linspace(1, 30, 10) -> max over scales. Two routes after the
integral image (two ``torch.cumsum``s on either device): on CUDA tensors
one hand-written kernel (``csrc/keypoints2d.cu``, ``keypoints2d_kernel``)
computes every scale's box sums, determinant and the maximum over scales
in one pass, equal to the plain version on the card bit for bit; on CPU
tensors the plain version, ``keypoints2d_reference``: every box sum is four
shifted slices of a padded integral image, top/left zero-padded (indices
< 0 contribute 0), bottom/right edge-padded (indices clipped).

The float32 integral image sums in a device-dependent order, so codes near
a quantisation edge can differ between CPU and GPU by one step.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._build import call_kernel
from ..utils import profiler

_PAD = 128  # covers offsets for sigma <= 30 (size = 90, offsets < 92)
_KERNEL_SCALES = 16  # scales the kernel takes (csrc/keypoints2d.cu: kScales)


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


def keypoints2d_reference(gray: torch.Tensor, min_sigma: float = 1.0,
                          max_sigma: float = 30.0,
                          num_sigma: int = 10) -> torch.Tensor:
    """Plain version of ``keypoints2d`` on any device."""
    H, W = gray.shape[-2:]
    padded = _pad_integral(integral_image(gray.to(torch.float32)))
    resp = None
    for s in np.linspace(min_sigma, max_sigma, num_sigma):
        r = hessian_det_appx(padded, H, W, float(s))
        resp = r if resp is None else torch.maximum(resp, r)
    return resp


def keypoints2d(gray: torch.Tensor, min_sigma: float = 1.0,
                max_sigma: float = 30.0, num_sigma: int = 10) -> torch.Tensor:
    """DoH interest image from (N,H,W) grayscale in [0,1], float32 (N,H,W):
    CPU tensors take ``keypoints2d_reference``; CUDA tensors the kernel on
    their integral image (``keypoints2d_kernel``)."""
    if gray.device.type == "cpu":
        return keypoints2d_reference(gray, min_sigma, max_sigma, num_sigma)
    return keypoints2d_kernel(integral_image(gray.to(torch.float32)),
                              min_sigma, max_sigma, num_sigma)


def _scale_rows(min_sigma: float, max_sigma: float,
                num_sigma: int) -> np.ndarray:
    """The kernel's int32 row a sigma of the linspace: size, s2, s3,
    s3 // 2, reach (the largest |offset| of a corner that
    ``hessian_det_appx`` reads) and the float32 bits of its weight; raises
    on more scales than the kernel takes and where a reach passes the plain
    version's pad."""
    if not 1 <= num_sigma <= _KERNEL_SCALES:
        raise ValueError(f"keypoints2d: num_sigma {num_sigma} must be 1 to "
                         f"{_KERNEL_SCALES}")
    rows = []
    for sigma in np.linspace(min_sigma, max_sigma, num_sigma):
        size = int(3 * float(sigma))
        s2, s3 = (size - 1) // 2, size // 3
        h3 = s3 // 2
        w_i = 1.0 / (size * size)
        boxes = ((-s3, -s3, s3, s3), (1, 1, s3, s3), (1, -s3, s3, s3),
                 (-s3, 1, s3, s3), (-s3 + 1, -s2, 2 * s3 - 1, size),
                 (-s3 + 1, -h3, 2 * s3 - 1, s3),
                 (-s2, -s3 + 1, size, 2 * s3 - 1),
                 (-h3, -s3 + 1, s3, 2 * s3 - 1))
        reach = max(abs(o) for r0, c0, rl, cl in boxes
                    for o in (r0 - 1, c0 - 1, r0 + rl - 1, c0 + cl - 1))
        if reach > _PAD:
            raise ValueError(f"keypoints2d: sigma {float(sigma)} reaches "
                             f"{reach} pixels, past the pad of {_PAD}")
        w_bits = int(np.float32(w_i).view(np.int32))
        rows.append((size, s2, s3, h3, reach, w_bits))
    return np.array(rows, dtype=np.int32).reshape(-1, 6)


def keypoints2d_kernel(ii: torch.Tensor, min_sigma: float = 1.0,
                       max_sigma: float = 30.0,
                       num_sigma: int = 10) -> torch.Tensor:
    """The kernel of ``csrc/keypoints2d.cu`` on an (N,H,W) float32,
    contiguous CUDA integral image -> the maximum over scales, (N,H,W)
    float32, equal to ``keypoints2d_reference`` on the card bit for bit.
    Built on first use; raises on what it does not take or if it fails to
    build or launch. Each call adds one to ``keypoints2d.launches`` and,
    while the recorder records, N to counter ``keypoints2d.images_fused``."""
    checks = [
        (ii.device.type == "cuda", lambda: f"no kernel for {ii.device}"),
        (ii.dtype == torch.float32, lambda: f"float32 only, got {ii.dtype}"),
        (ii.dim() == 3 and ii.numel() > 0,
         lambda: f"a non-empty (N, H, W) image, got {tuple(ii.shape)}"),
        (ii.is_contiguous(), lambda: "the integral image must be contiguous"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"keypoints2d_kernel: {msg()}")
    scales = _scale_rows(min_sigma, max_sigma, num_sigma)
    N, H, W = ii.shape
    with torch.cuda.device(ii.device):
        out = torch.empty_like(ii)
        call_kernel("keypoints2d", "keypoints2d_launch",
                    [ii.data_ptr(), out.data_ptr(), scales.ctypes.data],
                    [N, H, W, len(scales)])
    keypoints2d.launches += 1
    if profiler.recording():
        profiler.count("keypoints2d.images_fused", N)
    return out


keypoints2d.launches = 0
