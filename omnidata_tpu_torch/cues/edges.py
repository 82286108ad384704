"""Texture (2D) and occlusion (3D) edges, batched over a leading dim.

- edge_texture: masked gaussian smooth then Sobel magnitude, sigma 3.0.
- edge_occlusion: Sobel of sqrt-scaled depth restricted to the valid mask
  (depth < 2^16-500), 16-bit output. The reference computes a masked
  gaussian smooth here but drops the result, so the default reproduces
  sobel on unsmoothed sqrt depth; smooth=True applies it.

Sobel follows skimage.filters.sobel: kernels [[1,2,1],[0,0,0],[-1,-2,-1]]/4,
magnitude / sqrt(2), zeroed where the 3x3 neighbourhood leaves the mask.
``F.conv2d`` is cross-correlation, as JAX's ``conv_general_dilated`` is. On
a card, float32 convolutions must run with
``torch.backends.cudnn.allow_tf32 = False`` to stay float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter's kernel (radius = truncate*sigma)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv(img: torch.Tensor, kernel: np.ndarray, pad: tuple[int, int]):
    """(N,H,W) cross-correlation with a 2D kernel, zero padding (ph, pw).
    On the CPU each image is convolved alone: oneDNN picks its algorithm by
    batch size, and a view's labels must not depend on the batch it is
    annotated in (``annotator.distributed`` splits batches)."""
    w = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)[None, None]
    if img.device.type == "cpu" and img.shape[0] > 1:
        return torch.cat([F.conv2d(img[i:i + 1, None], w, padding=pad)[:, 0]
                          for i in range(img.shape[0])])
    return F.conv2d(img[:, None], w, padding=pad)[:, 0]


def gaussian_blur_constant(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian with zero boundary over (N,H,W), matching
    scipy.ndimage.gaussian_filter(mode='constant')."""
    k = _gaussian_kernel_1d(sigma)
    r = (k.shape[0] - 1) // 2
    x = _conv(img, k[:, None], (r, 0))
    return _conv(x, k[None, :], (0, r))


def smooth_with_mask(img: torch.Tensor, mask: torch.Tensor,
                     sigma: float) -> torch.Tensor:
    """Masked smoothing with bleed-over renormalization."""
    m = mask.to(img.dtype)
    bleed = gaussian_blur_constant(m, sigma)
    sm = gaussian_blur_constant(img * m, sigma)
    return sm / (bleed + torch.finfo(img.dtype).eps)


_SOBEL_H = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float32) / 4.0


def _binary_erosion_3x3(mask: torch.Tensor) -> torch.Tensor:
    """3x3 binary erosion with zero border: the image's 1-pixel frame is
    always eroded, like skimage's sobel mask."""
    m = F.pad(mask.to(torch.float32), (1, 1, 1, 1))
    return -F.max_pool2d(-m[:, None], 3, stride=1)[:, 0] > 0.5


def sobel_magnitude(img: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """skimage.filters.sobel over (N,H,W): sqrt(h^2+v^2)/sqrt(2),
    eroded-mask zeroed."""
    h = _conv(img, _SOBEL_H, (1, 1))
    v = _conv(img, _SOBEL_H.T.copy(), (1, 1))
    mag = torch.sqrt(h * h + v * v) / math.sqrt(2.0)
    if mask is not None:
        mag = torch.where(_binary_erosion_3x3(mask), mag, 0.0)
    return mag


def edge_texture(gray: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    """2D texture edges in [0,1] from (N,H,W) grayscale in [0,1]."""
    ones = torch.ones_like(gray, dtype=torch.bool)
    smoothed = smooth_with_mask(gray, ones, sigma)
    return sobel_magnitude(smoothed, ones)


def edge_occlusion(depth_code_u16: torch.Tensor, sigma: float = 1.0,
                   smooth: bool = False) -> torch.Tensor:
    """3D occlusion edges in [0,1] from (N,H,W) 16-bit z-buffer codes:
    mask = code < 2^16 - 500, input = sqrt(code)/sqrt(2^16)."""
    code = depth_code_u16.to(torch.float32)
    mask = code < (2**16 - 500)
    x = torch.sqrt(code) / math.sqrt(float(2**16))
    if smooth:
        x = smooth_with_mask(x, mask, sigma)
    return sobel_magnitude(x, mask)
