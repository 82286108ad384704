"""Device half of the segmentation host cues: their input maps.

The unsupervised segmentation cues (reference:
create_segmentation_2d_images.py:41-85, create_segmentation_25d_images.py:
47-120) are sequential at their core (Kruskal union-find, recursive
normalized cuts), but their inputs are convolutions:

- segment_unsup2d blurs the rgb with a sigma-3 gaussian before
  felzenszwalb (the reference passes ``sigma`` to skimage's felzenszwalb,
  which filters internally);
- segment_unsup25d builds a 5-channel image [w_d log(depth)/16,
  w_n masked-smoothed normals (sigma 2), w_e edge], where each masked
  smoothing is two gaussian fields (x mask and mask).

These maps are computed here as plain torch ops on the batch the render
just produced, so only the sequential cores run on the host.

Numerics: float32 separable convolutions with scipy's kernel (truncate
4.0), written as shifted multiply-adds in tap order rather than through
``F.conv2d``, so that cuDNN's algorithm choice (and TF32) cannot change a
code: the card and the CPU give the same codes. The host path computes the
same maps in float64; the consumers are threshold and ordering algorithms,
so tests hold the labels to the host's by ARI.

The maps leave as uint16 codes with static per-channel scales, the codes
the JAX package's batched CLI hands its host cues; the channels stay
unweighted and the host applies the SEGMENTATION_25D_*_WEIGHT settings
after dequantising, so one device pass serves any weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .narf_device import _div, _u16_codes

# static u16 quantisation scales (value = code / 65535 * scale)
# ch0: log(max(code, 1)) / 16 <= log(65535) / 16 ~ 0.6931 (masked mean keeps it)
# ch1-3: normals in [0, 1]; ch4: edge u16 / 255 / 255 <= 1.0081
SEG25D_QSCALES = (0.75, 1.0, 1.0, 1.0, 1.01)
SEG2D_QSCALE = 255.0


def _gauss_kernel(sigma: float) -> np.ndarray:
    """scipy.ndimage.gaussian_filter's order-0 kernel (truncate=4.0)."""
    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * x * x / (sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Source indices of numpy's 'symmetric' pad of r on each side of n."""
    m = torch.remainder(torch.arange(-r, n + r, device=device), 2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def _blur_axis(x: torch.Tensor, k: np.ndarray, dim: int, mode: str) -> torch.Tensor:
    r = (k.shape[0] - 1) // 2
    n = x.shape[dim]
    if mode == "reflect":
        xp = x.index_select(dim, _symmetric_index(n, r, x.device))
    else:
        shape = list(x.shape)
        shape[dim] = r
        pad = x.new_zeros(shape)
        xp = torch.cat([pad, x, pad], dim)
    acc = xp.narrow(dim, 0, n) * float(k[0])
    for t in range(1, k.shape[0]):
        acc = acc + xp.narrow(dim, t, n) * float(k[t])
    return acc


def _blur_hw(x: torch.Tensor, sigma: float, mode: str = "constant") -> torch.Tensor:
    """Separable gaussian over the trailing (H, W) dims, rows first.

    mode: scipy.ndimage boundary semantics — 'constant' (zero pad; what the
    masked smoothing uses) or 'reflect' (scipy's edge-duplicating reflect,
    numpy's 'symmetric'; scipy's default, felzenszwalb's internal blur)."""
    if mode not in ("constant", "reflect"):
        raise ValueError(f"mode {mode!r}")
    k = _gauss_kernel(sigma)
    return _blur_axis(_blur_axis(x, k, x.dim() - 2, mode), k, x.dim() - 1, mode)


def _as_float(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).to(torch.float32)


@torch.no_grad()
def seg2d_blur_maps(rgb_u8: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    """(K, H, W, 3) uint8 rgb -> the blurred image at felzenszwalb's internal
    0-255 scale (img_as_float x 255, then the gaussian), uint16 codes."""
    x = _as_float(rgb_u8).permute(0, 3, 1, 2)  # u8 / 255 * 255 == the bytes
    x = _blur_hw(x, sigma, mode="reflect")
    return _u16_codes(_div(x, SEG2D_QSCALE)).permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def seg25d_channel_maps(depth_u16: torch.Tensor, normal_u8: torch.Tensor,
                        edge_u16: torch.Tensor) -> torch.Tensor:
    """(K, H, W[, 3]) encoded labels -> the 5 unweighted segment_unsup25d
    channels (masked-smoothed log depth at sigma 1, masked-smoothed normals
    at sigma 2, edge), uint16 codes (K, H, W, 5) with SEG25D_QSCALES."""
    depth = _as_float(depth_u16)
    mask = (depth < 2.0 ** 16 - 2.0).to(torch.float32)
    eps = float(np.finfo(np.float32).eps)

    def sm(x, sigma):
        m = mask if x.dim() == mask.dim() else mask[:, None]
        return _blur_hw(x * m, sigma) / (_blur_hw(m, sigma) + eps)

    # log in float64, rounded once: the same codes on the card and the CPU
    logd = torch.log(torch.clamp(depth.double(), min=1.0)).float()
    ch0 = sm(logd / 16.0, 1.0)
    nrm = _div(_as_float(normal_u8), 255.0)
    chn = sm(nrm.permute(0, 3, 1, 2), 2.0)  # (K, 3, H, W)
    ch4 = _div(_div(_as_float(edge_u16), 255.0), 255.0)
    chans = torch.cat([ch0[:, None], chn, ch4[:, None]], 1)
    q = torch.stack([_u16_codes(_div(chans[:, c], float(np.float32(s))))
                     for c, s in enumerate(SEG25D_QSCALES)], -1)
    return q


def seg2d_blurred_from_maps(q_u16: np.ndarray) -> np.ndarray:
    """Host dequantisation: (H, W, 3) uint16 -> the float64 blurred image at
    felzenszwalb's 0-255 scale (for segment_2d(blurred255=...))."""
    return np.asarray(q_u16, np.float64) * (SEG2D_QSCALE / 65535.0)


def seg25d_input_from_maps(q_u16: np.ndarray, depth_weight: float,
                           normal_weight: float, edge_weight: float) -> np.ndarray:
    """Host dequantisation and weighting: (H, W, 5) uint16 -> the float64
    5-channel image segment_25d feeds felzenszwalb (for
    segment_25d(input_img=...))."""
    v = np.asarray(q_u16, np.float64) * (np.asarray(SEG25D_QSCALES) / 65535.0)
    w = np.asarray([depth_weight] + [normal_weight] * 3 + [edge_weight])
    return v * w
