"""Label encodings: the reference's compositor/PNG conventions.

Depth: 16-bit with sensitivity max_m / 2^16 (1/512 m at the default 128 m);
invalid pixels saturate to 65535. mask_valid: 255 valid / 0 invalid.
Normals: camera-space n -> (0.5 - 0.5nx, 0.5 + 0.5ny, 0.5 + 0.5nz).

Rounding is round-half-even (``torch.round``, as ``jnp.round``). Values are
computed in float32 and cast once at the end: torch.uint16 has few
operators, so it is an output type only.
"""
from __future__ import annotations

import torch

DEPTH_MAX_METERS = 128.0
U16_MAX = 65535


def _as_u16(code: torch.Tensor) -> torch.Tensor:
    """Integral float32 codes in [0, 65535] -> uint16."""
    return code.to(torch.int32).to(torch.uint16)


def encode_depth_16bit(depth_m: torch.Tensor, valid: torch.Tensor,
                       max_meters: float = DEPTH_MAX_METERS) -> torch.Tensor:
    """Metric depth (...,H,W) -> uint16 codes; invalid -> 65535."""
    code = torch.round(torch.clamp(depth_m / max_meters, 0.0, 1.0) * U16_MAX)
    return _as_u16(torch.where(valid, code, float(U16_MAX)))


def mask_valid_image(valid: torch.Tensor) -> torch.Tensor:
    """Boolean valid mask -> 8-bit mask image (255 valid / 0 invalid)."""
    return valid.to(torch.uint8) * 255


def encode_normals_color(n_cam: torch.Tensor,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Camera-frame unit normals (...,3) -> float colors in [0,1], R channel
    inverted; no-hit pixels are 0.5 grey."""
    col = torch.stack(
        [0.5 - 0.5 * n_cam[..., 0], 0.5 + 0.5 * n_cam[..., 1],
         0.5 + 0.5 * n_cam[..., 2]], -1)
    col = torch.clamp(col, 0.0, 1.0)
    if valid is not None:
        col = torch.where(valid[..., None], col, 0.5)
    return col


def img_as_uint16(x: torch.Tensor) -> torch.Tensor:
    """skimage.img_as_uint for floats in [0,1]: round(x * 65535)."""
    return _as_u16(torch.round(torch.clamp(x, 0.0, 1.0) * U16_MAX))


def img_as_uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255).to(torch.uint8)
