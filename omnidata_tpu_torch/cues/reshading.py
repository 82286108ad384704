"""Reshading: Lambertian shading by a point light at the camera origin.

POINT lamp at the camera location, diffuse white material, INVERSE_SQUARE
falloff with half-life distance D (intensity(r) = E·D²/(D²+r²)), 8-bit
output. Defaults: E = 2.5, D = 8 m (the reference's 'all' settings).
"""
from __future__ import annotations

import torch

LAMP_ENERGY = 2.5
LAMP_HALF_LIFE_DISTANCE = 8.0


def reshade(
    t: torch.Tensor,
    n_world: torch.Tensor,
    ray_dirs: torch.Tensor,
    valid: torch.Tensor,
    energy: float = LAMP_ENERGY,
    half_life: float = LAMP_HALF_LIFE_DISTANCE,
) -> torch.Tensor:
    """Reshading image in [0,1] from fragments, batched over leading dims.

    t: (...,H,W) ray lengths · n_world: (...,H,W,3) surface normals ·
    ray_dirs: (...,H,W,3) unit rays from the camera · valid: hit mask.
    Light direction at a hit is -ray_dir; the geometry term is |cos|."""
    prod = n_world * (-ray_dirs)
    cos = torch.abs(prod[..., 0] + prod[..., 1] + prod[..., 2])
    d2 = half_life * half_life
    falloff = d2 / (d2 + t * t)
    img = energy * falloff * cos
    return torch.where(valid, torch.clamp(img, 0.0, 1.0), 0.0)
