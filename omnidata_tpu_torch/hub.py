"""torch.hub-style entry points (the reference's hub names,
omnidata_tools/torch/README.md:23-29). Each returns a ``Predictor`` module:
NCHW float32 in, the reference's output convention out."""
from .models.registry import (
    depth_dpt_hybrid_384,
    dpt_hybrid_384,
    surface_normal_dpt_hybrid_384,
    surface_normal_unet,
)

__all__ = [
    "dpt_hybrid_384",
    "depth_dpt_hybrid_384",
    "surface_normal_dpt_hybrid_384",
    "surface_normal_unet",
]
