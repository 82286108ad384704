"""The port's models: DPT-hybrid-384 and the v1 UNet, with the published
checkpoints' key schemas (``convert``) and the hub-style registry."""
from .dpt import DPTHybrid
from .registry import (
    MODELS,
    Predictor,
    cast_params_bf16,
    create_model,
    depth_dpt_hybrid_384,
    dpt_hybrid_384,
    surface_normal_dpt_hybrid_384,
    surface_normal_unet,
)
from .unet import UNet

__all__ = [
    "DPTHybrid", "UNet", "MODELS", "Predictor", "cast_params_bf16",
    "create_model", "dpt_hybrid_384", "depth_dpt_hybrid_384",
    "surface_normal_dpt_hybrid_384", "surface_normal_unet",
]
