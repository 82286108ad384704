"""The port's models: DPT-hybrid-384 and the v1 UNet, with the published
checkpoints' key schemas (``convert``) and the hub-style registry; the
multi-task architectures, the attention blocks and HRNet; normal TTA."""
from .attention_blocks import CBAM, ECA, ChannelAttention
from .dpt import DPTHybrid
from .hrnet import HRNet
from .multitask import (
    MTAN,
    ASPPHead,
    ConvBlock,
    CrossStitch,
    Encoder,
    HRNetLite,
    MultiTaskModel,
    PADNet,
    grad_norm_weights,
)
from .registry import (
    MODELS,
    Predictor,
    cast_params_bf16,
    create_model,
    depth_dpt_hybrid_384,
    dpt_hybrid_384,
    hrnet,
    surface_normal_dpt_hybrid_384,
    surface_normal_unet,
)
from .tta import SurfaceNormalsTTA
from .unet import UNet

__all__ = [
    "CBAM", "ECA", "ChannelAttention", "DPTHybrid", "HRNet", "MTAN", "ASPPHead",
    "ConvBlock", "CrossStitch", "Encoder", "HRNetLite", "MultiTaskModel", "PADNet",
    "grad_norm_weights", "UNet", "MODELS", "Predictor", "cast_params_bf16",
    "create_model", "dpt_hybrid_384", "depth_dpt_hybrid_384", "hrnet",
    "surface_normal_dpt_hybrid_384", "surface_normal_unet", "SurfaceNormalsTTA",
]
