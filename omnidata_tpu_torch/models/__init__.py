"""The port's models: DPT-hybrid-384, the v1 UNet and MiDaS v2.1 (large
and small, with the MiDaS input transforms), with the published
checkpoints' key schemas (``convert``) and the hub-style registry; the
multi-task architectures, the attention blocks and HRNet; normal TTA."""
from .attention_blocks import CBAM, ECA, ChannelAttention
from .dpt import DPTHybrid
from .hrnet import HRNet
from .midas_full import (
    EfficientNetLite3Backbone,
    MidasNet,
    MidasNetSmallTF,
    ResNeXt101Backbone,
)
from .midas_net import MidasNetSmall
from .midas_transforms import midas_transform_v21, midas_transform_v21_small
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
    midas_v21,
    midas_v21_small,
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
    "EfficientNetLite3Backbone", "MidasNet", "MidasNetSmallTF", "ResNeXt101Backbone",
    "MidasNetSmall", "midas_transform_v21", "midas_transform_v21_small", "midas_v21",
    "midas_v21_small",
]
