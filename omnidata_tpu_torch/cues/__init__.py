from .curvature import bake_curvature_colors
from .edges import edge_occlusion, edge_texture, gaussian_blur_constant
from .encode import (
    encode_depth_16bit,
    encode_normals_color,
    img_as_uint8,
    img_as_uint16,
    mask_valid_image,
)
from .keypoints2d import keypoints2d
from .reshading import reshade

__all__ = [
    "bake_curvature_colors", "edge_occlusion", "edge_texture",
    "gaussian_blur_constant", "encode_depth_16bit", "encode_normals_color",
    "img_as_uint8", "img_as_uint16", "mask_valid_image", "keypoints2d",
    "reshade",
]
