from .cameras import (
    DEFAULT_RESOLUTION,
    Camera,
    camera_rays,
    extrinsic_RT,
    focal_px_from_fov,
    intrinsic_matrix,
    look_at_rotation,
)
from .rotations import rot_x, rot_y, rot_z

__all__ = [
    "DEFAULT_RESOLUTION", "Camera", "camera_rays", "extrinsic_RT",
    "focal_px_from_fov", "intrinsic_matrix", "look_at_rotation",
    "rot_x", "rot_y", "rot_z",
]
