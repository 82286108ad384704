"""Camera pose tensors from point_info in PyTorch3D convention — the
reference attaches cam-to-world R,T + projection K/K_inv to every sampled
view (dataloader/omnidata_dataset.py:565-594: euler XZY with a -90 degree X
offset and axis sign flips, FoVPerspective znear 0.001 zfar 512).

Pure numpy, host-side like the rest of the data layer; the port's copy of
the JAX package's ``data/pose.py``.
"""
from __future__ import annotations

import math

import numpy as np

EULER_X_OFFSET_RADS = math.radians(90.0)
ZNEAR, ZFAR = 0.001, 512.0


def _rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rot_z(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def euler_xzy_matrix(ax: float, az: float, ay: float) -> np.ndarray:
    """pytorch3d.transforms.euler_angles_to_matrix(convention='XZY'):
    R = R_X(ax) @ R_Z(az) @ R_Y(ay)."""
    return _rot_x(ax) @ _rot_z(az) @ _rot_y(ay)


def fov_perspective_K(fov_rads: float, znear: float = ZNEAR,
                      zfar: float = ZFAR, aspect: float = 1.0) -> np.ndarray:
    """pytorch3d FoVPerspectiveCameras.compute_projection_matrix (4,4)."""
    t = math.tan(fov_rads / 2.0)
    K = np.zeros((4, 4), np.float64)
    K[0, 0] = 1.0 / (t * aspect)
    K[1, 1] = 1.0 / t
    K[2, 2] = zfar / (zfar - znear)
    K[2, 3] = -(zfar * znear) / (zfar - znear)
    K[3, 2] = 1.0
    return K


def cam_to_world_R_T_K(point_info: dict) -> dict:
    """R,T,K(+inv) tensors for one view dict, byte-matching the reference's
    _get_cam_to_world_R_T_K (names kept even where historically quirky)."""
    ex, ey, ez = point_info["camera_rotation_final"]
    Tx, Ty, Tz = point_info["camera_location"]
    fov = float(point_info["field_of_view_rads"])

    R = euler_xzy_matrix(ex - EULER_X_OFFSET_RADS, -ey, -ez)
    T = np.array([-Tx, Tz, Ty], np.float64)

    R_inv = R.T  # P3D expects world -> cam
    T_inv = -(R @ T)
    K = fov_perspective_K(fov)
    return {
        "cam_to_world_R": R_inv.astype(np.float32),
        "cam_to_world_T": T_inv.astype(np.float32),
        "proj_K": K.astype(np.float32),
        "proj_K_inv": np.linalg.inv(K[:3, :3]).astype(np.float32),
    }
