"""Vanishing points from camera extrinsics under the Manhattan-world
assumption (create_vanishing_points.py:36-178). Host-side numpy (one tiny
computation per view; golden-testable against the taskonomy point_info JSON).
"""
from __future__ import annotations

import math

import numpy as np


def _euler_sxyz(e):
    """transforms3d euler2mat axes='sxyz': R = Rx? — static frame x->y->z,
    which equals Rz @ Ry @ Rx applied to column vectors (same as Blender XYZ)."""
    x, y, z = e
    cx, sx, cy, sy, cz, sz = (
        math.cos(x), math.sin(x), math.cos(y), math.sin(y), math.cos(z), math.sin(z),
    )
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _rotation_to_make_axes_well_defined(R: np.ndarray) -> np.ndarray:
    """Pick the world 90-degree z-rotation that best aligns global +y (in the
    rotated camera frame, xy flipped) with the camera's -z
    (create_vanishing_points.py:81-107)."""
    axes = np.eye(3)
    best = (180.0, np.eye(3))
    flip = np.array([[0.0, 1, 0], [-1, 0, 0], [0, 0, 1]])  # x<->y flip (get_camera_matrix flip_xy)
    cam_rot_flipped = flip @ R
    for k in range(4):
        a = k * math.pi / 2
        Wz = np.array(
            [[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]]
        )
        gy = cam_rot_flipped.T @ (Wz @ axes[1])
        deg = math.degrees(math.acos(np.clip(np.dot(gy, -axes[2]), -1, 1)))
        if deg < best[0]:
            best = (deg, np.linalg.inv(Wz))
    return best[1]


def vanishing_points(view: dict, resolution: int = 512):
    """Returns (image_vps (3,2-ish tuples), gaussian_sphere_vps (3 unit vecs))
    for world axes x,y,z, exactly like the reference."""
    e = view["camera_rotation_final"]
    R = _euler_sxyz(e)
    Wrot = _rotation_to_make_axes_well_defined(R)
    R = Wrot @ R

    dist = 1.0
    compass = [np.array(p, float) for p in ((dist, 0, 0), (0, dist, 0), (0, 0, dist))]
    compass = [np.linalg.inv(R) @ p for p in compass]
    tangent = [p / np.linalg.norm(p) for p in compass]
    sphere_vps = [tuple(p / np.linalg.norm(p)) for p in tangent]

    fov = view["field_of_view_rads"]
    focal = resolution / (2.0 * math.tan(fov / 2.0))
    K = np.array(
        [[focal, 0, resolution / 2.0], [0, focal, resolution / 2.0], [0, 0, 1.0]]
    )
    K[:, 1] *= -1
    K[:, 2] *= -1
    image_vps = []
    for p in tangent:
        q = K @ (0.1 * p - np.array([0, 0, 0.2]))
        image_vps.append((q[0] / q[2], q[1] / q[2]))
    return image_vps, sphere_vps
