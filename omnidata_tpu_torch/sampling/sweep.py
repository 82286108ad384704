"""SWEEP-mode point generation: per-camera view dicts with K/RT matrices.

The reference's generate_points_per_camera (generate_points.py:624-686)
emits, for every camera, either the 6 cube faces of a panorama
(CREATE_PANOS: top/front/right/back/left/bottom at the Matterport FOV) or
NUM_POINTS random sweep views (yaw ~ U(-pi,pi), pitch ~ N(0,15 deg), FOV
truncated-normal in [FOV_MIN, FOV_MAX]). Sweep view dicts carry
`camera_k_matrix` (3x3) and `camera_rt_matrix` (3x4 world->CV) built by
get_save_info_for_sweep (io_utils.py:388-458). The rotation maths runs in
float32 on the CPU."""
from __future__ import annotations

import math

import numpy as np

from .points import _f32

FIELD_OF_VIEW_MATTERPORT_RADS = math.pi / 2.0

# (yaw, pitch) per cube face, in the reference's order (generate_points.py:624-638)
CUBE_FACES = [
    (math.pi, math.pi / 2),    # 0 top
    (0.0, 0.0),                # 1 front
    (math.pi / 2, 0.0),        # 2 right
    (math.pi, 0.0),            # 3 back
    (-math.pi / 2, 0.0),       # 4 left
    (math.pi, -math.pi / 2),   # 5 bottom
]


def sample_yaw_pitch_fov(
    rng: np.random.RandomState,
    sample_i: int,
    panos: bool,
    fov_min: float = math.radians(30.0),
    fov_max: float = math.radians(125.0),
):
    if panos:
        if sample_i >= len(CUBE_FACES):
            raise ValueError("Too many samples for a panorama! (Max 6)")
        yaw, pitch = CUBE_FACES[sample_i]
        return yaw, pitch, FIELD_OF_VIEW_MATTERPORT_RADS
    yaw = rng.uniform(-math.pi, math.pi)
    pitch = rng.normal(0.0, math.radians(15.0))
    z = 2.0
    while abs(z) > 1.0:
        z = rng.normal(0.0, 1.0)
    half = (fov_max - fov_min) / 2.0
    return yaw, pitch, fov_min + half + z * half


def sweep_view_dict(
    camera_uuid,
    point_uuid,
    view_id: int,
    location,
    rotation_euler_original,
    yaw: float,
    pitch: float,
    fov: float,
    resolution: int = 512,
) -> dict:
    """One sweep view dict (get_save_info_for_sweep schema): the camera's
    original rotation, rotated about its LOCAL Y by yaw then LOCAL X by
    pitch (Blender rotate_axis order), with K and world->CV RT."""
    from ..core.cameras import extrinsic_RT, intrinsic_matrix
    from ..core.rotations import (
        euler_xyz_to_matrix,
        matrix_to_euler_xyz,
        rot_x,
        rot_y,
    )

    e_orig = np.asarray(rotation_euler_original, np.float32)
    R_orig = euler_xyz_to_matrix(_f32(e_orig)).numpy()
    # rotate_axis composes on the local frame: R @ rot
    R_new = R_orig @ rot_y(_f32(yaw)).numpy()
    R_new = R_new @ rot_x(_f32(pitch)).numpy()
    e_final = matrix_to_euler_xyz(_f32(R_new)).numpy()
    R_delta = R_new @ R_orig.T
    loc = np.asarray(location, np.float32)

    K = intrinsic_matrix(_f32(fov), resolution).numpy()
    RT = extrinsic_RT(_f32(loc), _f32(R_new)).numpy()
    return {
        "camera_uuid": camera_uuid,
        "point_uuid": point_uuid,
        "view_id": int(view_id),
        "camera_location": [float(x) for x in loc],
        "camera_original_rotation": [float(x) for x in e_orig],
        "final_camera_rotation": [float(x) for x in e_final],
        # aliases used by the device render loop (camera_from_view_dict)
        "camera_rotation_original": [float(x) for x in e_orig],
        "camera_rotation_final": [float(x) for x in e_final],
        "rotation_from_original_to_point": [
            float(x)
            for x in matrix_to_euler_xyz(_f32(R_delta)).numpy()
        ],
        "field_of_view_rads": float(fov),
        "resolution": int(resolution),
        "camera_k_matrix": [[float(x) for x in row] for row in K],
        "camera_rt_matrix": [[float(x) for x in row] for row in RT],
    }


def generate_points_per_camera(
    camera_poses: dict,
    num_points: int = 6,
    resolution: int = 512,
    rng: np.random.RandomState | None = None,
    panos: bool = False,
) -> list:
    """camera_poses: {camera_uuid: {'position': (3,), 'rotation': euler(3)}}.
    Returns one point (list of view dicts) per camera; point_uuid is the
    camera's uuid (the reference keys sweep points to their camera)."""
    rng = rng or np.random.RandomState(0)
    n = 6 if panos else num_points
    out = []
    for camera_uuid in sorted(camera_poses):
        ext = camera_poses[camera_uuid]
        views = []
        for i in range(n):
            yaw, pitch, fov = sample_yaw_pitch_fov(rng, i, panos)
            views.append(
                sweep_view_dict(
                    camera_uuid, str(camera_uuid), i,
                    ext["position"], ext["rotation"], yaw, pitch, fov,
                    resolution,
                )
            )
        out.append(views)
    return out


def skybox_face_of_direction(d_world, R_orig: np.ndarray) -> int:
    """Which of the 6 skybox cube faces (Matterport numbering: 0 top,
    1 front, 2 right, 3 back, 4 left, 5 bottom) contains a world direction,
    relative to the camera's original orientation (get_skybox_path_info)."""
    local = R_orig.T @ np.asarray(d_world, np.float64)
    x, y, z = local  # Blender camera: +x right, +y up, -z forward
    ax, ay, az = abs(x), abs(y), abs(z)
    if ay >= ax and ay >= az:
        return 0 if y > 0 else 5
    if az >= ax:
        return 1 if z < 0 else 3
    return 2 if x > 0 else 4
