"""Smooth camera trajectories (generate_points_smooth_trajectory.py:160-264):
order a point's cameras into a far->near neighbor chain, linearly interpolate
locations (10 steps/meter) and SLERP the keyframe rotations between
keyframes. Interpolated frames are NOT re-fixated: they carry the slerped
rotation (so keyframe roll/fixation carries through), exactly like the
reference's scipy Slerp over `camera_rotation_final` eulers; only keyframes
keep fixated=True.
"""
from __future__ import annotations

import numpy as np


def order_cameras_chain(cam_locs: np.ndarray, point: np.ndarray) -> np.ndarray:
    """Start at the farthest camera from the point, greedily hop to the
    nearest unvisited camera (the reference's sort + pop(-1) + closest
    loop)."""
    n = len(cam_locs)
    d_to_pt = np.linalg.norm(cam_locs - point, axis=1)
    order = [int(np.argmax(d_to_pt))]
    remaining = set(range(n)) - set(order)
    while remaining:
        cur = cam_locs[order[-1]]
        nxt = min(remaining, key=lambda j: np.linalg.norm(cam_locs[j] - cur))
        order.append(nxt)
        remaining.remove(nxt)
    return np.asarray(order)


def interpolate_trajectory(
    cam_locs: np.ndarray,
    point: np.ndarray,
    key_Rs: np.ndarray | None = None,
    steps_per_meter: float = 10.0,
):
    """-> (frame_locs (T,3), frame_R (T,3,3), key_view (T,), is_key (T,)).

    key_Rs: per-camera rotation matrices (camera_rotation_final). When None,
    keyframe rotations are look-at fixations on the point (the slerp then
    reduces to spherical interpolation of the viewing directions).
    key_view[t] is the ORIGINAL index (into cam_locs/key_Rs) of the keyframe
    governing frame t — the reference copies that keyframe's point_info onto
    interpolated frames."""
    from ..core.cameras import look_at_rotation
    from ..core.rotations import matrix_to_quat, quat_to_matrix, slerp
    from .points import _f32

    order = order_cameras_chain(cam_locs, point)
    keys = cam_locs[order]
    if key_Rs is None:
        Rk = look_at_rotation(_f32(keys), _f32(point).expand(len(keys), 3)).numpy()
    else:
        Rk = np.asarray(key_Rs)[order]
    quats = matrix_to_quat(_f32(Rk)).numpy()

    locs, Rs, key_of, is_key = [], [], [], []
    for ki, (a, b) in enumerate(zip(keys[:-1], keys[1:])):
        seg = float(np.linalg.norm(b - a))
        n = max(int(seg * steps_per_meter), 1)
        qa, qb = quats[ki], quats[ki + 1]
        for s in range(n):
            t = s / n
            locs.append((1 - t) * a + t * b)
            q = slerp(_f32(qa), _f32(qb), _f32(t))
            Rs.append(quat_to_matrix(q).numpy())
            key_of.append(ki)
            is_key.append(s == 0)
    locs.append(keys[-1])
    Rs.append(Rk[-1])
    key_of.append(len(keys) - 1)
    is_key.append(True)
    return (
        np.stack(locs).astype(np.float32),
        np.stack(Rs).astype(np.float32),
        order[np.asarray(key_of)],  # original-view index per frame
        np.asarray(is_key),
    )


def frame_uuid(t: int) -> str:
    """camera_uuid = str(t).zfill(4) (generate_points_smooth_trajectory.py)."""
    return str(t).zfill(4)
