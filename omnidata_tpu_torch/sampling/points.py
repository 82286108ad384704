"""Point-of-interest generation: the wide-baseline multi-view sampler.

Batch-first: all candidate surface points are sampled at once and the full
(candidate x camera) line-of-sight matrix is one batched raycast on the
mesh's device. The per-view rotation maths (3x3 matrices) runs in float32 on
the CPU, whatever the mesh's device.

Per accepted (point, camera) pair a view dict is emitted with the reference's
point_info schema (io_utils.py:284-458): fixated rotation (look-at), original
rotation (leveled yaw/roll), FOV ~ truncated normal in [min_fov, max_fov],
camera distance, obliqueness, pitch, and nonfixated cross-links.
"""
from __future__ import annotations

import os

import numpy as np

MIN_FOV_RADS = np.deg2rad(30.0)   # settings.py:143-144
MAX_FOV_RADS = np.deg2rad(125.0)
FOV_MEAN = np.deg2rad(75.0)
FOV_STD = np.deg2rad(30.0)
LOS_TOLERANCE = 1e-3  # 1mm hit tolerance (generate_points.py:496-525)


def _f32(a):
    """A host float32 tensor: the per-view rotation maths runs on the CPU."""
    import torch

    return torch.as_tensor(np.asarray(a, np.float32), device="cpu")


def sample_surface_points(mesh, rng: np.random.RandomState, n: int):
    """Area-weighted random points on the mesh surface: (pts (n,3), normals
    (n,3), face ids (n,))."""
    v = mesh.vertices.cpu().numpy()
    f = mesh.faces[: mesh.num_faces].cpu().numpy()
    tri = v[f]
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
    )
    probs = areas / areas.sum()
    fi = rng.choice(len(f), n, p=probs)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    a, b, c = tri[fi, 0], tri[fi, 1], tri[fi, 2]
    pts = (1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c
    fn = np.cross(tri[fi, 1] - tri[fi, 0], tri[fi, 2] - tri[fi, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    return pts.astype(np.float32), fn.astype(np.float32), fi


def line_of_sight_matrix(cam_locs: np.ndarray, points: np.ndarray, mesh,
                         tol: float = LOS_TOLERANCE) -> np.ndarray:
    """(n_cams, n_points) boolean: camera c sees point p (no blocker closer
    than dist - tol). One batched any-hit query."""
    import torch

    from ..mesh.raycast import any_hit_within

    C, P = len(cam_locs), len(points)
    o = np.repeat(cam_locs, P, 0)  # (C*P,3)
    tgt = np.tile(points, (C, 1))
    d = tgt - o
    dist = np.linalg.norm(d, axis=1)
    dist = np.maximum(dist, 1e-9)
    dev = mesh.vertices.device

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    blocked = any_hit_within(on_dev(o), on_dev(d / dist[:, None]),
                             on_dev(dist - tol), mesh)
    return ~blocked.cpu().numpy().reshape(C, P)


def obliqueness_matrix(cam_locs: np.ndarray, points: np.ndarray,
                       normals: np.ndarray) -> np.ndarray:
    """(n_cams, n_points) angle between the surface normal and the
    point->camera direction (generate_points.py obliqueness)."""
    d = cam_locs[:, None, :] - points[None, :, :]
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    cos = np.sum(d * normals[None], -1)
    return np.arccos(np.clip(cos, -1.0, 1.0))


def sample_fov(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Truncated normal FOV in [30 deg, 125 deg] (generate_points.py:607-620)."""
    out = np.empty(n)
    for i in range(n):
        while True:
            x = rng.randn() * FOV_STD + FOV_MEAN
            if MIN_FOV_RADS <= x <= MAX_FOV_RADS:
                out[i] = x
                break
    return out


def in_frustum(cam_loc, R, fov, points, resolution: int = 512,
               margin: float = 0.0) -> np.ndarray:
    """Boolean (n_points,): point projects inside the image and in front."""
    from ..core.cameras import extrinsic_RT, intrinsic_matrix

    K = intrinsic_matrix(_f32(fov), resolution).numpy()
    RT = extrinsic_RT(_f32(cam_loc), _f32(R)).numpy()
    ph = np.concatenate([points, np.ones((len(points), 1))], -1)
    cam = ph @ RT.T
    z = cam[:, 2]
    uvw = cam @ K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = uvw[:, :2] / np.where(np.abs(z[:, None]) < 1e-9, 1e-9, z[:, None])
    lo, hi = -margin, resolution + margin
    return (z > 1e-6) & (uv >= lo).all(1) & (uv <= hi).all(1)


def generate_points(
    mesh,
    cam_locs: np.ndarray,
    rng: np.random.RandomState,
    n_points: int,
    min_views_per_point: int = 3,
    max_views_per_point: int = 25,
    max_obliqueness_rad: float = np.deg2rad(70.0),
    resolution: int = 512,
    candidate_factor: int = 8,
):
    """Returns point_infos: list (per point) of lists of view dicts, matching
    the reference's schema, with nonfixated cross-links filled in."""
    from ..core.cameras import look_at_rotation
    from ..core.rotations import (
        euler_xyz_to_matrix,
        matrix_to_euler_xyz,
        matrix_to_quat,
    )

    # 1. candidates + visibility
    n_cand = n_points * candidate_factor
    pts, nrm, _ = sample_surface_points(mesh, rng, n_cand)
    los = line_of_sight_matrix(cam_locs, pts, mesh)
    obl = obliqueness_matrix(cam_locs, pts, nrm)
    viable_cams = los & (obl < max_obliqueness_rad)  # (C, n_cand)
    n_views = viable_cams.sum(0)

    order = np.argsort(-n_views, kind="stable")
    chosen = [i for i in order if n_views[i] >= min_views_per_point][:n_points]
    if not chosen:
        return []

    # 2. per-point view dicts
    point_infos = []
    all_views = []  # (point_idx, view_idx, cam_idx, R(3,3), fov)
    for p_out, ci in enumerate(chosen):
        cams = np.nonzero(viable_cams[:, ci])[0]
        if len(cams) > max_views_per_point:
            cams = rng.choice(cams, max_views_per_point, replace=False)
        views = []
        for view_id, cam_idx in enumerate(cams):
            loc = cam_locs[cam_idx]
            fov = float(sample_fov(rng, 1)[0])
            Rfix = look_at_rotation(_f32(loc), _f32(pts[ci])).numpy()
            # original rotation: leveled camera (pitch pi/2 in Blender euler
            # terms) with random yaw/roll — like sample_camera_quaternion
            yaw = rng.uniform(-np.pi, np.pi)
            e_orig = np.array([np.pi / 2, 0.0, yaw], np.float32)
            Rorig = euler_xyz_to_matrix(_f32(e_orig)).numpy()
            Rdelta = Rfix @ Rorig.T
            d = pts[ci] - loc
            dist = float(np.linalg.norm(d))
            fwd = d / dist
            view = {
                "point_uuid": str(p_out),
                "view_id": int(view_id),
                "camera_uuid": int(cam_idx),
                "camera_location": [float(x) for x in loc],
                "camera_rotation_original": [float(x) for x in e_orig],
                "camera_rotation_final": [
                    float(x) for x in matrix_to_euler_xyz(_f32(Rfix)).numpy()
                ],
                "camera_rotation_final_quaternion": [
                    float(x) for x in matrix_to_quat(_f32(Rfix)).numpy()
                ],
                "camera_rotation_from_original_to_final": [
                    float(x) for x in matrix_to_euler_xyz(_f32(Rdelta)).numpy()
                ],
                "field_of_view_rads": fov,
                "camera_distance": dist,
                "point_location": [float(x) for x in pts[ci]],
                "point_normal": [float(x) for x in nrm[ci]],
                "obliqueness_angle": float(obl[cam_idx, ci]),
                "point_pitch": float(np.arcsin(np.clip(fwd[2], -1, 1))),
                "resolution": resolution,
                "nonfixated_points_in_view": [],
            }
            # skybox cube-face bookkeeping (get_skybox_path_info,
            # io_utils.py:376-385): which face of the camera's original
            # orientation contains the point, and the Matterport-style path
            from .sweep import skybox_face_of_direction

            sky = skybox_face_of_direction(d, Rorig)
            view["skybox_img"] = sky
            view["skybox_img_path"] = os.path.join(
                "./img/high", f"{int(cam_idx)}_skybox{sky}.jpg"
            )
            views.append(view)
            all_views.append((p_out, view_id, int(cam_idx), Rfix, fov))
        point_infos.append(views)

    # 3. nonfixated cross-links: which chosen points fall inside each view's
    # frustum with line of sight (generate_points.py:343-363)
    chosen_pts = pts[chosen]
    for (p_out, view_id, cam_idx, Rfix, fov) in all_views:
        vis = in_frustum(cam_locs[cam_idx], Rfix, fov, chosen_pts, resolution)
        vis &= los[cam_idx][chosen]
        nonfix = [int(j) for j in np.nonzero(vis)[0] if j != p_out]
        point_infos[p_out][view_id]["nonfixated_points_in_view"] = nonfix

    return point_infos


def prune_points(point_infos, min_views: int = 1, min_nonfixated: int = 1):
    """Fixed-point pruning (generate_points.py:188-214): drop points with too
    few views or too few nonfixated appearances, re-check until stable."""
    alive = {int(v[0]["point_uuid"]) for v in point_infos if v}
    changed = True
    while changed:
        changed = False
        counts = {p: 0 for p in alive}
        for views in point_infos:
            if not views or int(views[0]["point_uuid"]) not in alive:
                continue
            for view in views:
                for j in view["nonfixated_points_in_view"]:
                    if j in counts:
                        counts[j] += 1
        for views in point_infos:
            if not views:
                continue
            p = int(views[0]["point_uuid"])
            if p in alive and (len(views) < min_views or counts.get(p, 0) < min_nonfixated):
                alive.remove(p)
                changed = True
    out = []
    for views in point_infos:
        if views and int(views[0]["point_uuid"]) in alive:
            pruned_views = []
            for view in views:
                view = dict(view)
                view["nonfixated_points_in_view"] = [
                    j for j in view["nonfixated_points_in_view"] if j in alive
                ]
                pruned_views.append(view)
            out.append(pruned_views)
    return out
