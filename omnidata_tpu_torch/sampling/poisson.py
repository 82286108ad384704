"""Poisson-disc camera-location sampling + building-floor detection.

Capability match for generate_camera_poses.py:108-368: Bridson-style
poisson-disc samples inside the mesh bbox, filtered to per-floor height bands
(floors = z-histogram density peaks > 1.5x mean), inside-mesh parity test via
the raycaster, and a minimum clearance from the mesh surface. Object-mode
sampling places cameras on a scaled bounding sphere.

Host-side numpy drives the rejection loops (tiny data); the expensive
inside-mesh / clearance tests are batched raycasts on the mesh's device.
"""
from __future__ import annotations

import numpy as np


def find_building_floors(
    vertices: np.ndarray, bins_per_meter: float = 10.0, peak_factor: float = 1.5
) -> list[float]:
    """Floor z-levels from vertex-density peaks (generate_camera_poses.py:283-318):
    histogram vertex z at ~10 bins/m; bins denser than peak_factor x mean mark
    floor/ceiling structure; consecutive peak runs collapse to their start."""
    z = vertices[:, 2]
    zmin, zmax = float(z.min()), float(z.max())
    n_bins = max(int((zmax - zmin) * bins_per_meter), 1)
    hist, edges = np.histogram(z, bins=n_bins)
    thresh = peak_factor * hist.mean()
    peaks = hist > thresh
    floors = []
    prev = False
    for i, p in enumerate(peaks):
        if p and not prev:
            floors.append(float(edges[i]))
        prev = p
    if not floors:
        floors = [zmin]
    return floors


def poisson_disc_2d(
    rng: np.random.RandomState,
    bounds_lo: np.ndarray,
    bounds_hi: np.ndarray,
    radius: float,
    k: int = 30,
) -> np.ndarray:
    """Bridson poisson-disc in a 2D rectangle; returns (N,2)."""
    cell = radius / np.sqrt(2.0)
    dims = np.maximum(((bounds_hi - bounds_lo) / cell).astype(int) + 1, 1)
    grid = -np.ones(dims, np.int64)
    pts: list[np.ndarray] = []
    active: list[int] = []

    def grid_idx(p):
        return tuple(np.minimum(((p - bounds_lo) / cell).astype(int), dims - 1))

    def ok(p):
        if np.any(p < bounds_lo) or np.any(p > bounds_hi):
            return False
        gi = np.asarray(grid_idx(p))
        lo = np.maximum(gi - 2, 0)
        hi = np.minimum(gi + 3, dims)
        for ix in range(lo[0], hi[0]):
            for iy in range(lo[1], hi[1]):
                j = grid[ix, iy]
                if j >= 0 and np.linalg.norm(pts[j] - p) < radius:
                    return False
        return True

    p0 = bounds_lo + rng.rand(2) * (bounds_hi - bounds_lo)
    pts.append(p0)
    grid[grid_idx(p0)] = 0
    active.append(0)
    while active:
        ai = rng.randint(len(active))
        base = pts[active[ai]]
        placed = False
        for _ in range(k):
            ang = rng.rand() * 2 * np.pi
            r = radius * (1 + rng.rand())
            cand = base + r * np.array([np.cos(ang), np.sin(ang)])
            if ok(cand):
                pts.append(cand)
                grid[grid_idx(cand)] = len(pts) - 1
                active.append(len(pts) - 1)
                placed = True
        if not placed:
            active.pop(ai)
    return np.stack(pts)


def sample_camera_locations_building(
    mesh,
    rng: np.random.RandomState,
    min_spacing: float = 1.0,
    min_height: float = 0.2,
    max_height: float = 2.0,
    min_clearance: float = 0.3,
    max_cameras: int | None = None,
) -> np.ndarray:
    """Poisson-disc camera locations inside a building mesh, per floor.

    Tests: inside-mesh (ray-crossing parity, 3-ray vote) and clearance
    (no surface within min_clearance along 6 axis rays)."""
    import torch

    from ..mesh.raycast import count_crossings, raycast

    v = mesh.vertices.cpu().numpy()
    dev = mesh.vertices.device
    floors = find_building_floors(v)
    lo = v.min(0)[:2]
    hi = v.max(0)[:2]

    if max_height <= min_height:
        # legacy 'MAX_CAMERA_HEIGHT = 0 means unclamped' configs: use the
        # scene's z extent (an inverted band would make rng.uniform
        # undefined and silently pin cameras to the floor)
        max_height = max(float(v[:, 2].max() - v[:, 2].min()),
                         min_height + 1e-3)

    cands = []
    for fz in floors:
        pts2d = poisson_disc_2d(rng, lo, hi, min_spacing)
        # per-floor height band (generate_camera_poses.py:203: z uniform in
        # [floor + MIN_CAMERA_HEIGHT, floor + MAX_CAMERA_HEIGHT])
        z = fz + rng.uniform(min_height, max_height, len(pts2d))
        cands.append(np.concatenate([pts2d, z[:, None]], -1))
    cand = np.concatenate(cands).astype(np.float32)

    # inside-mesh parity: odd crossings along 3 fixed directions (majority)
    dirs = np.array(
        [[0.31, 0.52, 0.80], [0.80, -0.31, 0.52], [-0.52, 0.80, 0.31]], np.float32
    )
    cand_t = torch.as_tensor(cand, device=dev)
    votes = np.zeros(len(cand), np.int32)
    for d in dirs:
        c = count_crossings(
            cand_t, torch.as_tensor(d, device=dev).expand(cand.shape), mesh)
        votes += (c.cpu().numpy() % 2).astype(np.int32)
    inside = votes >= 2

    # clearance: nearest surface along +-xyz axis rays
    axes = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float32,
    )
    min_t = np.full(len(cand), np.inf)
    for d in axes:
        hits = raycast(
            cand_t, torch.as_tensor(d, device=dev).expand(cand.shape), mesh)
        t = hits.t.cpu().numpy().copy()
        t[~hits.valid.cpu().numpy()] = np.inf
        min_t = np.minimum(min_t, t)
    clear = min_t > min_clearance

    out = cand[inside & clear]
    if max_cameras is not None and len(out) > max_cameras:
        out = out[rng.choice(len(out), max_cameras, replace=False)]
    return out


def sample_camera_locations_object(
    mesh, rng: np.random.RandomState, n: int, sphere_scaling: float = 2.0
) -> np.ndarray:
    """Object mode (generate_camera_poses.py:321-368): cameras uniformly on a
    bounding sphere scaled by sphere_scaling."""
    v = mesh.vertices.cpu().numpy()
    center = (v.min(0) + v.max(0)) / 2.0
    radius = float(np.linalg.norm(v - center, axis=1).max()) * sphere_scaling
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (center + radius * d).astype(np.float32)


def sample_camera_yaw_roll(
    rng: np.random.RandomState, n: int, max_roll_rad: float = 0.052
) -> tuple[np.ndarray, np.ndarray]:
    """yaw ~ U(-pi, pi); roll ~ truncated normal within +-max_roll
    (generate_camera_poses.py:249-281; MAX_CAMERA_ROLL ~ 3 deg)."""
    yaw = rng.uniform(-np.pi, np.pi, n)
    roll = np.clip(rng.randn(n) * (max_roll_rad / 2.0), -max_roll_rad, max_roll_rad)
    return yaw, roll
