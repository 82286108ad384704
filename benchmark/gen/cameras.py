"""The benchmark's cameras: a frozen numpy copy of the port's
``scenes.sample_cameras_np`` (fixated cameras inside the room, Blender's
TRACK_TO look-at, horizontal field of view uniform in [0.7, 1.4] rad)."""
from __future__ import annotations

import numpy as np


def look_at(loc: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """Batched look-at rotation (track -Z, up Y), columns the camera axes."""
    fwd = tgt - loc
    fwd /= np.maximum(np.linalg.norm(fwd, axis=-1, keepdims=True), 1e-30)
    z = -fwd
    up = np.array([0.0, 0.0, 1.0], np.float32)
    x = np.cross(np.broadcast_to(up, z.shape), z)
    xn = np.linalg.norm(x, axis=-1, keepdims=True)
    x = np.where(xn < 1e-8, np.array([1.0, 0.0, 0.0], np.float32),
                 x / np.where(xn < 1e-8, 1.0, xn))
    y = np.cross(z, x)
    y /= np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), 1e-30)
    return np.stack([x, y, z], -1).astype(np.float32)


def sample(n: int, seed: int):
    """(locations (n,3), rotations (n,3,3), fovs (n,)) float32."""
    rng = np.random.RandomState(seed)
    locs = np.stack([rng.uniform(-3.0, 3.0, n), rng.uniform(-3.0, 3.0, n),
                     rng.uniform(1.2, 2.0, n)], -1).astype(np.float32)
    tgts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
                     rng.uniform(0.3, 2.5, n)], -1).astype(np.float32)
    fovs = rng.uniform(0.7, 1.4, n).astype(np.float32)
    return locs, look_at(locs, tgts), fovs
