"""Instance-mask utilities (reference: dataloader/segment_instance.py, 218
LoC): extract per-instance masks/bboxes from label images, stable random
colors, simple overlay rendering. Instance ids come from semantic label
images or from fragment face-id renders mapped through face->instance.

The port's copy of ``omnidata_tpu.data.segment_instance``.
"""
from __future__ import annotations

import numpy as np

_GOLDEN = 0.618033988749895


def random_colors(n: int, seed: int = 0, bright: bool = True) -> np.ndarray:
    """(n,3) float colors, evenly spread hues (golden-ratio walk)."""
    import colorsys

    rng = np.random.RandomState(seed)
    h0 = rng.rand()
    v = 1.0 if bright else 0.7
    cols = [
        colorsys.hsv_to_rgb((h0 + _GOLDEN * i) % 1.0, 0.85, v) for i in range(n)
    ]
    return np.asarray(cols, np.float32)


def extract_instance_masks(labels: np.ndarray, background: int = 0):
    """Label image (H,W) -> (ids (N,), masks (N,H,W) bool) skipping background."""
    ids = np.unique(labels)
    ids = ids[ids != background]
    masks = np.stack([labels == i for i in ids]) if len(ids) else np.zeros(
        (0,) + labels.shape, bool
    )
    return ids, masks


def masks_to_bboxes(masks: np.ndarray) -> np.ndarray:
    """(N,H,W) -> (N,4) [y0, x0, y1, x1] inclusive-exclusive."""
    out = np.zeros((len(masks), 4), np.int32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            out[i] = (ys.min(), xs.min(), ys.max() + 1, xs.max() + 1)
    return out


def fragments_to_instances(face_ids: np.ndarray, face_to_instance: np.ndarray,
                           background: int = 0) -> np.ndarray:
    """Fragment face-id image -> instance-label image through a per-face
    instance table (the renderer's Fragments.face replaces the reference's
    fragment renders)."""
    safe = np.clip(face_ids, 0, len(face_to_instance) - 1)
    inst = face_to_instance[safe]
    return np.where(face_ids >= 0, inst, background)


def overlay_instances(rgb: np.ndarray, labels: np.ndarray, alpha: float = 0.5,
                      background: int = 0) -> np.ndarray:
    """Blend per-instance colors over an RGB image (uint8 HW3 -> uint8)."""
    ids, masks = extract_instance_masks(labels, background)
    out = rgb.astype(np.float32) / 255.0
    cols = random_colors(len(ids))
    for m, c in zip(masks, cols):
        out[m] = (1 - alpha) * out[m] + alpha * c
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
