"""Per-component dataset registry — the role of the reference's component
subclasses (dataloader/component_datasets/*/__init__.py: TaskonomyDataset,
ReplicaDataset, GSOReplicaDataset, HypersimDataset, BlendedMVGDataset).

Components differ in: which tasks they ship, crop policy (hypersim/BlendedMVG
train with random crops, others center — data/omnidata_dataset.py:394-408),
building-name parsing, label remaps (hypersim NYU40), and normal coordinate
frames (hypersim stores world-space normals; transform to camera with the
view pose). This module centralizes those quirks as data + small hooks and
builds configured OmnidataDataset instances.

The port's copy of ``omnidata_tpu.data.components``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .dataset import OmnidataDataset, Options

# NYU40 class names (hypersim semantic labels are NYU40 ids)
NYU40_CLASSES = [
    "void", "wall", "floor", "cabinet", "bed", "chair", "sofa", "table",
    "door", "window", "bookshelf", "picture", "counter", "blinds", "desk",
    "shelves", "curtain", "dresser", "pillow", "mirror", "floor mat",
    "clothes", "ceiling", "books", "refrigerator", "television", "paper",
    "towel", "shower curtain", "box", "whiteboard", "person", "night stand",
    "toilet", "sink", "lamp", "bathtub", "bag", "otherstructure",
    "otherfurniture", "otherprop",
]


def normal_world_to_cam(normal_01: np.ndarray, R_world_from_cam: np.ndarray) -> np.ndarray:
    """Hypersim ships world-frame normals; rotate into the camera frame and
    re-encode to [0,1] (hypersim/__init__.py:60-250 world-normal transform)."""
    n = normal_01 * 2.0 - 1.0  # CHW in [-1,1]
    C, H, W = n.shape
    flat = n.reshape(3, -1)
    cam = R_world_from_cam.T @ flat
    return (cam.reshape(3, H, W) + 1.0) / 2.0


@dataclass
class Component:
    name: str
    default_tasks: tuple = ("rgb", "normal", "depth_zbuffer", "mask_valid")
    random_crop: bool = False
    # depth encoding max meters (clevr/google use shorter ranges, settings.py:87)
    depth_max_meters: float = 128.0
    class_labels: Optional[list] = None
    notes: str = ""


COMPONENTS = {
    "taskonomy": Component(
        "taskonomy",
        default_tasks=(
            "rgb", "normal", "depth_zbuffer", "depth_euclidean", "mask_valid",
            "reshading", "principal_curvature", "edge_texture",
            "edge_occlusion", "keypoints2d", "keypoints3d",
            "segment_unsup2d", "segment_unsup25d",
        ),
    ),
    "replica": Component(
        "replica",
        default_tasks=("rgb", "normal", "depth_zbuffer", "depth_euclidean",
                       "mask_valid", "semantic"),
    ),
    "replica_gso": Component("replica_gso"),
    "gso": Component("gso"),
    "hypersim": Component(
        "hypersim",
        random_crop=True,
        class_labels=NYU40_CLASSES,
        notes="semantic labels are NYU40 ids in per-scene HDF5; normals are "
              "world-frame (use normal_world_to_cam)",
    ),
    "blended_mvg": Component("blended_mvg", random_crop=True),
    "blendedMVS": Component("blendedMVS", random_crop=True),
    "hm3d": Component("hm3d"),
    "clevr_simple": Component("clevr_simple", depth_max_meters=64.0),
    "google_scanned": Component("google_scanned", depth_max_meters=0.5),
}


def make_component_dataset(
    component: str,
    data_path: str,
    tasks: tuple | None = None,
    image_size: int | None = None,
    split: str = "train",
    **kw,
) -> OmnidataDataset:
    """Build an OmnidataDataset with the component's quirks applied."""
    c = COMPONENTS.get(component)
    if c is None:
        raise KeyError(f"unknown component {component!r}; known: {sorted(COMPONENTS)}")
    meta_path = kw.pop("meta_path", None)
    options = Options(
        data_path=data_path,
        tasks=tuple(tasks or c.default_tasks),
        image_size=image_size,
        split=split,
        random_crop=c.random_crop,
        **kw,
    )
    if component == "hypersim":
        from .hypersim import HypersimDataset

        return HypersimDataset(options, meta_path=meta_path)
    return OmnidataDataset(options)
