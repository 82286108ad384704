"""Hypersim component: per-scene camera keyframes, intrinsics metadata,
NYU40 semantics, world-frame normals.

Mirrors the reference's HypersimDataset
(dataloader/component_datasets/hypersim/__init__.py:60-250):
- building names are '<scene>-<camera>' (e.g. 'ai_001_001-cam_00'); the frame
  index plays the role of the point id in the filename grammar
- camera_keyframe/<building>/camera_keyframe_{positions,orientations}.hdf5
  hold per-frame camera pose (orientations R = world-from-cam rotation;
  positions p in asset units); world-to-cam T = -R^T p, scaled to meters
- metadata_camera_parameters.csv holds per-scene M_proj / M_cam_from_uv /
  meters_per_asset_unit / output image dims
- semantic labels are NYU40 ids in HDF5, remapped into the taskonomy label
  space with CLASS_LABEL_TRANSFORM
- normals are stored in WORLD coordinates; rotated into the camera frame at
  load time with the frame's orientation

Metadata lives under <data_path>/_hypersim_meta by default (the reference
vendors it inside the package dir).

The port's copy of ``omnidata_tpu.data.hypersim``; h5py is imported on
first use, and without it the keyframe reader raises an ImportError that
names it."""
from __future__ import annotations

import csv
import os

import numpy as np

from .dataset import OmnidataDataset, Options
from .transforms import h5py_module

# NYU40 id -> taskonomy semantic label id (hypersim/__init__.py:46-49)
CLASS_LABEL_TRANSFORM = [
    0, 116, 87, 62, 41, 38, 39, 42, 85, 119, 122, 98, 123, 68, 82, 102, 78,
    124, 99, 125, 92, 74, 79, 55, 54, 44, 96, 112, 126, 69, 127, 128, 94, 43,
    53, 90, 64, 8, 0, 0, 0,
]

# asset axes -> mesh axes (hypersim/__init__.py:70-75)
COORD_TRANSFORM = np.diag([-1.0, 1.0, -1.0])

# pytorch3d camera convention flip (+X left) (hypersim/__init__.py:92-97)
CAMERA_CONVENTION = np.diag([-1.0, 1.0, 1.0, 1.0])

# center-crop of the 4:3 frame to square NDC: x in [-.75,.75] -> [-1,1]
# (hypersim/__init__.py:101-119 computes the same map by least squares)
CROP_NDC = np.diag([4.0 / 3.0, 1.0, 1.0, 1.0])
CROP_INV_NDC = np.diag([0.75, 1.0, 1.0])
ASPECT = np.diag([4.0 / 3.0, 1.0, 1.0, 1.0])

_META_COLS_PROJ = [[f"M_proj_{i}{j}" for j in range(4)] for i in range(4)]
_META_COLS_UV = [[f"M_cam_from_uv_{i}{j}" for j in range(3)] for i in range(3)]


def load_scene_metadata(csv_path: str) -> dict:
    """metadata_camera_parameters.csv -> {scene_name: {...}} with M_proj (4,4),
    M_cam_from_uv (3,3), meters_per_asset_unit, width/height_pixels."""
    out = {}
    with open(csv_path, newline="") as fh:
        for row in csv.DictReader(fh):
            name = row["scene_name"]
            out[name] = {
                "width_pixels": int(float(row["settings_output_img_width"])),
                "height_pixels": int(float(row["settings_output_img_height"])),
                "meters_per_asset_unit": float(
                    row["settings_units_info_meters_scale"]
                ),
                "M_proj": np.array(
                    [[float(row[c]) for c in r] for r in _META_COLS_PROJ]
                ),
                "M_cam_from_uv": np.array(
                    [[float(row[c]) for c in r] for r in _META_COLS_UV]
                ),
            }
    return out


def load_camera_keyframes(meta_path: str, building: str):
    """(positions (N,3) asset units, orientations (N,3,3) world-from-cam)."""
    h5py = h5py_module("the hypersim keyframe reader")
    d = os.path.join(meta_path, "camera_keyframe", building)
    with h5py.File(os.path.join(d, "camera_keyframe_positions.hdf5"), "r") as f:
        positions = np.asarray(f["dataset"][:], np.float64)
    with h5py.File(
        os.path.join(d, "camera_keyframe_orientations.hdf5"), "r"
    ) as f:
        orientations = np.asarray(f["dataset"][:], np.float64)
    return positions, orientations


def hypersim_pose(positions, orientations, meta, frame: int) -> dict:
    """cam_to_world_R/T + proj_K/proj_K_inv for one frame, with the
    reference's convention chain (hypersim/__init__.py:219-241)."""
    R = orientations[frame]
    p = positions[frame]
    scaling = meta["meters_per_asset_unit"]
    T = -(R.T @ p) * scaling
    # conjugate into mesh axes
    R = COORD_TRANSFORM @ R @ COORD_TRANSFORM.T
    T = COORD_TRANSFORM @ T
    K4 = np.eye(4)
    K4[:] = meta["M_proj"]
    coord4 = np.eye(4)
    coord4[:3, :3] = COORD_TRANSFORM
    K = CROP_NDC @ CAMERA_CONVENTION @ ASPECT @ K4 @ coord4.T
    K_inv = (
        COORD_TRANSFORM
        @ meta["M_cam_from_uv"]
        @ CAMERA_CONVENTION[:3, :3].T
        @ CROP_INV_NDC
    )
    return {
        "cam_to_world_R": R.astype(np.float32),
        "cam_to_world_T": T.astype(np.float32),
        "proj_K": K.astype(np.float32),
        "proj_K_inv": K_inv.astype(np.float32),
    }


class HypersimDataset(OmnidataDataset):
    def __init__(self, options: Options, meta_path: str | None = None):
        self.meta_path = meta_path or os.path.join(
            options.data_path, "_hypersim_meta"
        )
        self._kf_cache: dict = {}
        self._scene_meta: dict | None = None
        super().__init__(options)
        if "normal" in options.tasks:
            self.post_transform_hooks["normal"] = self._normal_world_to_cam
        if "semantic" in options.tasks:
            self.post_transform_hooks["semantic"] = self._semantic_remap

    # ---- metadata ----------------------------------------------------------
    def scene_meta(self, scene: str) -> dict:
        if self._scene_meta is None:
            self._scene_meta = load_scene_metadata(
                os.path.join(self.meta_path, "metadata_camera_parameters.csv")
            )
        return self._scene_meta[scene]

    def keyframes(self, building: str):
        if building not in self._kf_cache:
            self._kf_cache[building] = load_camera_keyframes(
                self.meta_path, building
            )
        return self._kf_cache[building]

    # ---- hooks -------------------------------------------------------------
    def _normal_world_to_cam(self, arr, building, point, view):
        """Normals ship world-frame; rotate into the camera frame
        (n_cam = R_wc^T n_world in mesh axes) and re-encode to [0,1]."""
        positions, orientations = self.keyframes(building)
        R = (
            COORD_TRANSFORM
            @ orientations[int(point)]
            @ COORD_TRANSFORM.T
        )
        n = arr * 2.0 - 1.0  # CHW [0,1] -> [-1,1]
        flat = n.reshape(3, -1)
        cam = R.T @ flat
        return ((cam.reshape(arr.shape) + 1.0) / 2.0).astype(arr.dtype)

    def _semantic_remap(self, arr, building, point, view):
        """NYU40 HDF5 ids (-1/255 = undefined) -> taskonomy label ids."""
        ids = np.asarray(arr)
        lut = np.asarray(CLASS_LABEL_TRANSFORM, np.int32)
        safe = np.clip(ids, 0, len(lut) - 1).astype(np.int64)
        out = lut[safe]
        out[(ids < 0) | (ids == 255)] = 0
        return out

    def _mesh_path(self, building: str) -> str | None:
        """hypersim: mesh/<scene>.ply shared across the scene's cameras
        (reference _build_mesh_path, hypersim/__init__.py:178)."""
        scene = building.split("-")[0]
        p = os.path.join(self.o.data_path, "mesh", f"{scene}.ply")
        return p if os.path.exists(p) else super()._mesh_path(building)

    # ---- pose --------------------------------------------------------------
    def _load_one(self, entry, rng=None):
        out = super()._load_one(entry, rng)
        building = out["building"]
        scene = building.split("-")[0]
        positions, orientations = self.keyframes(building)
        out.update(
            hypersim_pose(
                positions, orientations, self.scene_meta(scene),
                int(out["point"]),
            )
        )
        return out
