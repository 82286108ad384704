"""Annotator settings — the reference's flag system
(omnidata_annotator/scripts/settings.py:1-156 + load_settings.py:18-100).

Same three-level cascade: defaults < override_settings.py found walking the
cwd upward < KEY=VAL command-line pairs (values parsed with
ast.literal_eval, falling back to string). Setting names keep the reference's
UPPER_CASE vocabulary so `omnidata-annotate ... with KEY=VAL` invocations
transfer unchanged.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field, fields, replace


@dataclass
class Settings:
    # ---- rendering (settings.py:32-38, 86-89) ----
    RESOLUTION: int = 512
    SENSOR_WIDTH: float = 20.0
    SENSOR_HEIGHT: float = 20.0
    PANO_RESOLUTION: tuple = (2048, 1024)
    DEPTH_ZBUFFER_MAX_DISTANCE_METERS: float = 128.0
    DEPTH_EUCLIDEAN_MAX_DISTANCE_METERS: float = 128.0
    DEPTH_BITS_PER_CHANNEL: int = 16
    COLOR_BITS_PER_CHANNEL: int = 8
    PREFERRED_IMG_EXT: str = "png"

    # ---- camera sampling (settings.py:52-67, 143-144) ----
    MIN_CAMERA_SPACING: float = 1.0
    MIN_CAMERA_HEIGHT: float = 0.2  # above floor, meters (settings.py:56)
    MAX_CAMERA_HEIGHT: float = 2.0  # above floor, meters (settings.py:57)
    MAX_CAMERA_ROLL: float = 3.0  # degrees
    MIN_CAMERA_DISTANCE_TO_MESH: float = 0.3
    FIELD_OF_VIEW_MIN_RADS: float = 0.5235987755982988   # 30 deg
    FIELD_OF_VIEW_MAX_RADS: float = 2.181661564992912    # 125 deg
    MODE: str = "DEBUG"
    SCENE: bool = True  # building (True) vs object (False) sampling
    SPHERE_SCALING_FACTOR: float = 2.0

    # ---- points (generate_points.py knobs) ----
    NUM_POINTS: int = 12
    NUM_POINTS_PER_CAMERA: int = 6  # sweep views per camera (SWEEP mode)
    MIN_VIEWS_PER_POINT: int = 3
    MAX_VIEWS_PER_POINT: int = 25
    POINT_TYPE: str = "CORRESPONDENCES"
    MODEL_FILE: str = ""  # explicit mesh filename (else mesh.ply/mesh.obj)
    RGB_MODEL_FILE: str = ""       # mesh for the rgb task (textured obj)
    SEMANTIC_MODEL_FILE: str = ""  # mesh for the semantic task
    TEXTURE_FILE: str = ""         # explicit texture image for load_obj
    OBJ_AXIS_FORWARD: str = "Y"  # OBJ import axis remap (Blender flags;
    OBJ_AXIS_UP: str = "Z"       # (Y, Z) = identity, files already world-frame)
    GENERATE_CAMERAS: bool = True  # False: reuse camera_poses.json
    CAMERA_POSE_FILE: str = "camera_poses.json"
    NUM_CAMERAS: int = 0           # cap sampled cameras (0 = no cap)
    MIN_CAMERA_DISTANCE: float = 0.0  # min spacing between cameras (alias
    # for MIN_CAMERA_SPACING when set)
    STOP_VIEW_NUMBER: int = -1     # render at most N+1 views per point
    MIN_VIEWS_AFTER_PRUNE: int = 1
    MIN_NONFIXATED_AFTER_PRUNE: int = 1
    CREATE_PANOS: bool = False
    CREATE_FIXATED: bool = True
    CREATE_TRAJECTORY: bool = False

    # ---- per-cue knobs (settings.py:92-136) ----
    MIN_CURVATURE_RADIUS: float = 0.03
    CANNY_RGB_BLUR_SIGMA: float = 3.0
    EDGE_3D_THRESH: float | None = None
    KEYPOINT_SUPPORT_SIZE: float = 0.3
    KEYPOINT_BLUR_RADIUS: int = 0  # pre-blur the gray input of keypoints2d
    # (cv2.GaussianBlur kernel size in the reference; sigma derived as
    # 0.3*((k-1)*0.5 - 1) + 0.8, its k->sigma rule; 0 = off)
    LAMP_ENERGY: float = 2.5
    LAMP_HALF_LIFE_DISTANCE: float = 8.0
    SEGMENTATION_2D_BLUR: float = 3.0
    SEGMENTATION_2D_SCALE: float = 200.0
    SEGMENTATION_2D_CUT_THRESH: float = 0.005
    SEGMENTATION_2D_SELF_EDGE_WEIGHT: float = 1.0
    SEGMENTATION_25D_SCALE: float = 200.0
    SEGMENTATION_25D_DEPTH_WEIGHT: float = 2.0
    SEGMENTATION_25D_NORMAL_WEIGHT: float = 1.0
    SEGMENTATION_25D_EDGE_WEIGHT: float = 10.0
    SEGMENTATION_25D_CUT_THRESH: float = 1.0
    SEGMENTATION_25D_SELF_EDGE_WEIGHT: float = 1.0

    RESOLUTION_X: int = 0  # reference aliases; only square renders are
    RESOLUTION_Y: int = 0  # supported — both must match when set

    # ---- runtime ----
    RANDOM_SEED: int = 42
    MAX_CONCURRENT_PROCESSES: int = 1
    # renderer knobs: tile size / per-tile triangle cap (unused by the
    # batched renderer, kept for the vocabulary) / scan chunk
    RASTER_TILE: int = 32
    RASTER_CAP: int = 4096
    RASTER_CHUNK: int = 128
    MAX_FACE_EDGE_METERS: float = 1.0  # split longer edges at load (0 = off);
    # no-op for real scans, kills pathological big faces (walls as 2 tris)
    VIEWS_PER_DISPATCH: int = 32  # cameras per raster launch
    FORCE_BATCHED_PATH: int = 0  # 1: on the CPU, run the host cues'
    # convolution-shaped prefixes on the device path as on a card (the JAX
    # CLI's batched path off a TPU); the renders are batched either way


def _coerce(value: str):
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def find_override_file(start_dir: str | None = None) -> str | None:
    """Walk cwd -> root looking for override_settings.py (load_settings.py:19-31)."""
    d = os.path.abspath(start_dir or os.getcwd())
    while True:
        cand = os.path.join(d, "override_settings.py")
        if os.path.exists(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def load_settings(argv: list[str] | None = None, start_dir: str | None = None) -> Settings:
    """defaults < override_settings.py < KEY=VAL argv pairs."""
    s = Settings()
    valid = {f.name for f in fields(Settings)}

    path = find_override_file(start_dir)
    if path:
        ns: dict = {}
        with open(path) as fh:
            exec(compile(fh.read(), path, "exec"), {}, ns)  # noqa: S102 — same trust model as the reference
        s = replace(s, **{k: v for k, v in ns.items() if k in valid})

    for arg in argv or []:
        if "=" not in arg:
            continue
        k, v = arg.split("=", 1)
        if k in valid:
            s = replace(s, **{k: _coerce(v)})
    validate_settings(s)
    return s


def validate_settings(s: Settings) -> None:
    """Internal-consistency checks (reference validate_blender_settings,
    load_settings.py:133-156 — minus the Blender version check, which has
    no equivalent here)."""
    if s.CREATE_PANOS and s.CREATE_FIXATED:
        raise RuntimeError(
            "Cannot create both panos and non-panos in the same run. "
            "Either turn off panos or turn off fixated!"
        )
