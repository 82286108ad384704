"""Task -> array transforms (reference: omnidata_tools/torch/data/transforms.py:29-157),
the port's counterpart of the JAX package's ``data/transforms.py``.

Host-side decode into float32 CHW numpy arrays with the JAX package's
values, without PIL: PNGs are read by ``cues.encode.load_png`` into a
``utils.pil_image.PilArray`` (the pixels PIL would give), and resized by
``utils.pil_image``'s PIL-equal BILINEAR (rgb) and NEAREST (everything
else) resizes.

- rgb/normal/reshading: 8-bit -> [0,1] float CHW
- 16-bit single channel (depths, edges, keypoints): /(2^16-1)
- principal_curvature: first 2 of 3 8-bit channels
- dense labels (segment_semantic/instance/fragments): int64 HW(C)
- clamp_to rescaling: x -> clip(x, 0, max)/max (e.g. depth 8000/65535,
  edge_texture 0.25)
- default_loader: .png, .npy, .json (point_info; pops nonfixated, adds
  building); .hdf5 (hypersim semantics) is not ported yet and raises
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..cues.encode import load_png
from ..utils.pil_image import (
    PilArray,
    from_png,
    pil_bilinear_resize,
    pil_nearest_resize,
)
from . import task_configs


def _to_chw(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img[None]
    return img.transpose(2, 0, 1)


def transform_8bit(img) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    return _to_chw(arr)


def transform_8bit_n_channel(n_channel: int = 1, crop_channels: bool = False):
    def fn(img):
        arr = transform_8bit(img)
        if crop_channels and arr.shape[0] > n_channel:
            arr = arr[:n_channel]
        return arr

    return fn


def transform_16bit_single_channel(img) -> np.ndarray:
    arr = np.asarray(img).astype(np.float32) / (2**16 - 1.0)
    return _to_chw(arr)


def transform_dense_labels(img) -> np.ndarray:
    return np.asarray(img).astype(np.int64)


def transform_fragment(img, move_last_row: bool = True) -> np.ndarray:
    """Reference fragment images (dataloader/transforms.py:103-115): RGB
    pngs used as opaque (H,W,3) face signatures; the official non-hypersim
    release stores the last COLUMN first, which the reference rotates back.
    Our own annotator writes raw int32 .npy face ids — ndarray inputs pass
    through untouched (no quirk to undo)."""
    if isinstance(img, np.ndarray):
        return img.astype(np.int64)
    arr = np.asarray(img)
    if move_last_row and arr.ndim == 3:
        arr = np.concatenate([arr[:, 1:], arr[:, 0][:, np.newaxis, :]], axis=1)
    return arr.astype(np.int64)


def transform_mask_valid(img) -> np.ndarray:
    arr = np.asarray(img, np.float32)
    if arr.max() > 1:
        arr = arr / 255.0
    return _to_chw(arr)


def _rescale_0_max(maxx: float):
    def fn(arr):
        return np.clip(arr, 0.0, maxx) / maxx

    return fn


def _short_side_size(w: int, h: int, image_size: int) -> tuple:
    if w < h:
        return image_size, int(round(h * image_size / w))
    return int(round(w * image_size / h)), image_size


def _resize(img, image_size: int, method: str):
    """Shorter side to image_size, as the JAX package resizes with PIL."""
    if isinstance(img, np.ndarray):
        if img.ndim != 2:
            return img  # npy feature arrays: resizing handled upstream
        # 2D dense-label arrays: nearest short-side resize (PIL mode "I")
        # so the joint square crop sees the SAME scale as the other tasks
        h, w = img.shape
        if min(h, w) == image_size:
            return img
        out = pil_nearest_resize(img.astype(np.int32), _short_side_size(w, h, image_size))
        return out.astype(img.dtype)
    w, h = img.size
    if min(w, h) == image_size:
        return img
    size = _short_side_size(w, h, image_size)
    if method == "bilinear":
        return PilArray(pil_bilinear_resize(img.pixels, size))
    return PilArray(pil_nearest_resize(img.pixels, size, img.special), img.special)


def get_transform(task: str, image_size: int | None = None):
    """Callable image-or-array -> float32 numpy in the reference's convention.

    Curvature keeps its first 2 channels; 16-bit tasks are scaled by 1/65535;
    clamp_to tasks are rescaled to [0,1] by their max; rgb resizes bilinear,
    everything else nearest (transforms.py:76-78)."""
    if task in ("rgb", "normal", "reshading"):
        base = transform_8bit
    elif task == "mask_valid":
        base = transform_mask_valid
    elif task in ("keypoints2d", "keypoints3d", "depth_euclidean",
                  "depth_zbuffer", "edge_texture", "edge_occlusion"):
        base = transform_16bit_single_channel
    elif task in ("principal_curvature", "curvature"):
        base = transform_8bit_n_channel(2, crop_channels=True)
    elif task == "fragments":
        base = transform_fragment
    elif task in ("semantic", "segment_semantic", "segment_instance",
                  "segment_panoptic", "segment_unsup2d", "segment_unsup25d"):
        base = transform_dense_labels
    elif task in ("class_object", "class_scene"):
        base = lambda x: np.asarray(x, np.float32)
        image_size = None
    elif task in ("mesh", "point_info"):
        return None
    else:
        raise NotImplementedError(f"Unknown transform for task {task}")

    steps = [base]
    params = task_configs.task_parameters.get(task, {})
    if "clamp_to" in params:
        minn, maxx = params["clamp_to"]
        if minn > 0:
            raise NotImplementedError("nonzero clamp minimum")
        steps.append(_rescale_0_max(maxx))

    def transform(img):
        if image_size is not None:
            img = _resize(img, image_size, "bilinear" if task == "rgb" else "nearest")
        out = img
        for s in steps:
            out = s(out)
        return out

    return transform


def default_loader(path: str):
    """png/npy/json loader (transforms.py:124-147)."""
    if path.endswith(".hdf5"):
        raise NotImplementedError(
            f"{path}: HDF5 labels (hypersim) are not ported yet; see ROADMAP.md "
            "queue 1, the data item")
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".json"):
        with open(path) as f:
            d = json.load(f)
        d["building"] = os.path.basename(os.path.dirname(path))
        d.pop("nonfixated_points_in_view", None)
        return d
    return from_png(load_png(path, expand_palette=False))
