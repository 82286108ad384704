"""External-benchmark eval loaders + the OASIS normal-eval protocol, the
port's counterpart of the JAX package's ``data/external_eval.py``
(reference: paper_code/oasis_eval_tta.py):

- OASISNormalDataset / OASISNormalDatasetVal (oasis_eval_tta.py:89-246):
  CSV rows with image + normal-pickle paths; the pickle carries an ROI
  bounding box and the ROI normal map; the mask marks nonzero ROI normals.
  Val resizes the short side (default 512).
- NYUNormalDataset (paper_code/data/nyu_dataset.py:62-87): .h5 files with
  'rgb', plus normals_gt/{normals,masks}/NNNN.png companions;
  NYUDepthDataset: .h5 files with 'rgb' and 'depth'.
- evaluate_normals (oasis_eval_tta.py:264-378 valid_normals): forward at a
  fixed input size, bilinear-resize pred/target/mask back to the original
  resolution, L2-normalise, masked per-pixel angle errors; reports
  pixel-weighted MAE, MDAE, and % below 11.25/22.5/30 degrees.

Resizes are PIL's on mode "F" images (``utils.pil_image.pil_float_resize``,
bit for bit), so no PIL is needed. Images are PNGs read by
``cues.encode`` (``load_rgb_u8``, as PIL's ``convert("RGB")`` gives them);
other formats raise. The NYU readers need ``h5py``, imported when an item
is read; without it they raise.
"""
from __future__ import annotations

import csv
import math
import os
import pickle

import numpy as np
import torch

from ..cues.encode import load_png, load_rgb_u8
from ..utils.pil_image import from_png, pil_float_resize


def _resize_chw(arr: np.ndarray, h: int, w: int, method: str = "bilinear") -> np.ndarray:
    """Each channel of a (C, H, W) array as a PIL mode "F" image resized to
    (h, w) with BILINEAR (or NEAREST) -> (C, h, w) float32."""
    return np.stack([pil_float_resize(np.asarray(c, np.float32), (w, h), method)
                     for c in arr])


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the NYU readers read .h5 files with h5py, which is not "
                          "installed here") from e
    return h5py


def _short_side(h: int, w: int, s: int) -> tuple:
    return (s, int(s * w / h)) if w > h else (int(s * h / w), s)


class OASISNormalDataset:
    """CSV -> (rgb, normal, mask, orig_size, name) samples.

    CSV columns follow the OASIS_trainval layout: column 0 is the image
    path, column 3 the normal pickle path (rows with an empty normal column
    are skipped); paths are joined onto ``root``."""

    def __init__(self, csv_filename: str, root: str = "", img_size: int = 256):
        self.img_names: list[str] = []
        self.normal_names: list[str] = []
        with open(csv_filename) as fh:
            reader = csv.reader(fh)
            next(reader)  # header
            for row in reader:
                if len(row) < 4 or not row[3].strip():
                    continue
                self.img_names.append(os.path.join(root, row[0].strip()))
                self.normal_names.append(os.path.join(root, row[3].strip()))
        self.width = self.height = img_size

    def __len__(self):
        return len(self.img_names)

    def _load_raw(self, index: int):
        color = load_rgb_u8(self.img_names[index]).astype(np.float32)
        with open(self.normal_names[index], "rb") as fh:
            nd = pickle.load(fh)
        h, w, _ = color.shape
        normal = np.zeros((h, w, 3), np.float32)
        mask = np.zeros((h, w), np.float32)
        roi = np.asarray(nd["normal"], np.float32)
        y0, y1, x0, x1 = nd["min_y"], nd["max_y"], nd["min_x"], nd["max_x"]
        normal[y0:y1 + 1, x0:x1 + 1] = roi
        mask[y0:y1 + 1, x0:x1 + 1] = (roi != 0).any(-1).astype(np.float32)
        return color, normal, mask

    def _sizes(self, h: int, w: int):
        return self.height, self.width

    def __getitem__(self, index: int):
        color, normal, mask = self._load_raw(index)
        h, w = color.shape[:2]
        rh, rw = self._sizes(h, w)
        rgb = _resize_chw(color.transpose(2, 0, 1), rh, rw) / 255.0
        return {
            "rgb": rgb.astype(np.float32),
            "normal": normal.transpose(2, 0, 1),  # original resolution
            "mask": mask[None],
            "orig_size": (h, w),
            "name": self.img_names[index],
        }


class OASISNormalDatasetVal(OASISNormalDataset):
    """Short-side resize variant used for the published tables
    (oasis_eval_tta.py:177-246)."""

    def __init__(self, csv_filename: str, root: str = "",
                 short_side_size: int = 512, long_side_size: int | None = None):
        super().__init__(csv_filename, root)
        self.short_side_size = short_side_size
        self.long_side_size = long_side_size

    def _sizes(self, h: int, w: int):
        rh, rw = _short_side(h, w, self.short_side_size)
        if self.long_side_size is not None:
            if w > h:
                rw = self.long_side_size
            else:
                rh = self.long_side_size
        return rh, rw


def _h5_arrays(path: str, keys) -> list:
    with _h5py().File(path, "r") as f:
        return [np.asarray(f[k]) for k in keys]


def _rgb_chw(rgb: np.ndarray) -> np.ndarray:
    return rgb if rgb.shape[0] == 3 else rgb.transpose(2, 0, 1)


class NYUNormalDataset:
    """NYU .h5 rgb files + deigen normals_gt companions
    (nyu_dataset.py:62-87): normals_gt/normals/NNNN.png ([0,255] encoded)
    and normals_gt/masks/NNNN.png."""

    def __init__(self, root: str, short_side_size: int = 512):
        self.files = sorted(os.path.join(root, f) for f in os.listdir(root)
                            if f.endswith(".h5"))
        self.root = root
        self.short_side_size = short_side_size

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int):
        path = self.files[index]
        rgb = _rgb_chw(_h5_arrays(path, ("rgb",))[0])
        num = int(os.path.splitext(os.path.basename(path))[0])

        def png(kind):
            return np.asarray(from_png(load_png(os.path.join(
                self.root, "normals_gt", kind, f"{num:04}.png"))), np.float32)

        normal = png("normals") / 255.0 * 2.0 - 1.0
        mask = png("masks")
        if mask.max() > 1:
            mask = mask / 255.0
        h, w = normal.shape[:2]
        rh, rw = _short_side(h, w, self.short_side_size)
        rgb = _resize_chw(rgb.astype(np.float32), rh, rw) / 255.0
        return {
            "rgb": rgb.astype(np.float32),
            "normal": normal.transpose(2, 0, 1),
            "mask": mask[None],
            "orig_size": (h, w),
            "name": path,
        }


class NYUDepthDataset:
    """NYU .h5 files with 'rgb' (3,H,W) uint8 and 'depth' (H,W) float
    meters (paper_code/data/nyu_dataset.py h5_loader) — the depth-eval
    counterpart of NYUNormalDataset; mask = depth within NYU's valid range
    (0.02-10 m)."""

    MIN_DEPTH, MAX_DEPTH = 0.02, 10.0

    def __init__(self, root: str, short_side_size: int = 512):
        self.files = sorted(os.path.join(root, f) for f in os.listdir(root)
                            if f.endswith(".h5"))
        self.short_side_size = short_side_size

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int):
        rgb, depth = _h5_arrays(self.files[index], ("rgb", "depth"))
        rgb, depth = _rgb_chw(rgb), depth.astype(np.float32)
        mask = ((depth > self.MIN_DEPTH) & (depth < self.MAX_DEPTH)).astype(np.float32)
        h, w = depth.shape
        rh, rw = _short_side(h, w, self.short_side_size)
        x = _resize_chw(rgb.astype(np.float32), rh, rw) / 255.0
        return {
            "rgb": x.astype(np.float32),
            "depth": depth[None],
            "mask": mask[None],
            "orig_size": (h, w),
            "name": self.files[index],
        }


def make_oasis_model_fn(model):
    """Model adapter (oasis_eval_tta.py:440-445): [0,1]-encoded normals ->
    [-1,1], z flipped into OASIS coords, L2-normalised."""

    def fn(x_nchw: torch.Tensor) -> torch.Tensor:
        y = torch.clamp(model(x_nchw), 0.0, 1.0) * 2.0 - 1.0  # (B,3,H,W)
        y = torch.cat([y[:, :2], -y[:, 2:3]], 1)
        n = torch.sqrt(torch.sum(y * y, 1, keepdim=True))
        return y / torch.clamp(n, min=1e-8)

    return fn


def evaluate_normals(model_fn, dataset, max_items: int | None = None,
                     fixed_input_size: tuple | None = (512, 512),
                     device: torch.device | str = "cpu") -> dict:
    """The valid_normals protocol (oasis_eval_tta.py:264-378). Per image:
    optionally resize input to fixed size, forward on device, resize
    pred/target/mask to the ORIGINAL resolution, mask, accumulate per-pixel
    angle errors. Aggregates are pixel-weighted over the whole set."""
    errors = []
    n = len(dataset) if max_items is None else min(max_items, len(dataset))
    for i in range(n):
        s = dataset[i]
        x = s["rgb"][None]
        if fixed_input_size is not None:
            x = _resize_chw(x[0], *fixed_input_size)[None]
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
        out = model_fn(xt)
        pred = (out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out))[0]
        h, w = s["orig_size"]
        pred = _resize_chw(pred, h, w)
        target = s["normal"]
        if target.shape[1:] != (h, w):
            target = _resize_chw(target, h, w)
        mask = _resize_chw(s["mask"], h, w)[0] > 0.5
        if not mask.any():
            continue
        p = pred.transpose(1, 2, 0)[mask]
        t = target.transpose(1, 2, 0)[mask]
        p = p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-8)
        t = t / np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-8)
        ang = np.arccos(np.clip((p * t).sum(1), -1.0, 1.0))
        errors.append(ang)

    if not errors:
        raise ValueError("no valid pixels in the evaluation set")
    total = sum(e.size for e in errors)
    mae = math.degrees(sum(float(e.sum()) for e in errors) / total)
    mdae = math.degrees(float(np.median(np.concatenate(errors))))

    def below(th):
        return sum(float((e < math.radians(th)).sum()) for e in errors) / total

    return {"MAE": mae, "MDAE": mdae, "11.25": below(11.25), "22.5": below(22.5),
            "30": below(30.0)}
