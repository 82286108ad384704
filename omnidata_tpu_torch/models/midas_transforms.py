"""MiDaS input transforms (reference: modules/midas/transforms.py), the
port's counterpart of the JAX package's ``models/midas_transforms.py``:
Resize with keep-aspect and ensure_multiple_of, NormalizeImage,
PrepareForNet. Host-side numpy; ``midas_transform_v21()`` and
``midas_transform_v21_small()`` compose them as the torch hub
'transforms' entry does.

The JAX package resizes through PIL (``Image.resize(size, BICUBIC)`` of
the image truncated to 8 bits); the port reproduces that resize pixel for
pixel with ``utils.pil_image.pil_bicubic_resize``, without PIL.
"""
from __future__ import annotations

import numpy as np

from ..utils.pil_image import pil_bicubic_resize


class Resize:
    """Resize sample['image'] (H,W,3 float [0,1]) to width x height.

    resize_method: 'lower_bound' (output >= target, MiDaS default),
    'upper_bound' (<=), or 'minimal'. keep_aspect_ratio scales both sides by
    one factor; sizes are constrained to multiples of ensure_multiple_of."""

    def __init__(self, width, height, keep_aspect_ratio=True,
                 ensure_multiple_of=32, resize_method="lower_bound"):
        self.w, self.h = width, height
        self.keep = keep_aspect_ratio
        self.mult = ensure_multiple_of
        self.method = resize_method

    def _constrain(self, x, min_val=0, max_val=None):
        y = (np.round(x / self.mult) * self.mult).astype(int)
        if max_val is not None and y > max_val:
            y = (np.floor(x / self.mult) * self.mult).astype(int)
        if y < min_val:
            y = (np.ceil(x / self.mult) * self.mult).astype(int)
        return int(y)

    def get_size(self, width, height):
        sw = self.w / width
        sh = self.h / height
        if self.keep:
            if self.method == "lower_bound":
                s = max(sw, sh)
            elif self.method == "upper_bound":
                s = min(sw, sh)
            else:  # minimal change
                s = sh if abs(1 - sh) < abs(1 - sw) else sw
            sw = sh = s
        if self.method == "lower_bound":
            nh = self._constrain(sh * height, min_val=self.h)
            nw = self._constrain(sw * width, min_val=self.w)
        elif self.method == "upper_bound":
            nh = self._constrain(sh * height, max_val=self.h)
            nw = self._constrain(sw * width, max_val=self.w)
        else:
            nh = self._constrain(sh * height)
            nw = self._constrain(sw * width)
        return nw, nh

    def __call__(self, sample: dict) -> dict:
        img = sample["image"]
        h, w = img.shape[:2]
        nw, nh = self.get_size(w, h)
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)  # truncates, as PIL's input
        sample = dict(sample)
        sample["image"] = pil_bicubic_resize(u8, (nw, nh)).astype(np.float32) / 255.0
        return sample


class NormalizeImage:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample: dict) -> dict:
        sample = dict(sample)
        sample["image"] = (sample["image"] - self.mean) / self.std
        return sample


class PrepareForNet:
    """HWC -> contiguous CHW float32."""

    def __call__(self, sample: dict) -> dict:
        sample = dict(sample)
        sample["image"] = np.ascontiguousarray(
            np.transpose(sample["image"], (2, 0, 1)).astype(np.float32))
        return sample


class Compose:
    def __init__(self, fns):
        self.fns = fns

    def __call__(self, sample):
        for f in self.fns:
            sample = f(sample)
        return sample


def _midas_transform(size: int) -> Compose:
    return Compose([
        Resize(size, size, keep_aspect_ratio=True, ensure_multiple_of=32,
               resize_method="upper_bound"),
        NormalizeImage(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225]),
        PrepareForNet(),
    ])


def midas_transform_v21() -> Compose:
    """default_transform of the midas_v21 hub entry (384, ImageNet stats)."""
    return _midas_transform(384)


def midas_transform_v21_small() -> Compose:
    """small_transform of the midas_v21_small hub entry (256)."""
    return _midas_transform(256)
