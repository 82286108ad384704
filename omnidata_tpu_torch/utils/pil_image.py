"""PIL's image reading and resizing, reproduced in numpy so that the port
needs no PIL: the arrays ``np.asarray(Image.open(png))`` gives, and
``Image.resize`` with the BILINEAR filter (8-bit and 32-bit float images),
the BICUBIC filter (8-bit images) and the NEAREST filter (8-bit, 16-bit
and 32-bit integer and float images), pixel for pixel.

- BILINEAR and BICUBIC on 8-bit images are PIL's fixed-point two-pass
  resampler (``Resample.c``): the filter (triangle of support 1, or Keys'
  cubic with a = -0.5 and support 2) widened by the downscale factor,
  22-bit integer coefficients, the horizontal pass first, each pass
  rounded and clipped to uint8.
- BILINEAR on float images (mode ``"F"``) is PIL's float path: the same
  support and taps, double coefficients divided by their sum, no fixed
  point; each output pixel sums its taps in order in double precision and is
  stored as float32, the horizontal pass first.
- NEAREST: PIL scales by an affine transform with sample positions at pixel
  centres, ``floor(scale (x + 0.5))``. For 8-bit and 32-bit images
  (``ImagingScaleAffine``) the position is accumulated, ``x0 + scale / 2``
  plus ``scale`` once per pixel, in double precision; for 16-bit images
  (``I;16``, a "special" mode in ``Geometry.c``) it is computed directly for
  each pixel. The two differ where a position falls on an integer.
"""
from __future__ import annotations

import functools
import math

import numpy as np

_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point coefficients (Resample.c)


class PilArray:
    """A decoded image as PIL holds it: ``np.asarray`` gives the pixels PIL
    gives, ``size`` is (width, height) and ``special`` marks 16-bit greys
    (mode ``I;16``), which PIL resizes by its own rule."""

    def __init__(self, pixels: np.ndarray, special: bool = False):
        self.pixels = pixels
        self.special = special

    @property
    def size(self) -> tuple:
        return self.pixels.shape[1], self.pixels.shape[0]

    def __array__(self, dtype=None, copy=None):
        return self.pixels if dtype is None else self.pixels.astype(dtype)


def from_png(arr: np.ndarray) -> PilArray:
    """``cues.encode.decode_png``'s array -> the image PIL opens from the
    same file: 16-bit greys stay 16-bit (``I;16``), 16-bit colour images
    keep the high byte of each sample (PIL opens them as 8-bit RGB(A))."""
    if arr.dtype == np.uint16 and arr.ndim == 3:
        return PilArray((arr >> 8).astype(np.uint8))
    return PilArray(arr, special=arr.dtype == np.uint16)


def _bilinear_filter(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic_filter(x: float) -> float:
    """Keys' cubic with a = -0.5, in PIL's order of operations."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# PIL's filters: (function, support at scale 1)
_FILTERS = {"bilinear": (_bilinear_filter, 1.0), "bicubic": (_bicubic_filter, 2.0)}


@functools.lru_cache(maxsize=64)
def _pil_coeffs(in_size: int, out_size: int, method: str = "bilinear"):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for a filter on the
    whole axis -> (source index, integer weight) of each tap of each output
    pixel as read-only (out, ksize) arrays, the weights zero past each
    pixel's own count.

    Bicubic weights go negative. A pass sums a pixel's taps in int32 from
    2^21 on, each term at most 255 times its weight in size, so every
    partial sum lies between 2^21 - 255 N and 2^21 + 255 P, where P and N
    are the row's sums of positive and of negative weights. The weights
    are rounded from taps normalised to sum 1, so P - N is 2^22 within
    ksize; Keys' negative lobes hold 1/12 of the kernel's mass, so N stays
    near 2^22 / 12 and 255 P + 2^21 below about 1.3e9, under 2^31 (2.1e9).
    The check below holds every row to it."""
    fn, support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        k = [int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0
             else int(0.5 + v * (1 << _PRECISION_BITS)) for v in w]
        idx[xx, :xmax] = xmin + np.arange(xmax)
        idx[xx, xmax:] = xmin
        kk[xx, :xmax] = k
    pos, neg = np.where(kk > 0, kk, 0).sum(1), np.where(kk < 0, -kk, 0).sum(1)
    half = 1 << (_PRECISION_BITS - 1)
    if (255 * pos + half).max() >= 2**31 or (255 * neg - half).max() > 2**31:
        raise OverflowError(f"{method} {in_size} -> {out_size}: int32 partial sums "
                            "could overflow")
    kk = kk.astype(np.int32)
    idx.setflags(write=False)
    kk.setflags(write=False)
    return idx, kk


@functools.lru_cache(maxsize=64)
def _pil_coeffs_double(in_size: int, out_size: int):
    """PIL's precompute_coeffs for the bilinear filter -> (source index,
    double weight, tap in range) of each tap of each output pixel as
    read-only (out, ksize) arrays."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    used = np.zeros((out_size, ksize), bool)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        idx[xx, :xmax] = xmin + np.arange(xmax)
        idx[xx, xmax:] = xmin
        kk[xx, :xmax] = w
        used[xx, :xmax] = True
    for a in (idx, kk, used):
        a.setflags(write=False)
    return idx, kk, used


def _pil_pass_float(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One float32 resampling pass of PIL along axis: each output pixel's
    taps summed in order in float64 (taps past its count skipped), then
    rounded to float32."""
    idx, kk, used = _pil_coeffs_double(a.shape[axis], out_size)
    src = np.moveaxis(a, axis, 0)
    wshape = (-1,) + (1,) * (src.ndim - 1)
    ss = np.zeros((out_size,) + src.shape[1:], np.float64)
    for k in range(idx.shape[1]):
        term = src[idx[:, k]].astype(np.float64) * kk[:, k].reshape(wshape)
        ss += np.where(used[:, k].reshape(wshape), term, 0.0)
    return np.ascontiguousarray(np.moveaxis(ss.astype(np.float32), 0, axis))


def pil_float_resize(img: np.ndarray, size: tuple, method: str = "bilinear") -> np.ndarray:
    """PIL's ``Image.fromarray(img, mode="F").resize((w, h), filter)`` of an
    (H, W) float32 image, filter BILINEAR ('bilinear') or NEAREST
    ('nearest')."""
    img = np.asarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f"a mode 'F' image is (H, W), not {img.shape}")
    w, h = size
    if method == "nearest":
        return pil_nearest_resize(img, size)
    if method != "bilinear":
        raise ValueError(f"method {method!r}: 'bilinear' or 'nearest'")
    if img.shape[1] != w:
        img = _pil_pass_float(img, w, 1)
    if img.shape[0] != h:
        img = _pil_pass_float(img, h, 0)
    return np.array(img, np.float32)


def _pil_pass(a: np.ndarray, out_size: int, axis: int, method: str) -> np.ndarray:
    """One 8-bit resampling pass of PIL along axis (0 rows, 1 columns),
    tap by tap in int32 (``_pil_coeffs`` shows the partial sums fit), then
    PIL's ``clip8``: shifted down, clipped to [0, 255]."""
    idx, kk = _pil_coeffs(a.shape[axis], out_size, method)
    src = np.moveaxis(a, axis, 0)
    wshape = (-1,) + (1,) * (src.ndim - 1)
    ss = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for k in range(idx.shape[1]):
        ss += src[idx[:, k]].astype(np.int32) * kk[:, k].reshape(wshape)
    out = np.clip(ss >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def _pil_resize_8bit(img: np.ndarray, size: tuple, method: str) -> np.ndarray:
    """The horizontal pass, then the vertical one, each rounded to uint8 (a
    pass is skipped where its size does not change)."""
    if img.dtype != np.uint8 or (img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"PIL-equal {method} resize takes 8-bit grey or RGB, not "
                         f"{img.dtype} {img.shape} (PIL premultiplies alpha)")
    w, h = size
    if img.shape[1] != w:
        img = _pil_pass(img, w, 1, method)
    if img.shape[0] != h:
        img = _pil_pass(img, h, 0, method)
    return img


def pil_bilinear_resize(img: np.ndarray, size: tuple) -> np.ndarray:
    """PIL's ``Image.resize((w, h), Image.BILINEAR)`` of an (H, W) or
    (H, W, C) uint8 image without alpha."""
    return _pil_resize_8bit(img, size, "bilinear")


def pil_bicubic_resize(img: np.ndarray, size: tuple) -> np.ndarray:
    """PIL's ``Image.resize((w, h), Image.BICUBIC)`` of an (H, W) or (H, W,
    C) uint8 image without alpha (the MiDaS transforms' resize)."""
    return _pil_resize_8bit(img, size, "bicubic")


def _nearest_index(n_in: int, n_out: int, special: bool) -> np.ndarray:
    scale = n_in / n_out
    if special:
        pos = scale * (np.arange(n_out, dtype=np.float64) + 0.5)
    else:
        steps = np.full(n_out, scale)
        steps[0] = scale * 0.5
        pos = np.add.accumulate(steps)  # sequential, as PIL's loop adds
    return np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)


def pil_nearest_resize(img: np.ndarray, size: tuple, special: bool = False) -> np.ndarray:
    """PIL's ``Image.resize((w, h), Image.NEAREST)`` of an (H, W) or (H, W,
    C) image; ``special`` for a 16-bit grey (``I;16``) image."""
    w, h = size
    rows = _nearest_index(img.shape[0], h, special)
    cols = _nearest_index(img.shape[1], w, special)
    return img[rows][:, cols]
