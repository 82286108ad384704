"""2D augmentations — the kornia cascade + multi-scale resize/crop of the
reference (omnidata_tools/torch/data/augmentation.py:14-121), the port's
counterpart of the JAX package's ``augment/image_augs.py``.

augment_rgb: probability-gated sharpness -> motion blur -> gaussian blur,
each branch computed and selected with ``torch.where`` on the device (no
host round trip), its draws from an explicit ``torch.Generator``.
resize_crop: joint resize (rgb bilinear, labels nearest as
``jax.image.resize``) or centre/random crop of a task dict to a fixed size.

In a sharded step (``train/parallel``) a rank holds rows [i·B, (i+1)·B) of
a global batch of n·B, ``shard=(i, n)``: the per-image draws are made for
the global batch from the generator every rank seeds alike, and each rank
keeps its rows, so the step draws what the one-process step draws.
resize_crop draws one crop for the whole batch and needs no shard.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..losses.masked import clip
from ..models.layers import resize_bilinear


def _conv2d_same(img: torch.Tensor, kernel_2d: torch.Tensor) -> torch.Tensor:
    """Each channel cross-correlated with an odd k x k kernel, zero "SAME"
    padding."""
    kh, kw = kernel_2d.shape
    B, C, H, W = img.shape
    x = F.pad(img.reshape(B * C, 1, H, W), ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    y = F.conv2d(x, kernel_2d.to(img.dtype).reshape(1, 1, kh, kw))
    return y.reshape(B, C, H, W)


def sharpness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """kornia RandomSharpness: blend with a fixed 3x3 smoothing kernel;
    factor (B,)."""
    k = img.new_tensor([[1.0, 1, 1], [1, 5, 1], [1, 1, 1]]) / 13.0
    out = img + (img - _conv2d_same(img, k)) * factor.reshape(-1, 1, 1, 1)
    return clip(out, 0.0, 1.0)


def _motion_kernels(kernel_size: int = 3, device=None) -> torch.Tensor:
    """(4, k, k) line kernels: horizontal, vertical, diagonal, antidiagonal."""
    k = kernel_size
    mid = torch.arange(k, device=device) == k // 2
    eye = torch.eye(k, device=device)
    horizontal = torch.where(mid[:, None], 1.0, 0.0) / k * torch.ones(1, k, device=device)
    vertical = torch.where(mid[None, :], 1.0, 0.0) / k * torch.ones(k, 1, device=device)
    return torch.stack([horizontal, vertical, eye / k, eye.flip(0) / k])


def motion_blur(img: torch.Tensor, direction, kernel_size: int = 3) -> torch.Tensor:
    """Linear motion blur along direction 0-3 (an int or a 0-d tensor on
    img's device): horizontal, vertical, diagonal, antidiagonal."""
    return _conv2d_same(img, _motion_kernels(kernel_size, img.device)[direction])


def gaussian_blur(img: torch.Tensor, sigma, kernel_size: int = 5) -> torch.Tensor:
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=img.device)
    n = torch.arange(kernel_size, dtype=torch.float32, device=img.device) - (kernel_size - 1) / 2.0
    w = torch.exp(-(n**2) / (2.0 * torch.clamp(sigma, min=1e-6) ** 2))
    w = w / w.sum()
    return _conv2d_same(img, w[:, None] * w[None, :])


def augment_rgb(rgb: torch.Tensor, generator: torch.Generator,
                p_sharpness: float = 0.4, p_motion: float = 0.2,
                p_gauss: float = 0.2, shard: tuple = (0, 1)) -> torch.Tensor:
    """The reference's cascade (augmentation.py:19-67), p-gated per batch;
    ``generator`` lives on rgb's device; shard (i, n): rgb is rows i of n
    equal parts of the global batch."""
    kw = dict(generator=generator, device=rgb.device)
    B, (i, n) = rgb.shape[0], shard
    sf = torch.rand(n * B, **kw)[i * B:(i + 1) * B]
    gates = torch.rand(3, **kw)
    direction = torch.randint(0, 4, (), **kw)
    sigma = 0.1 + 1.9 * torch.rand((), **kw)
    out = torch.where(gates[0] < p_sharpness, sharpness(rgb, sf), rgb)
    out = torch.where(gates[1] < p_motion, motion_blur(out, direction), out)
    return torch.where(gates[2] < p_gauss, gaussian_blur(out, sigma), out)


def _resize_nearest(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """``jax.image.resize(method="nearest")`` of NCHW x: source index
    floor((i + 0.5) in / out) in float32 along each axis that changes."""
    for axis in (2, 3):
        m = x.shape[axis]
        if m == out_size:
            continue
        pos = (torch.arange(out_size, dtype=torch.float32, device=x.device) + 0.5) * m / out_size
        x = x.index_select(axis, torch.floor(pos).to(torch.int64))
    return x


def resize_crop(batch: dict, generator: torch.Generator | None, out_size: int,
                random_crop: bool = False, rgb_keys: tuple = ("rgb",)) -> dict:
    """Joint resize(+crop) of an NCHW task dict to out_size x out_size: a
    crop (centre, or random from ``generator`` when random_crop) where every
    image is at least that large, else rgb resized bilinear and labels
    nearest (reference resize_augmentation:69-121, fixed-size path)."""
    ref = next(v for v in batch.values() if torch.is_tensor(v) and v.dim() >= 4)
    H, W = ref.shape[-2:]
    can_crop = H >= out_size and W >= out_size
    if random_crop and can_crop:
        kw = dict(generator=generator, device=generator.device)
        top = int(torch.randint(0, H - out_size + 1, (), **kw))
        left = int(torch.randint(0, W - out_size + 1, (), **kw))
    else:
        top, left = max(H - out_size, 0) // 2, max(W - out_size, 0) // 2
    out = {}
    for k, v in batch.items():
        if not torch.is_tensor(v) or v.dim() < 4 or tuple(v.shape[-2:]) == (out_size, out_size):
            out[k] = v
        elif can_crop and v.shape[-2] >= out_size and v.shape[-1] >= out_size:
            out[k] = v[..., top:top + out_size, left:left + out_size]
        elif k in rgb_keys:
            out[k] = resize_bilinear(v, (out_size, out_size))
        else:
            out[k] = _resize_nearest(v, out_size)
    return out


def augment_batch(batch: dict, generator: torch.Generator, image_size: int,
                  normalize: bool, shard: tuple = (0, 1)) -> dict:
    """The trainers' in-step augmentation (train_depth.py:245-253,
    train_normal.py:237-241): resize/crop to image_size, the mask back to
    bool, the rgb cascade; normalize maps rgb to [-1, 1] after it (depth).
    shard (i, n): the batch is rows i of n equal parts of the global one."""
    batch = resize_crop(dict(batch), generator, image_size)
    batch["mask_valid"] = batch["mask_valid"] > 0.5
    rgb = augment_rgb(batch["rgb"], generator, shard=shard)
    batch["rgb"] = rgb * 2.0 - 1.0 if normalize else rgb
    return batch
