"""Test-time augmentation for surface normals — the role of the reference's
``tta.SurfaceNormalsTTAWrapper(model, transforms, merger_fn=MedianMerger)``
in paper_code/oasis_eval_tta.py:446-447, the port's counterpart of the JAX
package's ``models/tta.py``: run the model over a set of input
augmentations, invert each prediction back into the original frame
(horizontal flip also negates the normal x component; scales resize back),
merge with a per-pixel median or mean, then L2-normalise.

The median is ``jnp.median``'s: of an even number of members it is the
mean of the two middle values (``torch.median`` returns the lower one, so
identity + flip, two members, would differ on every pixel). The scale
resizes are ``jax.image.resize``'s bilinear, antialiased when shrinking
(``layers.resize_scaled``).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .layers import resize_scaled


def median(stack: torch.Tensor) -> torch.Tensor:
    """``jnp.median(stack, axis=0)``: the middle of the sorted members, or
    the mean of the two middle ones for an even count."""
    s = torch.sort(stack, dim=0).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return s[n // 2 - 1] * 0.5 + s[n // 2] * 0.5


class SurfaceNormalsTTA:
    """Wrap model_fn (x_nchw -> normals (B, 3, H, W), [-1, 1]) with flip /
    scale TTA. transforms = identity, [hflip], and any extra scales."""

    def __init__(self, model_fn: Callable, hflip: bool = True,
                 scales: Sequence[float] = (), merger: str = "median"):
        self.model_fn = model_fn
        self.hflip = hflip
        self.scales = tuple(scales)
        self.merger = merger

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2], x.shape[3]
        preds = [self.model_fn(x)]
        if self.hflip:
            y = torch.flip(self.model_fn(torch.flip(x, (-1,))), (-1,))
            # mirror flips the x component of a normal field
            y = torch.cat([-y[:, :1], y[:, 1:]], 1)
            preds.append(y)
        for s in self.scales:
            # snap to the backbone stride (DPT needs H, W % 16 == 0)
            sh = max(16, int(round(H * s / 16.0)) * 16)
            sw = max(16, int(round(W * s / 16.0)) * 16)
            y = self.model_fn(resize_scaled(x, (sh, sw), "linear"))
            preds.append(resize_scaled(y, (H, W), "linear"))
        stack = torch.stack(preds)
        merged = median(stack) if self.merger == "median" else torch.mean(stack, 0)
        n = torch.sqrt(torch.sum(merged * merged, 1, keepdim=True))
        return merged / torch.clamp(n, min=1e-8)
