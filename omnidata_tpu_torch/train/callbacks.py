"""Training callbacks (reference behaviors), the port's counterpart of the
JAX package's ``train/callbacks.py``:

- crash dump: on any exception in the step loop, save params + the offending
  batch for post-mortem (train_normal.py:188-203,341-348
  register_save_on_error_callback / crash_model.pth + crash_batch.pth)
- validation image dumps every val_step steps (train_normal.py:295-331),
  written as PNGs by ``cues.encode.save_png``
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..cues.encode import save_png


def save_crash_dump(directory: str, params: dict, batch: dict,
                    error: BaseException) -> str:
    os.makedirs(directory, exist_ok=True)
    host = lambda tree: {k: v.detach().cpu() if torch.is_tensor(v) else v
                         for k, v in tree.items()}
    torch.save(host(params), os.path.join(directory, "crash_model.pth"))
    torch.save(host(batch), os.path.join(directory, "crash_batch.pth"))
    with open(os.path.join(directory, "crash_error.txt"), "w") as fh:
        fh.write(repr(error))
    return directory


def save_validation_images(directory: str, step: int, rgb, pred, target) -> None:
    """Side-by-side rgb | prediction | target PNG per sample (first 4);
    numpy (B,C,H,W) arrays in [0, 1]."""
    os.makedirs(directory, exist_ok=True)

    def to_img(x):
        x = np.asarray(x)
        if x.ndim == 3 and x.shape[0] in (1, 3):
            x = x.transpose(1, 2, 0)
        if x.ndim == 2:
            x = x[..., None]
        if x.shape[-1] == 1:
            x = np.repeat(x, 3, -1)
        return (np.clip(x, 0, 1) * 255).astype(np.uint8)

    for i in range(min(4, len(rgb))):
        row = np.concatenate([to_img(rgb[i]), to_img(pred[i]), to_img(target[i])], 1)
        save_png(os.path.join(directory, f"step{step}_sample{i}.png"), row)
