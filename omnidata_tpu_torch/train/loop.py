"""Shared driver loop pieces: validation evaluation + val-monitored
checkpointing + periodic validation image dumps — the reference's
Lightning semantics (train_normal.py:295-331 log_validation_example_images,
:371-374 ModelCheckpoint(save_top_k, monitor='val_*_loss'),
validation_epoch_end val-loss averaging); the port's counterpart of the JAX
package's ``train/loop.py``.
"""
from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np

from .callbacks import save_validation_images


def run_validation(val_datasets: Sequence, batch_size: int,
                   prepare: Callable[[dict], dict], evaluate: Callable[[dict], tuple],
                   loss_key: str, max_batches: int = 4):
    """Average eval metrics over up to max_batches per component.

    prepare: numpy batch -> device batch dict. evaluate: device batch ->
    (metrics, pred). Returns (mean_val_loss | None, last (rgb, pred, target))."""
    losses = []
    sample = None
    for ds in val_datasets:
        n = 0
        for batch in ds.batches(min(batch_size, max(1, len(ds))), shuffle=False):
            b = prepare(batch)
            metrics, pred = evaluate(b)
            losses.append(float(metrics[loss_key]))
            sample = (b["rgb"], pred, b.get("normal", b.get("depth")))
            n += 1
            if n >= max_batches:
                break
    if not losses:
        return None, None
    return float(np.mean(losses)), sample


def dump_val_images(ckpt_dir: str, step: int, sample) -> None:
    if sample is None:
        return
    rgb, pred, target = (x.detach().float().cpu().numpy() for x in sample)
    if rgb.min() < -0.01:  # depth driver feeds [-1,1] rgb
        rgb = (rgb + 1.0) / 2.0
    if pred.ndim == 3:  # (B,H,W) depth predictions
        pred = pred[:, None]
    save_validation_images(os.path.join(ckpt_dir, "val_images"), step, rgb, pred, target)
