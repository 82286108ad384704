"""Surface-normal training step (reference: train_normal.py:256-258), the
port's counterpart of the JAX package's ``train/normal.py``: loss = masked
cosine-angular + 10 * masked L1 over the dilated valid mask; Adam amsgrad
lr 1e-4, wd 2e-6, grad-clip 10. Sharded, as ``train/depth``'s step.
"""
from __future__ import annotations

import torch

from ..augment import augment_batch
from ..data.masks import make_valid_mask
from ..losses import clip, masked_cosine_angular_loss, masked_l1_loss
from .depth import data_shard, global_metrics
from .state import TrainState

L1_WEIGHT = 10.0


def normal_loss_fn(pred: torch.Tensor, batch: dict, group=None):
    """pred (B,3,H,W) from the net; batch: rgb (B,3,H,W) in [0,1] · normal
    (B,3,H,W) in [0,1] · mask_valid (B,1,H,W) bool. -> (loss, metrics);
    group: the data group, whose ranks each return their share."""
    pred = clip(pred, 0.0, 1.0)
    mask3 = make_valid_mask(batch["mask_valid"], 4).repeat_interleave(3, 1)
    cos = masked_cosine_angular_loss(pred, batch["normal"], mask3, group)
    l1 = masked_l1_loss(pred, batch["normal"], mask3, group)
    loss = cos + L1_WEIGHT * l1
    return loss, {"loss": loss, "cos": cos, "l1": l1}


def make_normal_train_step(apply_fn, augment: bool = False, image_size: int = 512):
    """-> train_step(state, batch, generator=None) -> metrics; updates state
    in place. augment=True applies the reference's in-step augmentation
    (train_normal.py:237-241: resize/crop of the whole batch, then the rgb
    cascade)."""

    def train_step(state: TrainState, batch: dict, generator=None):
        shard, group = data_shard(state.mesh)
        if augment:
            batch = augment_batch(batch, generator, image_size, normalize=False, shard=shard)
        loss, metrics = normal_loss_fn(apply_fn(state.net, batch["rgb"]), batch, group)
        loss.backward()
        state.apply_gradients()
        return global_metrics(metrics, group)

    return train_step


def make_normal_eval_step(apply_fn):
    """eval_step(net, batch) -> (metrics, pred); no augmentation."""

    @torch.no_grad()
    def eval_step(net, batch: dict):
        pred = clip(apply_fn(net, batch["rgb"]), 0.0, 1.0)
        _, m = normal_loss_fn(pred, batch)
        return {"val_normal_loss": m["loss"], "cos": m["cos"], "l1": m["l1"]}, pred

    return eval_step
