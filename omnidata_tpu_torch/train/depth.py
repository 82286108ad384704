"""Depth training step (reference: train_depth.py:245-287 _shared_step),
the port's counterpart of the JAX package's ``train/depth.py``.

Loss schedule (train_depth.py:274-279): SSI-only for the first 15k steps,
then ssi + 0.1 * gradient-matching + 10 * virtual-normal. Grad-clip 10,
Adam lr 1e-5. rgb in [-1,1]; predictions clipped to [0,1]; the valid mask is
max-pool dilated (make_valid_mask, train_depth.py:215-242).

Before the switch the regularizer and the VNL are computed as metrics
without a graph: JAX computes them and selects ``ssi`` with ``where``, so
their gradient is zero there and the loss and gradients are the same.
"""
from __future__ import annotations

import torch

from ..augment import augment_batch
from ..data.masks import make_valid_mask
from ..losses import VNLParams, clip, inverse_depth_regularizer, sample_triplets, ssi_mae
from ..losses import vnl_from_indices
from .state import TrainState

SSI_ONLY_STEPS = 15_000
VNL_WEIGHT = 10.0
REG_WEIGHT = 0.1


def depth_loss_fn(pred: torch.Tensor, batch: dict, step: int,
                  triplets: torch.Tensor, vnl_params: VNLParams,
                  schedule: bool = True):
    """pred (B,H,W) from the net; batch: rgb (B,3,H,W) in [-1,1] · depth
    (B,1,H,W) in [0,1] · mask_valid (B,1,H,W) bool. -> (loss, metrics);
    schedule=False gives the post-switch loss at any step (validation)."""
    pred = clip(pred, 0.0, 1.0)[:, None]
    mask = make_valid_mask(batch["mask_valid"], 4)
    ssi = ssi_mae(pred, batch["depth"], mask)
    late = not schedule or step >= SSI_ONLY_STEPS
    with torch.set_grad_enabled(late and torch.is_grad_enabled()):
        reg = inverse_depth_regularizer(pred, batch["depth"], mask)
        # reference train_depth.py:272 passes PREDICTIONS in the gt_depth
        # slot (vnl_loss(depth_preds, depth_gt)): triplet filtering keys on pred
        vnl = vnl_from_indices(pred, batch["depth"], triplets, vnl_params)
    loss = ssi + REG_WEIGHT * reg + VNL_WEIGHT * vnl if late else ssi
    return loss, {"loss": loss, "ssi": ssi, "reg": reg, "vnl": vnl}


def make_depth_train_step(apply_fn, vnl_params: VNLParams, augment: bool = False,
                          image_size: int = 384):
    """-> train_step(state, batch, generator=None, triplets=None) -> metrics
    (device tensors); updates state in place. apply_fn(net, rgb) -> (B,H,W).

    augment=True applies the reference's in-step train augmentation
    (train_depth.py:245-253): resize/crop to image_size, then the rgb
    cascade; batch['rgb'] then arrives in [0,1] and is normalized to
    [-1,1] after augmenting. The triplets are drawn from ``generator``
    unless given."""

    def train_step(state: TrainState, batch: dict, generator=None, triplets=None):
        if augment:
            batch = augment_batch(batch, generator, image_size, normalize=True)
        if triplets is None:
            triplets = sample_triplets(generator, vnl_params, batch["rgb"].device)
        pred = apply_fn(state.net, batch["rgb"])
        loss, metrics = depth_loss_fn(pred, batch, state.step, triplets, vnl_params)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_depth_eval_step(apply_fn, vnl_params: VNLParams):
    """eval_step(net, batch, generator=None, triplets=None) -> (metrics,
    pred): the validation loss in the reference's post-schedule form
    (ssi + 0.1 reg + 10 vnl; no augmentation)."""

    @torch.no_grad()
    def eval_step(net, batch: dict, generator=None, triplets=None):
        if triplets is None:
            triplets = sample_triplets(generator, vnl_params, batch["rgb"].device)
        pred = apply_fn(net, batch["rgb"])
        loss, m = depth_loss_fn(pred, batch, 0, triplets, vnl_params, schedule=False)
        return ({"val_depth_loss": loss, "ssi": m["ssi"], "reg": m["reg"],
                 "vnl": m["vnl"]}, clip(pred, 0.0, 1.0)[:, None])

    return eval_step
