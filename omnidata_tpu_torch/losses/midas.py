"""MiDaS scale-shift-invariant depth loss + gradient-matching regularizer
(reference: omnidata_tools/torch/losses/midas_loss.py:10-157), the port's
counterpart of the JAX package's ``losses/midas.py``.

- ``ssi_mae``: median/MAD alignment of pred & gt over valid pixels, then
  masked L1.
- ``gradient_matching_term``: multi-scale masked gradient L1 on inverse depth
  aligned to inverse gt by least-squares scale/shift.
- ``midas_loss``: total = ssi + alpha * reg  (alpha=0.1, reduction='image-based').

Masked medians sort with invalid pixels pushed to the float maximum; the
sort is stable, as ``jnp.sort`` is, so that among equal values the gradient
reaches the same element as JAX's.

``group``: the data group of a sharded step, None in one process (see
``losses.masked``). The alignments are per image and stay local; only the
reductions over the batch take all-reduced denominators.
"""
from __future__ import annotations

import torch

from ..utils.collectives import all_sum
from .masked import masked_l1_loss


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row masked (lower) median. x, mask: (..., N) -> (...); rows with
    no valid element give 0 (torch.nanmedian's lower median otherwise)."""
    big = torch.finfo(x.dtype).max
    xs, _ = torch.sort(torch.where(mask, x, x.new_tensor(big)), dim=-1, stable=True)
    count = mask.sum(-1)
    idx = torch.clamp((count - 1).div(2, rounding_mode="floor"), 0, x.shape[-1] - 1)
    med = torch.gather(xs, -1, idx[..., None])[..., 0]
    return torch.where(count > 0, med, med.new_tensor(0.0))


def masked_shift_and_scale(depth_pred: torch.Tensor, depth_gt: torch.Tensor,
                           mask_valid: torch.Tensor):
    """Align pred & gt by masked median shift and mean-abs-dev scale.

    Shapes: (B, C, H, W); mask boolean. Returns (pred_aligned, gt_aligned).
    Reference: midas_loss.py:33-56 (note the ``sum(mask) + 1`` denominator).
    """
    B, C = depth_pred.shape[:2]
    mflat = mask_valid.reshape(B, C, -1)
    m = mflat.to(depth_pred.dtype)
    mask_sum = m.sum(-1, keepdim=True) + 1.0

    def align(x):
        xf = x.reshape(B, C, -1)
        t = _masked_median(xf, mflat)[..., None]
        s = (torch.abs(xf - t) * m).sum(-1, keepdim=True) / mask_sum
        return ((xf - t) / (s + 1e-6)).reshape(x.shape)

    return align(depth_pred), align(depth_gt)


def ssi_mae(depth_pred: torch.Tensor, depth_gt: torch.Tensor,
            mask_valid: torch.Tensor, group=None) -> torch.Tensor:
    """Scale-shift-invariant masked L1 (midas_loss.py:104-112)."""
    pred_a, gt_a = masked_shift_and_scale(depth_pred, depth_gt, mask_valid)
    return masked_l1_loss(pred_a, gt_a, mask_valid, group)


def compute_scale_and_shift(prediction: torch.Tensor, target: torch.Tensor,
                            mask: torch.Tensor):
    """Least-squares (scale, shift) aligning prediction to target over mask.
    Shapes: (B, H, W). Reference: midas_loss.py:10-30."""
    m = mask.to(prediction.dtype)
    a_00 = torch.sum(m * prediction * prediction, (1, 2))
    a_01 = torch.sum(m * prediction, (1, 2))
    a_11 = torch.sum(m, (1, 2))
    b_0 = torch.sum(m * prediction * target, (1, 2))
    b_1 = torch.sum(m * target, (1, 2))
    det = a_00 * a_11 - a_01 * a_01
    valid = det != 0
    zero = det.new_tensor(0.0)
    denom = torch.where(valid, det + 1e-6, det.new_tensor(1.0))
    x_0 = torch.where(valid, (a_11 * b_0 - a_01 * b_1) / denom, zero)
    x_1 = torch.where(valid, (-a_01 * b_0 + a_00 * b_1) / denom, zero)
    return x_0, x_1


def _gradient_loss_image(prediction, target, mask):
    """Per-image masked gradient L1 sum; returns (image_loss (B,), M (B,))."""
    m = mask.to(prediction.dtype)
    M = torch.sum(m, (1, 2))
    diff = (prediction - target) * m
    grad_x = torch.abs(diff[:, :, 1:] - diff[:, :, :-1]) * (m[:, :, 1:] * m[:, :, :-1])
    grad_y = torch.abs(diff[:, 1:, :] - diff[:, :-1, :]) * (m[:, 1:, :] * m[:, :-1, :])
    return torch.sum(grad_x, (1, 2)) + torch.sum(grad_y, (1, 2)), M


def _reduce(image_loss, M, reduction: str, group=None):
    one = M.new_tensor(1.0)
    if reduction == "batch-based":
        divisor = all_sum(torch.sum(M), group)
        return torch.where(divisor > 0, torch.sum(image_loss) / torch.maximum(divisor, one),
                           divisor.new_tensor(0.0))
    # image-based: per-image mean over valid pixels, then mean over images
    per_image = torch.where(M > 0, image_loss / torch.maximum(M, one), image_loss)
    if group is None:
        return torch.mean(per_image)
    return torch.sum(per_image) / all_sum(M.new_tensor(M.shape[0]), group)


def gradient_matching_term(prediction: torch.Tensor, target: torch.Tensor,
                           mask: torch.Tensor, scales: int = 4,
                           reduction: str = "batch-based", group=None) -> torch.Tensor:
    """Multi-scale gradient matching (midas_loss.py:114-134): 2**k strided
    subsampling, k in [0, scales)."""
    total = 0.0
    for scale in range(scales):
        step = 2**scale
        il, M = _gradient_loss_image(prediction[:, ::step, ::step],
                                     target[:, ::step, ::step], mask[:, ::step, ::step])
        total = total + _reduce(il, M, reduction, group)
    return total


def inverse_depth_regularizer(depth_pred: torch.Tensor, depth_gt: torch.Tensor,
                              mask_valid: torch.Tensor, scales: int = 4,
                              reduction: str = "image-based", group=None) -> torch.Tensor:
    """midas_loss's regularizer: gradient matching on inverse depth, the
    inverse prediction least-squares aligned to the inverse gt."""
    pred_inv = 1.0 / (depth_pred[:, 0] + 1e-6)
    gt_inv = 1.0 / (depth_gt[:, 0] + 1e-6)
    m = mask_valid[:, 0]
    scale, shift = compute_scale_and_shift(pred_inv, gt_inv, m)
    pred_ssi = scale[:, None, None] * pred_inv + shift[:, None, None]
    return gradient_matching_term(pred_ssi, gt_inv, m, scales=scales, reduction=reduction,
                                  group=group)


def midas_loss(depth_pred: torch.Tensor, depth_gt: torch.Tensor,
               mask_valid: torch.Tensor, alpha: float = 0.1, scales: int = 4,
               reduction: str = "image-based", group=None):
    """Full MiDaS loss (midas_loss.py:137-157). Inputs NCHW with C=1 (mask
    boolean). Returns (total, ssi, reg)."""
    ssi = ssi_mae(depth_pred, depth_gt, mask_valid, group)
    reg = inverse_depth_regularizer(depth_pred, depth_gt, mask_valid, scales, reduction,
                                    group)
    return ssi + alpha * reg, ssi, reg
