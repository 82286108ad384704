"""Evaluation metrics (reference: paper_code/evaluation_metrics.py:13-110),
the port's counterpart of the JAX package's ``train/metrics.py``: normals —
mean/median angular error, % within 11.25/22.5/30 degrees, masked L1/MSE
x100; depth — log10, si-log, relative error, irmse.

Torch reductions in the inputs' dtype (float32, or float64 given float64
normals), except the masked median: the angles come to the host and numpy
takes the median over the ragged valid set, as in the JAX package
(``torch.median`` returns the lower middle value of an even count).
Inputs NCHW, masks (B, 1, H, W) boolean; each function returns a dict of
Python floats.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _flatten(pred, target, mask):
    C = pred.shape[1]
    p = pred.permute(0, 2, 3, 1).reshape(-1, C)
    t = target.permute(0, 2, 3, 1).reshape(-1, C)
    m = mask[:, 0].reshape(-1)
    return p, t, m


def normal_metrics(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> dict:
    """pred/target are unit-ish normal fields in [-1, 1] (C = 3)."""
    p, t, m = _flatten(pred, target, mask)
    dt = torch.float64 if p.dtype == torch.float64 else torch.float32
    mf = m.to(dt)
    nvalid = torch.clamp(mf.sum(), min=1.0)

    def norm(a):
        return torch.sqrt(torch.sum(a * a, 1))

    w12 = torch.sum(p * t, 1)
    cos = torch.clamp(w12 / torch.clamp(norm(p) * norm(t), min=1e-8), -1.0, 1.0)
    ang = torch.arccos(cos) * 180.0 / math.pi

    ang_mean = torch.sum(ang * mf) / nvalid

    def within(d):
        return torch.sum((ang <= d).to(dt) * mf) / nvalid

    ang_np = ang.cpu().numpy()
    m_np = m.cpu().numpy()
    ang_median = float(np.median(ang_np[m_np])) if m_np.any() else 0.0

    np_ = p / (norm(p)[:, None] + 2e-2)
    nt = t / (norm(t)[:, None] + 2e-2)
    diff = torch.abs(np_ - nt) * mf[:, None]
    ratio = m.shape[0] / nvalid
    l1 = torch.mean(torch.abs(diff)) * ratio
    mse = torch.mean(diff ** 2) * ratio

    return {
        "ang_error_mean": float(ang_mean),
        "ang_error_median": ang_median,
        "percentage_within_11.25_degrees": float(within(11.25)),
        "percentage_within_22.5_degrees": float(within(22.5)),
        "percentage_within_30_degrees": float(within(30.0)),
        "eval_L1": float(l1 * 100),
        "eval_mse": float(mse * 100),
    }


def depth_metrics(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> dict:
    """Depth in the reference's [0, 1] encoding (C = 1)."""
    p, t, m = _flatten(pred, target, mask)
    mf = m.to(torch.float32)[:, None]
    nvalid = torch.clamp(mf.sum(), min=1.0)
    ratio = m.shape[0] / nvalid

    diff = torch.abs(p - t) * mf
    log10_diff = torch.mean(torch.log(1 + 64 * diff) * mf) * ratio
    logs = torch.abs(torch.log(1 + 64 * p) - torch.log(1 + 64 * t)) * mf
    log10 = torch.mean(logs) * ratio
    si_log = torch.sum(logs ** 2) / nvalid - (torch.sum(logs) ** 2) / (nvalid ** 2)
    rel = torch.mean(diff / torch.clamp(t, min=1e-12) * mf) * ratio
    irmse = torch.mean(((1.0 / (1 + 64 * p) - 1.0 / (1 + 64 * t)) ** 2) * mf) * ratio
    l1 = torch.mean(diff) * ratio
    mse = torch.mean(diff ** 2) * ratio

    return {
        "eval_L1": float(l1 * 100),
        "eval_mse": float(mse * 100),
        "log10_diff": float(log10_diff),
        "log10": float(log10),
        "si_log": float(si_log),
        "rel_error": float(rel),
        "irmse": float(irmse),
    }
