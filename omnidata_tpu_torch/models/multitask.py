"""Multi-task architectures — capability match for the reference's paper
code (paper_code/models/: multi_task_model.py shared-encoder/per-head,
MTAN attention variant (mtan.py:49), PADNet intermediate-prediction
distillation (padnet.py:86), cross-stitch soft sharing (cross_stitch.py:57))
over a ResNet-ish encoder, the port's counterpart of the JAX package's
``models/multitask.py``, on NCHW tensors.

Each module and parameter keeps its Flax name (``backbone``,
``head_{task}``, ``stage{i}_{t}``, ``stitch{i}``, ...), so a Flax tree maps
onto ``state_dict()`` one to one (``convert.state_dict_from_flax_tree``).
Flax's conventions are kept: ``padding="SAME"`` is TF's, asymmetric at
stride 2 (``layers.same_pad``); dilated 3x3 convs at stride 1 pad the
dilation on each side; GroupNorm has eps 1e-6 (torch's default is 1e-5);
bilinear resizes are half-pixel (``align_corners=False``). A model returns
a dict of (B, C, H, W) tensors, one per task (PADNet adds ``"aux"``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import GroupNorm32, SameConv, resize_bilinear

WIDTHS = (64, 128, 256, 512)


def _gn(ch: int) -> GroupNorm32:
    return GroupNorm32(8, ch, eps=1e-6)


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = SameConv(in_ch, features, 3, stride, bias=False)
        self.gn1 = _gn(features)
        self.conv2 = SameConv(features, features, 3, bias=False)
        self.gn2 = _gn(features)
        self.proj = (SameConv(in_ch, features, 1, stride, bias=False)
                     if in_ch != features or stride != 1 else None)

    def forward(self, x):
        y = F.relu(self.gn1(self.conv1(x)))
        y = self.gn2(self.conv2(y))
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(y + x)


class Encoder(nn.Module):
    """4-stage residual encoder (the resnet18-dilated role of
    multi_task_model.py get_backbone); returns the 4 stages' features."""

    def __init__(self, widths: Sequence[int] = WIDTHS, in_ch: int = 3):
        super().__init__()
        self.widths = tuple(widths)
        self.stem = SameConv(in_ch, widths[0], 7, 2, bias=False)
        self.stem_gn = _gn(widths[0])
        prev = widths[0]
        for i, w in enumerate(widths):
            self.add_module(f"stage{i}_0", ConvBlock(prev, w, 1 if i == 0 else 2))
            self.add_module(f"stage{i}_1", ConvBlock(w, w))
            prev = w

    def forward(self, x):
        x = F.relu(self.stem_gn(self.stem(x)))
        feats = []
        for i in range(len(self.widths)):
            x = getattr(self, f"stage{i}_1")(getattr(self, f"stage{i}_0")(x))
            feats.append(x)
        return feats


class ASPPHead(nn.Module):
    """DeepLab-style head (multi_task_model.py get_head 'deeplab')."""

    RATES = (6, 12, 18)

    def __init__(self, in_ch: int, out_channels: int, features: int = 256):
        super().__init__()
        self.b0 = nn.Conv2d(in_ch, features, 1)
        for i, rate in enumerate(self.RATES):
            self.add_module(f"b{i + 1}", nn.Conv2d(in_ch, features, 3, padding=rate,
                                                   dilation=rate))
        self.gap = nn.Conv2d(in_ch, features, 1)
        self.proj = nn.Conv2d(5 * features, features, 1)
        self.out = nn.Conv2d(features, out_channels, 1)

    def forward(self, x, out_hw):
        branches = [self.b0(x)] + [getattr(self, f"b{i + 1}")(x)
                                   for i in range(len(self.RATES))]
        gap = self.gap(torch.mean(x, dim=(2, 3), keepdim=True))
        branches.append(gap.expand(-1, -1, x.shape[2], x.shape[3]))
        y = F.relu(self.proj(torch.cat(branches, 1)))
        return resize_bilinear(self.out(y), out_hw, align_corners=False)


class MultiTaskModel(nn.Module):
    """Shared encoder + per-task ASPP heads (multi_task_model.py:18-110)."""

    def __init__(self, tasks: dict):
        super().__init__()
        self.tasks = dict(tasks)
        self.backbone = Encoder()
        for t, c in self.tasks.items():
            self.add_module(f"head_{t}", ASPPHead(WIDTHS[-1], c))

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        top = self.backbone(x)[-1]
        return {t: getattr(self, f"head_{t}")(top, (H, W)) for t in self.tasks}


class MTAN(nn.Module):
    """Multi-Task Attention Network: shared encoder + per-task attention
    masks gating the shared features at each stage (mtan.py:49)."""

    def __init__(self, tasks: dict):
        super().__init__()
        self.tasks = dict(tasks)
        self.backbone = Encoder()
        for t, c in self.tasks.items():
            prev = 0
            for i, w in enumerate(WIDTHS):
                self.add_module(f"att_{t}_{i}a", nn.Conv2d(w + prev, w, 1))
                self.add_module(f"att_{t}_{i}b", nn.Conv2d(w, w, 1))
                prev = w
            self.add_module(f"head_{t}", ASPPHead(WIDTHS[-1], c))

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        feats = self.backbone(x)
        outs = {}
        for t in self.tasks:
            a = None
            for i, f in enumerate(feats):
                g = f if a is None else torch.cat(
                    [f, resize_bilinear(a, f.shape[2:])], 1)
                att = F.relu(getattr(self, f"att_{t}_{i}a")(g))
                att = torch.sigmoid(getattr(self, f"att_{t}_{i}b")(att))
                a = att * f
            outs[t] = getattr(self, f"head_{t}")(a, (H, W))
        return outs


class PADNet(nn.Module):
    """Prediction-and-distillation: auxiliary predictions for every task at
    the encoder's scale, re-encoded and fused into final per-task heads
    (padnet.py:86). The auxiliary outputs are returned under "aux"; a loss
    that ignores them leaves ``aux_{t}_out`` without a gradient."""

    def __init__(self, tasks: dict, mid_features: int = 128):
        super().__init__()
        self.tasks = dict(tasks)
        m, T = mid_features, len(self.tasks)
        self.backbone = Encoder()
        for t, c in self.tasks.items():
            self.add_module(f"aux_{t}_conv", SameConv(WIDTHS[-1], m, 3))
            self.add_module(f"aux_{t}_out", nn.Conv2d(m, c, 1))
            self.add_module(f"msg_{t}", SameConv(m, m, 3))
        for t, c in self.tasks.items():
            self.add_module(f"dist_{t}", SameConv(m + T * m, m, 3))
            self.add_module(f"final_{t}", nn.Conv2d(m, c, 1))

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        top = self.backbone(x)[-1]
        aux, msg = {}, {}
        for t in self.tasks:
            h = F.relu(getattr(self, f"aux_{t}_conv")(top))
            aux[t] = getattr(self, f"aux_{t}_out")(h)
            msg[t] = getattr(self, f"msg_{t}")(h)
        fused = torch.cat([msg[t] for t in self.tasks], 1)
        outs = {}
        for t in self.tasks:
            h = F.relu(getattr(self, f"dist_{t}")(torch.cat([msg[t], fused], 1)))
            y = getattr(self, f"final_{t}")(h)
            outs[t] = resize_bilinear(y, (H, W), align_corners=False)
        outs["aux"] = {t: resize_bilinear(a, (H, W), align_corners=False)
                       for t, a in aux.items()}
        return outs


class CrossStitch(nn.Module):
    """Cross-stitch units mixing per-task towers after every stage
    (cross_stitch.py:57): y_t = sum_s alpha[t, s] x_s with learned alpha
    (``stitch{i}``, (T, T), initialised to 0.9 I + 0.1 / T)."""

    def __init__(self, tasks: dict):
        super().__init__()
        self.tasks = dict(tasks)
        names, T = list(self.tasks), len(self.tasks)
        for t in names:
            self.add_module(f"stem_{t}", SameConv(3, WIDTHS[0], 7, 2, bias=False))
            self.add_module(f"stem_gn_{t}", _gn(WIDTHS[0]))
        prev = WIDTHS[0]
        for i, w in enumerate(WIDTHS):
            for t in names:
                self.add_module(f"stage{i}_{t}", ConvBlock(prev, w, 1 if i == 0 else 2))
            self.register_parameter(f"stitch{i}", nn.Parameter(
                torch.eye(T) * 0.9 + torch.full((T, T), 0.1 / T)))
            prev = w
        for t, c in self.tasks.items():
            self.add_module(f"head_{t}", ASPPHead(WIDTHS[-1], c))

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        names = list(self.tasks)
        feats = {t: F.relu(getattr(self, f"stem_gn_{t}")(getattr(self, f"stem_{t}")(x)))
                 for t in names}
        for i in range(len(WIDTHS)):
            for t in names:
                feats[t] = getattr(self, f"stage{i}_{t}")(feats[t])
            stacked = torch.stack([feats[t] for t in names], 0)  # (T, B, C, H, W)
            mixed = torch.einsum("ts,sbchw->tbchw", getattr(self, f"stitch{i}"), stacked)
            feats = {t: mixed[ti] for ti, t in enumerate(names)}
        return {t: getattr(self, f"head_{t}")(feats[t], (H, W)) for t in names}


ARCHS = {"multitask": MultiTaskModel, "mtan": MTAN, "padnet": PADNet,
         "crossstitch": CrossStitch}


def grad_norm_weights(losses: dict, grads_norm: dict, alpha: float = 1.5,
                      initial_losses: dict | None = None) -> dict:
    """GradNorm-style loss balancing (paper_code/losses/loss_balancing.py:3):
    weights pushing per-task gradient norms toward a common scale adjusted
    by relative training rates, summing to the number of tasks. Functional
    single-step form on Python floats, computed in float32 as the JAX
    package computes it; returns {task: float}."""
    tasks = list(losses)
    g = torch.tensor([float(grads_norm[t]) for t in tasks], dtype=torch.float32)
    mean_g = torch.mean(g)
    if initial_losses:
        r = torch.tensor([float(losses[t]) / max(float(initial_losses[t]), 1e-8)
                          for t in tasks], dtype=torch.float32)
        r = r / torch.mean(r)
    else:
        r = torch.ones(len(tasks))
    target = mean_g * r ** alpha
    w = target / torch.clamp(g, min=1e-8)
    w = w * len(tasks) / torch.sum(w)
    return {t: float(w[i]) for i, t in enumerate(tasks)}


class HRNetLite(nn.Module):
    """HRNet-style multi-resolution network (paper_code/models/seg_hrnet.py
    role): parallel high/mid/low-resolution branches with repeated
    cross-resolution fusion, concat-upsampled head. Compact width
    configuration (``hrnet.HRNet`` is the published w18/w32/w48 one)."""

    def __init__(self, out_channels: int, widths: Sequence[int] = (32, 64, 128),
                 n_stages: int = 3, in_ch: int = 3):
        super().__init__()
        self.widths, self.n_stages = tuple(widths), n_stages
        w0 = widths[0]
        self.stem1 = SameConv(in_ch, w0, 3, 2)
        self.stem1_gn = _gn(w0)
        self.stem2 = SameConv(w0, w0, 3, 2)
        self.stem2_gn = _gn(w0)
        for b in range(1, len(widths)):
            self.add_module(f"down_init_{b}", SameConv(widths[b - 1], widths[b], 3, 2))
        for s in range(n_stages):
            for i, w in enumerate(widths):
                self.add_module(f"s{s}_b{i}", ConvBlock(w, w))
            for i, wi in enumerate(widths):
                for j, wj in enumerate(widths):
                    if j != i:
                        self.add_module(f"x{s}_{j}to{i}", nn.Conv2d(wj, wi, 1))
        self.head_proj = nn.Conv2d(sum(widths), widths[-1], 1)
        self.head_out = nn.Conv2d(widths[-1], out_channels, 1)

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        x = F.relu(self.stem1_gn(self.stem1(x)))
        x = F.relu(self.stem2_gn(self.stem2(x)))
        branches = [x]
        for b in range(1, len(self.widths)):
            branches.append(getattr(self, f"down_init_{b}")(branches[-1]))
        n = len(branches)
        for s in range(self.n_stages):
            branches = [getattr(self, f"s{s}_b{i}")(h) for i, h in enumerate(branches)]
            fused = []
            for i in range(n):
                acc = branches[i]
                for j in range(n):
                    if j != i:
                        h = getattr(self, f"x{s}_{j}to{i}")(branches[j])
                        acc = acc + resize_bilinear(h, acc.shape[2:], align_corners=False)
                fused.append(F.relu(acc))
            branches = fused
        top_hw = branches[0].shape[2:]
        cat = torch.cat([resize_bilinear(h, top_hw, align_corners=False)
                         for h in branches], 1)
        y = self.head_out(F.relu(self.head_proj(cat)))
        return resize_bilinear(y, (H, W), align_corners=False)
