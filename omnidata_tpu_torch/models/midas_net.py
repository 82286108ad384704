"""MidasNetSmall, the counterpart of the JAX package's
``models/midas_net.py``: a role-equivalent net in the MidasNet_small slot
(reference: modules/midas/midas_net_custom.py), not weight-for-weight with
a published checkpoint. A compact inverted-residual encoder with
GroupNorm(8) (eps 1e-6, Flax's) feeds DPT's fusion decoder and monocular
head. Module names are the Flax module's, but for the fusion blocks'
``resConfUnit{1,2}`` (Flax ``rcu{1,2}``); ``convert._midas_net_small_mapping``
carries Flax parameters across.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from .dpt import FeatureFusion
from .layers import GroupNorm32, SameConv, resize_bilinear


class InvertedResidual(nn.Module):
    """pw1 1x1 -> gn1 -> relu -> dw 3x3 (SAME, at ``stride``) -> gn2 -> relu
    -> pw2 1x1 -> gn3, plus the input at stride 1 when the widths agree."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, expand: int = 4):
        super().__init__()
        mid = in_ch * expand
        self.residual = stride == 1 and in_ch == features
        self.pw1 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.gn1 = GroupNorm32(8, mid, eps=1e-6)
        self.dw = SameConv(mid, mid, 3, stride, bias=False, groups=mid)
        self.gn2 = GroupNorm32(8, mid, eps=1e-6)
        self.pw2 = nn.Conv2d(mid, features, 1, bias=False)
        self.gn3 = GroupNorm32(8, features, eps=1e-6)

    def forward(self, x):
        y = F.relu(self.gn1(self.pw1(x)))
        y = F.relu(self.gn2(self.dw(y)))
        y = self.gn3(self.pw2(y))
        return y + x if self.residual else y


class MidasNetSmall(nn.Module):
    """Lightweight monocular depth net (the MidasNet_small role): NCHW ->
    non-negative (B, 1, H, W); four levels of ``widths``; H and W multiples
    of 16."""

    def __init__(self, features: int = 64, widths: Sequence[int] = (24, 40, 96, 176)):
        super().__init__()
        self.stem = SameConv(3, 16, 3, 2, bias=False)
        self.stem_gn = GroupNorm32(8, 16, eps=1e-6)
        in_ch = 16
        for i, w in enumerate(widths):
            setattr(self, f"ir{i}a", InvertedResidual(in_ch, w, stride=2 if i else 1))
            setattr(self, f"ir{i}b", InvertedResidual(w, w))
            setattr(self, f"layer{i + 1}_rn", SameConv(w, features, 3, bias=False))
            setattr(self, f"refinenet{i + 1}", FeatureFusion(features))
            in_ch = w
        self.head_conv1 = SameConv(features, features // 2, 3)
        self.head_conv2 = SameConv(features // 2, 32, 3)
        self.head_conv3 = nn.Conv2d(32, 1, 1)

    def forward(self, x):
        H, W = x.shape[-2:]
        h = F.relu(self.stem_gn(self.stem(x)))
        laterals = []
        for i in range(4):
            h = getattr(self, f"ir{i}b")(getattr(self, f"ir{i}a")(h))
            laterals.append(getattr(self, f"layer{i + 1}_rn")(h))
        p = self.refinenet4(laterals[3])
        p = self.refinenet3(p, laterals[2])
        p = self.refinenet2(p, laterals[1])
        p = self.refinenet1(p, laterals[0])
        y = resize_bilinear(self.head_conv1(p), (H, W), align_corners=True)
        y = self.head_conv3(F.relu(self.head_conv2(y)))
        return F.relu(y)
