"""The full MiDaS v2.1 architectures in PyTorch, the counterpart of the
JAX package's ``models/midas_full.py`` (reference: omnidata_tools/torch/
modules/midas/{midas_net.py, midas_net_custom.py, blocks.py}):

- ``MidasNet``, MiDaS v2.1 large: a ResNeXt101-32x8d (WSL) backbone tapped
  after layer1..layer4 (256, 512, 1024, 2048 channels) and the plain
  fusion decoder at 256 features.
- ``MidasNetSmallTF``, MiDaS v2.1 small: a tf_efficientnet_lite3 backbone
  tapped after stages 1, 2, 4 and 6 (32, 48, 136, 384 channels), the
  expanding scratch (64, 128, 256, 512) and the custom fusion decoder.

Both take an NCHW float32 batch and return the non-negative depth (B, H,
W). BatchNorm runs on its running statistics in eval mode. The module
trees carry the published checkpoints' key schemas (midas_v21-f6b98070.pt
and midas_v21_small-70d6b9c8.pt; the torch keys of ``convert._midas_mapping``
and ``convert._midas_small_mapping``), so such a checkpoint loads with
``load_state_dict(strict=True)``. The large net holds
``scratch.refinenet4.resConfUnit1``, which its forward never runs
(refinenet4 gets no lateral input), as the reference does.

Padding: torchvision's ResNeXt pads statically (the stem 3, the grouped
3x3 convolutions 1, the max-pool 1 with -inf), where a stride-2 window
starts on the first pixel; the EfficientNet's stem and depthwise
convolutions pad as Flax's "SAME" does (``layers.SameConv``: the odd pixel
after the image at stride 2).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .dpt import FeatureFusion, ResidualConvUnit
from .layers import SameConv, resize_bilinear

# ---------------------------------------------------------------------------
# shared decoder blocks
# ---------------------------------------------------------------------------

class FeatureFusionBlock(nn.Module):
    """Plain fusion (blocks.py FeatureFusionBlock): the skip through
    resConfUnit1 added, resConfUnit2, x2 align-corners bilinear upsampling."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), align_corners=True)


class FeatureFusionBlockCustom(FeatureFusion):
    """MidasNet_small's fusion (blocks.py FeatureFusionBlock_custom,
    deconv=False, bn=False): DPT's fusion block, whose 1x1 out_conv halves
    the channels when ``expand``."""

    def __init__(self, features: int, expand: bool = False):
        super().__init__(features)
        self.out_conv = nn.Conv2d(features, features // 2 if expand else features, 1)


def _head(features: int, mid: int) -> nn.Sequential:
    """``scratch.output_conv``: conv 3x3 -> x2 bilinear up (corners not
    aligned, blocks.py Interpolate) -> conv 3x3 (32) -> relu -> conv 1x1 (1)
    -> relu (non_negative); weights at indices 0, 2, 4."""
    return nn.Sequential(
        nn.Conv2d(features, mid, 3, padding=1),
        nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
        nn.Conv2d(mid, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())


def _scratch(in_channels, out_channels, fusion) -> nn.Module:
    """``scratch``: layer{i}_rn 3x3 convolutions without bias, refinenet{i}."""
    scratch = nn.Module()
    for i, (c, f) in enumerate(zip(in_channels, out_channels), 1):
        setattr(scratch, f"layer{i}_rn", nn.Conv2d(c, f, 3, padding=1, bias=False))
        setattr(scratch, f"refinenet{i}", fusion(i, f))
    return scratch


def _decode(scratch, feats):
    l1, l2, l3, l4 = (getattr(scratch, f"layer{i}_rn")(t)
                      for i, t in enumerate(feats, 1))
    p4 = scratch.refinenet4(l4)
    p3 = scratch.refinenet3(p4, l3)
    p2 = scratch.refinenet2(p3, l2)
    p1 = scratch.refinenet1(p2, l1)
    return scratch.output_conv(p1)[:, 0]


# ---------------------------------------------------------------------------
# ResNeXt101 32x8d
# ---------------------------------------------------------------------------

class ResNeXtBottleneck(nn.Module):
    """torchvision Bottleneck with groups 32, base width 8: 1x1 -> grouped
    3x3 at the block's stride (padding 1) -> 1x1 (4 planes), BatchNorm eps
    1e-5 after each; the shortcut a strided 1x1 conv + BatchNorm
    (``downsample.0``/``.1``) in each stage's first block."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, groups: int = 32,
                 base_width: int = 8, downsample: bool = False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * 4
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=1, groups=groups,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
            nn.BatchNorm2d(out_ch, eps=1e-5)) if downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNeXt101Backbone(nn.Module):
    """resnext101_32x8d, stages (3, 4, 23, 3), as MiDaS wraps it
    (blocks.py _make_resnet_backbone): ``layer1`` = (conv1 7x7/2 pad 3, bn1,
    relu, max-pool 3/2 pad 1, resnet.layer1), ``layer2..4`` = resnet's.
    Returns the four stage features (strides 4, 8, 16, 32)."""

    def __init__(self, layers=(3, 4, 23, 3)):
        super().__init__()
        stages, in_ch, planes = [], 64, 64
        for si, n in enumerate(layers):
            blocks = []
            for bi in range(n):
                blocks.append(ResNeXtBottleneck(
                    in_ch, planes, stride=(1 if si == 0 or bi else 2),
                    downsample=bi == 0))
                in_ch = planes * 4
            stages.append(nn.Sequential(*blocks))
            planes *= 2
        self.layer1 = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, padding=3, bias=False), nn.BatchNorm2d(64, eps=1e-5),
            nn.ReLU(), nn.MaxPool2d(3, 2, padding=1), stages[0])
        self.layer2, self.layer3, self.layer4 = stages[1:]

    def forward(self, x):
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)
        return feats


class MidasNet(nn.Module):
    """MiDaS v2.1 large (midas_net.py): ResNeXt101-WSL + plain fusion at
    ``features`` 256, head conv(128) -> x2 up -> conv(32) -> relu -> conv(1)
    -> relu. NCHW -> (B, H, W); H and W multiples of 32."""

    def __init__(self, features: int = 256):
        super().__init__()
        self.pretrained = ResNeXt101Backbone()
        self.scratch = _scratch((256, 512, 1024, 2048), (features,) * 4,
                                lambda i, f: FeatureFusionBlock(f))
        self.scratch.output_conv = _head(features, 128)

    def forward(self, x):
        return _decode(self.scratch, self.pretrained(x))


# ---------------------------------------------------------------------------
# tf_efficientnet_lite3
# ---------------------------------------------------------------------------

def _round_channels(c: float, multiplier: float = 1.2, divisor: int = 8) -> int:
    c *= multiplier
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


# EfficientNet-B0 stage spec: (repeats, kernel, stride, expand, channels)
_EFFNET_STAGES = [
    (1, 3, 1, 1, 16),
    (2, 3, 2, 6, 24),
    (2, 5, 2, 6, 40),
    (3, 3, 2, 6, 80),
    (3, 5, 1, 6, 112),
    (4, 5, 2, 6, 192),
    (1, 3, 1, 6, 320),
]


def lite3_stage_channels():
    """tf_efficientnet_lite3 (width 1.2, depth 1.4; lite: the first and last
    stages' repeats not depth-scaled, the stem fixed at 32, no SE, relu6)
    -> (repeats, kernel, stride, expand, channels) per stage."""
    out = []
    for i, (r, k, s, e, c) in enumerate(_EFFNET_STAGES):
        reps = r if i in (0, len(_EFFNET_STAGES) - 1) else int(math.ceil(r * 1.4))
        out.append((reps, k, s, e, _round_channels(c)))
    return out


class MBConvLite(nn.Module):
    """EfficientNet-lite block (no SE, relu6, BatchNorm eps 1e-3), in
    geffnet's names: with ``expand`` 1 a DepthwiseSeparableConv (conv_dw,
    bn1, conv_pw, bn2), else an InvertedResidual (conv_pw, bn1, conv_dw,
    bn2, conv_pwl, bn3). The depthwise conv pads as Flax's "SAME"; the
    input is added back at stride 1 when the widths agree."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, expand: int):
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        self.separable = expand == 1
        if self.separable:
            self.conv_dw = SameConv(in_ch, in_ch, kernel, stride, bias=False, groups=in_ch)
            self.bn1 = nn.BatchNorm2d(in_ch, eps=1e-3)
            self.conv_pw = nn.Conv2d(in_ch, out_ch, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(out_ch, eps=1e-3)
        else:
            mid = in_ch * expand
            self.conv_pw = nn.Conv2d(in_ch, mid, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(mid, eps=1e-3)
            self.conv_dw = SameConv(mid, mid, kernel, stride, bias=False, groups=mid)
            self.bn2 = nn.BatchNorm2d(mid, eps=1e-3)
            self.conv_pwl = nn.Conv2d(mid, out_ch, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        if self.separable:
            y = self.bn2(self.conv_pw(F.relu6(self.bn1(self.conv_dw(x)))))
        else:
            y = F.relu6(self.bn1(self.conv_pw(x)))
            y = F.relu6(self.bn2(self.conv_dw(y)))
            y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


class EfficientNetLite3Backbone(nn.Module):
    """tf_efficientnet_lite3 as MiDaS wraps it (blocks.py
    _make_efficientnet_backbone): ``layer1`` = (conv_stem 3x3/2 SAME, bn1,
    relu6, stage 0, stage 1), ``layer2`` = (stage 2), ``layer3`` = (stages
    3, 4), ``layer4`` = (stages 5, 6). Returns the four taps (strides 4, 8,
    16, 32; 32, 48, 136, 384 channels)."""

    def __init__(self):
        super().__init__()
        stages, in_ch = [], 32
        for reps, k, s, e, c in lite3_stage_channels():
            blocks = []
            for bi in range(reps):
                blocks.append(MBConvLite(in_ch, c, k, s if bi == 0 else 1, e))
                in_ch = c
            stages.append(nn.Sequential(*blocks))
        self.layer1 = nn.Sequential(
            SameConv(3, 32, 3, 2, bias=False), nn.BatchNorm2d(32, eps=1e-3), nn.ReLU6(),
            stages[0], stages[1])
        self.layer2 = nn.Sequential(stages[2])
        self.layer3 = nn.Sequential(stages[3], stages[4])
        self.layer4 = nn.Sequential(stages[5], stages[6])

    def forward(self, x):
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)
        return feats


class MidasNetSmallTF(nn.Module):
    """MiDaS v2.1 small (midas_net_custom.py, blocks={'expand': True}): the
    lite3 taps -> scratch (64, 128, 256, 512) -> custom fusion, each block
    but refinenet1 halving its channels -> head conv(32) -> x2 up ->
    conv(32) -> relu -> conv(1) -> relu. NCHW -> (B, H, W); H and W
    multiples of 32."""

    def __init__(self, features: int = 64):
        super().__init__()
        self.pretrained = EfficientNetLite3Backbone()
        fs = (features, features * 2, features * 4, features * 8)
        self.scratch = _scratch((32, 48, 136, 384), fs,
                                lambda i, f: FeatureFusionBlockCustom(f, expand=i > 1))
        self.scratch.output_conv = _head(features, features // 2)

    def forward(self, x):
        return _decode(self.scratch, self.pretrained(x))
