"""HRNet (High-Resolution Network) for semantic segmentation
(paper_code/models/seg_hrnet.py:1-590, "High-Resolution Representations
for Labeling Pixels and Regions"), the port's counterpart of the JAX
package's ``models/hrnet.py``, on NCHW tensors.

Modules carry the published torch ``seg_hrnet`` key schema — ``conv1`` /
``bn1``, ``conv2`` / ``bn2``, ``layer1.k``, ``transition{s}``,
``stage{s}.m.branches`` / ``fuse_layers``, ``last_layer.{0,1,3}`` — so a
published checkpoint loads with ``strict=True``; ``hrnet_mapping`` (the
port's copy of the JAX package's) pairs each key with its Flax path.

Structure (seg_hrnet.py:271-345):
- stem: two stride-2 3x3 convs (3->64->64), BN+ReLU
- stage1: Bottleneck x num_blocks at 64 channels (out 256)
- stages 2-4: parallel branches at 1/4 .. 1/32 resolution; each stage runs
  NUM_MODULES HighResolutionModules of BasicBlocks followed by full
  cross-resolution fusion (1x1 conv + bilinear up for coarse->fine, chains
  of stride-2 3x3 convs for fine->coarse, sum + ReLU; seg_hrnet.py:189-266)
- transitions insert new coarser branches from the previous stage's last
  branch (seg_hrnet.py:347-384)
- head: upsample all branches to 1/4, concat, 1x1 conv + BN + ReLU + 1x1 to
  n_classes, bilinear (align_corners=True) to the input size

BatchNorm always uses its running statistics (eps 1e-5), computed in
float32 whatever the activation dtype. Convs pad k // 2 on each side, as
the reference's do. The input's height and width must be 1 more than a
multiple of 8, the reference's assert (seg_hrnet.py:446).
"""
from __future__ import annotations

from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn

from .layers import resize_bilinear

# (num_modules, num_blocks, channels) per stage, per variant;
# stage1 is (num_blocks, channels) with Bottleneck
HRNET_CONFIGS = {
    "w18": ((2, 64), (1, 2, (18, 36)), (3, 2, (18, 36, 72)),
            (2, 2, (18, 36, 72, 144))),
    "w32": ((2, 64), (1, 2, (32, 64)), (3, 2, (32, 64, 128)),
            (2, 2, (32, 64, 128, 256))),
    "w48": ((2, 64), (1, 2, (48, 96)), (3, 2, (48, 96, 192)),
            (2, 2, (48, 96, 192, 384))),
}


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d on its running statistics in train and eval mode alike,
    in float32, cast back to the input dtype."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=1e-5)

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight.float(), self.bias.float(), False, 0.0,
                            self.eps).to(x.dtype)


def _conv(i: int, o: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(i, o, k, stride, k // 2, bias=bias)


def _conv_bn(i: int, o: int, k: int, stride: int, relu: bool) -> nn.Sequential:
    mods = [_conv(i, o, k, stride), FrozenBatchNorm2d(o)]
    return nn.Sequential(*(mods + [nn.ReLU()] if relu else mods))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (seg_hrnet.py:37-70), expansion 1."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(planes, planes, 3), FrozenBatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm2d(planes)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1(x4) residual block (seg_hrnet.py:73-115)."""

    def __init__(self, inplanes: int, planes: int, downsample: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), FrozenBatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm2d(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), FrozenBatchNorm2d(planes * 4)
        self.downsample = _conv_bn(inplanes, planes * 4, 1, 1, False) if downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class HighResolutionModule(nn.Module):
    """Per-branch BasicBlocks + full fusion (seg_hrnet.py:118-266)."""

    def __init__(self, channels, num_blocks: int):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c) for _ in range(num_blocks)]) for c in channels)
        self.fuse_layers = None
        if n > 1:
            self.fuse_layers = nn.ModuleList()
            for i in range(n):
                row = nn.ModuleList()
                for j in range(n):
                    if j > i:  # coarser -> 1x1 conv + BN (then bilinear up)
                        row.append(_conv_bn(channels[j], channels[i], 1, 1, False))
                    elif j == i:
                        row.append(None)
                    else:  # finer -> chain of stride-2 3x3 convs
                        row.append(nn.Sequential(*[
                            _conv_bn(channels[j], channels[i] if k == i - j - 1
                                     else channels[j], 3, 2, k != i - j - 1)
                            for k in range(i - j)]))
                self.fuse_layers.append(row)

    def forward(self, xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = ys[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                h = layer(ys[j])
                if j > i:
                    h = resize_bilinear(h, acc.shape[2:], align_corners=False)
                acc = acc + h
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """Full segmentation HRNet (HighResolutionNet, seg_hrnet.py:271-502):
    (B, 3, H, W) -> (B, out_channels, H, W)."""

    def __init__(self, out_channels: int, variant: str = "w18"):
        super().__init__()
        cfg = HRNET_CONFIGS[variant]
        self.variant = variant
        self.conv1, self.bn1 = _conv(3, 64, 3, 2), FrozenBatchNorm2d(64)
        self.conv2, self.bn2 = _conv(64, 64, 3, 2), FrozenBatchNorm2d(64)
        n_blocks1, ch1 = cfg[0]
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if k == 0 else ch1 * 4, ch1, downsample=k == 0)
            for k in range(n_blocks1)])
        prev_ch = [ch1 * 4]
        for s, (n_modules, n_blocks, channels) in enumerate(cfg[1:], start=2):
            trans = nn.ModuleList()
            for i, c in enumerate(channels):
                if i < len(prev_ch):
                    trans.append(_conv_bn(prev_ch[i], c, 3, 1, True)
                                 if prev_ch[i] != c else None)
                else:
                    chain = []
                    for j in range(i + 1 - len(prev_ch)):
                        out_c = c if j == i - len(prev_ch) else prev_ch[-1]
                        chain.append(_conv_bn(prev_ch[-1], out_c, 3, 2, True))
                    trans.append(nn.Sequential(*chain))
            self.add_module(f"transition{s - 1}", trans)
            self.add_module(f"stage{s}", nn.Sequential(*[
                HighResolutionModule(channels, n_blocks) for _ in range(n_modules)]))
            prev_ch = list(channels)
        last = sum(prev_ch)
        self.last_layer = nn.Sequential(
            nn.Conv2d(last, last, 1), FrozenBatchNorm2d(last), nn.ReLU(),
            nn.Conv2d(last, out_channels, 1))
        self.n_stages = len(cfg) - 1

    def forward(self, x):
        H, W = x.shape[2], x.shape[3]
        if (H - 1) % 8 or (W - 1) % 8:
            raise ValueError(f"HRNet input {H}x{W}: height and width must be "
                             "1 more than a multiple of 8")
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s in range(2, self.n_stages + 2):
            trans = getattr(self, f"transition{s - 1}")
            nxt = []
            for i, t in enumerate(trans):
                if i < len(xs):
                    nxt.append(xs[i] if t is None else t(xs[i]))
                else:
                    nxt.append(t(xs[-1]))
            xs = getattr(self, f"stage{s}")(nxt)
        hw = xs[0].shape[2:]
        cat = torch.cat([xs[0]] + [resize_bilinear(h, hw, align_corners=False)
                                   for h in xs[1:]], 1)
        y = self.last_layer(cat)
        return resize_bilinear(y, (H, W), align_corners=True)


def hrnet_mapping(variant: str = "w18") -> Iterator[tuple]:
    """(flax_path, torch_key, kind) triples pairing the JAX package's HRNet
    Flax variables with the torch seg_hrnet state dict."""
    cfg = HRNET_CONFIGS[variant]

    def cbn(flax_prefix, torch_conv, torch_bn):
        yield (f"{flax_prefix}/conv", torch_conv, "conv_nobias")
        yield (f"{flax_prefix}/bn", torch_bn, "bn")

    yield from cbn("stem1", "conv1", "bn1")
    yield from cbn("stem2", "conv2", "bn2")

    n_blocks1, _ = cfg[0]
    for k in range(n_blocks1):
        base = f"layer1.{k}"
        for c in (1, 2, 3):
            yield from cbn(f"layer1_{k}/c{c}", f"{base}.conv{c}", f"{base}.bn{c}")
        if k == 0:
            yield from cbn(f"layer1_{k}/ds", f"{base}.downsample.0",
                           f"{base}.downsample.1")

    prev_ch = [cfg[0][1] * 4]
    for s, (n_modules, n_blocks, channels) in enumerate(cfg[1:], start=2):
        t = f"transition{s - 1}"
        for i, c in enumerate(channels):
            if i < len(prev_ch):
                if prev_ch[i] != c:
                    yield from cbn(f"t{s}_{i}", f"{t}.{i}.0", f"{t}.{i}.1")
            else:
                for j in range(i + 1 - len(prev_ch)):
                    yield from cbn(f"t{s}_{i}_{j}", f"{t}.{i}.{j}.0", f"{t}.{i}.{j}.1")
        for m in range(n_modules):
            mod = f"stage{s}.{m}"
            for i in range(len(channels)):
                for k in range(n_blocks):
                    b = f"{mod}.branches.{i}.{k}"
                    yield from cbn(f"s{s}_m{m}/b{i}_{k}/c1", f"{b}.conv1", f"{b}.bn1")
                    yield from cbn(f"s{s}_m{m}/b{i}_{k}/c2", f"{b}.conv2", f"{b}.bn2")
            if len(channels) > 1:
                for i in range(len(channels)):
                    for j in range(len(channels)):
                        if j > i:
                            f = f"{mod}.fuse_layers.{i}.{j}"
                            yield from cbn(f"s{s}_m{m}/f{i}_{j}", f"{f}.0", f"{f}.1")
                        elif j < i:
                            for k in range(i - j):
                                f = f"{mod}.fuse_layers.{i}.{j}.{k}"
                                yield from cbn(f"s{s}_m{m}/f{i}_{j}_{k}", f"{f}.0",
                                               f"{f}.1")
        prev_ch = list(channels)

    yield ("head1", "last_layer.0", "conv")
    yield ("head_bn", "last_layer.1", "bn")
    yield ("head2", "last_layer.3", "conv")
