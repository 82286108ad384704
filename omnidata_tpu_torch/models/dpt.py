"""DPT-hybrid-384 in PyTorch: the counterpart of the JAX package's
``models/dpt.py`` (reference: omnidata_tools/torch/modules/midas/
{dpt_depth.py, vit.py, blocks.py}).

A ResNetV2-50 (3, 4, 9) stem with weight-standardized convs and GroupNorm
feeds a ViT-B/16 at 1/16 resolution; features are tapped at ResNet stages
0-1 and after transformer blocks 8 and 11 ('vitb_rn50_384' hooks), read out
with the cls token ('project'), reassembled, fused by four RefineNet blocks
and decoded by the monocular head. Inputs and outputs are NCHW.

The module tree carries the published checkpoints' key schema
(omnidata_dpt_{depth,normal}_v2.ckpt after ``convert.strip_prefix``; the
torch keys of ``convert._dpt_mapping``), so such a checkpoint loads with
``load_state_dict(strict=True)``. Two of its tensors are held but never
used by the forward pass, as in the reference: timm's ImageNet classifier
``pretrained.model.head`` (1000 x 768) and
``scratch.refinenet4.resConfUnit1`` (refinenet4 gets no lateral input).
The final ViT LayerNorm ``pretrained.model.norm`` is held too; DPT taps the
blocks before it.

Any input size divisible by 16 works: the 24 x 24 position-embedding grid
is resized as the JAX model resizes it (``jax.image.resize`` bilinear,
antialiased when the grid shrinks).

The forward pass records three spans (``utils.profiler``, only while a
profiler runs): ``dpt.backbone`` (the ResNet stem and stages),
``dpt.encoder`` (the patch projection, position embedding and
transformer blocks) and ``dpt.decoder`` (reassemble, fusion and head),
and the counter ``dpt.tokens`` (tokens entering the blocks, cls included).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiler
from .layers import (
    EncoderBlock,
    GroupNormAct,
    LayerNorm32,
    SameConv,
    StdConv,
    max_pool_same,
    resize_bilinear,
    resize_scaled,
)


class BottleneckV2(nn.Module):
    """timm resnetv2.Bottleneck (non-preact): conv1/norm1 -> conv2/norm2 ->
    conv3/norm3 (no act) -> + shortcut -> relu; the shortcut is a 1x1 conv +
    norm when the width or stride changes."""

    def __init__(self, in_ch: int, mid: int, out: int, stride: int = 1):
        super().__init__()
        if in_ch != out or stride != 1:
            self.downsample = nn.Module()
            self.downsample.conv = StdConv(in_ch, out, 1, stride)
            self.downsample.norm = GroupNormAct(out, act=False)
        else:
            self.downsample = None
        self.conv1 = StdConv(in_ch, mid, 1)
        self.norm1 = GroupNormAct(mid)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.norm2 = GroupNormAct(mid)
        self.conv3 = StdConv(mid, out, 1)
        self.norm3 = GroupNormAct(out, act=False)

    def forward(self, x):
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample.norm(self.downsample.conv(x))
        y = self.norm1(self.conv1(x))
        y = self.norm2(self.conv2(y))
        y = self.norm3(self.conv3(y))
        return F.relu(y + shortcut)


class ResNetV2Backbone(nn.Module):
    """Stem + stages (3, 4, 9) -> features at strides 4, 8, 16 with 256,
    512, 1024 channels."""

    def __init__(self, layers: Sequence[int] = (3, 4, 9)):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv = StdConv(3, 64, 7, 2)
        self.stem.norm = GroupNormAct(64)
        self.stages = nn.ModuleList()
        in_ch = 64
        for si, (n, (mid, out)) in enumerate(zip(layers, ((64, 256), (128, 512),
                                                          (256, 1024)))):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                BottleneckV2(in_ch if bi == 0 else out, mid, out,
                             2 if (si > 0 and bi == 0) else 1)
                for bi in range(n))
            self.stages.append(stage)
            in_ch = out

    def forward(self, x):
        x = max_pool_same(self.stem.norm(self.stem.conv(x)), 3, 2)
        feats = []
        for stage in self.stages:
            for block in stage.blocks:
                x = block(x)
            feats.append(x)
        return feats


class ProjectReadout(nn.Module):
    """Fuse the cls token into every patch token: concat + Linear + GELU
    (vit.py:36-47, readout='project')."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens, cls_tok):
        readout = cls_tok[:, None, :].expand_as(tokens)
        return self.project(torch.cat([tokens, readout], -1))


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv + skip (blocks.py ResidualConvUnit_custom, bn=False)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = SameConv(features, features, 3)
        self.conv2 = SameConv(features, features, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusion(nn.Module):
    """blocks.py FeatureFusionBlock_custom: the lateral RCU added when there
    is a lateral input, an RCU, x2 align-corners bilinear upsampling, a 1x1
    out conv."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, lateral=None):
        if lateral is not None:
            x = x + self.resConfUnit1(lateral)
        x = self.resConfUnit2(x)
        x = resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), align_corners=True)
        return self.out_conv(x)


def _postprocess(dim: int, down: bool) -> nn.Sequential:
    """act_postprocess3/4 of vit.py:432-460: [ProjectReadout, Transpose,
    Unflatten, Conv1x1, (Conv3x3 stride 2)]; the reshapes hold no weights."""
    mods = [ProjectReadout(dim), nn.Identity(), nn.Identity(), nn.Conv2d(dim, dim, 1)]
    if down:
        mods.append(SameConv(dim, dim, 3, 2))
    return nn.Sequential(*mods)


class DPTHybrid(nn.Module):
    """The whole DPT-hybrid: NCHW float image -> NCHW output with
    ``num_channels`` channels (1: depth head, 3: surface normals;
    dpt_depth.py:87-107)."""

    def __init__(self, num_channels: int = 1, features: int = 256,
                 vit_dim: int = 768, vit_heads: int = 12, vit_blocks: int = 12,
                 hooks: Sequence[int] = (8, 11), pos_grid: int = 24,
                 non_negative: bool = True):
        super().__init__()
        self.hooks, self.pos_grid, self.vit_dim = tuple(hooks), pos_grid, vit_dim
        self.non_negative = non_negative
        self._pe_cache = (None, None)  # (key, the resized embedding) while no grad
        self.pretrained = nn.Module()
        m = self.pretrained.model = nn.Module()
        m.cls_token = nn.Parameter(torch.zeros(1, 1, vit_dim))
        m.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1, vit_dim))
        m.patch_embed = nn.Module()
        m.patch_embed.backbone = ResNetV2Backbone()
        m.patch_embed.proj = nn.Conv2d(1024, vit_dim, 1)
        m.blocks = nn.ModuleList(EncoderBlock(vit_dim, vit_heads)
                                 for _ in range(vit_blocks))
        m.norm = LayerNorm32(vit_dim, eps=1e-6)  # held; DPT taps before it
        m.head = nn.Linear(vit_dim, 1000)  # held; timm's unused classifier
        self.pretrained.act_postprocess3 = _postprocess(vit_dim, down=False)
        self.pretrained.act_postprocess4 = _postprocess(vit_dim, down=True)
        f = features
        self.scratch = nn.Module()
        for i, c in enumerate((256, 512, vit_dim, vit_dim), 1):
            setattr(self.scratch, f"layer{i}_rn", SameConv(c, f, 3, bias=False))
            setattr(self.scratch, f"refinenet{i}", FeatureFusion(f))
        self.scratch.output_conv = nn.Sequential(
            SameConv(f, f // 2, 3), nn.Identity(), SameConv(f // 2, 32, 3),
            nn.ReLU(), nn.Conv2d(32, num_channels, 1))

    def _pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        pe = self.pretrained.model.pos_embed
        if (gh, gw) == (self.pos_grid, self.pos_grid):
            return pe
        key = (gh, gw, pe._version, pe.device, pe.dtype)
        if not torch.is_grad_enabled() and self._pe_cache[0] == key:
            return self._pe_cache[1]  # inference: no copy to the device to capture
        g = pe[:, 1:].reshape(1, self.pos_grid, self.pos_grid, -1).permute(0, 3, 1, 2)
        g = resize_scaled(g, (gh, gw), "linear")
        out = torch.cat([pe[:, :1], g.flatten(2).transpose(1, 2)], 1)
        if not torch.is_grad_enabled():
            self._pe_cache = (key, out)
        return out

    def stages(self):
        """The forward pass as (span name, function) stages, each function
        taking the previous one's tensors: the ResNet, the ViT, the decoder.
        ``forward`` runs them in turn, each in its span;
        ``registry.Predictor.graphed`` replays each as a CUDA graph in the
        same span."""
        return (("dpt.backbone", self._backbone), ("dpt.encoder", self._encoder),
                ("dpt.decoder", self._decoder))

    def forward(self, x):
        out = (x,)
        for name, stage in self.stages():
            with profiler.span(name):
                out = stage(*out)
        return out[0]

    def _backbone(self, x):
        return tuple(self.pretrained.model.patch_embed.backbone(x))

    def _encoder(self, layer_1, layer_2, feat):
        m = self.pretrained.model
        B, (gh, gw) = feat.shape[0], feat.shape[-2:]
        tokens = m.patch_embed.proj(feat).flatten(2).transpose(1, 2)  # (B, N, C)
        seq = torch.cat([m.cls_token.expand(B, -1, -1).to(tokens.dtype), tokens], 1)
        seq = seq + self._pos_embed(gh, gw).to(tokens.dtype)
        if profiler.recording():
            profiler.count("dpt.tokens", B * seq.shape[1])
        hooked = {}
        for i, block in enumerate(m.blocks):
            seq = block(seq)
            if i in self.hooks:
                hooked[i] = seq
        return layer_1, layer_2, hooked[self.hooks[0]], hooked[self.hooks[1]]

    def _decoder(self, layer_1, layer_2, tokens_3, tokens_4):
        B = layer_2.shape[0]
        gh, gw = (-(-n // 2) for n in layer_2.shape[-2:])  # the ViT's grid

        def tokens_to_map(t, post):
            r = post[0](t[:, 1:], t[:, 0])
            return r.transpose(1, 2).reshape(B, self.vit_dim, gh, gw)

        p3, p4 = self.pretrained.act_postprocess3, self.pretrained.act_postprocess4
        layer_3 = p3[3](tokens_to_map(tokens_3, p3))
        layer_4 = p4[4](p4[3](tokens_to_map(tokens_4, p4)))

        s = self.scratch
        path4 = s.refinenet4(s.layer4_rn(layer_4))
        path3 = s.refinenet3(path4, s.layer3_rn(layer_3))
        path2 = s.refinenet2(path3, s.layer2_rn(layer_2))
        path1 = s.refinenet1(path2, s.layer1_rn(layer_1))

        head = s.output_conv
        y = head[0](path1)
        y = resize_bilinear(y, (y.shape[-2] * 2, y.shape[-1] * 2), align_corners=True)
        y = head[4](head[3](head[2](y)))
        return (F.relu(y) if self.non_negative else y,)
