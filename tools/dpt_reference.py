"""A plain float32 reference of DPT-Hybrid depth inference: one functional
forward pass over a state dict, in plain torch operations.

    with exact_float32():
        depth = dpt_forward(state_dict, x, heads=12, hooks=(8, 11))[:, 0]

``x`` is an NCHW float32 batch, normalised as the model expects (depth:
``(rgb / 255 - 0.5) / 0.5``), its sides divisible by 32. The state dict
has the published key schema: the keys of ``omnidata_dpt_depth_v2.ckpt``
once its ``model.`` prefixes are stripped. Every width (the ResNet's
stage depths, the ViT's width, depth and MLP, the decoder's features and
the head's outputs) is read from the tensors' shapes, so a small state
dict of the same schema runs too; the head count and the ViT blocks tapped
are not in the shapes and are arguments. This file imports nothing but
torch.

Written from the papers and the modules they name, not from a port:
- Ranftl, Bochkovskiy, Koltun, "Vision Transformers for Dense Prediction"
  (arXiv:2103.13413): DPT-Hybrid, the reassemble, fusion and head blocks,
  readout "project";
- timm's ``vit_base_r50_s16_384``: a ResNetV2-50 of stages (3, 4, 9)
  without pre-activation, weight-standardised convolutions with TF "SAME"
  padding and GroupNorm(32), a "SAME" max pool in the stem, then a 1 x 1
  projection into a ViT-B/16 of pre-norm blocks (LayerNorm eps 1e-6,
  exact GELU);
- DPT's ``vitb_rn50_384`` backbone: taps after ResNet stages 0 and 1 and
  after ViT blocks 8 and 11, the cls token concatenated to every token and
  projected (Linear + GELU), 1 x 1 convolutions, and a 3 x 3 stride-2
  convolution for the coarsest map; four RefineNet fusion blocks (residual
  conv units without batch norm, x2 bilinear upsampling with aligned
  corners, a 1 x 1 output conv); the monocular head (3 x 3 conv, x2
  upsampling, 3 x 3 conv, ReLU, 1 x 1 conv, ReLU).

Departures, each where the program this is compared with follows the JAX
port of omnidata rather than the published PyTorch code:
- the weight standardisation adds eps 1e-6 to the variance (timm's
  ``StdConv2dSame`` takes eps as an argument);
- the 3 x 3 stride-2 convolution of the coarsest map pads TF "SAME"
  (nothing before, one row and column after, on an even map), where DPT's
  ``nn.Conv2d(padding=1)`` pads one on each side;
- where the token grid differs from the position embedding's (inputs
  other than 384 x 384), the grid is resized bilinearly with antialiasing
  (DPT's ``_resize_pos_embed`` does not antialias); at 384 x 384 nothing
  is resized.

Held in the state dict and never used by the forward pass
(``HELD_UNUSED``): timm's ImageNet classifier, the ViT's final LayerNorm
(DPT taps the blocks before it), and refinenet4's first residual unit
(refinenet4 has no lateral input).

``rounder`` gives the operand rounding of a lower precision: passed as
``rnd``, every input and weight of a convolution or linear layer is
rounded to it (float8 types with a scale of their own per tensor, so its
largest magnitude maps to the type's largest value) and computed on in
float32.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

HELD_UNUSED = ("pretrained.model.head.", "pretrained.model.norm.",
               "scratch.refinenet4.resConfUnit1.")
STAGE_STRIDES = (1, 2, 2)  # ResNetV2's stages: the first block of each strides
BACKBONE = "pretrained.model.patch_embed.backbone."
VIT = "pretrained.model."


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products and convolutions without TF32, inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rounder(dtype: torch.dtype):
    """t -> t rounded to dtype and back (float8: per-tensor scaled)."""
    if torch.finfo(dtype).bits == 8:
        top = torch.finfo(dtype).max

        def rnd(t):
            scale = t.abs().amax().clamp(min=torch.finfo(torch.float32).tiny) / top
            return (t / scale).to(dtype).to(t.dtype) * scale
        return rnd
    return lambda t: t.to(dtype).to(t.dtype)


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """TF "SAME" for a k x k window at stride s: total max((ceil(n / s) - 1)
    s + k - n, 0) per side pair, the odd one after."""
    ph = max((math.ceil(x.shape[-2] / s) - 1) * s + k - x.shape[-2], 0)
    pw = max((math.ceil(x.shape[-1] / s) - 1) * s + k - x.shape[-1], 0)
    if ph == pw == 0:
        return x
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), value=value)


class _Net:
    """The state dict and the operand rounding; one method per layer kind."""

    def __init__(self, sd, rnd):
        self.sd, self.rnd = sd, rnd

    def _ops(self, x, w):
        return (x, w) if self.rnd is None else (self.rnd(x), self.rnd(w))

    def conv(self, x, name: str, stride: int = 1, standardize: bool = False):
        w = self.sd[name + ".weight"]
        b = self.sd[name + ".bias"] if name + ".bias" in self.sd else None
        if standardize:
            var, mean = torch.var_mean(w, dim=(1, 2, 3), correction=0, keepdim=True)
            w = (w - mean) / torch.sqrt(var + 1e-6)
        x, w = self._ops(_pad_same(x, w.shape[-1], stride), w)
        return F.conv2d(x, w, b, stride)

    def linear(self, x, name: str):
        x, w = self._ops(x, self.sd[name + ".weight"])
        return F.linear(x, w, self.sd[name + ".bias"])

    def group_norm(self, x, name: str):
        return F.group_norm(x, 32, self.sd[name + ".weight"], self.sd[name + ".bias"], 1e-5)

    def layer_norm(self, x, name: str):
        w = self.sd[name + ".weight"]
        return F.layer_norm(x, w.shape, w, self.sd[name + ".bias"], 1e-6)

    # ---- ResNetV2 ---------------------------------------------------------

    def bottleneck(self, x, p: str, stride: int):
        shortcut = x
        if p + "downsample.conv.weight" in self.sd:
            shortcut = self.group_norm(
                self.conv(x, p + "downsample.conv", stride, True), p + "downsample.norm")
        y = F.relu(self.group_norm(self.conv(x, p + "conv1", 1, True), p + "norm1"))
        y = F.relu(self.group_norm(self.conv(y, p + "conv2", stride, True), p + "norm2"))
        y = self.group_norm(self.conv(y, p + "conv3", 1, True), p + "norm3")
        return F.relu(y + shortcut)

    def backbone(self, x):
        x = self.conv(x, BACKBONE + "stem.conv", 2, True)
        x = F.relu(self.group_norm(x, BACKBONE + "stem.norm"))
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        feats = []
        for s, stride in enumerate(STAGE_STRIDES):
            b = 0
            while f"{BACKBONE}stages.{s}.blocks.{b}.conv1.weight" in self.sd:
                x = self.bottleneck(x, f"{BACKBONE}stages.{s}.blocks.{b}.",
                                    stride if b == 0 else 1)
                b += 1
            feats.append(x)
        return feats

    # ---- ViT ----------------------------------------------------------------

    def pos_embed(self, gh: int, gw: int):
        pe = self.sd[VIT + "pos_embed"]
        n = math.isqrt(pe.shape[1] - 1)
        if (gh, gw) == (n, n):
            return pe
        grid = pe[:, 1:].reshape(1, n, n, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False,
                             antialias=True)
        return torch.cat([pe[:, :1], grid.flatten(2).transpose(1, 2)], 1)

    def vit_block(self, x, p: str, heads: int):
        B, N, C = x.shape
        h = self.layer_norm(x, p + "norm1")
        qkv = self.linear(h, p + "attn.qkv").reshape(B, N, 3, heads, C // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, heads, N, C / heads)
        attn = ((q @ k.transpose(-2, -1)) * (C // heads) ** -0.5).softmax(-1)
        x = x + self.linear((attn @ v).transpose(1, 2).reshape(B, N, C), p + "attn.proj")
        h = self.layer_norm(x, p + "norm2")
        return x + self.linear(F.gelu(self.linear(h, p + "mlp.fc1")), p + "mlp.fc2")

    def reassemble(self, t, p: str, gh: int, gw: int):
        """Readout "project" then tokens to a (B, C, gh, gw) map."""
        tokens = t[:, 1:]
        cls = t[:, :1].expand_as(tokens)
        r = F.gelu(self.linear(torch.cat([tokens, cls], -1), p + "0.project.0"))
        return r.transpose(1, 2).reshape(t.shape[0], -1, gh, gw)

    # ---- decoder ---------------------------------------------------------

    def residual_unit(self, x, p: str):
        y = self.conv(F.relu(x), p + "conv1")
        return self.conv(F.relu(y), p + "conv2") + x

    def fusion(self, x, p: str, lateral=None):
        if lateral is not None:
            x = x + self.residual_unit(lateral, p + "resConfUnit1.")
        x = self.residual_unit(x, p + "resConfUnit2.")
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return self.conv(x, p + "out_conv")


def dpt_forward(sd, x: torch.Tensor, heads: int = 12, hooks=(8, 11), rnd=None):
    """DPT-Hybrid on NCHW float32 x -> NCHW float32 output (depth: 1
    channel, non-negative)."""
    net = _Net(sd, rnd)
    layer_1, layer_2, feat = net.backbone(x)

    tokens = net.conv(feat, VIT + "patch_embed.proj")
    B, _, gh, gw = tokens.shape
    tokens = tokens.flatten(2).transpose(1, 2)
    t = torch.cat([sd[VIT + "cls_token"].expand(B, -1, -1), tokens], 1)
    t = t + net.pos_embed(gh, gw)
    taps = {}
    i = 0
    while f"{VIT}blocks.{i}.norm1.weight" in sd:
        t = net.vit_block(t, f"{VIT}blocks.{i}.", heads)
        if i in hooks:
            taps[i] = t
        i += 1

    p3, p4 = "pretrained.act_postprocess3.", "pretrained.act_postprocess4."
    layer_3 = net.conv(net.reassemble(taps[hooks[0]], p3, gh, gw), p3 + "3")
    layer_4 = net.conv(net.conv(net.reassemble(taps[hooks[1]], p4, gh, gw), p4 + "3"),
                       p4 + "4", stride=2)

    rn = [net.conv(f, f"scratch.layer{j}_rn")
          for j, f in enumerate((layer_1, layer_2, layer_3, layer_4), 1)]
    path = net.fusion(rn[3], "scratch.refinenet4.")
    path = net.fusion(path, "scratch.refinenet3.", rn[2])
    path = net.fusion(path, "scratch.refinenet2.", rn[1])
    path = net.fusion(path, "scratch.refinenet1.", rn[0])

    y = net.conv(path, "scratch.output_conv.0")
    y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=True)
    y = F.relu(net.conv(y, "scratch.output_conv.2"))
    return F.relu(net.conv(y, "scratch.output_conv.4"))
