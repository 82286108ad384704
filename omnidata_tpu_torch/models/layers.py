"""Shared building blocks of the port's models, on NCHW images and
(B, N, C) token sequences.

Counterparts of the JAX package's ``models/layers.py``. Its align-corners
bilinear resize is two dense interpolation matmuls, a TPU choice (row
gathers are slow there); here it is ``F.interpolate``, which computes the
same two-tap function. ``jax.image.resize``, which the JAX models use for
their bicubic and antialiased bilinear resizes, is rebuilt from explicit
1-D weight matrices in ``scale_and_translate``'s form (Keys cubic a = -0.5,
weights renormalised over the in-bounds taps, the kernel widened by the
downscale factor): ``F.interpolate``'s bicubic uses a = -0.75 and clamps.

TF/Flax "SAME" padding is explicit (``same_pad``): for a strided window on
an even size it pads (0, 1), where torch's ``padding=1`` would pad (1, 1).
Normalisation layers run in float32 and cast back to the activation dtype,
so a bfloat16 model keeps float32 statistics (``registry.cast_params_bf16``
leaves their parameters in float32).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """Pad the trailing (H, W) of x as TF/Flax "SAME" does for a k x k
    window at stride s: total max((ceil(n/s) - 1) s + k - n, 0), the odd
    pixel after."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad's order: W first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


def resize_bilinear(x: torch.Tensor, out_hw: tuple, align_corners: bool = False) -> torch.Tensor:
    """Two-tap bilinear resize of NCHW x (source positions clamped to the
    image, no antialiasing), in x's dtype."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                   ((1.5 * x - 2.5) * x) * x + 1.0)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def scale_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_out, n_in) float32 resize weights of ``jax.image.resize``
    (``scale_and_translate`` with antialias): half-pixel centres, the kernel
    widened by the downscale factor, weights divided by their in-bounds sum."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T.astype(np.float32)


def resize_scaled(x: torch.Tensor, out_hw: tuple, method: str) -> torch.Tensor:
    """``jax.image.resize(method=...)`` of NCHW x ('cubic' or 'linear',
    antialiased when shrinking), computed in float32, returned in x's
    dtype."""
    H, W = x.shape[-2:]
    if (H, W) == tuple(out_hw):
        return x
    wh = torch.from_numpy(scale_weights(H, out_hw[0], method)).to(x.device)
    ww = torch.from_numpy(scale_weights(W, out_hw[1], method)).to(x.device)
    y = torch.einsum("oh,...hw->...ow", wh, x.float())
    y = torch.einsum("pw,...ow->...op", ww, y)
    return y.to(x.dtype)


def resize_bicubic(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """Bicubic resize of NCHW x as the JAX package's ``resize_bicubic``
    (``jax.image.resize(method="cubic")``)."""
    return resize_scaled(x, out_hw, "cubic")


class StdConv(nn.Conv2d):
    """Weight-standardized conv with TF "SAME" padding (timm
    StdConv2dSame): per output channel, zero mean and unit variance over
    (in, kh, kw), eps 1e-6, in float32; the conv runs in the activation
    dtype."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 bias: bool = False):
        super().__init__(in_ch, out_ch, k, stride=stride, bias=bias)

    def forward(self, x):
        w = self.weight.float()
        var, mean = torch.var_mean(w, dim=(1, 2, 3), correction=0, keepdim=True)
        w = ((w - mean) / torch.sqrt(var + 1e-6)).to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(same_pad(x, self.kernel_size[0], self.stride[0]), w, b,
                        self.stride)


class SameConv(nn.Conv2d):
    """Flax ``nn.Conv(padding="SAME")``: an odd square kernel, TF padding."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 bias: bool = True):
        super().__init__(in_ch, out_ch, k, stride=stride, bias=bias)

    def forward(self, x):
        return F.conv2d(same_pad(x, self.kernel_size[0], self.stride[0]),
                        self.weight, self.bias, self.stride)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm computed in float32, cast back to the input dtype."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class GroupNormAct(GroupNorm32):
    """GroupNorm(32), eps 1e-5, and an optional ReLU (timm GroupNormAct)."""

    def __init__(self, channels: int, act: bool = True, groups: int = 32):
        super().__init__(groups, channels, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return F.relu(x) if self.act else x


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in float32, cast back to the input dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax ``nn.max_pool(padding="SAME")``: pads with -inf."""
    return F.max_pool2d(same_pad(x, k, s, value=float("-inf")), k, s)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """ViT multi-head self-attention with a fused qkv projection; the
    softmax in float32, the value product back in the activation dtype."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, h, N, d)
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(hd)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        y = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(y)


class EncoderBlock(nn.Module):
    """Pre-norm transformer block: x + attn(ln(x)); x + mlp(ln(x)); the
    LayerNorms (eps 1e-6) in float32."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm32(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm32(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))
