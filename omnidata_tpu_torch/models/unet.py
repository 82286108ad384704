"""UNet (6 down, 6 up, GroupNorm(8)) in PyTorch: the counterpart of the JAX
package's ``models/unet.py``, the reference's v1 surface-normal model
(omnidata_tools/torch/modules/unet.py:8-110), with its key schema
(``convert._unet_mapping``). NCHW; x2 bilinear upsampling with
align_corners=False, like nn.Upsample.

``remat=True`` recomputes each down/up block (pooling and upsampling
included) on the backward pass (``torch.utils.checkpoint``), as the JAX
model's ``nn.remat`` does: the block-internal activations are not kept.
The values and parameter names are unchanged."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import SameConv, resize_bilinear


class _Block(nn.Module):
    """Three conv3x3 + GroupNorm(8) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        for i in (1, 2, 3):
            setattr(self, f"conv{i}", SameConv(in_ch if i == 1 else out_ch, out_ch, 3))
            setattr(self, f"bn{i}", nn.GroupNorm(8, out_ch, eps=1e-5))

    def forward(self, x):
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class UNet(nn.Module):
    """final_activation: None (the reference UNet), 'relu' (UNetRelu) or
    'sigmoid' (the v1 normal demo's output convention)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 downsample: int = 6, final_activation: str | None = None,
                 remat: bool = False):
        super().__init__()
        self.final_activation = final_activation
        self.remat = remat
        self.down1 = _Block(in_channels, 16)
        self.down_blocks = nn.ModuleList(
            _Block(2 ** (4 + i), 2 ** (5 + i)) for i in range(downsample))
        c = 2 ** (4 + downsample)
        for i in (1, 2, 3):
            setattr(self, f"mid_conv{i}", SameConv(c, c, 3))
            setattr(self, f"bn{i}", nn.GroupNorm(8, c, eps=1e-5))
        # up block i: the upsampled 2^(5+i) channels + skip i's 2^(4+i)
        self.up_blocks = nn.ModuleList(
            _Block(2 ** (5 + i) + 2 ** (4 + i), 2 ** (4 + i)) for i in range(downsample))
        self.last_conv1 = SameConv(16, 16, 3)
        self.last_bn = nn.GroupNorm(8, 16, eps=1e-5)
        self.last_conv2 = nn.Conv2d(16, out_channels, 1)

    def _run(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(self, x):
        x = self._run(self.down1, x)
        skips = [x]
        for block in self.down_blocks:
            x = self._run(lambda y, b=block: F.max_pool2d(b(y), 2, 2), x)
            skips.append(x)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"mid_conv{i}")(x)))
        for i in reversed(range(len(self.up_blocks))):
            x = self._run(self._up, self.up_blocks[i], x, skips[i])
        x = F.relu(self.last_bn(self.last_conv1(x)))
        x = self.last_conv2(x)
        if self.final_activation == "relu":
            return F.relu(x)
        if self.final_activation == "sigmoid":
            return torch.sigmoid(x)
        return x

    @staticmethod
    def _up(block, x, skip):
        x = resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        return block(torch.cat([x, skip], 1))
