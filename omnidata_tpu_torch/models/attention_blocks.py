"""Channel-attention blocks (reference: modules/channel_attention.py — ECA,
RCAN channel attention, CBAM; kept for capability parity), the port's
counterpart of the JAX package's ``models/attention_blocks.py``, on NCHW
tensors. Parameter names follow the Flax modules' (``fc1``, ``fc2``,
``spatial``; ECA's 1-D kernel is ``weight``, Flax's (k, 1, 1) ``kernel``
as a ``conv1d`` weight (1, 1, k))."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import SameConv


class ECA(nn.Module):
    """Efficient Channel Attention: GAP -> 1-D cross-correlation over the
    channels (zero padding k // 2) -> sigmoid."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.zeros(1, 1, kernel_size))

    def forward(self, x):
        gap = torch.mean(x, dim=(2, 3))  # (B, C)
        y = F.conv1d(gap[:, None, :], self.weight, padding=self.kernel_size // 2)[:, 0]
        return x * torch.sigmoid(y)[:, :, None, None]


class ChannelAttention(nn.Module):
    """RCAN-style squeeze-excite: GAP -> bottleneck MLP -> sigmoid."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, max(channels // reduction, 1))
        self.fc2 = nn.Linear(max(channels // reduction, 1), channels)

    def forward(self, x):
        h = self.fc2(F.relu(self.fc1(torch.mean(x, dim=(2, 3)))))
        return x * torch.sigmoid(h)[:, :, None, None]


class CBAM(nn.Module):
    """Convolutional Block Attention: channel (avg + max through ONE shared
    MLP, as the CBAM paper and the reference share fc1/fc2) then spatial (a
    7x7 conv over [mean, max] across channels, Flax SAME padding)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, max(channels // reduction, 1))
        self.fc2 = nn.Linear(max(channels // reduction, 1), channels)
        self.spatial = SameConv(2, 1, 7)

    def forward(self, x):
        def mlp(v):
            return self.fc2(F.relu(self.fc1(v)))

        ca = torch.sigmoid(mlp(torch.mean(x, (2, 3))) + mlp(torch.amax(x, (2, 3))))
        x = x * ca[:, :, None, None]
        sp = torch.cat([torch.mean(x, 1, keepdim=True), torch.amax(x, 1, keepdim=True)], 1)
        return x * torch.sigmoid(self.spatial(sp))
