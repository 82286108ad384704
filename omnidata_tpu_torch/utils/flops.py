"""FLOPs of a model's forward, counted from its layer shapes, and the dense
peaks of one NVIDIA H100 SXM that a share of peak is taken against; the
bench (``omnidata_tpu_torch.bench``) and ``chip_smoke.py`` count alike."""
from __future__ import annotations

import torch

# dense peaks of one H100 SXM at 700 W (data sheet): FP32 without tensor
# cores (TF32 off), TF32 and BF16 tensor cores
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12}


def model_flops(model, x) -> float:
    """Multiply-adds x 2 of one forward on x, per image, from the layer
    shapes: every convolution and linear layer, and attention's two matrix
    products (no interpolation, normalisation or elementwise work)."""
    from ..models.layers import Attention

    total = [0.0]

    def conv(m, inp, out):
        total[0] += 2.0 * out.numel() * (m.in_channels // m.groups) \
            * m.kernel_size[0] * m.kernel_size[1]

    def linear(m, inp, out):
        total[0] += 2.0 * out.numel() * m.in_features

    def attention(m, inp, out):
        B, N, C = inp[0].shape
        total[0] += 2.0 * 2 * B * N * N * C  # q k^T and attn v over all heads

    hooks = []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear))
        elif isinstance(m, Attention):
            hooks.append(m.register_forward_hook(attention))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0] / x.shape[0]
