"""Work of one DPT-Hybrid forward pass, counted from the configuration's
widths alone, independent of any implementation: multiply-adds x 2 of
every convolution and linear layer that the forward pass runs, and of
attention's two matrix products (q k^T and the weights times v, over all
heads); interpolation, normalisation and elementwise work are not
counted. 255.23 GFLOP an image at 384^2 at the published widths. Behind
``dpt_mfu``, taken against the card's dense bfloat16 peak."""
from __future__ import annotations

import math

BF16_PEAK = 989e12  # FLOP/s, one H100 SXM, dense bfloat16 (data sheet)


def image_flops(cfg: dict, size: int) -> float:
    """FLOPs of one image of size x size through the model of ``cfg``."""
    total = 0.0

    def conv(n_in, n_out, k, side):  # side: the output map's side
        nonlocal total
        total += 2.0 * side * side * n_out * n_in * k * k

    def out_side(side, stride):  # TF "SAME"
        return math.ceil(side / stride)

    side = out_side(size, 2)
    conv(3, cfg["stem_width"], 7, side)
    side = out_side(side, 2)  # the stem's max pool
    c_in = cfg["stem_width"]
    sides = []
    for s, (n, width) in enumerate(zip(cfg["backbone_layers"], cfg["backbone_widths"])):
        mid = width // 4
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            out = out_side(side, stride)
            if b == 0:
                conv(c_in, width, 1, out)  # the shortcut's projection
            conv(c_in if b == 0 else width, mid, 1, side)
            conv(mid, mid, 3, out)
            conv(mid, width, 1, out)
            side = out
        c_in = width
        sides.append(side)

    C, M = cfg["hidden_size"], cfg["intermediate_size"]
    grid = side
    n = grid * grid
    conv(c_in, C, 1, grid)  # the patch projection
    tokens = n + 1
    per_block = 2.0 * tokens * C * (3 * C + C + 2 * M) + 2.0 * 2 * tokens * tokens * C
    total += cfg["num_hidden_layers"] * per_block
    total += 2 * 2.0 * n * (2 * C) * C  # readout "project", twice
    conv(C, C, 1, grid)
    conv(C, C, 1, grid)
    coarse = out_side(grid, 2)
    conv(C, C, 3, coarse)

    F = cfg["fusion_features"]
    levels = [(cfg["backbone_widths"][0], sides[0]), (cfg["backbone_widths"][1], sides[1]),
              (C, grid), (C, coarse)]
    for c, s in levels:
        conv(c, F, 3, s)  # layer{i}_rn
    for i, (_, s) in enumerate(levels):
        units = 1 if i == 3 else 2  # refinenet4 has no lateral input
        for _ in range(2 * units):
            conv(F, F, 3, s)
        conv(F, F, 1, 2 * s)  # out_conv after the x2 upsampling
    h1, h2 = cfg["head_widths"]
    half = 2 * sides[0]
    conv(F, h1, 3, half)
    conv(h1, h2, 3, 2 * half)
    conv(h2, cfg["num_channels"], 1, 2 * half)
    return total
