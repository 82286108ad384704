"""Seeded weights of DPT-Hybrid in the published checkpoint's layout.

``schema`` lists every tensor of ``omnidata_dpt_depth_v2.ckpt`` (its keys
once the ``model.`` prefix is stripped, and shapes) from a configuration's
widths; ``draw`` fills them from a seed; ``cached`` writes them once per
checkout, as a Lightning checkpoint (``{"state_dict": {"model.<key>":
tensor}}``), under the benchmark's cache, so the program reads them
through its own checkpoint loader.

The initialisers are Flax's defaults, which the program's own seeded
models use: LeCun-normal kernels (N(0, 1 / fan_in)), zero biases, unit
norm scales and zero shifts, the cls token 0 and the position embedding
N(0, 0.02); the tensors that DPT holds but never runs (timm's classifier
``head``, the ViT's final ``norm``, refinenet4's first residual unit) are
drawn too. Two departures, so that the comparison with the float32
reference can tell bfloat16 from a lower precision:
- each bottleneck's last GroupNorm scale (``norm3``) is ``norm3_scale``, so
  that a residual branch starts small, as in a trained ResNet (timm's
  ``zero_init_last`` sets it to 0): with unit scales the random ResNet
  stage amplifies rounding block after block, and bfloat16 lands about as
  far from float32 as any lower precision does;
- the head's last kernel (``scratch.output_conv.4``) is scaled by
  ``head_out_scale``, so that the depth falls inside [0, 1] as a trained
  model's does: unscaled, nearly every pixel passes 1, and the clamp the
  prediction route applies would hide any difference there.
Imports nothing of the program.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import torch

CACHE = Path(__file__).resolve().parent.parent / "cache"
SPEC_KEYS = ("stem_width", "backbone_layers", "backbone_widths", "hidden_size",
               "num_hidden_layers", "intermediate_size", "pos_grid", "fusion_features",
               "head_widths", "num_channels", "classifier_classes", "norm3_scale",
               "head_out_scale")


def schema(cfg: dict) -> list:
    """[(key, shape)] of every tensor, in a fixed order."""
    out = []

    def conv(name, o, i, k, bias=True):
        out.append((f"{name}.weight", (o, i, k, k)))
        if bias:
            out.append((f"{name}.bias", (o,)))

    def linear(name, o, i):
        out.extend([(f"{name}.weight", (o, i)), (f"{name}.bias", (o,))])

    def norm(name, c):
        out.extend([(f"{name}.weight", (c,)), (f"{name}.bias", (c,))])

    C, M, F = cfg["hidden_size"], cfg["intermediate_size"], cfg["fusion_features"]
    vit = "pretrained.model"
    out += [(f"{vit}.cls_token", (1, 1, C)),
            (f"{vit}.pos_embed", (1, cfg["pos_grid"] ** 2 + 1, C))]
    bb = f"{vit}.patch_embed.backbone"
    stem = cfg["stem_width"]
    conv(f"{bb}.stem.conv", stem, 3, 7, bias=False)
    norm(f"{bb}.stem.norm", stem)
    c_in = stem
    for s, (n, width) in enumerate(zip(cfg["backbone_layers"], cfg["backbone_widths"])):
        mid = width // 4
        for b in range(n):
            p = f"{bb}.stages.{s}.blocks.{b}"
            if b == 0:
                conv(f"{p}.downsample.conv", width, c_in, 1, bias=False)
                norm(f"{p}.downsample.norm", width)
            conv(f"{p}.conv1", mid, c_in if b == 0 else width, 1, bias=False)
            norm(f"{p}.norm1", mid)
            conv(f"{p}.conv2", mid, mid, 3, bias=False)
            norm(f"{p}.norm2", mid)
            conv(f"{p}.conv3", width, mid, 1, bias=False)
            norm(f"{p}.norm3", width)
        c_in = width
    conv(f"{vit}.patch_embed.proj", C, c_in, 1)
    for i in range(cfg["num_hidden_layers"]):
        p = f"{vit}.blocks.{i}"
        norm(f"{p}.norm1", C)
        linear(f"{p}.attn.qkv", 3 * C, C)
        linear(f"{p}.attn.proj", C, C)
        norm(f"{p}.norm2", C)
        linear(f"{p}.mlp.fc1", M, C)
        linear(f"{p}.mlp.fc2", C, M)
    norm(f"{vit}.norm", C)
    linear(f"{vit}.head", cfg["classifier_classes"], C)
    for k in (3, 4):
        p = f"pretrained.act_postprocess{k}"
        linear(f"{p}.0.project.0", C, 2 * C)
        conv(f"{p}.3", C, C, 1)
        if k == 4:
            conv(f"{p}.4", C, C, 3)
    widths = list(cfg["backbone_widths"][:2]) + [C, C]
    for i, c in enumerate(widths, 1):
        conv(f"scratch.layer{i}_rn", F, c, 3, bias=False)
    for i in range(1, 5):
        p = f"scratch.refinenet{i}"
        for u in (1, 2):
            for c in (1, 2):
                conv(f"{p}.resConfUnit{u}.conv{c}", F, F, 3)
        conv(f"{p}.out_conv", F, F, 1)
    h1, h2 = cfg["head_widths"]
    conv("scratch.output_conv.0", h1, F, 3)
    conv("scratch.output_conv.2", h2, h1, 3)
    conv("scratch.output_conv.4", cfg["num_channels"], h2, 1)
    return out


def draw(cfg: dict, seed: int) -> dict:
    """The state dict (float32, on the CPU) of ``schema(cfg)`` from ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    sd = {}
    for key, shape in schema(cfg):
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            t = torch.randn(shape, generator=g) * 0.02
        elif leaf in ("cls_token", "bias"):
            t = torch.zeros(shape)
        elif len(shape) == 1:  # a norm's scale
            t = torch.full(shape, cfg["norm3_scale"] if ".norm3." in key else 1.0)
        else:
            fan_in = 1
            for d in shape[1:]:
                fan_in *= d
            t = torch.randn(shape, generator=g) / fan_in ** 0.5
            if key == "scratch.output_conv.4.weight":
                t = t * cfg["head_out_scale"]
        sd[key] = t
    return sd


def cached(cfg: dict, seed: int, cache: Path | None = None) -> Path:
    """The checkpoint file of ``draw(cfg, seed)``, written on first use."""
    cache = CACHE if cache is None else Path(cache)
    spec = {k: cfg[k] for k in SPEC_KEYS} | {"seed": int(seed)}
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
    path = cache / f"dpt-{key}.pt"
    if not path.exists():
        cache.mkdir(parents=True, exist_ok=True)
        tmp = cache / f"dpt-{key}.tmp{os.getpid()}.pt"
        sd = draw(cfg, seed)
        torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, tmp)
        os.replace(tmp, path)
    return path


def load(path: Path) -> dict:
    """A checkpoint ``cached`` wrote -> its state dict, prefixes stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {k[len("model."):]: v for k, v in ckpt["state_dict"].items()}
