"""Key schemas of the published checkpoints, and Flax parameters carried
into them.

The published omnidata checkpoints (omnidata_dpt_{depth,normal}_v2.ckpt,
omnidata_unet_normal_v1.pth) hold timm-0.4.x / reference-module state
dicts, which the port's modules reproduce key for key (``dpt.DPTHybrid``,
``unet.UNet``). Each mapping below yields (flax_path, torch_key, kind)
triples, the port's copy of the JAX package's ``models/convert.py``
``_dpt_mapping`` and ``_unet_mapping``: flax_path is a '/'-joined path into
the Flax parameter tree (None for tensors the forward pass never uses);
kind is 'conv' | 'conv_nobias' | 'linear' | 'norm' | 'ln' | 'raw', or a
'*_drop' kind for those unused tensors.

``state_dict_from_flax`` walks a Flax variable tree given as nested dicts
of numpy arrays (``jax.device_get`` of the JAX model's variables; no JAX
needed here) into such a state dict:

- conv kernels:   flax (kh, kw, I, O) -> torch (O, I, kh, kw)
- dense kernels:  flax (I, O)         -> torch (O, I)
- norm scale/bias -> weight/bias
- BatchNorm ('bn'): also ``batch_stats`` mean/var -> running_mean/var

The multi-task models and the attention blocks keep the Flax modules'
names, so ``state_dict_from_flax_tree`` maps their trees without a
mapping: a '/'-joined path becomes a '.'-joined key, ``kernel`` becomes
``weight`` (4-D transposed as a conv's, 2-D as a dense layer's, 3-D — ECA's
(k, 1, 1) 1-D conv — reversed to (1, 1, k)), ``scale`` becomes ``weight``,
and any other leaf (``bias``, CrossStitch's ``stitch{i}``) keeps its name.
HRNet's torch keys are the published seg_hrnet's, so it goes through
``hrnet.hrnet_mapping``.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def _dpt_mapping(vit_blocks: int = 12, layers=(3, 4, 9)) -> Iterator[tuple]:
    """(flax_path, torch_key, kind) for DPTHybrid."""
    bb = "pretrained.model.patch_embed.backbone"
    yield ("backbone/stem_conv", f"{bb}.stem.conv", "conv_nobias")
    yield ("backbone/stem_norm/gn", f"{bb}.stem.norm", "norm")
    for s, n in enumerate(layers):
        for b in range(n):
            base = f"{bb}.stages.{s}.blocks.{b}"
            fb = f"backbone/stage{s}_block{b}"
            for i in (1, 2, 3):
                yield (f"{fb}/conv{i}", f"{base}.conv{i}", "conv_nobias")
                yield (f"{fb}/norm{i}/gn", f"{base}.norm{i}", "norm")
            if b == 0:
                yield (f"{fb}/downsample_conv", f"{base}.downsample.conv", "conv_nobias")
                yield (f"{fb}/downsample_norm/gn", f"{base}.downsample.norm", "norm")
    pm = "pretrained.model"
    yield ("cls_token", f"{pm}.cls_token", "raw")
    yield ("pos_embed", f"{pm}.pos_embed", "raw")
    yield ("patch_proj", f"{pm}.patch_embed.proj", "conv")
    for i in range(vit_blocks):
        base = f"{pm}.blocks.{i}"
        fb = f"block{i}"
        yield (f"{fb}/norm1", f"{base}.norm1", "ln")
        yield (f"{fb}/attn/qkv", f"{base}.attn.qkv", "linear")
        yield (f"{fb}/attn/proj", f"{base}.attn.proj", "linear")
        yield (f"{fb}/norm2", f"{base}.norm2", "ln")
        yield (f"{fb}/mlp/fc1", f"{base}.mlp.fc1", "linear")
        yield (f"{fb}/mlp/fc2", f"{base}.mlp.fc2", "linear")
    yield ("norm", f"{pm}.norm", "ln")
    # timm's ImageNet classifier head: in the published checkpoints (vit.py
    # create_model keeps num_classes=1000) but never run by DPT
    yield (None, f"{pm}.head", ("linear_drop", (1000, 768)))
    yield ("readout3/project", "pretrained.act_postprocess3.0.project.0", "linear")
    yield ("postprocess3_conv", "pretrained.act_postprocess3.3", "conv")
    yield ("readout4/project", "pretrained.act_postprocess4.0.project.0", "linear")
    yield ("postprocess4_conv", "pretrained.act_postprocess4.3", "conv")
    yield ("postprocess4_down", "pretrained.act_postprocess4.4", "conv")
    for i in (1, 2, 3, 4):
        yield (f"layer{i}_rn", f"scratch.layer{i}_rn", "conv_nobias")
        for j in (1, 2):
            # refinenet4 has no lateral input: its resConfUnit1 is never run
            if i == 4 and j == 1:
                for c in (1, 2):
                    yield (None, f"scratch.refinenet4.resConfUnit1.conv{c}",
                           ("conv_drop", (256, 256, 3, 3)))
                continue
            for c in (1, 2):
                yield (f"refinenet{i}/rcu{j}/conv{c}",
                       f"scratch.refinenet{i}.resConfUnit{j}.conv{c}", "conv")
        yield (f"refinenet{i}/out_conv", f"scratch.refinenet{i}.out_conv", "conv")
    # head: nn.Sequential indices 0, 2, 4 (dpt_depth.py:91-99)
    yield ("head_conv1", "scratch.output_conv.0", "conv")
    yield ("head_conv2", "scratch.output_conv.2", "conv")
    yield ("head_conv3", "scratch.output_conv.4", "conv")


def _unet_mapping(downsample: int = 6) -> Iterator[tuple]:
    """(flax_path, torch_key, kind) for UNet (modules/unet.py:57-106)."""

    def block(fb, tb):
        for i in (1, 2, 3):
            yield (f"{fb}/conv{i}", f"{tb}.conv{i}", "conv")
            yield (f"{fb}/bn{i}", f"{tb}.bn{i}", "norm")

    yield from block("down1", "down1")
    for i in range(downsample):
        yield from block(f"down_blocks{i}", f"down_blocks.{i}")
    for i in (1, 2, 3):
        yield (f"mid_conv{i}", f"mid_conv{i}", "conv")
        yield (f"mid_bn{i}", f"bn{i}", "norm")
    for i in range(downsample):
        yield from block(f"up_blocks{i}", f"up_blocks.{i}")
    yield ("last_conv1", "last_conv1", "conv")
    yield ("last_bn", "last_bn", "norm")
    yield ("last_conv2", "last_conv2", "conv")


def strip_prefix(state_dict: dict) -> dict:
    """Undo the Lightning wrapping: checkpoint['state_dict'] with a 'model.'
    (or 'model.model.') prefix on every key (demo.py:64-72 strips k[6:])."""
    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    out = {}
    for k, v in state_dict.items():
        for p in ("model.model.", "model."):
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def state_dict_from_flax(mapping, flax_params: dict) -> dict:
    """Flax variables (nested dicts of numpy arrays, with or without the
    top 'params' level; 'batch_stats' beside it for BatchNorm) -> a torch
    state dict in the mapping's key schema. Tensors the forward pass never
    uses (the '*_drop' kinds) come out as zeros of their published shapes."""
    params = flax_params.get("params", flax_params)
    stats = flax_params.get("batch_stats", {})

    def leaf(path, name, tree=None):
        node = params if tree is None else tree
        for part in path.split("/"):
            node = node[part]
        return np.asarray(node if name is None else node[name], np.float32)

    def has(path, name):
        node = params
        for part in path.split("/"):
            node = node.get(part, {})
        return name in node

    sd = {}
    for flax_path, key, kind in mapping:
        if isinstance(kind, tuple):  # conv_drop / linear_drop
            shape = kind[1]
            sd[f"{key}.weight"] = np.zeros(shape, np.float32)
            sd[f"{key}.bias"] = np.zeros(shape[:1], np.float32)
        elif kind in ("conv", "conv_nobias"):
            sd[f"{key}.weight"] = leaf(flax_path, "kernel").transpose(3, 2, 0, 1)
            if has(flax_path, "bias"):
                sd[f"{key}.bias"] = leaf(flax_path, "bias")
        elif kind == "linear":
            sd[f"{key}.weight"] = leaf(flax_path, "kernel").T
            if has(flax_path, "bias"):
                sd[f"{key}.bias"] = leaf(flax_path, "bias")
        elif kind in ("norm", "ln", "bn"):
            sd[f"{key}.weight"] = leaf(flax_path, "scale")
            sd[f"{key}.bias"] = leaf(flax_path, "bias")
            if kind == "bn":
                sd[f"{key}.running_mean"] = leaf(flax_path, "mean", stats)
                sd[f"{key}.running_var"] = leaf(flax_path, "var", stats)
        elif kind == "raw":
            sd[key] = leaf(flax_path, None)
        else:
            raise ValueError(f"unknown kind {kind!r} for {key}")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


_KERNEL_AXES = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}


def state_dict_from_flax_tree(flax_params: dict) -> dict:
    """Flax variables whose module names are the torch module's (the
    multi-task models, the attention blocks) -> its state dict; see the
    module doc for the leaf rules."""
    params = flax_params.get("params", flax_params)
    sd = {}

    def walk(node, path):
        for name, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [name])
                continue
            a = np.asarray(v, np.float32)
            if name == "kernel":
                a, name = a.transpose(_KERNEL_AXES[a.ndim]), "weight"
            elif name == "scale":
                name = "weight"
            sd[".".join(path + [name])] = torch.from_numpy(np.array(a, np.float32))

    walk(params, [])
    return sd
