"""Key schemas of the published checkpoints, and Flax parameters carried
into them.

The published omnidata checkpoints (omnidata_dpt_{depth,normal}_v2.ckpt,
omnidata_unet_normal_v1.pth) and MiDaS v2.1's (midas_v21-f6b98070.pt,
midas_v21_small-70d6b9c8.pt) hold timm-0.4.x / torchvision / geffnet /
reference-module state dicts, which the port's modules reproduce key for
key (``dpt.DPTHybrid``, ``unet.UNet``, ``midas_full.MidasNet``,
``midas_full.MidasNetSmallTF``). Each mapping below yields (flax_path,
torch_key, kind) triples, the port's copy of the JAX package's
``models/convert.py`` ``_dpt_mapping``, ``_unet_mapping``,
``_midas_mapping`` and ``_midas_small_mapping`` (``_midas_net_small_mapping``
is the port's own, for ``midas_net.MidasNetSmall``, which has no published
checkpoint): flax_path is a '/'-joined path into
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


def _join(prefix: str, name: str) -> str:
    return f"{prefix}/{name}" if prefix else name


def _bottleneck_mapping(fb: str, tb: str, downsample: bool) -> Iterator[tuple]:
    """One ResNeXtBottleneck: Flax path prefix fb ('' at the root), torch
    key prefix tb ('' at the root)."""
    t = (lambda name: f"{tb}.{name}") if tb else (lambda name: name)
    for i in (1, 2, 3):
        yield _join(fb, f"conv{i}"), t(f"conv{i}"), "conv_nobias"
        yield _join(fb, f"bn{i}"), t(f"bn{i}"), "bn"
    if downsample:
        yield _join(fb, "downsample_conv"), t("downsample.0"), "conv_nobias"
        yield _join(fb, "downsample_bn"), t("downsample.1"), "bn"


def _mbconv_mapping(fb: str, tb: str, expand: int) -> Iterator[tuple]:
    """One MBConvLite: geffnet's DepthwiseSeparableConv names for expand 1
    (conv_dw/bn1/conv_pw/bn2; its project conv is named conv_pw there), its
    InvertedResidual names otherwise (conv_pw/bn1/conv_dw/bn2/conv_pwl/bn3)."""
    t = (lambda name: f"{tb}.{name}") if tb else (lambda name: name)
    if expand == 1:
        yield _join(fb, "conv_dw"), t("conv_dw"), "conv_nobias"
        yield _join(fb, "bn2"), t("bn1"), "bn"
        yield _join(fb, "conv_pwl"), t("conv_pw"), "conv_nobias"
        yield _join(fb, "bn3"), t("bn2"), "bn"
        return
    yield _join(fb, "conv_pw"), t("conv_pw"), "conv_nobias"
    yield _join(fb, "bn1"), t("bn1"), "bn"
    yield _join(fb, "conv_dw"), t("conv_dw"), "conv_nobias"
    yield _join(fb, "bn2"), t("bn2"), "bn"
    yield _join(fb, "conv_pwl"), t("conv_pwl"), "conv_nobias"
    yield _join(fb, "bn3"), t("bn3"), "bn"


def _midas_mapping(layers=(3, 4, 23, 3)) -> Iterator[tuple]:
    """MiDaS v2.1 large (MidasNet: ResNeXt101-WSL + plain fusion decoder).
    Stage 1 is Sequential(conv1, bn1, relu, maxpool, resnet.layer1), so its
    keys are pretrained.layer1.{0,1,4.b}; stages 2-4 are
    pretrained.layer{2,3,4}.b."""
    yield "pretrained/conv1", "pretrained.layer1.0", "conv_nobias"
    yield "pretrained/bn1", "pretrained.layer1.1", "bn"
    for si, n_blocks in enumerate(layers):
        tstage = "pretrained.layer1.4" if si == 0 else f"pretrained.layer{si + 1}"
        for b in range(n_blocks):
            yield from _bottleneck_mapping(f"pretrained/layer{si + 1}_block{b}",
                                           f"{tstage}.{b}", b == 0)
    for i in (1, 2, 3, 4):
        yield f"layer{i}_rn", f"scratch.layer{i}_rn", "conv_nobias"
        for u in (1, 2):
            for c in (1, 2):
                if i == 4 and u == 1:
                    # refinenet4 gets no skip input: its resConfUnit1 is in
                    # the published checkpoint but never run
                    yield (None, f"scratch.refinenet4.resConfUnit1.conv{c}",
                           ("conv_drop", (256, 256, 3, 3)))
                else:
                    yield (f"refinenet{i}/resConfUnit{u}/conv{c}",
                           f"scratch.refinenet{i}.resConfUnit{u}.conv{c}", "conv")
    yield "output_conv1", "scratch.output_conv.0", "conv"
    yield "output_conv2", "scratch.output_conv.2", "conv"
    yield "output_conv3", "scratch.output_conv.4", "conv"


# tf_efficientnet_lite3 stage repeats (lite: first/last not depth-scaled)
_LITE3_REPEATS = (1, 3, 3, 5, 5, 6, 1)

# stage index -> torch Sequential prefix inside _make_efficientnet_backbone
# (blocks.py:88-98: layer1 = Sequential(conv_stem, bn1, act1, blocks[0],
# blocks[1]) so stages 0/1 sit at indices 3/4; later layers wrap the stage
# Sequentials directly)
_LITE3_STAGE_PREFIX = {
    0: "pretrained.layer1.3",
    1: "pretrained.layer1.4",
    2: "pretrained.layer2.0",
    3: "pretrained.layer3.0",
    4: "pretrained.layer3.1",
    5: "pretrained.layer4.0",
    6: "pretrained.layer4.1",
}


def _midas_small_mapping() -> Iterator[tuple]:
    """MiDaS v2.1 small (midas_net_custom.py MidasNet_small,
    tf_efficientnet_lite3 in geffnet's layout): stage 0's blocks are
    DepthwiseSeparableConvs, the rest InvertedResiduals (``_mbconv_mapping``);
    the custom fusion blocks' RCU convs are ``resConfUnit{u}_conv{c}`` in
    Flax, ``resConfUnit{u}.conv{c}`` in torch."""
    yield "pretrained/conv_stem", "pretrained.layer1.0", "conv_nobias"
    yield "pretrained/bn1", "pretrained.layer1.1", "bn"
    for si, reps in enumerate(_LITE3_REPEATS):
        for bi in range(reps):
            yield from _mbconv_mapping(f"pretrained/blocks_{si}_{bi}",
                                       f"{_LITE3_STAGE_PREFIX[si]}.{bi}",
                                       1 if si == 0 else 6)
    feats = {1: 64, 2: 128, 3: 256, 4: 512}
    for i in (1, 2, 3, 4):
        yield f"layer{i}_rn", f"scratch.layer{i}_rn", "conv_nobias"
        for u in (1, 2):
            for c in (1, 2):
                if i == 4 and u == 1:
                    yield (None, f"scratch.refinenet4.resConfUnit1.conv{c}",
                           ("conv_drop", (feats[4], feats[4], 3, 3)))
                else:
                    yield (f"refinenet{i}/resConfUnit{u}_conv{c}",
                           f"scratch.refinenet{i}.resConfUnit{u}.conv{c}", "conv")
        yield f"refinenet{i}/out_conv", f"scratch.refinenet{i}.out_conv", "conv"
    yield "output_conv1", "scratch.output_conv.0", "conv"
    yield "output_conv2", "scratch.output_conv.2", "conv"
    yield "output_conv3", "scratch.output_conv.4", "conv"


def _midas_net_small_mapping(n_levels: int = 4, features: int = 64) -> Iterator[tuple]:
    """The port's ``midas_net.MidasNetSmall`` from the JAX package's Flax
    module of the same names (no published checkpoint exists); the last
    fusion block's lateral unit, which Flax never creates, comes out as
    zeros."""
    yield "stem", "stem", "conv_nobias"
    yield "stem_gn", "stem_gn", "norm"
    for i in range(n_levels):
        for blk in (f"ir{i}a", f"ir{i}b"):
            for name in ("pw1", "dw", "pw2"):
                yield f"{blk}/{name}", f"{blk}.{name}", "conv_nobias"
            for name in ("gn1", "gn2", "gn3"):
                yield f"{blk}/{name}", f"{blk}.{name}", "norm"
        yield f"layer{i + 1}_rn", f"layer{i + 1}_rn", "conv_nobias"
        fb, tb = f"refinenet{i + 1}", f"refinenet{i + 1}"
        for j in (1, 2):
            for c in (1, 2):
                if i + 1 == n_levels and j == 1:  # no lateral input: never run
                    yield (None, f"{tb}.resConfUnit1.conv{c}",
                           ("conv_drop", (features, features, 3, 3)))
                else:
                    yield (f"{fb}/rcu{j}/conv{c}", f"{tb}.resConfUnit{j}.conv{c}",
                           "conv")
        yield f"{fb}/out_conv", f"{tb}.out_conv", "conv"
    for i in (1, 2, 3):
        yield f"head_conv{i}", f"head_conv{i}", "conv"


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
