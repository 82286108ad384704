"""Model registry: the hub names of the reference (omnidata_tools/torch/
README.md:23-29: dpt_hybrid_384, depth_dpt_hybrid_384,
surface_normal_dpt_hybrid_384, surface_normal_unet), MiDaS v2.1
(midas_v21, midas_v21_small; the MiDaS hub entries) and the segmentation
HRNets (hrnet_w18, hrnet_w32, hrnet_w48; paper_code/models/seg_hrnet.py),
the counterpart of the JAX package's ``models/registry.py``.

Each entry returns a ``Predictor``: an ``nn.Module`` in eval mode (so
BatchNorm runs on its running statistics) that takes an NCHW float32 batch
and returns the reference's output convention in float32 — depth (B, H, W)
with the channel squeezed, normals (B, 3, H, W). Weights come from a
published torch checkpoint
(``torch.load`` -> ``convert.strip_prefix`` -> ``load_state_dict(strict=
True)``), from a checkpoint directory the port's trainers wrote, or,
without one, from a seeded ``torch.Generator`` (Flax's
initialisers: LeCun-normal kernels, zero biases, unit norm scales, pos
embed N(0, 0.02)); they are made on the CPU, then moved, so a seed gives
the same weights on every device.

``dtype="bfloat16"`` follows the JAX package's ``cast_params_bf16``: every
parameter goes to bfloat16 except those of the normalisation layers, which
stay float32 (their statistics are computed in float32 too; HRNet's
BatchNorm layers, which the JAX package casts, stay float32 here as well);
activations run in bfloat16 and the output comes back as float32.
"""
from __future__ import annotations

import math
import os

import torch
from torch import nn

from .convert import strip_prefix
from .dpt import DPTHybrid
from .hrnet import HRNet
from .midas_full import MidasNet, MidasNetSmallTF
from .unet import UNet

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Predictor(nn.Module):
    """net + the reference's input/output convention (see the module doc)."""

    def __init__(self, net: nn.Module, squeeze: bool, dtype: torch.dtype):
        super().__init__()
        self.net, self.squeeze, self.dtype = net, squeeze, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.net(x.to(self.dtype)).float()
        return y[:, 0] if self.squeeze else y


def init_weights(net: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initialisers from ``generator``, in module order:
    kernels N(0, 1/fan_in), biases 0, norm scales 1 and shifts 0, the ViT's
    cls token 0 and position embedding N(0, 0.02); CrossStitch's
    ``stitch{i}`` keep their own initial values."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("stitch"):
                continue  # CrossStitch's mixing weights keep 0.9 I + 0.1 / T
            if leaf == "pos_embed":
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "cls_token" or leaf == "bias":
                p.zero_()
            elif p.dim() == 1:  # a norm's scale
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


def cast_params_bf16(net: nn.Module) -> nn.Module:
    """Every parameter to bfloat16 except the normalisation layers' ones."""
    for mod in net.modules():
        if isinstance(mod, (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm2d)):
            continue
        for name, p in mod.named_parameters(recurse=False):
            p.data = p.data.to(torch.bfloat16)
    return net


def load_checkpoint(net: nn.Module, path: str) -> None:
    """A checkpoint into net, every key accounted for: a directory written
    by the trainers' ``CheckpointManager`` (``step_<N>``, ``last``) gives
    its train state's ``params``; a file is a published torch checkpoint
    (Lightning 'state_dict' with 'model.' prefixes, or a bare state dict)."""
    if os.path.isdir(path):
        from ..train.checkpoints import load_tree

        net.load_state_dict(load_tree(path)["params"], strict=True)
        return
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    net.load_state_dict(strip_prefix(ckpt), strict=True)


def _build(net: nn.Module, squeeze: bool, checkpoint, dtype: str, device,
           generator) -> Predictor:
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype!r}: one of {sorted(_DTYPES)}")
    if checkpoint:
        load_checkpoint(net, checkpoint)
    else:
        init_weights(net, generator if generator is not None
                     else torch.Generator().manual_seed(0))
    if dtype == "bfloat16":
        cast_params_bf16(net)
    return Predictor(net, squeeze, _DTYPES[dtype]).to(device).eval()


def dpt_hybrid_384(num_channels: int = 1, checkpoint: str | None = None,
                   dtype: str = "float32", device: torch.device | str = "cuda",
                   generator: torch.Generator | None = None) -> Predictor:
    """DPT-hybrid: depth (num_channels=1, output (B, H, W)) or normals
    (num_channels=3, output (B, 3, H, W))."""
    return _build(DPTHybrid(num_channels=num_channels), num_channels == 1,
                  checkpoint, dtype, device, generator)


def depth_dpt_hybrid_384(checkpoint: str | None = None, **kw) -> Predictor:
    return dpt_hybrid_384(num_channels=1, checkpoint=checkpoint, **kw)


def surface_normal_dpt_hybrid_384(checkpoint: str | None = None, **kw) -> Predictor:
    return dpt_hybrid_384(num_channels=3, checkpoint=checkpoint, **kw)


def surface_normal_unet(checkpoint: str | None = None,
                        device: torch.device | str = "cuda",
                        generator: torch.Generator | None = None) -> Predictor:
    """The v1 UNet normal model (the reference demo's commented v1 path),
    float32 as in the JAX package."""
    return _build(UNet(out_channels=3), False, checkpoint, "float32", device,
                  generator)


def hrnet(variant: str = "w18", out_channels: int = 21, checkpoint: str | None = None,
          dtype: str = "float32", device: torch.device | str = "cuda",
          generator: torch.Generator | None = None) -> Predictor:
    """Segmentation HRNet (paper_code/models/seg_hrnet.py get_configured_hrnet
    role), output (B, out_channels, H, W); loads torch seg_hrnet
    checkpoints as they are. Input height and width must be 1 more than a
    multiple of 8 (the reference's assert)."""
    return _build(HRNet(out_channels=out_channels, variant=variant), False,
                  checkpoint, dtype, device, generator)


def _midas(net: nn.Module, checkpoint, image_size: int, dtype: str, device,
           generator) -> Predictor:
    """The MiDaS entries: float32 only, as the JAX package's (which take no
    dtype); ``image_size`` is the JAX entries' init shape, kept for their
    signature (the weights do not depend on it)."""
    if dtype != "float32":
        raise ValueError(f"dtype {dtype!r}: the MiDaS models run in float32 only")
    del image_size
    return _build(net, False, checkpoint, "float32", device, generator)


def midas_v21(checkpoint: str | None = None, image_size: int = 384,
              dtype: str = "float32", device: torch.device | str = "cuda",
              generator: torch.Generator | None = None) -> Predictor:
    """MiDaS v2.1 large (ResNeXt101-32x8d-WSL + plain fusion), output (B, H,
    W); loads midas_v21-f6b98070.pt as it is."""
    return _midas(MidasNet(), checkpoint, image_size, dtype, device, generator)


def midas_v21_small(checkpoint: str | None = None, image_size: int = 256,
                    dtype: str = "float32", device: torch.device | str = "cuda",
                    generator: torch.Generator | None = None) -> Predictor:
    """MiDaS v2.1 small (tf_efficientnet_lite3 + custom expanding fusion),
    output (B, H, W); loads midas_v21_small-70d6b9c8.pt as it is."""
    return _midas(MidasNetSmallTF(), checkpoint, image_size, dtype, device, generator)


MODELS = {
    "dpt_hybrid_384": dpt_hybrid_384,
    "hrnet_w18": lambda **kw: hrnet("w18", **kw),
    "hrnet_w32": lambda **kw: hrnet("w32", **kw),
    "hrnet_w48": lambda **kw: hrnet("w48", **kw),
    "midas_v21": midas_v21,
    "midas_v21_small": midas_v21_small,
    "depth_dpt_hybrid_384": depth_dpt_hybrid_384,
    "surface_normal_dpt_hybrid_384": surface_normal_dpt_hybrid_384,
    "surface_normal_unet": surface_normal_unet,
}


def create_model(name: str, **kwargs) -> Predictor:
    """create_model(name, checkpoint=None, dtype="float32", device="cuda",
    generator=None); a CUDA device without a card raises."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    device = torch.device(kwargs.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return MODELS[name](**kwargs)
