"""3D refocus (depth-of-field) augmentation of image folders: the port's
counterpart of the root ``demo_refocus.py`` (reference:
omnidata_tools/torch/demo_refocus.py:1-81).

    python -m omnidata_tpu_torch.demo_refocus --input_path <dir with *rgb* \\
        and *depth_euclidean* PNGs> --output_path <dir> [--num_quantiles 10 \\
        --min_aperture 0.001 --max_aperture 6 --seed 0 --device cuda]

For each file whose name holds "rgb" it reads the file with "rgb" replaced
by "depth_euclidean" beside it (a file without one is skipped), both
through the dataset transforms at 512 (``data.transforms.get_transform``:
rgb in [0, 1], depth rescaled by 8000/65535 and clamped at 1e-3), refocuses
the pair on the device (``augment.refocus_augmentation``) and writes
<name>_refocused.png. It needs no PIL: PNGs are read and written by
``cues.encode``.

The draws come from one CPU ``torch.Generator`` seeded with --seed, taken
file after file; the same --seed gives the same images on the card and on
the CPU, but other draws than the JAX demo's ``jax.random`` keys.
``--device cuda`` (the default) raises without a card.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from pathlib import Path

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="Visualize 3D refocus augmentation")
    p.add_argument("--num_quantiles", type=int, default=10)
    p.add_argument("--min_aperture", type=float, default=0.001)
    p.add_argument("--max_aperture", type=float, default=6.0)
    p.add_argument("--input_path", required=True,
                   help="folder containing rgb and depth_euclidean images")
    p.add_argument("--output_path", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def load_pair(rgb_path: str, depth_path: str) -> tuple:
    """The demo's inputs: rgb (1, 3, 512, 512) and depth (1, 1, 512, 512),
    float32 numpy, the depth clamped at 1e-3 (refocus wants it positive)."""
    from .data.transforms import default_loader, get_transform

    rgb = get_transform("rgb", image_size=512)(default_loader(rgb_path))[:3][None]
    depth = get_transform("depth_euclidean", image_size=512)(default_loader(depth_path))
    return rgb, np.maximum(depth[:1][None], 1e-3)


def to_png_u8(img: torch.Tensor) -> np.ndarray:
    """(3, H, W) float in [0, 1] -> (H, W, 3) uint8, truncated as the demo's."""
    return (np.clip(img.cpu().numpy(), 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .annotator.cli import resolve_device
    from .augment import refocus_augmentation
    from .cues.encode import save_png

    device = resolve_device(args.device)
    os.makedirs(args.output_path, exist_ok=True)
    if not Path(args.input_path).is_dir():
        print("invalid file path!")
        sys.exit(1)

    gen = torch.Generator().manual_seed(args.seed)
    for f in sorted(glob.glob(args.input_path + "/*")):
        name = os.path.splitext(os.path.basename(f))[0]
        if "rgb" not in name:
            continue
        depth_path = os.path.join(os.path.dirname(f),
                                  os.path.basename(f).replace("rgb", "depth_euclidean"))
        if not os.path.exists(depth_path):
            continue
        print(f"Reading input {f} ...")
        rgb, depth = load_pair(f, depth_path)
        with torch.no_grad():
            out = refocus_augmentation(
                torch.from_numpy(rgb).to(device), torch.from_numpy(depth).to(device), gen,
                n_quantiles=args.num_quantiles, aperture_min=args.min_aperture,
                aperture_max=args.max_aperture)
        save_path = os.path.join(args.output_path, f"{name}_refocused.png")
        save_png(save_path, to_png_u8(out[0]))
        print(f"Writing output {save_path} ...")


if __name__ == "__main__":
    main()
