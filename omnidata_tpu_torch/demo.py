"""Monocular depth or surface normals from photos: the port's counterpart
of the root ``demo.py`` (reference: omnidata_tools/torch/demo.py:23-163).

    python -m omnidata_tpu_torch.demo --task normal --img_path <img-or-dir> \\
        --output_path <dir> [--checkpoint omnidata_dpt_normal_v2.ckpt] \\
        [--image_size 384] [--device cuda] [--dtype float32|bfloat16] \\
        [--batch_size 1]

For each image it writes <name>_rgb.png (the 512 centre crop) and
<name>_{depth,normal}.png. Pre- and post-processing are the reference's:
shorter side resized to image_size with PIL's bilinear filter, centre crop,
[0, 1] (depth: also normalised to [-1, 1]); outputs clamped to [0, 1];
depth bicubic-upsampled to 512, inverted (1 - d) and written with the
viridis colour map as ``plt.imsave`` writes it; normals as an RGB PNG.
The crops go through ``models.predict.predict_batches`` ``--batch_size`` at
a time (the model in ``--dtype``; bfloat16 keeps the norms in float32),
so one batch runs while the previous one's outputs are written.

It needs neither PIL nor matplotlib: it reads PNGs with
``cues.encode.load_rgb_u8``, reproduces PIL's BILINEAR resize
(``utils.pil_image``: fixed-point, antialiased when shrinking, each pass
rounded to uint8) and ``plt.imsave`` (min-max autoscale, index floor(x
256) clipped to 255, RGBA) with viridis's 256-entry table carried here;
other image formats raise. Without --checkpoint the weights are seeded
(useful only to check the path).
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

from .utils.pil_image import pil_bilinear_resize

# matplotlib's viridis as (lut * 255).astype(uint8): 256 RGB triples
VIRIDIS_U8 = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"
), np.uint8).reshape(256, 3)

def build_parser():
    p = argparse.ArgumentParser(description="Visualize output for depth or surface normals")
    p.add_argument("--task", dest="task", help="normal or depth", default="NONE")
    p.add_argument("--img_path", dest="img_path", help="path to rgb image")
    p.add_argument("--output_path", dest="output_path",
                   help="path to where output image should be stored")
    p.add_argument("--checkpoint", default=None, help="published torch checkpoint")
    p.add_argument("--image_size", type=int, default=384)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="the model's precision (default float32)")
    p.add_argument("--batch_size", type=int, default=1, help="images a forward pass")
    return p


def load_rgb_u8(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB, as PIL's convert("RGB") gives
    it. Only PNGs: other formats raise."""
    with open(path, "rb") as fh:
        is_png = fh.read(8) == b"\x89PNG\r\n\x1a\n"
    if is_png:
        from .cues.encode import load_rgb_u8 as load_png_rgb

        return load_png_rgb(path)
    ext = os.path.splitext(path)[1] or "unknown"
    raise RuntimeError(f"{path}: reading {ext} images needs PIL, which the port "
                       "does not import; convert the image to PNG")


def _resize_short_side_and_crop(img: np.ndarray, s: int) -> np.ndarray:
    h, w = img.shape[:2]
    if w < h:
        img = pil_bilinear_resize(img, (s, int(round(h * s / w))))
    else:
        img = pil_bilinear_resize(img, (int(round(w * s / h)), s))
    h, w = img.shape[:2]
    top, left = (h - s) // 2, (w - s) // 2
    return img[top:top + s, left:left + s]


def preprocess(img: np.ndarray, image_size: int, task: str) -> np.ndarray:
    """(H, W, 3) uint8 -> (1, 3, S, S) float32 with the reference's
    transform chain: the crop, then ``predict_batches``' normalisation."""
    from .models.predict import normalise

    crop = _resize_short_side_and_crop(img, image_size)
    return normalise(torch.from_numpy(np.ascontiguousarray(crop[None])), task).numpy()


def center_crop_512(img: np.ndarray) -> np.ndarray:
    return _resize_short_side_and_crop(img, 512)


def viridis_rgba(x: np.ndarray) -> np.ndarray:
    """``plt.imsave(cmap="viridis")``'s pixels for a float32 (H, W) array:
    min-max normalised in float32, index floor(v 256) with 256 -> 255,
    opaque RGBA uint8."""
    x = np.asarray(x, np.float32)
    vmin, vmax = x.min(), x.max()
    v = (x - vmin) / (vmax - vmin) if vmax > vmin else np.zeros_like(x)
    i = v * np.float32(256)
    i[i == 256] = 255
    i = np.clip(i.astype(np.int64), 0, 255)
    rgb = VIRIDIS_U8[i]
    return np.concatenate([rgb, np.full(x.shape + (1,), 255, np.uint8)], -1)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.task not in ("normal", "depth"):
        print("task should be one of the following: normal, depth")
        sys.exit(1)

    from collections import deque
    from pathlib import Path

    from .cues.encode import save_png
    from .models import create_model
    from .models.layers import resize_bicubic
    from .models.predict import predict_batches

    img_path = Path(args.img_path)
    if img_path.is_file():
        files = [args.img_path]
    elif img_path.is_dir():
        files = sorted(glob.glob(args.img_path + "/*"))
    else:
        print("invalid file path!")
        sys.exit(1)
    if args.batch_size < 1:
        raise SystemExit("--batch_size must be at least 1")

    os.makedirs(args.output_path, exist_ok=True)
    name = ("surface_normal_dpt_hybrid_384" if args.task == "normal"
            else "depth_dpt_hybrid_384")
    model = create_model(name, checkpoint=args.checkpoint, device=args.device,
                         dtype=args.dtype)
    names: deque = deque()  # each batch's output names, in predict order

    def crops():
        for i in range(0, len(files), args.batch_size):
            chunk = files[i:i + args.batch_size]
            stems = [os.path.splitext(os.path.basename(f))[0] for f in chunk]
            batch = []
            for f, stem in zip(chunk, stems):
                print(f"Reading input {f} ...")
                img = load_rgb_u8(f)
                save_png(os.path.join(args.output_path, f"{stem}_rgb.png"),
                         center_crop_512(img))
                batch.append(_resize_short_side_and_crop(img, args.image_size))
            names.append(stems)
            yield np.stack(batch)

    for out in predict_batches(model, crops(), args.task):
        for stem, pred in zip(names.popleft(), out):
            save_path = os.path.join(args.output_path, f"{stem}_{args.task}.png")
            if args.task == "depth":
                d = resize_bicubic(torch.from_numpy(pred)[None, None], (512, 512))
                save_png(save_path, viridis_rgba((1.0 - d[0, 0].clamp(0.0, 1.0)).numpy()))
            else:
                save_png(save_path, (pred.transpose(1, 2, 0) * np.float32(255)).astype(np.uint8))
            print(f"Writing output {save_path} ...")


if __name__ == "__main__":
    main()
