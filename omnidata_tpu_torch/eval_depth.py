"""Depth evaluation driver (reference: paper_code/test_depth.py; metrics
from evaluation_metrics.py:13-110: L1/MSE x100, log10, si-log, relative
error, irmse), the port's counterpart of the root ``eval_depth.py``.

    python -m omnidata_tpu_torch.eval_depth --data_path <annotated dir> \\
        [--checkpoint ckpt.ckpt | <trainer checkpoint dir>] [--align none|ssi] \\
        [--nyu_root <dir of .h5>] [--device cuda|cpu] [--dtype float32|bfloat16]

DPT-hybrid depth at --image_size on the annotator layout (rgb,
depth_zbuffer, mask_valid), or on NYU .h5 files (needs h5py). Prints the
metrics as JSON, each the mean over images (a partial tail batch weighted
by its size). ``--device cuda`` by default; it raises without a card.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", default=None)
    p.add_argument("--nyu_root", default=None,
                   help="NYU .h5 directory (rgb+depth) — external protocol")
    p.add_argument("--checkpoint", default=None,
                   help="published .ckpt/.pth or a trainer's checkpoint directory")
    p.add_argument("--image_size", type=int, default=384)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--align", choices=("none", "ssi"), default="none",
                   help="'ssi': per-image least-squares scale/shift "
                        "alignment of pred to gt before metrics — the MiDaS "
                        "protocol for models trained with the "
                        "scale-shift-invariant stage of the loss "
                        "(midas_loss.py:10-30; absolute metrics are "
                        "meaningless for an SSI-stage model)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="the model's precision (default float32; bfloat16 keeps "
                        "the norms in float32)")
    return p


def _nyu(args, model, device) -> dict:
    from .data.external_eval import NYUDepthDataset, _resize_chw
    from .train.metrics import depth_metrics

    ds = NYUDepthDataset(args.nyu_root)
    agg: dict = {}
    n = 0
    limit = args.max_batches * args.batch_size or len(ds)
    for i in range(min(limit, len(ds))):
        s = ds[i]
        x = _resize_chw(s["rgb"], args.image_size, args.image_size)
        x = (x - 0.5) / 0.5  # depth model takes [-1,1] rgb
        pred = model(torch.from_numpy(np.ascontiguousarray(x[None])).to(device))
        h, w = s["orig_size"]
        pred = np.clip(_resize_chw(pred.cpu().numpy(), h, w)[0], 0, 1)
        # model outputs [0,1] inverse-ish depth; evaluate vs gt scaled to
        # [0,1] by NYU's max range (the reference's clamp_to convention;
        # pred clipped the same as the --data_path protocol)
        gt = np.clip(s["depth"][0] / ds.MAX_DEPTH, 0, 1)
        m = torch.from_numpy(s["mask"][0] > 0.5)
        out = depth_metrics(torch.from_numpy(pred)[None, None],
                            torch.from_numpy(gt)[None, None], m[None, None])
        for k, v in out.items():
            agg[k] = agg.get(k, 0.0) + float(v)
        n += 1
    if n == 0:
        raise SystemExit("no NYU samples found")
    return {k: v / n for k, v in agg.items()}


def _annotated(args, model, device) -> dict:
    from .data.dataset import OmnidataDataset, Options
    from .losses.midas import compute_scale_and_shift
    from .train.metrics import depth_metrics

    ds = OmnidataDataset(Options(data_path=args.data_path,
                                 tasks=("rgb", "depth_zbuffer", "mask_valid"),
                                 image_size=args.image_size, random_flip=False))
    agg: dict = {}
    n = 0
    for i, batch in enumerate(ds.batches(args.batch_size, shuffle=False, drop_last=False)):
        if args.max_batches and i >= args.max_batches:
            break
        rgb = torch.from_numpy(batch["rgb"].astype(np.float32)).to(device) * 2.0 - 1.0
        pred = torch.clamp(model(rgb), 0.0, 1.0)[:, None]
        target = torch.from_numpy(batch["depth_zbuffer"].astype(np.float32)).to(device)
        mask = torch.from_numpy(batch["mask_valid"] > 0.5).to(device)
        if args.align == "ssi":
            s, t = compute_scale_and_shift(pred[:, 0], target[:, 0], mask[:, 0])
            pred = torch.clamp(s[:, None, None, None] * pred + t[:, None, None, None],
                               0.0, 1.0)
        m = depth_metrics(pred, target, mask)
        B = int(batch["rgb"].shape[0])  # partial tail batch: weight by size
        for k, v in m.items():
            agg[k] = agg.get(k, 0.0) + v * B
        n += B
    if n == 0:
        raise SystemExit("no complete (rgb, depth_zbuffer, mask_valid) samples found")
    return {k: v / n for k, v in agg.items()}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from .annotator.cli import resolve_device
    from .models import create_model

    device = resolve_device(args.device)
    if not (args.nyu_root or args.data_path):
        raise SystemExit("one of --data_path / --nyu_root required")
    model = create_model("depth_dpt_hybrid_384", checkpoint=args.checkpoint,
                         device=device, dtype=args.dtype)
    with torch.inference_mode():
        result = (_nyu if args.nyu_root else _annotated)(args, model, device)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
