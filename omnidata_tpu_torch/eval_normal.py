"""Surface-normal evaluation driver (reference: paper_code/test_normal.py +
oasis_eval; metrics from evaluation_metrics.py), the port's counterpart of
the root ``eval_normal.py``.

    python -m omnidata_tpu_torch.eval_normal --data_path <annotated dir> \\
        [--checkpoint ckpt.ckpt | <trainer checkpoint dir>] \\
        [--model dpt|unet] [--image_size 384] [--device cuda|cpu]
    python -m omnidata_tpu_torch.eval_normal --oasis_csv OASIS_val.csv \\
        --oasis_root DIR [--tta] ...      # or --nyu_root DIR (needs h5py)

On the annotator layout it reports mean/median angular error, % within
11.25/22.5/30 degrees, masked L1/MSE x100 — the OASIS table's metric suite
(docs/pretrained.html:56-117); on OASIS or NYU the external protocol's
MAE, MDAE and shares below 11.25/22.5/30 degrees, optionally with flip TTA
and a median merge. Prints the metrics as JSON. ``--device cuda`` by
default; it raises without a card.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", default=None,
                   help="annotator-layout directory (self-annotated eval)")
    p.add_argument("--oasis_csv", default=None,
                   help="OASIS_val.csv for the external-benchmark protocol")
    p.add_argument("--oasis_root", default="",
                   help="prefix joined onto the csv's relative paths")
    p.add_argument("--nyu_root", default=None,
                   help="NYU .h5 directory with normals_gt companions")
    p.add_argument("--checkpoint", default=None,
                   help="published .ckpt/.pth or a trainer's checkpoint directory")
    p.add_argument("--model", default="dpt", choices=["dpt", "unet"])
    p.add_argument("--image_size", type=int, default=384)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--tta", action="store_true",
                   help="flip TTA with median merge (oasis_eval_tta.py)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def _external(args, model, device) -> dict:
    from .data.external_eval import (
        NYUNormalDataset,
        OASISNormalDatasetVal,
        evaluate_normals,
        make_oasis_model_fn,
    )

    if args.oasis_csv:
        ds = OASISNormalDatasetVal(args.oasis_csv, root=args.oasis_root)
    else:
        ds = NYUNormalDataset(args.nyu_root)
    model_fn = make_oasis_model_fn(model)
    if args.tta:
        from .models.tta import SurfaceNormalsTTA

        model_fn = SurfaceNormalsTTA(model_fn)
    return evaluate_normals(model_fn, ds,
                            max_items=args.max_batches * args.batch_size or None,
                            fixed_input_size=(args.image_size, args.image_size),
                            device=device)


def _annotated(args, model, device) -> dict:
    from .data.dataset import OmnidataDataset, Options
    from .train.metrics import normal_metrics

    ds = OmnidataDataset(Options(data_path=args.data_path,
                                 tasks=("rgb", "normal", "mask_valid"),
                                 image_size=args.image_size, random_flip=False))
    agg: dict = {}
    n = 0
    for i, batch in enumerate(ds.batches(args.batch_size, shuffle=False, drop_last=False)):
        if args.max_batches and i >= args.max_batches:
            break
        pred = model(torch.from_numpy(batch["rgb"].astype(np.float32)).to(device))
        pred = torch.clamp(pred, 0.0, 1.0) * 2.0 - 1.0  # [0,1] -> [-1,1]
        target = torch.from_numpy(batch["normal"].astype(np.float32)).to(device) * 2.0 - 1.0
        mask = torch.from_numpy(batch["mask_valid"] > 0.5).to(device)
        m = normal_metrics(pred, target, mask)
        B = int(batch["rgb"].shape[0])  # partial tail batch: weight by size
        for k, v in m.items():
            agg[k] = agg.get(k, 0.0) + v * B
        n += B
    if n == 0:
        raise SystemExit("no complete (rgb, normal, mask_valid) samples found")
    return {k: v / n for k, v in agg.items()}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from .annotator.cli import resolve_device
    from .models import create_model

    device = resolve_device(args.device)
    external = bool(args.oasis_csv or args.nyu_root)
    if not (external or args.data_path):
        raise SystemExit("one of --data_path / --oasis_csv / --nyu_root required")
    name = "surface_normal_dpt_hybrid_384" if args.model == "dpt" else "surface_normal_unet"
    model = create_model(name, checkpoint=args.checkpoint, device=device)
    with torch.inference_mode():
        result = (_external if external else _annotated)(args, model, device)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
