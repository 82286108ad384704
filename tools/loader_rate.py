#!/usr/bin/env python3
"""Samples/s of the trainers' loader over annotator outputs, decoding PNGs
against reading a packed cache (``data.packed_cache``), for either
package's data layer: ``omnidata_tpu_torch.data`` (default) or the JAX
package's ``omnidata_tpu.data`` (``--package jax``; PIL decodes there).

Each rate is ``MixedLoader``'s batches of ``--batch`` samples with
``--workers`` threads, flip augmentation on, over ``--batches`` batches
after one warm-up batch; the pack is built first (not timed). Host-only:
no device is used.

    python tools/loader_rate.py --data DIR [--package jax] [--workers 1 8]
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path

TASKS = ("rgb", "normal", "depth_zbuffer", "mask_valid")


def rate(loader_mod, ds, batch: int, workers: int, batches: int) -> float:
    loader = loader_mod.MixedLoader([ds], batch_size=batch, num_workers=workers)
    it = loader.batches(steps=batches + 1, seed=0)
    next(it)
    t0 = time.perf_counter()
    n = sum(len(b["rgb"]) for b in it)
    return n / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", required=True, help="annotator output directory")
    p.add_argument("--package", choices=("torch", "jax"), default="torch")
    p.add_argument("--workers", type=int, nargs="+", default=[1, 8])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--batches", type=int, default=4)
    a = p.parse_args(argv)
    pkg = "omnidata_tpu_torch" if a.package == "torch" else "omnidata_tpu"
    dataset = importlib.import_module(f"{pkg}.data.dataset")
    packed = importlib.import_module(f"{pkg}.data.packed_cache")
    loader_mod = importlib.import_module(f"{pkg}.data.loader")
    ds = dataset.OmnidataDataset(dataset.Options(data_path=a.data, tasks=TASKS,
                                                 random_flip=True))
    out = {"package": pkg, "samples": len(ds), "tasks": TASKS, "batch": a.batch}
    with tempfile.TemporaryDirectory() as cache:
        pds = packed.PackedDataset.build(ds, cache)
        for w in a.workers:
            out[f"png_{w}"] = rate(loader_mod, ds, a.batch, w, a.batches)
            out[f"packed_{w}"] = rate(loader_mod, pds, a.batch, w, a.batches)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    main()
