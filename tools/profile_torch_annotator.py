#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's main paths, on one GPU.

For one cell, K = 32 views at 512², tile 32, chunk 128, every device
modality: the bench scene (``--scene bench``, ``scenes.build_scene(seed=0)``,
cameras of seed 1, 4 batches) or the large scene (``--scene large``,
``scenes.build_large_scene(seed=0)``, cameras of seed 3, ccap 192, 2
batches, as ``bench.py``'s large-scene measurement), on kernel A or, with
``--streamed``, on kernel C's compacting body. Prints:
- admission statistics per timed batch: rows per list encoding (exact,
  scan-all, block mode) and the trip counts the raster kernel will sweep;
  with ``--streamed`` also the staged faces per row;
- the raster kernel's time as is, with its tail rows emptied (scan-all
  rows, and with ``--streamed`` the rows past the stage cap, which sweep
  their raw lists), and with every row emptied (launch + output write), by
  CUDA events;
- each stage timed alone: ``prepare_raster``, ``decode_winners``,
  ``keypoints2d``, ``edge_texture``, ``edge_occlusion``;
- ``annotate_views`` per batch, then a ``torch.profiler`` table of device
  time by kernel over the batches and the device idle share (kernel time
  summed by the profiler against the unprofiled batch time).

Run from the repository root on a machine with a card:
``python3 tools/profile_torch_annotator.py [--scene large --streamed]``.
Imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import cuda_ms, gpu_name_and_power_limit  # noqa: E402
from omnidata_tpu_torch import scenes  # noqa: E402
from omnidata_tpu_torch.annotator import DEVICE_MODALITIES, annotate_views  # noqa: E402
from omnidata_tpu_torch.annotator.pipeline import _gather_attrs  # noqa: E402
from omnidata_tpu_torch.cues.edges import edge_occlusion, edge_texture  # noqa: E402
from omnidata_tpu_torch.cues.keypoints2d import keypoints2d  # noqa: E402
from omnidata_tpu_torch.mesh import raster as R  # noqa: E402
from omnidata_tpu_torch.mesh import raster_kernels as rk  # noqa: E402

K, RES, TILE, CHUNK = 32, 512, 32, 128
CELLS = {  # scene -> (builder, camera seed, ccap, timed batches)
    "bench": (scenes.build_scene, 1, None, 4),
    "large": (scenes.build_large_scene, 3, 192, 2),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=sorted(CELLS), default="bench")
    ap.add_argument("--streamed", action="store_true",
                    help="render with kernel C's compacting body")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(gpu_name_and_power_limit(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    build, cam_seed, ccap, n_batches = CELLS[a.scene]
    mesh, curv = build(device=dev)
    n_chunks = mesh.faces.shape[0] // CHUNK
    cams = scenes.sample_cameras_np((n_batches + 1) * K, seed=cam_seed)
    batches = [scenes.camera_batch(cams, range(K * (b + 1), K * (b + 2)), RES, dev)
               for b in range(n_batches)]
    vattrs, _ = _gather_attrs(mesh, curv, DEVICE_MODALITIES)
    render_kw = dict(ccap=ccap, compact=a.streamed, streamed=a.streamed)
    print(f"cell: {a.scene} scene, {mesh.num_faces} faces, streamed "
          f"{a.streamed}, ccap {ccap}, {n_batches} batches of K={K}", flush=True)

    def run(b):
        return annotate_views(b, mesh, curv, tile=TILE, chunk=CHUNK, ccap=ccap,
                              streamed=a.streamed)

    def kernel(inp, counts):
        args = (inp.ids, counts, inp.origins, inp.pack, inp.dir_planes)
        kw = dict(chunk=CHUNK, tiles_per_view=inp.tiles_per_view)
        if a.streamed:
            return rk.raster_tiles_streamed(*args, bbox_words=inp.bbox_words, **kw)
        return rk.raster_tiles_chunklist(*args, **kw)

    for b in batches:  # warm-up: kernel build, cuDNN plans, allocator
        run(b)
    torch.cuda.synchronize()

    for i, b in enumerate(batches):
        inp = R.prepare_raster(b, mesh, TILE, CHUNK, vattrs, **render_kw)
        c = inp.counts
        trip = torch.where(c == -1, n_chunks,
                           torch.where(c < -1, (-c - 2) * 8, c)).float()
        print(f"batch {i}: rows exact {int((c >= 0).sum())}, scan-all "
              f"{int((c == -1).sum())}, block {int((c <= -2).sum())}; trips "
              f"sum {int(trip.sum())}, mean {float(trip.mean()):.3f}, p99 "
              f"{float(trip.quantile(0.99)):.1f}, max {int(trip.max())}",
              flush=True)
        tail = c == -1
        if a.streamed:
            staged, _ = rk.stage_faces(inp.ids, c, inp.bbox_words, n_chunks,
                                       CHUNK, inp.tiles_per_view, TILE, 1)
            past = staged > rk.STREAMED_STAGE_CAP
            tail |= past
            sf = staged.float()
            print(f"  staged faces per row: mean {float(sf.mean()):.1f}, p50 "
                  f"{float(sf.quantile(0.5)):.0f}, p99 "
                  f"{float(sf.quantile(0.99)):.0f}, max {int(sf.max())}; rows "
                  f"past {rk.STREAMED_STAGE_CAP}: {int(past.sum())}, their "
                  f"raw trips {int(trip[past].sum())}", flush=True)
        if i:
            continue
        no_tail = torch.where(tail, 0, c).contiguous()
        empty = torch.zeros_like(c)
        ms = [cuda_ms(lambda cc=cc: kernel(inp, cc), 10)
              for cc in (c, no_tail, empty)]
        print(f"raster kernel K={K}: {ms[0]:.3f} ms; tail rows "
              f"({int(tail.sum())}) emptied {ms[1]:.3f} ms; all rows emptied "
              f"{ms[2]:.3f} ms", flush=True)
        packed, acc = kernel(inp, c)
        g = torch.rand(K, RES, RES, device=dev)
        codes = (torch.rand(K, RES, RES, device=dev) * 60000).to(torch.int32)
        stages = {
            "prepare_raster": lambda: R.prepare_raster(b, mesh, TILE, CHUNK, vattrs,
                                                       **render_kw),
            "decode_winners": lambda: rk.decode_winners(
                packed, acc, inp.origins, inp.dir_planes, inp.tiles_per_view),
            "keypoints2d": lambda: keypoints2d(g),
            "edge_texture": lambda: edge_texture(g),
            "edge_occlusion": lambda: edge_occlusion(codes.to(torch.uint16)),
        }
        print(f"stages K={K} (ms): " + ", ".join(
            f"{k} {cuda_ms(f, 5):.3f}" for k, f in stages.items()), flush=True)
        del packed, acc

    ms_batch = cuda_ms(lambda: [run(b) for b in batches], 2) / n_batches
    print(f"annotate_views K={K}: {ms_batch:.3f} ms/batch, "
          f"{K / ms_batch * 1e3:.2f} viewpoints/s", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            run(b)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profiled {n_batches} batches: device kernel time {dev_ms:.3f} ms "
          f"({len(kernels)} distinct kernels, {sum(e.count for e in kernels)} "
          f"launches) = {dev_ms / n_batches:.3f} ms/batch against "
          f"{ms_batch:.3f} ms/batch unprofiled: idle share "
          f"{1 - dev_ms / n_batches / ms_batch:.3f}", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=25,
                       max_name_column_width=60), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
