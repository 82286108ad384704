#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's main path, on one GPU.

For the bench cell (``scenes.build_scene(seed=0)``, K = 32 views at 512²,
tile 32, chunk 128, every device modality) prints:
- admission statistics per timed batch: rows per list encoding (exact,
  scan-all, block mode) and the trip counts the raster kernel will sweep;
- the raster kernel's time as is, with the scan-all rows emptied, and with
  every row emptied (launch + output write), by CUDA events;
- each stage timed alone: ``prepare_raster``, ``decode_winners``,
  ``keypoints2d``, ``edge_texture``, ``edge_occlusion``;
- ``annotate_views`` per batch, then a ``torch.profiler`` table of device
  time by kernel over 4 batches and the device idle share (kernel time
  summed by the profiler against the unprofiled batch time).

Run from the repository root on a machine with a card:
``python3 tools/profile_torch_annotator.py``. Imports no JAX.
"""
from __future__ import annotations

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

K, RES, TILE, CHUNK, N_BATCHES = 32, 512, 32, 128, 4


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(gpu_name_and_power_limit(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    mesh, curv = scenes.build_scene(device=dev)
    n_chunks = mesh.faces.shape[0] // CHUNK
    cams = scenes.sample_cameras_np((N_BATCHES + 1) * K, seed=1)
    batches = [scenes.camera_batch(cams, range(K * (b + 1), K * (b + 2)), RES, dev)
               for b in range(N_BATCHES)]
    vattrs, _ = _gather_attrs(mesh, curv, DEVICE_MODALITIES)

    def run(b):
        return annotate_views(b, mesh, curv, tile=TILE, chunk=CHUNK)

    for b in batches:  # warm-up: kernel build, cuDNN plans, allocator
        run(b)
    torch.cuda.synchronize()

    for i, b in enumerate(batches):
        inp = R.prepare_raster(b, mesh, TILE, CHUNK, vattrs)
        c = inp.counts
        trip = torch.where(c == -1, n_chunks,
                           torch.where(c < -1, (-c - 2) * 8, c)).float()
        print(f"batch {i}: rows exact {int((c >= 0).sum())}, scan-all "
              f"{int((c == -1).sum())}, block {int((c <= -2).sum())}; trips "
              f"sum {int(trip.sum())}, mean {float(trip.mean()):.3f}, p99 "
              f"{float(trip.quantile(0.99)):.1f}, max {int(trip.max())}",
              flush=True)
        if i:
            continue
        args = (inp.ids, inp.counts, inp.origins, inp.pack, inp.dir_planes)
        kw = dict(chunk=CHUNK, tiles_per_view=inp.tiles_per_view)
        no_scan = torch.where(c == -1, 0, c).contiguous()
        empty = torch.zeros_like(c)
        ms = [cuda_ms(lambda cc=cc: rk.raster_tiles_chunklist(
            inp.ids, cc, *args[2:], **kw), 10) for cc in (c, no_scan, empty)]
        print(f"raster kernel K={K}: {ms[0]:.3f} ms; scan-all rows emptied "
              f"{ms[1]:.3f} ms; all rows emptied {ms[2]:.3f} ms", flush=True)
        packed, acc = rk.raster_tiles_chunklist(*args, **kw)
        g = torch.rand(K, RES, RES, device=dev)
        codes = (torch.rand(K, RES, RES, device=dev) * 60000).to(torch.int32)
        stages = {
            "prepare_raster": lambda: R.prepare_raster(b, mesh, TILE, CHUNK, vattrs),
            "decode_winners": lambda: rk.decode_winners(
                packed, acc, inp.origins, inp.dir_planes, inp.tiles_per_view),
            "keypoints2d": lambda: keypoints2d(g),
            "edge_texture": lambda: edge_texture(g),
            "edge_occlusion": lambda: edge_occlusion(codes.to(torch.uint16)),
        }
        print("stages K=32 (ms): " + ", ".join(
            f"{k} {cuda_ms(f, 5):.3f}" for k, f in stages.items()), flush=True)

    ms_batch = cuda_ms(lambda: [run(b) for b in batches], 2) / N_BATCHES
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
    print(f"profiled {N_BATCHES} batches: device kernel time {dev_ms:.3f} ms "
          f"({len(kernels)} distinct kernels, {sum(e.count for e in kernels)} "
          f"launches) = {dev_ms / N_BATCHES:.3f} ms/batch against "
          f"{ms_batch:.3f} ms/batch unprofiled: idle share "
          f"{1 - dev_ms / N_BATCHES / ms_batch:.3f}", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=25,
                       max_name_column_width=60), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
