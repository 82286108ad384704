#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's main paths, on one GPU.

For one cell, K = 32 views at 512², tile 32, chunk 128, every device
modality: the bench scene (``--scene bench``, ``scenes.build_scene(seed=0)``,
cameras of seed 1, 4 batches) or the large scene (``--scene large``,
``scenes.build_large_scene(seed=0)``, cameras of seed 3, ccap 192, 2
batches, as ``bench.py``'s large-scene measurement; ``--scene large48``:
the same at the annotator CLI's ccap 48; ``--scene xl``: the 1,423,360-face
``scenes.build_xl_scene(seed=0)`` as the large scene), on kernel A or, with
``--streamed``, on kernel C's compacting body. ``--compact`` times kernel B
(the compacting kernel on the row-major pack, stage cap 512) in A's place
and ``render_views_fused(compact=True)`` against A's render, admission
included; ``annotate_views`` has no compact route, so its numbers stay
kernel A's. Prints:
- admission statistics per timed batch: rows per list encoding (exact,
  scan-all, block mode; on a card no block mode, and scan-all only for
  longer rows past the list buffer) and the trip counts the raster kernel
  will sweep; the faces per row whose bbox overlaps the tile, and the rows
  past the stage cap (8,192; 512 with ``--compact``);
- the raster kernel's time (CUDA events, median of 5 runs of 5 launches)
  beside its pixel-face pairs and bound (``raster_measure.raster_work``)
  and, where the checkout's wrapper records them, its work items and split
  rows; its time with its tail rows emptied (scan-all rows, and with
  ``--streamed`` or ``--compact`` the rows past the stage cap, which sweep
  their raw lists) and with every row emptied (launch + output write); and
  its time on the first 1, 2 and 8 views of the batch; with ``--compact``,
  the render on kernel A and on kernel B, in turns (A, B, B, A);
- each stage timed alone: ``prepare_raster``, ``decode_winners``,
  ``keypoints2d``, ``edge_texture``, ``edge_occlusion``;
- ``annotate_views`` per batch (median of 3 runs over the batches), then a
  ``torch.profiler`` table of device time by kernel over the batches and the
  device idle share (kernel time summed by the profiler against the
  unprofiled batch time).

``--root DIR`` imports ``omnidata_tpu_torch`` from another checkout of the
port (its kernels build under DIR/build/kernels), so that a parent commit
unpacked into a git-ignored directory is timed by the same script on the
same card: ``python3 tools/profile_torch_annotator.py --root build/parent``.

Run from the repository root on a machine with a card:
``python3 tools/profile_torch_annotator.py [--scene large --streamed]``
(or ``--compact`` on the bench scene).
Imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

from raster_measure import (cuda_ms, gpu_name_and_power_limit, item_counts,
                            overlap_counts, raster_work, trips)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, RES, TILE, CHUNK = 32, 512, 32, 128
SMALL_K = (1, 2, 8)
CELLS = {  # scene -> (scenes' function, camera seed, ccap, timed batches)
    "bench": ("build_scene", 1, None, 4),
    "large": ("build_large_scene", 3, 192, 2),
    "large48": ("build_large_scene", 3, 48, 2),
    "xl": ("build_xl_scene", 3, 192, 2),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=sorted(CELLS), default="bench")
    ap.add_argument("--streamed", action="store_true",
                    help="render with kernel C's compacting body")
    ap.add_argument("--compact", action="store_true",
                    help="time kernel B and the compact=True render in "
                    "kernel A's place")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose omnidata_tpu_torch is timed")
    a = ap.parse_args()
    if a.compact and a.streamed:
        ap.error("--compact and --streamed time different kernels")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.root))
    from omnidata_tpu_torch import scenes
    from omnidata_tpu_torch.annotator import DEVICE_MODALITIES, annotate_views
    from omnidata_tpu_torch.annotator.pipeline import _gather_attrs
    from omnidata_tpu_torch.cues.edges import edge_occlusion, edge_texture
    from omnidata_tpu_torch.cues.keypoints2d import keypoints2d
    from omnidata_tpu_torch.mesh import raster as R
    from omnidata_tpu_torch.mesh import raster_kernels as rk

    card = gpu_name_and_power_limit()
    print(f"{card}; package {os.path.dirname(rk.__file__)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    scene_fn, cam_seed, ccap, n_batches = CELLS[a.scene]
    mesh, curv = getattr(scenes, scene_fn)(device=dev)
    n_chunks = mesh.faces.shape[0] // CHUNK
    cams = scenes.sample_cameras_np((n_batches + 1) * K, seed=cam_seed)
    batches = [scenes.camera_batch(cams, range(K * (b + 1), K * (b + 2)), RES, dev)
               for b in range(n_batches)]
    vattrs, _ = _gather_attrs(mesh, curv, DEVICE_MODALITIES)
    compacting = a.streamed or a.compact
    render_kw = dict(ccap=ccap, compact=compacting, streamed=a.streamed)
    cap = rk.STAGE_CAP if a.compact else rk.STREAMED_STAGE_CAP
    wrapper = (rk.raster_tiles_streamed if a.streamed else rk.raster_tiles_compact
               if a.compact else rk.raster_tiles_chunklist)
    print(f"cell: {a.scene} scene, {mesh.num_faces} faces, streamed "
          f"{a.streamed}, compact {a.compact}, ccap {ccap}, {n_batches} "
          f"batches of K={K}", flush=True)

    def run(b):
        return annotate_views(b, mesh, curv, tile=TILE, chunk=CHUNK, ccap=ccap,
                              streamed=a.streamed)

    def kernel_on(inp, counts, views=K):
        """The raster kernel on the batch's first views, as a call."""
        T = inp.tiles_per_view
        r = slice(0, views * T)
        kw = dict(chunk=CHUNK, tiles_per_view=T)
        offsets = getattr(inp, "offsets", None)  # exact lists (not in older checkouts)
        if offsets is None:
            ids = inp.ids[r]
        else:
            ids, kw["offsets"] = inp.ids, offsets[r]
        args = (ids, counts[r], inp.origins[:views], inp.pack,
                tuple(d[r] for d in inp.dir_planes))
        if a.streamed:
            words = inp.bbox_words[:views]
            return lambda: wrapper(*args, bbox_words=words, **kw)
        if a.compact:
            words = inp.bbox_words[:views]
            return lambda: wrapper(*args[:4], words, args[4], **kw)
        return lambda: wrapper(*args, **kw)

    for b in batches:  # warm-up: kernel build, cuDNN plans, allocator
        run(b)
    torch.cuda.synchronize()

    for i, b in enumerate(batches):
        inp = R.prepare_raster(b, mesh, TILE, CHUNK, vattrs, **render_kw)
        c = inp.counts
        trip = trips(c, n_chunks).float()
        print(f"batch {i}: rows exact {int((c >= 0).sum())}, scan-all "
              f"{int((c == -1).sum())}, block {int((c <= -2).sum())}; trips "
              f"sum {int(trip.sum())}, mean {float(trip.mean()):.3f}, p99 "
              f"{float(trip.quantile(0.99)):.1f}, max {int(trip.max())}",
              flush=True)
        # the bbox words of the batch (kernel A's inputs lack them)
        winp = inp if compacting else R.prepare_raster(
            b, mesh, TILE, CHUNK, vattrs, ccap=ccap, compact=True)
        overlaps = overlap_counts(winp, CHUNK)
        of = overlaps.float()
        tail = c == -1
        past = overlaps > cap
        print(f"  bbox-overlapping faces per row: mean {float(of.mean()):.1f}, "
              f"p50 {float(of.quantile(0.5)):.0f}, p99 "
              f"{float(of.quantile(0.99)):.0f}, max {int(of.max())}; rows past "
              f"{cap}: {int(past.sum())}, their raw trips "
              f"{int(trip[past].sum())}", flush=True)
        if compacting:
            tail |= past
        del winp
        if i:
            continue
        kernel = kernel_on(inp, c)
        kernel()
        ms_runs = sorted(cuda_ms(kernel, 5) for _ in range(5))
        ms = statistics.median(ms_runs)
        work = raster_work(inp, overlaps, reads_bbox_words=compacting)
        sched = getattr(wrapper, "last_schedule", None)
        items = item_counts(sched) if sched is not None else "one CTA per row"
        ms_no_tail, ms_empty = (
            cuda_ms(kernel_on(inp, cc), 10)
            for cc in (torch.where(tail, 0, c).contiguous(), torch.zeros_like(c)))
        small = {}
        for v in SMALL_K:
            fn = kernel_on(inp, c, v)
            fn()
            small[v] = cuda_ms(fn, 20)
        print(f"raster kernel K={K}: {ms:.3f} ms (runs "
              f"{', '.join(f'{x:.3f}' for x in ms_runs)}); {work['pairs']:.4g} "
              f"pixel-face pairs, bound {work['bound_ms']:.3f} ms (by "
              f"{work['bound_by']}; operations {work['ops_ms']:.3f}, "
              f"{work['ops_ms_unfused']:.3f} unfused; bytes "
              f"{work['bytes_ms']:.3f}), {work['bound_ms'] / ms:.3f} of the "
              f"bound; items {items}; tail rows ({int(tail.sum())}) emptied "
              f"{ms_no_tail:.3f} ms; all rows emptied {ms_empty:.3f} ms; "
              + ", ".join(f"K={v} {t:.3f} ms" for v, t in small.items())
              + f"; card {card}", flush=True)
        if a.compact:
            def render(compact):
                return lambda: R.render_views_fused(
                    b, mesh, TILE, CHUNK, vattrs, ccap=ccap, streamed=False,
                    compact=compact)

            render(True)()
            turns = [cuda_ms(render(x), 5) for x in (False, True, True, False)]
            print(f"render_views_fused K={K}, admission included (A, B, B, "
                  f"A): {', '.join(f'{t:.3f}' for t in turns)} ms; card "
                  f"{card}", flush=True)
        packed, acc = kernel()
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

    reps = sorted(cuda_ms(lambda: [run(b) for b in batches], 1) / n_batches
                  for _ in range(3))
    ms_batch = statistics.median(reps)
    print(f"annotate_views K={K}: {ms_batch:.3f} ms/batch, "
          f"{K / ms_batch * 1e3:.2f} viewpoints/s (runs "
          f"{', '.join(f'{K / r * 1e3:.2f}' for r in reps)} vps); card {card}",
          flush=True)

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
