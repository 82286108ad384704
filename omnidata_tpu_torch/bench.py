"""Benchmark: annotated viewpoints/s of the port on one NVIDIA GPU, the
port's ``bench.py``: ``python -m omnidata_tpu_torch.bench [--device
cuda|cpu]``.

Scenes: procedural Replica-like interiors (room + furniture-scale boxes +
spheres) with baked curvature vertex colours (``scenes``) —
- small: 39,760 faces (kernel A, the chunk-list raster kernel);
- large: 584,704 faces, real-scan scale (kernel C, streamed and
  compacting; extra.large_scene_*);
- xl: 1,423,360 faces, the size of a real Replica scan (kernel C;
  extra.xl_scene_*).

Per viewpoint, the device pipeline (``annotator.annotate_views``) produces
the 10 device-side modalities at 512x512: depth_zbuffer, depth_euclidean,
mask_valid, normal, reshading, rgb, principal_curvature, edge_occlusion,
edge_texture, keypoints2d. extra.full13_vps adds the 3 host cues
(keypoints3d, segment_unsup2d, segment_unsup25d), computed on the CLI's
worker pool from the fetched device outputs, overlapped with the fetch of
the next batch.

Baseline: the reference annotates its demo mesh (12 modalities, ~12
points, one view each) in <= ~10 min on CPU (omnidata_annotator/README.md:55)
-> ~0.02 viewpoints/s with the full modality set. The final line's
vs_baseline uses full13_vps when measured, else the device-modality rate.

The headline JSON line is printed and flushed the moment the small-scene
number exists; the extras then run under a deadline (BENCH_DEADLINE_S
seconds from the start of the process, default 1200) and are skipped —
recorded in extra.skipped — once past their budget; the enriched line is
printed last. BENCH_FAST=1 prints the headline only; BENCH_TRAIN=1 adds the
depth training step. An extra that raises is recorded as extra.<name>_error
and the process then exits 1 after the enriched line. Scene assembly and
baked curvature are cached on disk under tmp/bench_scenes_torch/ (one npz
of v, f, colors and curv per scene and device type). Progress notes go to
stderr; stdout carries only the JSON lines.

Timing: a warm call, then ``time.perf_counter()`` around each repetition,
which ends by fetching a sum of the depth_zbuffer codes of every batch to
the host, so the clock stops after the device has finished; nothing
synchronizes inside the loop. On the card the bench runs as a server
would: torch's defaults, with ``cudnn.benchmark`` on; ``config`` records
the card's name and power limit and the TF32 and cuDNN flags in force.

``--device cpu`` takes bench.py's CPU branch: ``annotate_view`` per view
through the plain ``render_view`` (tile 64, chunk 64, cap 1024), K = 2 views,
1 batch, 1 repetition, no extras. Without a card the default ``--device
cuda`` fails with a message.

Divergences from bench.py: no probe that re-executes on the CPU when the
device does not answer (a missing card is an error here); no compile cache
(XLA's); full13 reports no modelled TPU-pod rate; the DPT extra reports no
ratio to an estimate for another card, and its share of peak is taken
against the H100's dense peaks (``utils.flops.PEAK_FLOPS``); full13 runs
the CLI's own pipeline (``annotator.cli.render_batches``) and starts its
pool's workers before the clock starts.

Prints JSON lines: {"metric", "value", "unit", "vs_baseline", "value_min",
"value_max", "config"[, "extra"]}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import scenes
from .scenes import camera_batch, sample_cameras_np

_T0 = time.perf_counter()
BASELINE_VIEWPOINTS_PER_SEC = 12.0 / 600.0  # reference demo: ~12 viewpoints / 10 min

_SCENE_CACHE_DIR = Path(__file__).resolve().parent.parent / "tmp" / "bench_scenes_torch"
_SCENE_CACHE_VERSION = "v1"
KERNEL_SOURCES = ("raster_chunklist", "raster_compact", "raster_admission")
HOST_LIBRARIES = ("narf", "felzenszwalb")
# bench_large_scene's launch (bench.py:383): views per call, tile, chunk-list
# cap and resolution
LARGE_K, LARGE_TILE, LARGE_CCAP, LARGE_RES = 32, 32, 192, 512
FULL13_NEEDED = ("depth_zbuffer", "rgb")  # the labels the host cues read
DEPTH_MAX_METERS = 128.0


def _deadline_s() -> float:
    return float(os.environ.get("BENCH_DEADLINE_S", 1200.0))


def _remaining() -> float:
    return _deadline_s() - (time.perf_counter() - _T0)


def _note(msg):
    """Progress marker on stderr (stdout carries only JSON lines)."""
    print(f"[bench] {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _cached_scene(name: str, build, device: torch.device):
    """Disk-cached scene: (mesh, curvature-coloured mesh).

    build(device=) -> the same pair. The cache holds the vertices, the
    faces in the mesh's own (Morton) order, the vertex colours and the baked
    curvature colours, so a cached load rebuilds the same mesh without the
    edge split and the quadric fit; the key is the scene's name, the device
    type (the bake runs there) and a version tag (the scenes are seeded)."""
    from .mesh.mesh import from_arrays

    path = _SCENE_CACHE_DIR / f"{name}_{device.type}_{_SCENE_CACHE_VERSION}.npz"
    if path.exists():
        z = np.load(path)
        mesh = from_arrays(z["v"], z["f"], vertex_colors=z["colors"],
                           spatial_order=False, device=device)
        return mesh, mesh._replace(vertex_colors=torch.as_tensor(
            z["curv"], device=device))
    mesh, curv = build(device=device)
    _SCENE_CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, v=mesh.vertices.cpu().numpy(),
             f=mesh.faces[: mesh.num_faces].cpu().numpy(),
             colors=mesh.vertex_colors.cpu().numpy(),
             curv=curv.vertex_colors.cpu().numpy())
    os.replace(tmp, path)
    return mesh, curv


def build_scene(seed: int = 0, n_spheres: int = 4, n_boxes: int = 5,
                device: torch.device | str = "cpu"):
    """Small scene: 39,760 faces (``scenes.build_scene``), cached."""
    return _cached_scene(
        f"small_{seed}_{n_spheres}_{n_boxes}",
        lambda device: scenes.build_scene(seed, n_spheres, n_boxes, device),
        torch.device(device))


def build_large_scene(seed: int = 0, device: torch.device | str = "cpu"):
    """Replica-scan-scale scene: 584,704 faces (``scenes.build_large_scene``),
    cached."""
    return _cached_scene(f"large_{seed}",
                         lambda device: scenes.build_large_scene(seed, device),
                         torch.device(device))


def build_xl_scene(seed: int = 0, device: torch.device | str = "cpu"):
    """The size of a real Replica scan: 1,423,360 faces
    (``scenes.build_xl_scene``), cached."""
    return _cached_scene(f"xl_{seed}",
                         lambda device: scenes.build_xl_scene(seed, device),
                         torch.device(device))


def _view(cams_np, i: int, res: int, device):
    """Row i of ``sample_cameras_np``'s arrays as one camera (location (3,),
    R (3,3), fov ())."""
    from .core.cameras import Camera

    locs, Rs, fovs = cams_np
    return Camera(torch.as_tensor(locs[i], device=device),
                  torch.as_tensor(Rs[i], device=device),
                  torch.as_tensor(fovs[i], device=device), res)


def _depth_sum(out) -> torch.Tensor:
    """The data-dependent scalar each timed call adds to the fetched sum."""
    return out["depth_zbuffer"].to(torch.int32).sum()


def main(argv=None, res: int = 512, reps: int | None = None) -> None:
    """The headline, then the extras (see the module doc). res and reps
    shrink a run (tests, a short check); the defaults are bench.py's."""
    from .annotator import annotate_view, annotate_views
    from .annotator.cli import resolve_device

    ap = argparse.ArgumentParser(prog="python -m omnidata_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    tile = 32 if on_card else 64  # smaller tiles: fewer candidates a pixel
    cap = 1024  # render_view's per-tile capacity (the CPU branch)
    chunk = 128 if on_card else 64
    K = 32 if on_card else 2  # views per annotate_views call
    n_batches = 16 if on_card else 1
    n_views = K * n_batches
    if on_card:
        from ._build import build_libraries

        _note("building the raster kernels and the host-cue cores")
        build_libraries(KERNEL_SOURCES, HOST_LIBRARIES)
        torch.backends.cudnn.benchmark = True  # as a server runs: autotuned

    _note("building small scene")
    mesh, curv = build_scene(device=dev)
    n_faces = mesh.num_faces
    cams_np = sample_cameras_np(n_views + K)
    kw = dict(tile=tile, chunk=chunk)
    batches = [camera_batch(cams_np, range(K + bi * K, K + (bi + 1) * K), res, dev)
               for bi in range(n_batches)]

    def annotate_batch(bi: int) -> torch.Tensor:
        """Batch bi's summed depth codes: one annotate_views call on the
        card, annotate_view per view through render_view on the CPU."""
        if on_card:
            return _depth_sum(annotate_views(batches[bi], mesh, curv, **kw))
        return sum(_depth_sum(annotate_view(_view(cams_np, i, res, dev), mesh, curv,
                                            use_pallas=False, cap=cap, **kw))
                   for i in range(K + bi * K, K + (bi + 1) * K))

    _note(f"warm-up call, small scene ({dev})")
    if on_card:
        int(_depth_sum(annotate_views(camera_batch(cams_np, range(K), res, dev),
                                      mesh, curv, **kw)))
    else:
        int(_depth_sum(annotate_view(_view(cams_np, 0, res, dev), mesh, curv,
                                     use_pallas=False, cap=cap, **kw)))

    def _timed_rep() -> float:
        t0 = time.perf_counter()
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for bi in range(n_batches):
            acc += annotate_batch(bi)
        _ = int(acc)  # host fetch: waits for every view's full computation
        return n_views / (time.perf_counter() - t0)

    reps = reps or (3 if on_card else 1)
    _note(f"timing small-scene batches ({reps} reps)")
    rates = [_timed_rep() for _ in range(reps)]
    vps = float(np.median(rates))
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    config = {"K": K, "tile": tile, "chunk": chunk, "n_batches": n_batches,
              "reps": len(rates)}
    if on_card:
        config.update({
            "card": card_name_and_power_limit(),
            "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_deterministic": torch.backends.cudnn.deterministic})
    result = {
        "metric": f"annotated viewpoints/sec (10 device modalities @{res}^2, "
                  f"{n_faces} tris, {kind})",
        "value": round(vps, 3),
        "unit": "viewpoints/s",
        "vs_baseline": round(vps / BASELINE_VIEWPOINTS_PER_SEC, 1),
        "value_min": round(min(rates), 3),
        "value_max": round(max(rates), 3),
        "config": config,
    }
    # flush the headline the moment it exists: if a later extra runs past
    # the caller's wall clock, this line is already on stdout
    print(json.dumps(result), flush=True)

    if not on_card or os.environ.get("BENCH_FAST"):
        return
    extra, skipped = {}, []
    # (name, fn, rough worst-case seconds)
    extras = [
        ("large_scene", lambda: bench_large_scene(device=dev), 420.0),
        ("full13", lambda: bench_full13(mesh, curv, batches, cams_np, K, res, kw),
         420.0),
        ("dpt", lambda: bench_dpt_inference(device=dev), 300.0),
        ("xl_scene", lambda: bench_large_scene(build=build_xl_scene, prefix="xl",
                                               device=dev), 420.0),
    ]
    if os.environ.get("BENCH_TRAIN"):
        extras.append(("train", lambda: bench_train_step(device=dev), 600.0))
    for name, fn, est in extras:
        if _remaining() < est:
            _note(f"skipping extra {name}: {_remaining():.0f}s left < {est:.0f}s budget")
            skipped.append(name)
            continue
        try:
            _note(f"extra: {name}")
            extra.update(fn())
        except Exception as e:  # an extra must never cost the headline
            import traceback

            traceback.print_exc()
            extra[f"{name}_error"] = repr(e)[:200]
    if skipped:
        extra["skipped"] = skipped
    extra["device10_vs_baseline"] = result["vs_baseline"]
    if "full13_vps" in extra:  # all 13 modalities against the reference's demo rate
        result["vs_baseline"] = round(extra["full13_vps"] / BASELINE_VIEWPOINTS_PER_SEC, 1)
    result["extra"] = extra
    print(json.dumps(result), flush=True)
    errors = [k for k in extra if k.endswith("_error")]
    if errors:
        raise SystemExit(f"bench: extras failed: {errors}")


def bench_large_scene(n_batches: int = 2, build=None, prefix: str = "large",
                      device: torch.device | str = "cuda", reps: int = 3) -> dict:
    """Replica-scale throughput on kernel C (the pack chunk-major, streamed
    from HBM; compacting body): ``annotate_views`` at K = LARGE_K, tile
    LARGE_TILE, ccap LARGE_CCAP, streamed=True, on n_batches batches of
    cameras from seed 3 after a warm batch (median of reps). prefix='xl'
    with build=build_xl_scene runs the same launch on the 1,423,360-face
    scene.

    Besides bench.py's keys: the peak device memory of ``prepare_raster``
    alone (the admission and pack of one batch) and of an ``annotate_views``
    call, kernel A's and C's launch counts over the warm call and the timed
    repetitions, and, for the last launch, the rows past kernel C's stage
    cap (``raster_kernels.STREAMED_STAGE_CAP``), the split rows and the work
    items."""
    from .annotator import DEVICE_MODALITIES, annotate_views
    from .annotator.pipeline import _gather_attrs
    from .mesh import raster as raster_mod
    from .mesh import raster_kernels as rk

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    _note(f"building {prefix} scene")
    mesh, curv = (build or build_large_scene)(device=dev)
    K, tile, ccap, res, chunk = LARGE_K, LARGE_TILE, LARGE_CCAP, LARGE_RES, 128
    cams_np = sample_cameras_np(K * (n_batches + 1), seed=3)
    batches = [camera_batch(cams_np, range(K * b, K * (b + 1)), res, dev)
               for b in range(n_batches + 1)]
    kw = dict(tile=tile, chunk=chunk, ccap=ccap, streamed=True)
    stats = {}

    def peak_gib(fn):
        """Peak device memory of fn() above what was allocated before."""
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize(dev)
        return out, (torch.cuda.max_memory_allocated(dev) - base) / 2**30

    attrs, _ = _gather_attrs(mesh, curv, DEVICE_MODALITIES)
    if on_card:
        _, stats[f"{prefix}_prepare_raster_peak_gib"] = peak_gib(
            lambda: raster_mod.prepare_raster(batches[0], mesh, tile, chunk, attrs, ccap,
                                              compact=True, streamed=True))
    counters = {"kernel_c_launches": (rk.raster_tiles_streamed, "launches"),
                "kernel_c_count_launches": (rk.raster_tiles_streamed, "count_launches"),
                "kernel_a_launches": (rk.raster_tiles_chunklist, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    rk.raster_tiles_streamed.last_schedule = None
    _note(f"warm-up call, {prefix} scene")

    def warm():
        return int(_depth_sum(annotate_views(batches[0], mesh, curv, **kw)))

    if on_card:
        _, stats[f"{prefix}_peak_gib"] = peak_gib(warm)
    else:
        warm()

    def rep() -> float:
        t0 = time.perf_counter()
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for b in batches[1:]:
            acc += _depth_sum(annotate_views(b, mesh, curv, **kw))
        _ = int(acc)
        return n_batches * K / (time.perf_counter() - t0)

    rates = [rep() for _ in range(reps)]
    for key, (fn, attr) in counters.items():
        stats[f"{prefix}_{key}"] = getattr(fn, attr)
    sched = rk.raster_tiles_streamed.last_schedule
    if sched is not None:  # a launch on the card
        staged = sched.staged
        stats.update({
            f"{prefix}_rows": int(staged.numel()),
            f"{prefix}_rows_past_stage_cap": int((staged > rk.STREAMED_STAGE_CAP).sum()),
            f"{prefix}_max_staged": int(staged.max()),
            f"{prefix}_split_rows": int((sched.n_items > 1).sum()),
            f"{prefix}_work_items": int(sched.ends[-1])})
    _note(f"{prefix} scene: {mesh.num_faces} faces (padded {mesh.faces.shape[0]}); "
          + ", ".join(f"{k} {v if isinstance(v, int) else round(v, 3)}"
                      for k, v in stats.items()))
    return {
        f"{prefix}_scene_tris": int(mesh.num_faces),
        f"{prefix}_scene_faces_padded": int(mesh.faces.shape[0]),
        f"{prefix}_scene_vps": round(float(np.median(rates)), 2),
        f"{prefix}_scene_vps_min": round(min(rates), 2),
        f"{prefix}_scene_vps_max": round(max(rates), 2),
        **{k: round(v, 3) if isinstance(v, float) else v for k, v in stats.items()},
    }


def full13_settings(res: int):
    """The CLI settings full13 runs under: the CLI's defaults (depth range
    128 m, 2D blur sigma 3, bench.py's) at res, on the batched route."""
    from .annotator.settings import Settings

    return Settings(RESOLUTION=res, FORCE_BATCHED_PATH=1)


def _worker_pid() -> int:
    """Pool warm-up job: load the host cues' modules -> this worker's pid."""
    from .cues import keypoints3d, segmentation  # noqa: F401

    time.sleep(0.05)
    return os.getpid()


def warm_pool(pool) -> int:
    """Start every worker of the host-cue pool and load its cue modules
    (a spawned worker starts on a submit that finds none idle): rounds of
    one job a worker until each has answered -> the pool's workers."""
    from concurrent.futures import ProcessPoolExecutor

    n = pool._max_workers
    if not isinstance(pool, ProcessPoolExecutor):
        return n
    seen: set = set()
    while len(seen) < n:
        seen.update(f.result() for f in [pool.submit(_worker_pid) for _ in range(n)])
    return n


def bench_full13(mesh, curv, batches, cams_np, K, res, kw, n_batches: int = 3) -> dict:
    """Full 13-modality rate: the 10 device modalities + the 3 host cues
    (keypoints3d / segment_unsup2d / segment_unsup25d), through the CLI's
    batched pipeline for ``--task all`` (``annotator.cli.render_batches``:
    ``annotate_views``, the cues' device maps ``device_cue_maps``, one fetch
    thread copying into pinned host buffers on a side stream, so batch b's
    copy overlaps batch b+1's render and the pool's work on batch b-1) and
    its host-cue pool (``cli._host_cue_pool``: spawned processes with no
    card), each view's maps cut by ``cli.view_cue_maps``. Unlike the CLI it
    fetches only the labels the cues read (bench.py's) and writes no PNGs.

    The device pass is warmed once untimed, and the pool's workers are
    started and their cue modules loaded before the clock starts
    (``full13_pool_spawn_s``, its own key). Timed: n_batches of the
    headline's batches (batches[bi] renders cams_np rows K + bi K ..),
    from the first render to the last view's cues. Then, on a quiet host,
    one batch's fetch is timed alone (``full13_fetch_mbps``,
    ``full13_payload_mb_per_view``) and 3 of its views' host cues run
    serially in this process (``full13_cue_secs``; the pipelined medians
    ride along as ``full13_cue_secs_pipelined``); ``full13_host_cpus`` is
    the host's cores."""
    from .annotator import DEVICE_MODALITIES, annotate_views
    from .annotator.cli import (HOST_CUE_TASKS, _host_cue_pool, device_cue_maps,
                                device_prefixes, fetch_to_host, render_batches,
                                tree_map, view_cue_maps)

    dev = mesh.vertices.device
    settings = full13_settings(res)
    prefixes = device_prefixes(HOST_CUE_TASKS, DEVICE_MODALITIES, settings, dev)
    n_batches = min(n_batches, len(batches))

    def render(bis):
        return render_batches((batches[bi] for bi in bis), mesh, curv, kw,
                              FULL13_NEEDED, settings, prefixes)

    def cue_args(fetched, bi: int, vi: int):
        """View vi of batch bi: _host_cues' arguments."""
        labels, maps = fetched
        fov = float(cams_np[2][K + bi * K + vi])
        vm = view_cue_maps(maps, vi, {"field_of_view_rads": fov}, res)
        return ({t: labels[t][vi] for t in FULL13_NEEDED}, fov, res, vm["narf"],
                vm["seg2d_q"], vm["seg25d_q"])

    list(render([0]))  # warm the map programs' allocations
    with _host_cue_pool() as pool:
        ts = time.perf_counter()
        n_workers = warm_pool(pool)
        spawn_s = time.perf_counter() - ts
        t0 = time.perf_counter()
        futures = []
        for bi, fetched in enumerate(render(range(n_batches))):
            futures += [pool.submit(_host_cues, *cue_args(fetched, bi, vi))
                        for vi in range(K)]
        cue_secs = [f.result() for f in futures]
        dt = time.perf_counter() - t0
    K_total = n_batches * K

    # the quiet pass: one batch's fetch alone, as render_batches makes it
    out = annotate_views(batches[0], mesh, curv, **kw)
    tree = ({t: out[t] for t in FULL13_NEEDED},
            device_cue_maps(out, batches[0].fov, settings, prefixes))
    side = ready = None
    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        ready = torch.cuda.Event()
        ready.record()
        torch.cuda.synchronize(dev)  # the pass is done before the fetch is timed
    tf0 = time.perf_counter()
    f = fetch_to_host(tree, ready, side)
    fetch_s = time.perf_counter() - tf0
    nbytes = []
    tree_map(lambda a: nbytes.append(a.nbytes), f)
    payload_mb = sum(nbytes) / 1e6
    quiet = [_host_cues(*cue_args(f, 0, vi)) for vi in range(min(3, K))]
    med = {k: float(np.median([c[k] for c in quiet])) for k in quiet[0]}
    med_pipelined = {k: float(np.median([c[k] for c in cue_secs])) for k in cue_secs[0]}
    return {"full13_vps": round(K_total / dt, 2),
            "full13_views": K_total,
            "full13_pool_workers": n_workers,
            "full13_pool_spawn_s": round(spawn_s, 2),
            "full13_host_cpus": os.cpu_count() or 1,
            "full13_cue_secs": {k: round(v, 3) for k, v in med.items()},
            "full13_cue_secs_pipelined": {k: round(v, 3) for k, v in med_pipelined.items()},
            "full13_fetch_mbps": round(payload_mb / fetch_s, 1),
            "full13_payload_mb_per_view": round(payload_mb / K, 2)}


def _host_cues(arrs, fov, res, border_maps=None, seg2d_q=None, seg25d_q=None):
    """The 3 host-side cues for one view (module-level: picklable for the
    full13 process pool) -> per-cue wall seconds. seg2d_q / seg25d_q: the
    device-computed quantized input maps (cues/seg_device.py); the
    segmentation cues then skip their host gaussians."""
    from .cues.keypoints3d import keypoints3d_from_depth_code
    from .cues.segmentation import segment_2d, segment_25d

    t0 = time.perf_counter()
    keypoints3d_from_depth_code(
        arrs["depth_zbuffer"], fov, res, support_size=0.3,
        max_meters=DEPTH_MAX_METERS, border_maps=border_maps)
    t1 = time.perf_counter()
    blurred = None
    if seg2d_q is not None:
        from .cues.seg_device import seg2d_blurred_from_maps

        blurred = seg2d_blurred_from_maps(seg2d_q)
    segment_2d(arrs["rgb"], scale=500.0, blur=3.0, cut_thresh=0.005,
               self_edge_weight=2.0, blurred255=blurred)
    t2 = time.perf_counter()
    input_img = None
    if seg25d_q is not None:
        from .cues.seg_device import seg25d_input_from_maps

        input_img = seg25d_input_from_maps(seg25d_q, 2.0, 1.0, 10.0)
    segment_25d(arrs.get("depth_zbuffer"), arrs.get("normal"),
                arrs.get("edge_occlusion"), input_img=input_img)
    return {"kp3d": t1 - t0, "seg2d": t2 - t1, "seg25d": time.perf_counter() - t2}


def bench_train_step(batch: int = 8, n_iters: int = 10,
                     device: torch.device | str = "cuda") -> dict:
    """Depth training step throughput (DPT-hybrid-384 forward + backward,
    the SSI loss stage, Adam through ``train.state.depth_optimizer(lr=1e-5)``,
    in-step augmentation on) at bs 8, 384², the reference's config
    (config/depth.yml). The batch is seeded with numpy; the step's draws
    come from one generator on the device, seeded. Opt-in via
    BENCH_TRAIN=1."""
    from .losses import VNLParams
    from .models import DPTHybrid
    from .models.registry import init_weights
    from .train import create_train_state, depth_optimizer, make_depth_train_step

    dev = torch.device(device)
    size = 384
    net = DPTHybrid(num_channels=1)
    init_weights(net, torch.Generator().manual_seed(0))
    state = create_train_state(net.to(dev), depth_optimizer(lr=1e-5))
    step_fn = make_depth_train_step(lambda m, x: m(x)[:, 0],
                                    VNLParams(1.0, 1.0, (size, size)),
                                    augment=True, image_size=size)
    rng = np.random.RandomState(0)
    batch_data = {
        "rgb": torch.as_tensor(rng.rand(batch, 3, size, size), dtype=torch.float32).to(dev),
        "depth": torch.as_tensor(rng.rand(batch, 1, size, size), dtype=torch.float32).to(dev),
        "mask_valid": torch.as_tensor(rng.rand(batch, 1, size, size) > 0.1).to(dev),
    }
    gen = torch.Generator(device=dev).manual_seed(1)
    float(step_fn(state, batch_data, gen)["loss"])  # warm (and cuDNN's autotuning)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        m = step_fn(state, batch_data, gen)
    _ = float(m["loss"])  # waits for the whole chain
    sec = time.perf_counter() - t0
    return {"train_depth_img_per_s": round(batch * n_iters / sec, 1),
            "train_depth_ms_per_step": round(sec / n_iters * 1000, 1)}


def peak_name(dtype: str) -> str:
    """The ``PEAK_FLOPS`` entry a share of peak for dtype is taken against:
    float32 runs on TF32's tensor cores while either TF32 flag is on (cuDNN's
    is by default)."""
    if dtype == "float32" and (torch.backends.cudnn.allow_tf32
                               or torch.backends.cuda.matmul.allow_tf32):
        return "tfloat32"
    return dtype


def bench_dpt_inference(batch: int = 8, n_iters: int = 20,
                        device: torch.device | str = "cuda") -> dict:
    """DPT-hybrid-384 (``models.registry.dpt_hybrid_384``, seeded weights)
    inference img/s, float32 and bfloat16 at batch 8, chain-timed with a
    final scalar fetch (the headline's accounting); FLOPs counted from the
    layer shapes (``utils.flops.model_flops``) and their share of the
    card's dense peak for the arithmetic in force (``utils.flops.PEAK_FLOPS``,
    named in ``dpt384_{dtype}_peak``: float32 against TF32's tensor-core
    peak while a TF32 flag is on, as cuDNN's is by default, else against
    FP32's). Then the bf16 batch sweep at 16 and 32 while the deadline
    allows."""
    from .models.registry import dpt_hybrid_384
    from .utils.flops import PEAK_FLOPS, model_flops

    dev = torch.device(device)

    def images(b):
        return torch.as_tensor(np.random.RandomState(0).rand(b, 3, 384, 384),
                               dtype=torch.float32).to(dev)

    def chain_s(mb, x) -> float:
        with torch.no_grad():
            float(mb(x).sum())  # warm (and cuDNN's autotuning)
            t0 = time.perf_counter()
            acc = torch.zeros((), device=dev)
            for _ in range(n_iters):
                acc += mb(x).sum()
            _ = float(acc)
        return time.perf_counter() - t0

    x = images(batch)
    out = {"dpt384_device_kind": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu"}
    for dt in ("float32", "bfloat16"):
        mb = dpt_hybrid_384(num_channels=1, dtype=dt, device=dev)
        flops = model_flops(mb, x) * batch  # one call
        sec = chain_s(mb, x)
        tflops = flops * n_iters / sec / 1e12
        out[f"dpt384_{dt}_img_per_s"] = round(batch * n_iters / sec, 1)
        out[f"dpt384_{dt}_tflops"] = round(tflops, 1)
        out[f"dpt384_{dt}_peak"] = peak_name(dt)
        out[f"dpt384_{dt}_mfu"] = round(tflops * 1e12 / PEAK_FLOPS[peak_name(dt)], 3)
    # the bf16 batch sweep: mb still holds the bfloat16 build
    for b in (16, 32):
        if _remaining() < 180.0:
            break
        try:
            out[f"dpt384_bf16_b{b}_img_per_s"] = round(
                b * n_iters / chain_s(mb, images(b)), 1)
        except torch.cuda.OutOfMemoryError as e:
            out[f"dpt384_bf16_b{b}_error"] = repr(e)[:120]
            break
    return out


if __name__ == "__main__":
    main()
