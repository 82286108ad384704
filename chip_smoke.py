#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

The main path is the device annotator: ``annotate_views`` on the
benchmark scene (39,760 faces, random vertex colours and baked curvature
colours, from a seed), K = 32 views per call at 512², tile 32, chunk 128,
every device modality. Phases, each of which fails the run on error:

1. set-up: the card's name and power limit; float32 matmuls and
   convolutions without TF32; build the CUDA kernels from csrc/ with nvcc.
2. kernel against plain version: the raster kernel and its plain PyTorch
   version on the same 2 views at the main path's tile shapes must agree
   bit for bit on ``packed`` and ``acc``.
3. main path: ``annotate_views`` at K = 32 must launch the raster kernel
   (launch counter reset just before, read just after) and return every
   label with its shape and dtype, each view with valid pixels.
4. pipeline on kernel against plain: the same 2 views through the whole
   pipeline, once on the kernel and once on the plain raster, must give
   equal labels.
5. timing with CUDA events: viewpoints/s over 4 batches of K = 32 (median
   of 5 repetitions); the render stage and the kernel alone at K = 32;
   kernel against plain version at K = 2, in turns.

Prints the kernel table as one JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when no CUDA device is present.

Run: ``python3 chip_smoke.py`` from the repository root.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

K_MAIN = 32
K_CHECK = 2
RES = 512
TILE = 32
CHUNK = 128
N_TIMED_BATCHES = 4
TIMED_REPS = 5

EXPECTED = {  # modality -> (trailing shape, dtype name)
    "depth_zbuffer": ((), "uint16"),
    "depth_euclidean": ((), "uint16"),
    "mask_valid": ((), "uint8"),
    "normal": ((3,), "uint8"),
    "reshading": ((), "uint8"),
    "rgb": ((3,), "uint8"),
    "principal_curvature": ((3,), "uint8"),
    "edge_occlusion": ((), "uint16"),
    "edge_texture": ((), "uint16"),
    "keypoints2d": ((), "uint16"),
    "fragments": ((), "int32"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over reps calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def plain_raster():
    """Route render_views_fused through the plain PyTorch raster, for the
    comparison of phase 4 only (the wrapper itself never does that on a
    CUDA tensor)."""
    from omnidata_tpu_torch.mesh import raster, raster_kernels

    saved = raster.raster_tiles_chunklist
    raster.raster_tiles_chunklist = raster_kernels.raster_tiles_chunklist_reference
    try:
        yield
    finally:
        raster.raster_tiles_chunklist = saved


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1

    from omnidata_tpu_torch import _build, scenes
    from omnidata_tpu_torch.annotator import DEVICE_MODALITIES, annotate_views
    from omnidata_tpu_torch.mesh import raster as raster_mod
    from omnidata_tpu_torch.mesh import raster_kernels as rk

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. set-up --------------------------------------------------------------
    card = gpu_name_and_power_limit()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # same conv algorithm per shape
    t0 = time.perf_counter()
    _build.load_kernel_library("raster_chunklist")
    log(f"built raster_chunklist in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log_path("raster_chunklist").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    t0 = time.perf_counter()
    mesh, curv = scenes.build_scene(seed=0, device=dev)
    cams_np = scenes.sample_cameras_np((N_TIMED_BATCHES + 1) * K_MAIN, seed=1)
    log(f"scene: {mesh.num_faces} faces (padded {mesh.faces.shape[0]}), "
        f"{mesh.num_vertices} vertices, built in {time.perf_counter() - t0:.1f} s")

    def batch(i0, k):
        return scenes.camera_batch(cams_np, range(i0, i0 + k), RES, device=dev)

    # 2. kernel against plain version, 2 views ------------------------------
    from omnidata_tpu_torch.annotator.pipeline import _gather_attrs

    vattrs, _ = _gather_attrs(mesh, curv, DEVICE_MODALITIES)
    inp2 = raster_mod.prepare_raster(batch(0, K_CHECK), mesh, TILE, CHUNK, vattrs)
    args2 = (inp2.ids, inp2.counts, inp2.origins, inp2.pack, inp2.dir_planes)
    kw = dict(chunk=CHUNK, tiles_per_view=inp2.tiles_per_view)
    c = inp2.counts
    log(f"admission ({K_CHECK} views): {int((c >= 0).sum())} exact, "
        f"{int((c == -1).sum())} scan-all, {int((c <= -2).sum())} block rows; "
        f"mean listed chunks {float(c.clamp(min=0).float().mean()):.2f}, "
        f"max {int(c.max())}; pack {tuple(inp2.pack.shape)}")
    k_packed, k_acc = rk.raster_tiles_chunklist(*args2, **kw)
    torch.cuda.synchronize()
    p_packed, p_acc = rk.raster_tiles_chunklist_reference(*args2, **kw)
    torch.cuda.synchronize()
    n_bad_packed = int((k_packed != p_packed).sum())
    max_abs_err = float((k_acc - p_acc).abs().max())
    acc_equal = torch.equal(k_acc.view(torch.int32), p_acc.view(torch.int32))
    log(f"kernel vs plain ({K_CHECK} views, {tuple(k_acc.shape)} acc): "
        f"packed mismatches {n_bad_packed}, acc bitwise equal {acc_equal}, "
        f"max |acc diff| {max_abs_err}")
    if n_bad_packed or not acc_equal:
        raise AssertionError("raster kernel disagrees with its plain version")
    hit_frac = float((k_packed < rk.BIG_PACKED).float().mean())
    log(f"hit pixels {hit_frac:.4f}")

    # 3. main path, K = 32 ---------------------------------------------------
    cams_main = batch(0, K_MAIN)
    torch.cuda.reset_peak_memory_stats(dev)
    rk.raster_tiles_chunklist.launches = 0
    out = annotate_views(cams_main, mesh, curv, tile=TILE, chunk=CHUNK,
                         modalities=DEVICE_MODALITIES)
    torch.cuda.synchronize()
    launches = rk.raster_tiles_chunklist.launches
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"main path: annotate_views K={K_MAIN} at {RES}², raster kernel "
        f"launches {launches}")
    if launches < 1:
        raise AssertionError("the main path did not launch the raster kernel")
    if set(out) != set(EXPECTED):
        raise AssertionError(f"modalities {sorted(out)} != {sorted(EXPECTED)}")
    for name, (trail, dtype) in EXPECTED.items():
        a = out[name]
        want_shape = (K_MAIN, RES, RES, *trail)
        if tuple(a.shape) != want_shape or str(a.dtype) != f"torch.{dtype}":
            raise AssertionError(f"{name}: {tuple(a.shape)} {a.dtype}, "
                                 f"want {want_shape} {dtype}")
        if a.device != dev:
            raise AssertionError(f"{name} left the card: {a.device}")
    valid = out["mask_valid"] == 255
    per_view = valid.float().mean((1, 2))
    if not bool((per_view > 0).all()):
        raise AssertionError(f"views without valid pixels: {per_view.tolist()}")
    frags = out["fragments"]
    if bool((frags[valid] < 0).any()) or bool((frags[~valid] != -1).any()) \
            or int(frags.max()) >= mesh.num_faces:
        raise AssertionError("face ids disagree with mask_valid")
    log(f"labels ok: {len(out)} modalities; mean valid fraction "
        f"{float(per_view.mean()):.4f} (min {float(per_view.min()):.4f})")

    # 4. pipeline on kernel against plain, 2 views ---------------------------
    cams2 = batch(0, K_CHECK)
    got = annotate_views(cams2, mesh, curv, tile=TILE, chunk=CHUNK)
    with plain_raster():
        want = annotate_views(cams2, mesh, curv, tile=TILE, chunk=CHUNK)
    torch.cuda.synchronize()
    unequal = [k for k in want if not torch.equal(got[k], want[k])]
    log(f"pipeline kernel vs plain raster ({K_CHECK} views): "
        f"{len(want) - len(unequal)}/{len(want)} labels equal")
    if unequal:
        raise AssertionError(f"labels differ: {unequal}")

    # 5. timing --------------------------------------------------------------
    batches = [batch((b + 1) * K_MAIN, K_MAIN) for b in range(N_TIMED_BATCHES)]
    annotate_views(batches[0], mesh, curv, tile=TILE, chunk=CHUNK)  # warm-up
    it = iter(range(10**9))

    def run_annotate():
        annotate_views(batches[next(it) % N_TIMED_BATCHES], mesh, curv,
                       tile=TILE, chunk=CHUNK)

    def run_render():
        raster_mod.render_views_fused(batches[next(it) % N_TIMED_BATCHES], mesh,
                                      TILE, CHUNK, vattrs)

    reps = sorted(cuda_ms(run_annotate, N_TIMED_BATCHES) for _ in range(TIMED_REPS))
    ms_annotate = statistics.median(reps)
    vps = K_MAIN / (ms_annotate / 1e3)
    ms_render = cuda_ms(run_render, N_TIMED_BATCHES)
    inp32 = raster_mod.prepare_raster(batches[0], mesh, TILE, CHUNK, vattrs)
    args32 = (inp32.ids, inp32.counts, inp32.origins, inp32.pack, inp32.dir_planes)
    kw32 = dict(chunk=CHUNK, tiles_per_view=inp32.tiles_per_view)
    ms_kernel32 = cuda_ms(lambda: rk.raster_tiles_chunklist(*args32, **kw32), 10)
    rk.raster_tiles_chunklist_reference(*args2, **kw)  # re-warm its allocations
    # in turns on one card: plain, kernel, kernel, plain
    ms_plain2 = [cuda_ms(lambda: rk.raster_tiles_chunklist_reference(*args2, **kw), 3)]
    ms_kernel2 = [cuda_ms(lambda: rk.raster_tiles_chunklist(*args2, **kw), 20)
                  for _ in range(2)]
    ms_plain2.append(cuda_ms(lambda: rk.raster_tiles_chunklist_reference(*args2, **kw), 3))
    log(f"annotate_views K={K_MAIN}: median {ms_annotate:.3f} ms/batch = "
        f"{vps:.2f} viewpoints/s; {TIMED_REPS} reps of {N_TIMED_BATCHES} "
        f"batches: {', '.join(f'{K_MAIN / r * 1e3:.2f}' for r in reps)} vps; "
        f"peak device memory {peak_gib:.2f} GiB; card {card}")
    log(f"render_views_fused K={K_MAIN}: {ms_render:.3f} ms; raster kernel "
        f"alone K={K_MAIN}: {ms_kernel32:.3f} ms; cue stack ~"
        f"{ms_annotate - ms_render:.3f} ms; admission+rays+pack+decode ~"
        f"{ms_render - ms_kernel32:.3f} ms")
    log(f"raster K={K_CHECK} (plain, kernel, kernel, plain): "
        f"{ms_plain2[0]:.3f}, {ms_kernel2[0]:.3f}, {ms_kernel2[1]:.3f}, "
        f"{ms_plain2[1]:.3f} ms")

    kernels = {"kernels": [{
        "name": "raster_chunklist",
        "route": "cuda",
        "source": "omnidata_tpu_torch/csrc/raster_chunklist.cu",
        "replaces": "omnidata_tpu/mesh/pallas_raster.py:343",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": statistics.mean(ms_kernel2),
        "plain_ms": statistics.mean(ms_plain2),
        "shape": f"K={K_CHECK} views, rows={inp2.ids.shape[0]}, P={TILE * TILE}, "
                 f"COLS={inp2.pack.shape[0]}, Fp={inp2.pack.shape[1]}",
        "ms_main_path_k32": ms_kernel32,
    }]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
