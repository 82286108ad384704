#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Two main paths of the device annotator, ``annotate_views`` with every device
modality at 512², tile 32, chunk 128, K = 32 views per call:
- the bench scene (39,760 faces, random vertex colours and baked curvature
  colours, from a seed) on kernel A, the chunk-list raster kernel;
- the large scene (584,704 faces, ``bench.py``'s Replica-scale scan) with
  ``ccap=192, streamed=True``, on kernel C's compacting body, cameras
  ``sample_cameras_np(seed=3)`` as ``bench.py`` draws them.
Phases, each of which fails the run on error:

1. set-up: the card's name and power limit; float32 matmuls and
   convolutions without TF32; build the CUDA kernels from csrc/ with nvcc,
   one process per source, all started together.
2. kernel A against its plain version on 2 bench views at the main path's
   tile shapes: bit for bit on ``packed`` and ``acc``.
3. bench main path: ``annotate_views`` at K = 32 must launch kernel A
   (launch counter reset just before, read just after) and return every
   label with its shape and dtype, each view with valid pixels.
4. pipeline on kernel against plain: the same 2 views through the whole
   pipeline, once on the kernels and once on the plain rasters, must give
   equal labels.
5. bench timing with CUDA events: viewpoints/s over 4 batches of K = 32
   (median of 5 repetitions); the render stage and kernel A alone at
   K = 32; kernel A against its plain version at K = 2, in turns.
6. kernel B (compacting) on 2 bench views: bit for bit against its plain
   version at stage cap 512 and at 64 (rows forced to the raw-list
   fallback); ``render_views_fused(compact=True)`` bit for bit against
   kernel A's render (valid, face, t, z, bary, attributes), its B launches
   counted.
7. kernel C on 2 large-scene views: the plain body and the compacting body
   bit for bit against their plain versions; both renders bit for bit
   against kernel A's render of the same views; the pipeline on kernel C
   against the plain raster on 1 view.
8. large main path: ``annotate_views(K=32, ccap=192, streamed=True)`` must
   launch kernel C and return every label, face ids agreeing with
   ``mask_valid``; peak device memory.
9. large timing with CUDA events: viewpoints/s over 2 batches of K = 32
   (median of 5 repetitions); at K = 32 kernels A, C plain and C compacting
   alone, the render stage and ``prepare_raster`` (admission and decode by
   difference); the staged-faces tail; kernel B against A alone on the
   bench scene at K = 32; B at K = 2 and C at K = 1 against their plain
   versions, in turns.

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
LARGE_CCAP = 192  # bench.py's large-scene call
LARGE_BATCHES = 2

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
KERNEL_SOURCES = ("raster_chunklist", "raster_compact")


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


def in_turns(plain, kernel, plain_reps: int, kernel_reps: int):
    """Plain, kernel, kernel, plain on one card -> (plain ms x2, kernel ms
    x2)."""
    plain()  # warm its allocations
    p = [cuda_ms(plain, plain_reps)]
    k = [cuda_ms(kernel, kernel_reps) for _ in range(2)]
    p.append(cuda_ms(plain, plain_reps))
    return p, k


def same_bits(a, b) -> bool:
    import torch

    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def check_kernel(what: str, got, want) -> float:
    """packed equal and acc equal bit for bit -> max |acc diff|."""
    (k_packed, k_acc), (p_packed, p_acc) = got, want
    n_bad = int((k_packed != p_packed).sum())
    err = float((k_acc - p_acc).abs().max())
    equal = same_bits(k_acc, p_acc)
    log(f"{what}: packed mismatches {n_bad}, acc bitwise equal {equal}, "
        f"max |acc diff| {err}")
    if n_bad or not equal:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return err


def check_renders(what: str, got, want) -> None:
    """(Fragments, attrs) equal bit for bit, field by field."""
    (gf, ga), (wf, wa) = got, want
    names = [*gf._fields, "attrs"]
    bad = [n for n, g, w in zip(names, (*gf, ga), (*wf, wa)) if not same_bits(g, w)]
    log(f"{what}: {len(names) - len(bad)}/{len(names)} fields bitwise equal")
    if bad:
        raise AssertionError(f"{what}: fields differ: {bad}")


def check_labels(out, k: int, n_faces: int, dev) -> None:
    """Every label with its shape, dtype and device; each view with valid
    pixels; face ids agreeing with mask_valid."""
    if set(out) != set(EXPECTED):
        raise AssertionError(f"modalities {sorted(out)} != {sorted(EXPECTED)}")
    for name, (trail, dtype) in EXPECTED.items():
        a = out[name]
        want_shape = (k, RES, RES, *trail)
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
            or int(frags.max()) >= n_faces:
        raise AssertionError("face ids disagree with mask_valid")
    log(f"labels ok: {len(out)} modalities; mean valid fraction "
        f"{float(per_view.mean()):.4f} (min {float(per_view.min()):.4f})")


def admission_log(what: str, inp) -> None:
    c = inp.counts
    n_chunks = inp.pack.shape[0] if inp.pack.dim() == 3 else inp.pack.shape[1] // CHUNK
    trip = (c.clamp(min=0) + (c == -1) * n_chunks + (c < -1) * (-c - 2) * 8).float()
    log(f"admission {what}: {int((c >= 0).sum())} exact, {int((c == -1).sum())} "
        f"scan-all, {int((c <= -2).sum())} block rows; trips mean "
        f"{float(trip.mean()):.2f}, p99 {float(trip.quantile(0.99)):.0f}, max "
        f"{int(trip.max())}, sum {int(trip.sum())}")


@contextlib.contextmanager
def plain_raster():
    """Route render_views_fused through the plain PyTorch rasters (A, B and
    C), for the comparisons of phases 4 and 7 only (the wrappers themselves
    never do that on a CUDA tensor)."""
    from omnidata_tpu_torch.mesh import raster, raster_kernels

    names = ("raster_tiles_chunklist", "raster_tiles_compact",
             "raster_tiles_streamed")
    saved = {n: getattr(raster, n) for n in names}
    for n in names:
        setattr(raster, n, getattr(raster_kernels, f"{n}_reference"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(raster, n, fn)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1

    from omnidata_tpu_torch import _build, scenes
    from omnidata_tpu_torch.annotator import DEVICE_MODALITIES, annotate_views
    from omnidata_tpu_torch.annotator.pipeline import _gather_attrs
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
    _build.build_kernel_libraries(KERNEL_SOURCES)
    s_build = time.perf_counter() - t0
    log(f"built {', '.join(KERNEL_SOURCES)} in {s_build:.1f} s (in parallel)")
    for name in KERNEL_SOURCES:
        for line in _build.build_log_path(name).read_text().splitlines():
            if "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                log(f"ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    mesh, curv = scenes.build_scene(seed=0, device=dev)
    s_scene = time.perf_counter() - t0
    cams_np = scenes.sample_cameras_np((N_TIMED_BATCHES + 1) * K_MAIN, seed=1)
    log(f"scene: {mesh.num_faces} faces (padded {mesh.faces.shape[0]}), "
        f"{mesh.num_vertices} vertices, built in {s_scene:.1f} s")

    def batch(i0, k, cams=cams_np):
        return scenes.camera_batch(cams, range(i0, i0 + k), RES, device=dev)

    # 2. kernel A against plain version, 2 views ----------------------------
    vattrs, _ = _gather_attrs(mesh, curv, DEVICE_MODALITIES)
    inp2 = raster_mod.prepare_raster(batch(0, K_CHECK), mesh, TILE, CHUNK, vattrs)
    args2 = (inp2.ids, inp2.counts, inp2.origins, inp2.pack, inp2.dir_planes)
    kw = dict(chunk=CHUNK, tiles_per_view=inp2.tiles_per_view)
    admission_log(f"bench ({K_CHECK} views, pack {tuple(inp2.pack.shape)})", inp2)
    err_a = check_kernel(
        f"kernel A vs plain ({K_CHECK} views)",
        rk.raster_tiles_chunklist(*args2, **kw),
        rk.raster_tiles_chunklist_reference(*args2, **kw))

    # 3. bench main path, K = 32 ---------------------------------------------
    cams_main = batch(0, K_MAIN)
    torch.cuda.reset_peak_memory_stats(dev)
    rk.raster_tiles_chunklist.launches = 0
    out = annotate_views(cams_main, mesh, curv, tile=TILE, chunk=CHUNK,
                         modalities=DEVICE_MODALITIES)
    torch.cuda.synchronize()
    launches_a = rk.raster_tiles_chunklist.launches
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"bench main path: annotate_views K={K_MAIN} at {RES}², kernel A "
        f"launches {launches_a}")
    if launches_a < 1:
        raise AssertionError("the bench main path did not launch kernel A")
    check_labels(out, K_MAIN, mesh.num_faces, dev)
    del out

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

    # 5. bench timing ---------------------------------------------------------
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
    inp32 = raster_mod.prepare_raster(batches[0], mesh, TILE, CHUNK, vattrs,
                                      compact=True)
    args32 = (inp32.ids, inp32.counts, inp32.origins, inp32.pack)
    kw32 = dict(chunk=CHUNK, tiles_per_view=inp32.tiles_per_view)
    ms_kernel32 = cuda_ms(lambda: rk.raster_tiles_chunklist(
        *args32, inp32.dir_planes, **kw32), 10)
    ms_plain2, ms_kernel2 = in_turns(
        lambda: rk.raster_tiles_chunklist_reference(*args2, **kw),
        lambda: rk.raster_tiles_chunklist(*args2, **kw), 3, 20)
    log(f"annotate_views K={K_MAIN}: median {ms_annotate:.3f} ms/batch = "
        f"{vps:.2f} viewpoints/s; {TIMED_REPS} reps of {N_TIMED_BATCHES} "
        f"batches: {', '.join(f'{K_MAIN / r * 1e3:.2f}' for r in reps)} vps; "
        f"peak device memory {peak_gib:.2f} GiB; card {card}")
    log(f"render_views_fused K={K_MAIN}: {ms_render:.3f} ms; kernel A "
        f"alone K={K_MAIN}: {ms_kernel32:.3f} ms; cue stack ~"
        f"{ms_annotate - ms_render:.3f} ms; admission+rays+pack+decode ~"
        f"{ms_render - ms_kernel32:.3f} ms")
    log(f"kernel A K={K_CHECK} (plain, kernel, kernel, plain): "
        f"{ms_plain2[0]:.3f}, {ms_kernel2[0]:.3f}, {ms_kernel2[1]:.3f}, "
        f"{ms_plain2[1]:.3f} ms")

    # 6. kernel B on the bench scene -----------------------------------------
    inp2c = raster_mod.prepare_raster(cams2, mesh, TILE, CHUNK, vattrs,
                                      compact=True)
    args2c = (*args2[:4], inp2c.bbox_words, inp2.dir_planes)
    err_b = 0.0
    for cap in (rk.STAGE_CAP, 64):
        staged, _ = rk.stage_faces(inp2.ids, inp2.counts, inp2c.bbox_words,
                                   inp2.pack.shape[1] // CHUNK, CHUNK,
                                   inp2.tiles_per_view, TILE, cap)
        err_b = max(err_b, check_kernel(
            f"kernel B vs plain ({K_CHECK} views, stage cap {cap}; "
            f"{int((staged > cap).sum())} of {staged.numel()} rows fall back)",
            rk.raster_tiles_compact(*args2c, stage_cap=cap, **kw),
            rk.raster_tiles_compact_reference(*args2c, stage_cap=cap, **kw)))
    want_a = raster_mod.render_views_fused(cams2, mesh, TILE, CHUNK, vattrs)
    rk.raster_tiles_compact.launches = 0
    got_b = raster_mod.render_views_fused(cams2, mesh, TILE, CHUNK, vattrs,
                                          compact=True)
    torch.cuda.synchronize()
    launches_b = rk.raster_tiles_compact.launches
    if launches_b < 1:
        raise AssertionError("render_views_fused(compact=True) launched no B")
    check_renders(f"render compact=True vs kernel A's render ({K_CHECK} views; "
                  f"B launches {launches_b})", got_b, want_a)

    # 7. kernel C on the large scene -----------------------------------------
    t0 = time.perf_counter()
    lmesh, lcurv = scenes.build_large_scene(seed=0, device=dev)
    s_large_scene = time.perf_counter() - t0
    lcams = scenes.sample_cameras_np(K_MAIN * (LARGE_BATCHES + 1), seed=3)
    log(f"large scene: {lmesh.num_faces} faces (padded {lmesh.faces.shape[0]}, "
        f"{lmesh.faces.shape[0] // CHUNK} chunks), {lmesh.num_vertices} "
        f"vertices, built in {s_large_scene:.1f} s")
    lattrs, _ = _gather_attrs(lmesh, lcurv, DEVICE_MODALITIES)
    lkw = dict(ccap=LARGE_CCAP)
    lcams2 = batch(0, K_CHECK, lcams)
    linp2 = raster_mod.prepare_raster(lcams2, lmesh, TILE, CHUNK, lattrs,
                                      compact=True, streamed=True, **lkw)
    admission_log(f"large ({K_CHECK} views, pack {tuple(linp2.pack.shape)})", linp2)
    largs2 = (linp2.ids, linp2.counts, linp2.origins, linp2.pack, linp2.dir_planes)
    lkw2 = dict(chunk=CHUNK, tiles_per_view=linp2.tiles_per_view)
    err_c = {}
    for body, words in (("plain", None), ("compacting", linp2.bbox_words)):
        err_c[body] = check_kernel(
            f"kernel C {body} body vs plain ({K_CHECK} large views)",
            rk.raster_tiles_streamed(*largs2, bbox_words=words, **lkw2),
            rk.raster_tiles_streamed_reference(*largs2, bbox_words=words, **lkw2))
    want_a = raster_mod.render_views_fused(lcams2, lmesh, TILE, CHUNK, lattrs, **lkw)
    rk.raster_tiles_streamed.launches = 0
    got_c = raster_mod.render_views_fused(lcams2, lmesh, TILE, CHUNK, lattrs,
                                          streamed=True, compact=False, **lkw)
    torch.cuda.synchronize()
    launches_c_plain = rk.raster_tiles_streamed.launches
    check_renders(f"render streamed, plain body vs kernel A's render "
                  f"({K_CHECK} large views; C launches {launches_c_plain})",
                  got_c, want_a)
    check_renders(f"render streamed, compacting vs kernel A's render "
                  f"({K_CHECK} large views)",
                  raster_mod.render_views_fused(lcams2, lmesh, TILE, CHUNK, lattrs,
                                                streamed=True, **lkw), want_a)
    del got_c, want_a
    lcams1 = batch(0, 1, lcams)
    lkw_ann = dict(tile=TILE, chunk=CHUNK, streamed=True, **lkw)
    got = annotate_views(lcams1, lmesh, lcurv, **lkw_ann)
    with plain_raster():
        want = annotate_views(lcams1, lmesh, lcurv, **lkw_ann)
    unequal = [k for k in want if not torch.equal(got[k], want[k])]
    log(f"large pipeline kernel C vs plain raster (1 view): "
        f"{len(want) - len(unequal)}/{len(want)} labels equal")
    if unequal:
        raise AssertionError(f"labels differ: {unequal}")
    del got, want

    # 8. large main path, K = 32 ---------------------------------------------
    lcams_main = batch(0, K_MAIN, lcams)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rk.raster_tiles_streamed.launches = 0
    out = annotate_views(lcams_main, lmesh, lcurv, modalities=DEVICE_MODALITIES,
                         **lkw_ann)
    torch.cuda.synchronize()
    launches_c = rk.raster_tiles_streamed.launches
    lpeak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"large main path: annotate_views K={K_MAIN} at {RES}², ccap "
        f"{LARGE_CCAP}, streamed: kernel C launches {launches_c}; peak device "
        f"memory {lpeak_gib:.2f} GiB")
    if launches_c < 1:
        raise AssertionError("the large main path did not launch kernel C")
    check_labels(out, K_MAIN, lmesh.num_faces, dev)
    del out

    # 9. large timing ---------------------------------------------------------
    lbatches = [batch(K_MAIN * (b + 1), K_MAIN, lcams) for b in range(LARGE_BATCHES)]
    lit = iter(range(10**9))

    def run_large():
        annotate_views(lbatches[next(lit) % LARGE_BATCHES], lmesh, lcurv,
                       **lkw_ann)

    run_large()  # warm-up
    lreps = sorted(cuda_ms(run_large, LARGE_BATCHES) for _ in range(TIMED_REPS))
    lms = statistics.median(lreps)
    lvps = K_MAIN / (lms / 1e3)
    lb = lbatches[0]
    linpA = raster_mod.prepare_raster(lb, lmesh, TILE, CHUNK, lattrs, **lkw)
    linpC = raster_mod.prepare_raster(lb, lmesh, TILE, CHUNK, lattrs,
                                      compact=True, streamed=True, **lkw)
    admission_log(f"large timed batch ({K_MAIN} views)", linpC)
    n_lchunks = linpC.pack.shape[0]
    staged, _ = rk.stage_faces(linpC.ids, linpC.counts, linpC.bbox_words,
                               n_lchunks, CHUNK, linpC.tiles_per_view, TILE, 1)
    sf = staged.float()
    fb_rows = staged > rk.STREAMED_STAGE_CAP
    log(f"staged faces per row (timed batch): mean {float(sf.mean()):.1f}, p50 "
        f"{float(sf.quantile(0.5)):.0f}, p99 {float(sf.quantile(0.99)):.0f}, "
        f"max {int(sf.max())}; rows past {rk.STREAMED_STAGE_CAP}: "
        f"{int(fb_rows.sum())} of {staged.numel()}")
    kwA = dict(chunk=CHUNK, tiles_per_view=linpA.tiles_per_view)
    lA = (linpA.ids, linpA.counts, linpA.origins, linpA.pack, linpA.dir_planes)
    lC = (linpC.ids, linpC.counts, linpC.origins, linpC.pack, linpC.dir_planes)
    lms_a = cuda_ms(lambda: rk.raster_tiles_chunklist(*lA, **kwA), 3)
    lms_cp = cuda_ms(lambda: rk.raster_tiles_streamed(*lC, **kwA), 3)
    lms_cc = cuda_ms(lambda: rk.raster_tiles_streamed(
        *lC, bbox_words=linpC.bbox_words, **kwA), 3)
    lms_render = cuda_ms(lambda: raster_mod.render_views_fused(
        lb, lmesh, TILE, CHUNK, lattrs, streamed=True, **lkw), 3)
    lms_prep = cuda_ms(lambda: raster_mod.prepare_raster(
        lb, lmesh, TILE, CHUNK, lattrs, compact=True, streamed=True, **lkw), 3)
    log(f"large annotate_views K={K_MAIN}: median {lms:.3f} ms/batch = "
        f"{lvps:.2f} viewpoints/s; {TIMED_REPS} reps of {LARGE_BATCHES} "
        f"batches: {', '.join(f'{K_MAIN / r * 1e3:.2f}' for r in lreps)} vps; "
        f"card {card}")
    log(f"large K={K_MAIN} kernels alone: A {lms_a:.3f} ms, C plain "
        f"{lms_cp:.3f} ms, C compacting {lms_cc:.3f} ms; render_views_fused "
        f"{lms_render:.3f} ms; prepare_raster {lms_prep:.3f} ms; decode+untile ~"
        f"{lms_render - lms_prep - lms_cc:.3f} ms; cue stack ~"
        f"{lms - lms_render:.3f} ms")
    ms_b32 = cuda_ms(lambda: rk.raster_tiles_compact(
        *args32, inp32.bbox_words, inp32.dir_planes, **kw32), 10)
    ms_a32 = cuda_ms(lambda: rk.raster_tiles_chunklist(
        *args32, inp32.dir_planes, **kw32), 10)
    log(f"bench K={K_MAIN} kernels alone: B {ms_b32:.3f} ms, A {ms_a32:.3f} ms")
    ms_plain_b, ms_kernel_b = in_turns(
        lambda: rk.raster_tiles_compact_reference(*args2c, **kw),
        lambda: rk.raster_tiles_compact(*args2c, **kw), 3, 20)
    log(f"kernel B K={K_CHECK} (plain, kernel, kernel, plain): "
        f"{ms_plain_b[0]:.3f}, {ms_kernel_b[0]:.3f}, {ms_kernel_b[1]:.3f}, "
        f"{ms_plain_b[1]:.3f} ms")
    lsel = slice(0, linp2.tiles_per_view)  # K = 1: the first view's rows
    largs1 = (linp2.ids[lsel], linp2.counts[lsel], linp2.origins[:1],
              linp2.pack, tuple(d[lsel] for d in linp2.dir_planes))
    c_turns = {}
    for body, words in (("plain", None), ("compacting", linp2.bbox_words[:1])):
        c_turns[body] = in_turns(
            lambda w=words: rk.raster_tiles_streamed_reference(
                *largs1, bbox_words=w, **lkw2),
            lambda w=words: rk.raster_tiles_streamed(*largs1, bbox_words=w, **lkw2),
            2, 10)
        (p0, p1), (k0, k1) = c_turns[body]
        log(f"kernel C {body} body K=1 large (plain, kernel, kernel, plain): "
            f"{p0:.3f}, {k0:.3f}, {k1:.3f}, {p1:.3f} ms")

    src = "omnidata_tpu_torch/csrc/"
    replaces = "omnidata_tpu/mesh/pallas_raster.py:"
    kernels = {"kernels": [
        {"name": "raster_chunklist (A)", "route": "cuda",
         "source": src + "raster_chunklist.cu", "replaces": replaces + "343",
         "launches": launches_a, "launches_in": "bench main path annotate_views",
         "max_abs_err": err_a, "ms": statistics.mean(ms_kernel2),
         "plain_ms": statistics.mean(ms_plain2),
         "shape": f"bench K={K_CHECK}, rows={inp2.ids.shape[0]}, P={TILE * TILE}, "
                  f"COLS={inp2.pack.shape[0]}, Fp={inp2.pack.shape[1]}",
         "ms_bench_k32": ms_kernel32, "ms_large_k32": lms_a},
        {"name": "raster_compact (B)", "route": "cuda",
         "source": src + "raster_compact.cu", "replaces": replaces + "601",
         "launches": launches_b,
         "launches_in": "render_views_fused(compact=True), bench scene",
         "max_abs_err": err_b, "ms": statistics.mean(ms_kernel_b),
         "plain_ms": statistics.mean(ms_plain_b),
         "shape": f"bench K={K_CHECK}, stage_cap={rk.STAGE_CAP}",
         "ms_bench_k32": ms_b32},
        {"name": "raster_streamed (C, compacting body)", "route": "cuda",
         "source": src + "raster_compact.cu", "replaces": replaces + "879",
         "launches": launches_c, "launches_in": "large main path annotate_views",
         "max_abs_err": err_c["compacting"],
         "ms": statistics.mean(c_turns["compacting"][1]),
         "plain_ms": statistics.mean(c_turns["compacting"][0]),
         "shape": f"large K=1, rows={linp2.tiles_per_view}, P={TILE * TILE}, "
                  f"pack={tuple(linp2.pack.shape)}, "
                  f"stage_cap={rk.STREAMED_STAGE_CAP}",
         "ms_large_k32": lms_cc},
        {"name": "raster_streamed (C, plain body)", "route": "cuda",
         "source": src + "raster_compact.cu", "replaces": replaces + "879",
         "launches": launches_c_plain,
         "launches_in": "render_views_fused(streamed=True, compact=False), "
                        "large scene",
         "max_abs_err": err_c["plain"],
         "ms": statistics.mean(c_turns["plain"][1]),
         "plain_ms": statistics.mean(c_turns["plain"][0]),
         "shape": f"large K=1, rows={linp2.tiles_per_view}, P={TILE * TILE}, "
                  f"pack={tuple(linp2.pack.shape)}",
         "ms_large_k32": lms_cp},
    ], "large_vps": lvps, "bench_vps": vps, "peak_gib_large": lpeak_gib,
        "s_kernel_build": s_build, "s_large_scene_build": s_large_scene}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
