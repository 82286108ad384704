#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Two main paths of the device annotator, ``annotate_views`` with every device
modality at 512², tile 32, chunk 128, K = 32 views per call:
- the bench scene (39,760 faces, random vertex colours and baked curvature
  colours, from a seed) on kernel A, the chunk-list raster kernel;
- the large scene (584,704 faces, ``bench.py``'s Replica-scale scan) with
  ``ccap=192, streamed=True``, on kernel C's compacting body, cameras
  ``sample_cameras_np(seed=3)`` as ``bench.py`` draws them.
And the annotator CLI (``omnidata_tpu_torch.annotator.cli``), the entry
point users run, on the same two scenes written as ``mesh.ply``: on the
bench scene it picks kernel A, on the large scene kernel C (scene pack over
8 MB). Phases, each of which fails the run on error:

1. set-up: the card's name and power limit; float32 matmuls and
   convolutions without TF32; build the CUDA kernels from csrc/ with nvcc,
   one process per source, all started together.
2. kernel A against its plain version on 2 bench views at the main path's
   tile shapes: bit for bit on ``packed`` and ``acc``.
3. bench main path: ``annotate_views`` at K = 32 must launch kernel A
   (launch counter reset just before, read just after) and return every
   label with its shape and dtype, each view with valid pixels; the
   launch's work items and split rows are printed.
4. pipeline on kernel against plain: the same 2 views through the whole
   pipeline, once on the kernels and once on the plain rasters, must give
   equal labels.
5. bench timing with CUDA events: viewpoints/s over 4 batches of K = 32
   (median of 5 repetitions); the render stage and kernel A alone at
   K = 32; kernel A against its plain version at K = 2, in turns.
6. kernel B (compacting) on 2 bench views: bit for bit against its plain
   version at stage cap 512 and at 64 (rows forced to the raw-list
   fallback); ``render_views_fused(compact=True)`` bit for bit against
   kernel A's render (valid, face, t, z, bary, attributes), its B sweeps
   and count passes counted.
7. kernel C on 2 large-scene views: the plain body and the compacting body
   bit for bit against their plain versions; both renders bit for bit
   against kernel A's render of the same views; the pipeline on kernel C
   against the plain raster on 1 view.
7b. work items of one list position (``seg=1``, a test-only argument):
   kernel A and kernel B (stage caps 512 and 64) on the 2 bench views and
   kernel C's plain body, compacting body and compacting body at stage cap
   512 on the 2 large views, each bit for bit against its plain version,
   with every multi-chunk raw-list row split into one item per chunk and
   merged (split rows required wherever a multi-chunk row is past the
   cap, or for the plain sweeps); B's item lists equal to
   ``split_schedule``'s.
8. large main path: ``annotate_views(K=32, ccap=192, streamed=True)`` must
   launch kernel C and its count pass (both counters reset just before,
   read just after) and return every label, face ids agreeing with
   ``mask_valid``; peak device memory.
9. large timing with CUDA events: viewpoints/s over 2 batches of K = 32
   (median of 5 repetitions); at K = 32 kernels A, C plain and C compacting
   alone, the render stage and ``prepare_raster`` (admission and decode by
   difference); the staged-faces tail; kernel B against A alone on the
   bench scene at K = 32, and B on the batch's first 1, 2 and 8 views;
   ``render_views_fused`` on the bench batch with kernel A and with B
   (``compact=True``), admission included, in turns (A, B, B, A); B at K
   = 2 and C at K = 1 against their plain versions, in turns. Then each
   kernel at K = 32, at the main paths' shapes (A and B on the bench
   batch, C's bodies on the large batch at ccap 192, C compacting also at
   the CLI's ccap 48): bit for bit against
   its plain version on the same inputs (2 views at a time, timed), its
   item list built on the card equal to ``split_schedule``'s and (B, C
   compacting) the count pass's staged faces to ``stage_faces``'; beside
   its pixel-face pairs and
   bound (``tools/raster_measure.raster_work``: 20 FP32 operations for each
   pixel and each face whose bbox overlaps its tile, at 67 TFLOP/s, or
   half that with -fmad=false, against each input read and each output
   written once at 3.35 TB/s), its work items and split rows.

10. the port's brute-force raycaster against kernel A's render on 2 bench
    views at 512²: valid equal, faces equal on >= 99.9% of pixels; its
    ray-triangle tests per second.
11. CLI on the bench scene: ``main(["--model_path", d, "--task", "all",
    "with", "NUM_POINTS=4", "STOP_VIEW_NUMBER=3"])``; every task's outputs
    there and decoding, kernel A launched (count reset just before, read
    just after), the device PNGs equal to ``annotate_views`` on the plain
    rasters for the same views and batches. The plain rasters run 2 views
    at a time, which gives the whole batch's rows.
12. CLI on the large scene: ``--task points`` at the default settings
    (timed), then the 12 device tasks in one ``run_device_tasks`` call:
    kernel C launched and kernel A not; viewpoints/s with the PNG writes,
    and of the same batches rendered and fetched without them. Then the
    CLI batch with the most scan-all and block-mode rows at the CLI's own
    ``ccap``: kernel C bit for bit against its plain version on its 2
    hardest views, and the batch's written outputs equal to
    ``annotate_views`` on the plain rasters with the CLI's arguments; the
    check prints the launch's work items and split rows.
13. CLI ``--task pano`` at 2048x1024 on the bench scene for 2 camera
    locations, each panorama's render timed; outputs decode.
The CLI phases work in ``build/chip_smoke_cli/`` and log the CLI's own
output to ``build/chip_smoke_cli/cli.log``; a failing CLI call prints the
log's last lines to stderr.

Prints the kernel table as one JSON line (per kernel its K = 32 time,
plain version, bound and work items, its main-path launches; no PyTorch
call computes these kernels' function, so ``library_ms`` is null), the
card's name and power limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when no CUDA device is present.

Run: ``python3 chip_smoke.py`` from the repository root.
"""
from __future__ import annotations

import contextlib
import json
import shutil
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tools"))

from raster_measure import (  # noqa: E402
    cuda_ms,
    gpu_name_and_power_limit,
    item_counts,
    raster_work,
    timed,
)

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
HOST_LIBRARIES = ("narf", "felzenszwalb")  # the host cues' native cores
CLI_DIR = ROOT / "build" / "chip_smoke_cli"
CLI_LOG = CLI_DIR / "cli.log"
CLI_BENCH_ARGS = ["with", "NUM_POINTS=4", "STOP_VIEW_NUMBER=3"]
PANO_CAMERAS = 2
# image outputs of `--task all` per view (semantic needs face labels)
CLI_IMAGE_TASKS = ("rgb", "normal", "depth_zbuffer", "depth_euclidean",
                   "mask_valid", "reshading", "principal_curvature",
                   "edge_texture", "edge_occlusion", "keypoints2d",
                   "keypoints3d", "segment_unsup2d", "segment_unsup25d")


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


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


def check_schedule(what: str, wrapper, counts, n_chunks: int,
                   overlaps=None, stage_cap=None, seg=None) -> dict:
    """The item list a kernel A, B or C launch built on the card equal to
    the plain ``split_schedule`` on the same counts (at the launch's stage
    cap and segment, C's and ``SPLIT_SEG`` by default), bit for bit (order,
    ends, items per row), and for the compacting kernels the count pass's
    staged faces equal to ``overlaps`` (``stage_faces``' count with no
    cap). -> the launch's work items and split rows."""
    import torch

    from omnidata_tpu_torch.mesh import raster_kernels as rk

    sched = wrapper.last_schedule
    want = rk.split_schedule(counts, overlaps, n_chunks, seg or rk.SPLIT_SEG,
                             CHUNK, stage_cap or rk.STREAMED_STAGE_CAP)
    bad = [n for n in ("order", "ends", "n_items")
           if not torch.equal(getattr(sched, n), getattr(want, n))]
    if overlaps is not None and not torch.equal(sched.staged.long(),
                                                overlaps.long()):
        bad.append("staged")
    items = item_counts(sched)
    log(f"{what}: item list built on the card vs split_schedule: "
        f"{'equal' if not bad else f'differs in {bad}'}; {items['items']} "
        f"items, {items['split_rows']} rows split")
    if bad:
        raise AssertionError(f"{what}: the card's item list differs in {bad}")
    return items


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
    from omnidata_tpu_torch.mesh.raster_kernels import list_trips

    c = inp.counts
    n_chunks = inp.pack.shape[0] if inp.pack.dim() == 3 else inp.pack.shape[1] // CHUNK
    trip = list_trips(c, n_chunks).float()
    log(f"admission {what}: {int((c >= 0).sum())} exact, {int((c == -1).sum())} "
        f"scan-all, {int((c <= -2).sum())} block rows; trips mean "
        f"{float(trip.mean()):.2f}, p99 {float(trip.quantile(0.99)):.0f}, max "
        f"{int(trip.max())}, sum {int(trip.sum())}")


def by_views(plain):
    """A plain raster run over K_CHECK views at a time, rows concatenated:
    rows are independent, so the result is the whole batch's, and the
    plain versions' (rows, P, chunk) temporaries stay those of K_CHECK
    views."""
    import torch

    def run(ids, counts, origins, pack, *rest, tiles_per_view, **kw):
        def part(x, v, r):  # dir planes by row, bbox words by view
            return tuple(d[r] for d in x) if isinstance(x, (tuple, list)) else x[v]

        outs = []
        for v0 in range(0, origins.shape[0], K_CHECK):
            v = slice(v0, v0 + K_CHECK)
            r = slice(v0 * tiles_per_view, (v0 + K_CHECK) * tiles_per_view)
            outs.append(plain(
                ids[r], counts[r], origins[v], pack,
                *(part(x, v, r) for x in rest), tiles_per_view=tiles_per_view,
                **{k: x if x is None or k != "bbox_words" else x[v]
                   for k, x in kw.items()}))
        return tuple(torch.cat(o) for o in zip(*outs))

    return run


@contextlib.contextmanager
def plain_raster():
    """Route render_views_fused through the plain PyTorch rasters (A, B and
    C), K_CHECK views at a time, for the comparisons of phases 4, 7, 11 and
    12 only (the wrappers themselves never do that on a CUDA tensor)."""
    from omnidata_tpu_torch.mesh import raster, raster_kernels

    names = ("raster_tiles_chunklist", "raster_tiles_compact",
             "raster_tiles_streamed")
    saved = {n: getattr(raster, n) for n in names}
    for n in names:
        setattr(raster, n, by_views(getattr(raster_kernels, f"{n}_reference")))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(raster, n, fn)


def run_cli(fn, *args, **kwargs):
    """Call a CLI function with its own output appended to CLI_LOG; on a
    failure the log's last lines go to stderr."""
    CLI_LOG.parent.mkdir(parents=True, exist_ok=True)
    try:
        with open(CLI_LOG, "a") as fh, contextlib.redirect_stdout(fh):
            print(f"=== {fn.__name__} {args}", flush=True)
            return fn(*args, **kwargs)
    except Exception:
        print("\n".join(CLI_LOG.read_text().splitlines()[-40:]), file=sys.stderr)
        raise


def write_mesh_dir(d: Path, mesh) -> str:
    """A fresh model directory holding the mesh as mesh.ply (colours stored
    as uchar, as a scan's would be)."""
    from omnidata_tpu_torch.utils.convert_mesh import write_ply

    d.mkdir(parents=True)
    nf = mesh.num_faces
    write_ply(str(d / "mesh.ply"), mesh.vertices.cpu().numpy(),
              mesh.faces[:nf].cpu().numpy(), mesh.vertex_colors.cpu().numpy())
    return str(d)


def output_path(d: str, view: dict, task: str) -> str:
    ext = "npy" if task == "fragments" else "png"
    return (f"{d}/{task}/point_{view['point_uuid']}_view_{view['view_id']}"
            f"_domain_{task}.{ext}")


def load_output(path: str):
    import numpy as np

    from omnidata_tpu_torch.cues.encode import load_png

    return np.load(path) if path.endswith(".npy") else load_png(path)


def check_cli_outputs(d: str, views, tasks) -> int:
    """Every task's file for every view exists and decodes to a RES² image
    (fragments: a RES² int32 array) -> number of files."""
    for view in views:
        for t in tasks:
            a = load_output(output_path(d, view, t))
            if tuple(a.shape[:2]) != (RES, RES) or (
                    t == "fragments" and str(a.dtype) != "int32"):
                raise AssertionError(f"{t}: {a.shape} {a.dtype}")
    return len(views) * len(tasks)


def cli_batches(views, settings) -> list:
    """views in the CLI's batches of VIEWS_PER_DISPATCH."""
    K = settings.VIEWS_PER_DISPATCH
    return [views[s:s + K] for s in range(0, len(views), K)]


def render_batch(cli, views, mesh, curv, settings, mods, dev):
    """annotate_views on one CLI batch with the CLI's own arguments."""
    from omnidata_tpu_torch.annotator import annotate_views

    return annotate_views(cli.view_batch(views, settings.RESOLUTION, dev), mesh,
                          curv, **cli.annotate_kwargs(settings, mods))


def unequal_outputs(d: str, views, out) -> list:
    """(task, point, view) of every written output of views that differs
    from out, a {modality: (K, ...)} batch of the same views."""
    import numpy as np

    return [(t, view["point_uuid"], view["view_id"])
            for vi, view in enumerate(views) for t, a in out.items()
            if not np.array_equal(load_output(output_path(d, view, t)),
                                  a[vi].cpu().numpy())]


def check_cli_streamed(cli, d: str, batches, mesh, curv, settings, mods,
                       dev) -> dict:
    """The CLI's own kernel-C inputs (its default ccap) against the plain
    versions, on the CLI batch with the most scan-all, then block-mode,
    rows: kernel C's compacting body bit for bit on the batch's K_CHECK
    views with the most such rows, and every written output of the batch
    equal to annotate_views on the plain rasters with the CLI's arguments.
    -> what was checked."""
    import torch

    from omnidata_tpu_torch.annotator.pipeline import _gather_attrs
    from omnidata_tpu_torch.mesh import raster as raster_mod
    from omnidata_tpu_torch.mesh import raster_kernels as rk

    kw = cli.annotate_kwargs(settings, mods)
    attrs, _ = _gather_attrs(mesh, curv, mods)

    def admission(views):
        return raster_mod.prepare_raster(
            cli.view_batch(views, settings.RESOLUTION, dev), mesh, kw["tile"],
            kw["chunk"], attrs, compact=True, streamed=True)

    def hard_rows(counts):
        return int((counts == -1).sum()), int((counts <= -2).sum())

    rows_of = [hard_rows(admission(v).counts) for v in batches]
    b = max(range(len(batches)), key=lambda i: rows_of[i])
    views = batches[b]
    inp = admission(views)
    ccap = inp.ids.shape[1]
    admission_log(f"CLI batch {b} ({len(views)} views, ccap {ccap})", inp)
    if sum(rows_of[b]) == 0:
        raise AssertionError("no CLI batch has scan-all or block-mode rows")
    per_view = (inp.counts < 0).reshape(len(views), -1).sum(1)
    vsel = per_view.argsort(descending=True, stable=True)[:K_CHECK].sort().values
    rsel = (vsel[:, None] * inp.tiles_per_view
            + torch.arange(inp.tiles_per_view, device=dev)).reshape(-1)
    args = (inp.ids[rsel], inp.counts[rsel], inp.origins[vsel], inp.pack,
            tuple(p[rsel] for p in inp.dir_planes))
    ckw = dict(chunk=kw["chunk"], tiles_per_view=inp.tiles_per_view,
               bbox_words=inp.bbox_words[vsel])
    got = rk.raster_tiles_streamed(*args, **ckw)
    items = item_counts(rk.raster_tiles_streamed.last_schedule)
    err = check_kernel(
        f"kernel C compacting body vs plain (CLI views {vsel.tolist()} of "
        f"batch {b}, ccap {ccap}; scan-all, block rows {hard_rows(args[1])}; "
        f"{items['items']} work items, {items['split_rows']} rows split)",
        got, rk.raster_tiles_streamed_reference(*args, **ckw))
    del inp, args, ckw, got
    t0 = time.perf_counter()
    with plain_raster():
        want = render_batch(cli, views, mesh, curv, settings, mods, dev)
    unequal = unequal_outputs(d, views, want)
    log(f"CLI outputs of batch {b} vs annotate_views on the plain rasters "
        f"({len(views)} views x {len(want)} labels, "
        f"{time.perf_counter() - t0:.1f} s): {len(unequal)} unequal")
    if unequal:
        raise AssertionError(f"CLI outputs differ from the plain pipeline: "
                             f"{unequal[:8]}")
    return {"checked_batch": b, "checked_views": len(views),
            "checked_scan_all_rows": rows_of[b][0],
            "checked_block_rows": rows_of[b][1], "max_abs_err_kernel_c": err,
            "checked_items": items}


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
    _build.build_libraries(KERNEL_SOURCES, HOST_LIBRARIES)
    s_build = time.perf_counter() - t0
    log(f"built {', '.join(KERNEL_SOURCES + HOST_LIBRARIES)} in {s_build:.1f} s "
        "(in parallel)")
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
    items_a = item_counts(rk.raster_tiles_chunklist.last_schedule)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"bench main path: annotate_views K={K_MAIN} at {RES}², kernel A "
        f"launches {launches_a}, {items_a['items']} work items, "
        f"{items_a['split_rows']} rows split")
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
    want_a = raster_mod.render_views_fused(cams2, mesh, TILE, CHUNK, vattrs,
                                           streamed=False)
    rk.raster_tiles_compact.launches = 0
    rk.raster_tiles_compact.count_launches = 0
    got_b = raster_mod.render_views_fused(cams2, mesh, TILE, CHUNK, vattrs,
                                          compact=True)
    torch.cuda.synchronize()
    launches_b = rk.raster_tiles_compact.launches
    count_launches_b = rk.raster_tiles_compact.count_launches
    if launches_b < 1 or count_launches_b < 1:
        raise AssertionError("render_views_fused(compact=True) launched no B "
                             "sweep and count pass")
    check_renders(f"render compact=True vs kernel A's render ({K_CHECK} views; "
                  f"B launches {launches_b}, count passes {count_launches_b})",
                  got_b, want_a)

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
    want_a = raster_mod.render_views_fused(lcams2, lmesh, TILE, CHUNK, lattrs,
                                           streamed=False, **lkw)
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

    # 7b. work items of one list position: every multi-chunk row split --
    seg1 = {}
    for what, fn, plain, a_, kw_, must_split in (
            ("kernel A (bench)", rk.raster_tiles_chunklist,
             rk.raster_tiles_chunklist_reference, args2, kw, True),
            ("kernel C plain body (large)", rk.raster_tiles_streamed,
             rk.raster_tiles_streamed_reference, largs2, lkw2, True),
            ("kernel C compacting body (large)", rk.raster_tiles_streamed,
             rk.raster_tiles_streamed_reference, largs2,
             dict(lkw2, bbox_words=linp2.bbox_words), False),
            ("kernel C compacting body, stage cap 512 (large)",
             rk.raster_tiles_streamed, rk.raster_tiles_streamed_reference,
             largs2, dict(lkw2, bbox_words=linp2.bbox_words, stage_cap=512),
             True)):
        got = fn(*a_, seg=1, **kw_)
        seg1[what] = item_counts(fn.last_schedule)
        check_kernel(f"{what} at seg 1 vs plain ({K_CHECK} views; "
                     f"{seg1[what]['items']} items, {seg1[what]['split_rows']} "
                     f"rows split)", got, plain(*a_, **kw_))
        if must_split and not seg1[what]["split_rows"]:
            raise AssertionError(f"{what} at seg 1 split no row")
    n_bchunks2 = inp2.pack.shape[1] // CHUNK
    overlaps2, _ = rk.stage_faces(inp2.ids, inp2.counts, inp2c.bbox_words,
                                  n_bchunks2, CHUNK, inp2.tiles_per_view, TILE, 1)
    long_rows = rk.list_trips(inp2.counts, n_bchunks2) > 1
    for cap in (rk.STAGE_CAP, 64):
        what = f"kernel B, stage cap {cap} (bench)"
        got = rk.raster_tiles_compact(*args2c, stage_cap=cap, seg=1, **kw)
        seg1[what] = check_schedule(f"{what} at seg 1", rk.raster_tiles_compact,
                                    inp2.counts, n_bchunks2, overlaps2, cap, 1)
        check_kernel(f"{what} at seg 1 vs plain ({K_CHECK} views; "
                     f"{seg1[what]['items']} items, {seg1[what]['split_rows']} "
                     f"rows split)", got,
                     rk.raster_tiles_compact_reference(*args2c, stage_cap=cap, **kw))
        if bool(((overlaps2 > cap) & long_rows).any()) and not seg1[what]["split_rows"]:
            raise AssertionError(f"{what} at seg 1 split no row past the cap")
    del got
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
    rk.raster_tiles_streamed.count_launches = 0
    out = annotate_views(lcams_main, lmesh, lcurv, modalities=DEVICE_MODALITIES,
                         **lkw_ann)
    torch.cuda.synchronize()
    launches_c = rk.raster_tiles_streamed.launches
    count_launches_c = rk.raster_tiles_streamed.count_launches
    items_c = item_counts(rk.raster_tiles_streamed.last_schedule)
    lpeak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"large main path: annotate_views K={K_MAIN} at {RES}², ccap "
        f"{LARGE_CCAP}, streamed: kernel C launches {launches_c} (count pass "
        f"{count_launches_c}), {items_c['items']} work items, "
        f"{items_c['split_rows']} rows split; peak device memory "
        f"{lpeak_gib:.2f} GiB")
    if launches_c < 1 or count_launches_c < 1:
        raise AssertionError("the large main path did not launch kernel C "
                             "and its count pass")
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
    ms_b_small = {}
    for v in (1, 2, 8):  # B on the batch's first v views
        r = slice(0, v * inp32.tiles_per_view)
        b_args = (inp32.ids[r], inp32.counts[r], inp32.origins[:v], inp32.pack,
                  inp32.bbox_words[:v], tuple(d[r] for d in inp32.dir_planes))
        rk.raster_tiles_compact(*b_args, **kw32)
        ms_b_small[v] = cuda_ms(
            lambda a=b_args: rk.raster_tiles_compact(*a, **kw32), 20)

    def render_bench(compact):
        return lambda: raster_mod.render_views_fused(
            batches[0], mesh, TILE, CHUNK, vattrs, streamed=False, compact=compact)

    render_bench(True)()
    ms_render_ab = [cuda_ms(render_bench(c), 5) for c in (False, True, True, False)]
    log(f"kernel B bench K=1, 2, 8: {', '.join(f'{t:.3f}' for t in ms_b_small.values())} "
        f"ms; render_views_fused K={K_MAIN}, admission included (A, B, B, A): "
        f"{', '.join(f'{t:.3f}' for t in ms_render_ab)} ms; card {card}")

    # the K = 32 kernels against their plain versions on the same inputs,
    # beside their work, bound and items
    linp48 = raster_mod.prepare_raster(lb, lmesh, TILE, CHUNK, lattrs, ccap=48,
                                       compact=True, streamed=True)
    admission_log(f"large timed batch at ccap 48 ({K_MAIN} views)", linp48)
    l48 = (linp48.ids, linp48.counts, linp48.origins, linp48.pack,
           linp48.dir_planes)
    lms_c48 = cuda_ms(lambda: rk.raster_tiles_streamed(
        *l48, bbox_words=linp48.bbox_words, **kwA), 3)
    staged48, _ = rk.stage_faces(linp48.ids, linp48.counts, linp48.bbox_words,
                                 n_lchunks, CHUNK, linp48.tiles_per_view, TILE, 1)
    staged_b, _ = rk.stage_faces(inp32.ids, inp32.counts, inp32.bbox_words,
                                 inp32.pack.shape[1] // CHUNK, CHUNK,
                                 inp32.tiles_per_view, TILE, 1)
    n_bchunks = inp32.pack.shape[1] // CHUNK
    streamed, chunklist = rk.raster_tiles_streamed, rk.raster_tiles_chunklist
    # name -> (ms, work, kernel call, plain version, (wrapper, counts,
    # chunks, overlaps[, stage cap]) of the item list's check)
    k32 = {
        "A": (ms_a32, raster_work(inp32, staged_b),
              lambda: chunklist(*args32, inp32.dir_planes, **kw32),
              lambda: by_views(rk.raster_tiles_chunklist_reference)(
                  *args32, inp32.dir_planes, **kw32),
              (chunklist, inp32.counts, n_bchunks, None)),
        "B": (ms_b32, raster_work(inp32, staged_b, reads_bbox_words=True),
              lambda: rk.raster_tiles_compact(
                  *args32, inp32.bbox_words, inp32.dir_planes, **kw32),
              lambda: by_views(rk.raster_tiles_compact_reference)(
                  *args32, inp32.bbox_words, inp32.dir_planes, **kw32),
              (rk.raster_tiles_compact, inp32.counts, n_bchunks, staged_b,
               rk.STAGE_CAP)),
        "C plain body": (lms_cp, raster_work(linpC, staged),
                         lambda: streamed(*lC, **kwA),
                         lambda: by_views(rk.raster_tiles_streamed_reference)(
                             *lC, **kwA),
                         (streamed, linpC.counts, n_lchunks, None)),
        "C compacting": (lms_cc, raster_work(linpC, staged, reads_bbox_words=True),
                         lambda: streamed(*lC, bbox_words=linpC.bbox_words, **kwA),
                         lambda: by_views(rk.raster_tiles_streamed_reference)(
                             *lC, bbox_words=linpC.bbox_words, **kwA),
                         (streamed, linpC.counts, n_lchunks, staged)),
        "C compacting, ccap 48": (
            lms_c48, raster_work(linp48, staged48, reads_bbox_words=True),
            lambda: streamed(*l48, bbox_words=linp48.bbox_words, **kwA),
            lambda: by_views(rk.raster_tiles_streamed_reference)(
                *l48, bbox_words=linp48.bbox_words, **kwA),
            (streamed, linp48.counts, n_lchunks, staged48)),
    }
    for name, (ms, work, run, plain, sched_of) in k32.items():
        got = run()
        work.update(check_schedule(f"kernel {name} K={K_MAIN}", *sched_of))
        work["plain_ms"], want = timed(plain)
        work["max_abs_err"] = check_kernel(
            f"kernel {name} K={K_MAIN} vs plain ({want[0].shape[0]} rows)",
            got, want)
        del got, want
        log(f"kernel {name} K={K_MAIN}: {ms:.3f} ms; {work['pairs']:.4g} "
            f"pixel-face pairs (bbox-overlapping faces), bound "
            f"{work['bound_ms']:.3f} ms (by {work['bound_by']}; operations "
            f"{work['ops_ms']:.3f}, {work['ops_ms_unfused']:.3f} unfused; bytes "
            f"{work['bytes_ms']:.3f}), {work['bound_ms'] / ms:.3f} of the bound; "
            f"items {work['items']}, split rows {work['split_rows']}; plain version "
            f"{work['plain_ms']:.1f} ms; card {card}")
    del linp48, l48
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

    # 10. raycaster against kernel A, 2 bench views at 512² ---------------
    from omnidata_tpu_torch.annotator import cli
    from omnidata_tpu_torch.annotator.settings import load_settings
    from omnidata_tpu_torch.core.cameras import camera_rays
    from omnidata_tpu_torch.mesh import pano as pano_mod
    from omnidata_tpu_torch.mesh.raycast import raycast
    from omnidata_tpu_torch.sampling import load_point_info

    frag2 = raster_mod.render_views_fused(cams2, mesh, TILE, CHUNK, streamed=False)
    o2, d2 = camera_rays(cams2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits = raycast(torch.repeat_interleave(o2, RES * RES, 0), d2.reshape(-1, 3), mesh)
    torch.cuda.synchronize()
    s_ray = time.perf_counter() - t0
    ray_tests = d2.numel() // 3 * mesh.faces.shape[0]
    face_eq = float((hits.face.reshape(frag2.face.shape) == frag2.face).float().mean())
    valid_diff = int((hits.valid.reshape(frag2.valid.shape) != frag2.valid).sum())
    log(f"raycast vs kernel A ({K_CHECK} bench views at {RES}²): faces equal on "
        f"{face_eq:.6f} of pixels, valid differs on {valid_diff}; {s_ray:.3f} s "
        f"= {ray_tests / s_ray:.4g} ray-triangle tests/s")
    if face_eq < 0.999:
        raise AssertionError("raycast and kernel A disagree on > 0.1% of pixels")
    del frag2, hits

    # 11. CLI --task all on the bench scene ---------------------------------
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    bdir = write_mesh_dir(CLI_DIR / "bench", mesh)
    rk.raster_tiles_chunklist.launches = 0
    rk.raster_tiles_streamed.launches = 0
    t0 = time.perf_counter()
    run_cli(cli.main, ["--model_path", bdir, "--task", "all", *CLI_BENCH_ARGS])
    torch.cuda.synchronize()
    s_cli_bench = time.perf_counter() - t0
    cli_a_bench = rk.raster_tiles_chunklist.launches
    cli_c_bench = rk.raster_tiles_streamed.launches
    bsettings = load_settings(CLI_BENCH_ARGS[1:])
    bviews = cli.device_views(bdir, bsettings)
    n_files = check_cli_outputs(bdir, bviews, CLI_IMAGE_TASKS + ("fragments",))
    all_views = [v for views in load_point_info(bdir) for v in views]
    if not all("vanishing_points_image" in v for v in all_views):
        raise AssertionError("vanishing points missing from point_info")
    log(f"CLI --task all (bench scene, {len(all_views)} views in point_info, "
        f"{len(bviews)} rendered): {s_cli_bench:.1f} s; {n_files} outputs "
        f"decode; kernel A launches {cli_a_bench}, C {cli_c_bench}")
    if cli_a_bench < 1 or cli_c_bench:
        raise AssertionError("the bench CLI run must launch kernel A, not C")
    mods = tuple(t for t in cli.TASKS_ALL if t in cli.DEVICE_TASKS)
    cmesh, ccurv = cli.prepare_device_mesh(bdir, mods, bsettings, device=dev)
    unequal = []
    with plain_raster():
        for views in cli_batches(bviews, bsettings):
            want = render_batch(cli, views, cmesh, ccurv, bsettings, mods, dev)
            unequal += unequal_outputs(bdir, views, want)
    log(f"CLI device outputs vs annotate_views on the plain rasters "
        f"({len(bviews)} views x {len(want)} labels): {len(unequal)} unequal")
    if unequal:
        raise AssertionError(f"CLI outputs differ from the plain pipeline: "
                             f"{unequal[:8]}")
    del cmesh, ccurv, want

    # 12. CLI on the large scene: points, then the device tasks -----------
    ldir = write_mesh_dir(CLI_DIR / "large", lmesh)
    t0 = time.perf_counter()
    run_cli(cli.main, ["--model_path", ldir, "--task", "points"])
    s_points_large = time.perf_counter() - t0
    lsettings = load_settings([])
    lviews = cli.device_views(ldir, lsettings)
    rk.raster_tiles_chunklist.launches = 0
    rk.raster_tiles_streamed.launches = 0
    t0 = time.perf_counter()
    run_cli(cli.run_device_tasks, ldir, list(mods), lsettings, device=dev)
    torch.cuda.synchronize()
    s_pass = time.perf_counter() - t0
    cli_a_large = rk.raster_tiles_chunklist.launches
    cli_c_large = rk.raster_tiles_streamed.launches
    n_lfiles = check_cli_outputs(ldir, lviews, CLI_IMAGE_TASKS[:10] + ("fragments",))
    log(f"CLI --task points (large scene, default settings): {s_points_large:.2f} s, "
        f"{len(lviews)} views; device pass: {s_pass:.2f} s, {n_lfiles} outputs "
        f"decode; kernel C launches {cli_c_large}, A {cli_a_large}")
    if cli_c_large < 1 or cli_a_large:
        raise AssertionError("the large CLI run must launch kernel C, not A")
    t0 = time.perf_counter()
    lm, lc = cli.prepare_device_mesh(ldir, mods, lsettings, device=dev)
    s_setup = time.perf_counter() - t0
    lbatches_cli = cli_batches(lviews, lsettings)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for views in lbatches_cli:
        out = render_batch(cli, views, lm, lc, lsettings, mods, dev)
        {k: v.cpu().numpy() for k, v in out.items()}
    s_render = time.perf_counter() - t0
    del out
    cli_large = {
        "views": len(lviews), "s_points": s_points_large, "s_device_pass": s_pass,
        "s_mesh_setup": s_setup, "s_render_fetch": s_render,
        "vps_with_png": len(lviews) / s_pass,
        "vps_with_png_after_setup": len(lviews) / (s_pass - s_setup),
        "vps_without_png": len(lviews) / s_render}
    log(f"CLI large device pass: {cli_large['vps_with_png']:.2f} vps with PNG "
        f"writes and set-up ({s_setup:.2f} s of mesh load + curvature), "
        f"{cli_large['vps_with_png_after_setup']:.2f} vps after set-up, "
        f"{cli_large['vps_without_png']:.2f} vps rendered and fetched without "
        f"PNG writes; card {card}")

    cli_large.update(check_cli_streamed(cli, ldir, lbatches_cli, lm, lc,
                                        lsettings, mods, dev))
    del lm, lc

    # 13. CLI --task pano at 2048x1024, bench scene -------------------------
    pdir = write_mesh_dir(CLI_DIR / "pano", mesh)
    plocs = scenes.sample_cameras_np(PANO_CAMERAS, seed=1)[0]
    with open(f"{pdir}/camera_poses.json", "w") as fh:
        json.dump([{"camera_id": f"{i:04d}", "location": [float(x) for x in p]}
                   for i, p in enumerate(plocs)], fh)
    pano_s = []
    render_pano = pano_mod.render_pano

    def timed_render_pano(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        frag = render_pano(*args, **kwargs)
        torch.cuda.synchronize()
        pano_s.append(time.perf_counter() - t)
        return frag

    pano_mod.render_pano = timed_render_pano
    try:
        t0 = time.perf_counter()
        run_cli(cli.main, ["--model_path", pdir, "--task", "pano"])
        s_pano_task = time.perf_counter() - t0
    finally:
        pano_mod.render_pano = render_pano
    W, H = lsettings.PANO_RESOLUTION
    for i in range(PANO_CAMERAS):
        pano = {t: load_output(f"{pdir}/{t}/point_{i:04d}_view_equirectangular_"
                               f"domain_{t}.png")
                for t in ("depth_euclidean", "depth_zbuffer", "normal",
                          "reshading", "rgb")}
        if any(tuple(a.shape[:2]) != (H, W) for a in pano.values()):
            raise AssertionError(f"pano shapes {[a.shape for a in pano.values()]}")
        holes = float((pano["depth_euclidean"] == 65535).mean())
        if holes > 0.01 or not pano["rgb"].any():
            raise AssertionError(f"panorama {i}: {holes:.4f} of pixels without "
                                 "a hit inside a closed room")
    pano_rate = W * H * mesh.faces.shape[0] / statistics.mean(pano_s)
    log(f"CLI --task pano {W}x{H} (bench scene, {PANO_CAMERAS} cameras): "
        f"{s_pano_task:.1f} s; render_pano {', '.join(f'{x:.2f}' for x in pano_s)} "
        f"s = {pano_rate:.4g} ray-triangle tests/s; card {card}")

    src = "omnidata_tpu_torch/csrc/"
    replaces = "omnidata_tpu/mesh/pallas_raster.py:"
    no_library = ("none: no PyTorch call computes a winner-key sweep over "
                  "per-tile chunk lists")

    def entry(name, key, source, line, launches, launches_in, err, k2, **extra):
        """One kernel of the table: its K = 32 time beside its plain version,
        bound and work items on the same inputs (phase 9), its largest
        difference from the plain version over every check, its K = 2 (K = 1
        for C) times in turns with the plain version, its launches."""
        ms, work = k32[key][:2]
        (p0, p1), (k0, k1) = k2
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces + line, "launches": launches,
                "launches_in": launches_in,
                "max_abs_err": max(err, work["max_abs_err"]), "ms": ms,
                "plain_ms": work["plain_ms"], "bound_ms": work["bound_ms"],
                "bound_by": work["bound_by"], "library_ms": None,
                "library": no_library, "pairs": work["pairs"],
                "bytes": work["bytes"], "share_of_bound": work["bound_ms"] / ms,
                "ops_ms_unfused": work["ops_ms_unfused"],
                "items": work["items"], "split_rows": work["split_rows"],
                "ms_small": statistics.mean([k0, k1]),
                "plain_ms_small": statistics.mean([p0, p1]), **extra}

    ms48, work48 = k32["C compacting, ccap 48"][:2]
    kernels = {"kernels": [
        entry("raster_chunklist (A)", "A", "raster_chunklist.cu", "343",
              launches_a, "bench main path annotate_views", err_a,
              (ms_plain2, ms_kernel2), shape=f"bench K={K_MAIN}, P={TILE * TILE}; "
              f"small: K={K_CHECK}", items_main_path=items_a,
              items_seg1=seg1["kernel A (bench)"], ms_large_k32=lms_a,
              launches_cli_bench=cli_a_bench),
        entry("raster_compact (B)", "B", "raster_compact.cu", "601", launches_b,
              "render_views_fused(compact=True), bench scene", err_b,
              (ms_plain_b, ms_kernel_b),
              shape=f"bench K={K_MAIN}, stage_cap={rk.STAGE_CAP}; small: "
              f"K={K_CHECK}", count_launches=count_launches_b,
              items_seg1=seg1[f"kernel B, stage cap {rk.STAGE_CAP} (bench)"],
              ms_k1_k2_k8=list(ms_b_small.values()),
              render_ms_a_b_b_a=ms_render_ab),
        entry("raster_streamed (C, compacting body)", "C compacting",
              "raster_compact.cu", "879", launches_c,
              "large main path annotate_views", err_c["compacting"],
              c_turns["compacting"],
              shape=f"large K={K_MAIN}, ccap {LARGE_CCAP}, "
              f"stage_cap={rk.STREAMED_STAGE_CAP}; small: K=1",
              count_launches=count_launches_c, items_main_path=items_c,
              items_seg1=seg1["kernel C compacting body (large)"],
              ms_ccap48=ms48, bound_ms_ccap48=work48["bound_ms"],
              pairs_ccap48=work48["pairs"], items_ccap48=work48["items"],
              split_rows_ccap48=work48["split_rows"],
              plain_ms_ccap48=work48["plain_ms"],
              max_abs_err_ccap48=work48["max_abs_err"],
              launches_cli_large=cli_c_large),
        entry("raster_streamed (C, plain body)", "C plain body",
              "raster_compact.cu", "879", launches_c_plain,
              "render_views_fused(streamed=True, compact=False), large scene",
              err_c["plain"], c_turns["plain"],
              shape=f"large K={K_MAIN}, ccap {LARGE_CCAP}; small: K=1",
              items_seg1=seg1["kernel C plain body (large)"]),
    ], "large_vps": lvps, "bench_vps": vps, "peak_gib_large": lpeak_gib,
        "s_kernel_build": s_build, "s_large_scene_build": s_large_scene,
        "raycast_tests_per_s": ray_tests / s_ray, "raycast_face_agreement": face_eq,
        "cli_bench_all_s": s_cli_bench, "cli_large": cli_large,
        "pano_s": pano_s, "pano_tests_per_s": pano_rate}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
