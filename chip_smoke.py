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
8 MB), its host cues on their device prefixes. And the models' serving
path: DPT-hybrid-384 and MiDaS v2.1 (large and small) at full width
through ``models.create_model``, ``python -m omnidata_tpu_torch.demo`` and
``python -m omnidata_tpu_torch.demo_refocus``. And training: the DPT depth and
UNet normal trainers (``python -m omnidata_tpu_torch.train_depth`` /
``train_normal``) on the labels the CLI wrote; then evaluation of what
they trained (``eval_depth``, ``eval_normal``), the multi-task trainer
(``train_multitask``) and HRNet at its published widths. And the per-view
annotator (``annotate_view``, kernel A once a view), the sharded annotator,
the packed sample cache and the trajectory video. And multi-device
training: the sharded step under NCCL at world size 1 and under gloo
ranks sharing the card, ``train_depth`` under torchrun. Phases, each of
which fails the run on error:

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
   its plain version on the same inputs (2 views at a time, timed; at
   ccap 48 the rows of the 8 views with the most staged faces), its
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
    hardest views, and the written outputs of its 2 hardest views equal to
    ``annotate_views`` on the plain rasters with the CLI's arguments; the
    check prints the launch's work items and split rows.
13. CLI ``--task pano`` at 2048x1024 on the bench scene for 1 camera
    location, the panorama's render timed; outputs decode.
14. the host cues' device prefixes: NARF border maps, 2D blur and 2.5D
    channel maps (``annotator.cli.device_cue_maps``) of the bench and the
    large K = 32 batches on the card (timed), against the port on the CPU
    from the same label codes (NARF on the first 2 views): every code equal
    (the CPU tests' tolerances, change within 2e-3 and directions aligned,
    are met with room: the port rounds each operation alike on both).
    Phase 11's CLI run must have
    taken the device-prefix route (``device_cue_maps`` called with all
    three prefixes), and its keypoints3d and segment PNGs of 2 views must
    equal the host cues recomputed from its label PNGs with maps made on
    the card. Host-cue seconds per view with and without the prefixes,
    serially and through ``run_device_tasks`` with the three host cues.
15. DPT-hybrid-384 (``omnidata_tpu_torch.models``), depth and normal heads
    on seeded weights at 384²: float32 on the card against the CPU at
    batch 1 (max |diff| <= 1e-3 of max |CPU|, TF32 off); bfloat16 against
    float32 on the card (one EncoderBlock within 0.01 relative, the whole
    net correlated > 0.9, tests/test_models.py:302's bounds); img/s at
    float32 and bfloat16, batch 1, 8, 16, by CUDA events (median, min, max
    of 3 reps), beside the FLOPs per image counted from the layer shapes
    and their share of the card's dense peak; peak device memory. Then
    ``python -m omnidata_tpu_torch.demo`` on a seeded 640x480 PNG for both
    tasks at once; its PNGs must decode and not be constant. No TPU kernel's
    counterpart runs on this path (its convolutions, matmuls and attention
    are PyTorch's).
16. training on phase 11's labels (the CLI's 16 bench views at 512²):
    a. one DPT-hybrid-384 depth step (published widths, seeded weights,
       batch 1 at 384², fixed triplets) before and after the 15k schedule
       switch, and one UNet (downsample 6) normal step (batch 1 at 512²),
       each on the card against the CPU with TF32 off: the loss within
       1e-3; each parameter's gradient, backpropagated on the card from the
       CPU's dL/dpred, against the same in float64 on the CPU, within 3
       times the CPU float32's error plus 1e-2 of its norm; the update from
       the CPU's gradients within 0.1 lr. Printed: the whole step's
       differences (the loss's median and hard-example picks and Adam's
       sign-like first step amplify last-bit differences) and whether two
       card steps from one state agree bit for bit;
    b. ``python -m omnidata_tpu_torch.train_depth`` (384², batch 8, 6
       steps, validation and checkpoints every 3, top 2, augment, 8 loader
       threads) and ``train_normal`` (UNet, 512², batch 4, 6 steps, every 3)
       as subprocesses at once on phase 11's output: finite logged losses,
       ``scores.json`` on the validation loss, validation PNGs, ``last`` at
       the final step; then both again with ``--resume``: resumed at that
       step, ``last`` unchanged bit for bit;
    c. times by CUDA events (2 warm-up steps, median, min, max of 6): the
       depth step at batch 8, 384² before and after the switch with the
       script's cuDNN setting (TF32 off, deterministic) and with torch's
       defaults (which the trainers run with), the normal step at batch
       16, 512² with remat on and off with torch's defaults; img/s,
       training FLOPs (3 forwards, ``model_flops``), share of 67 TFLOP/s,
       peak memory; each step's parts by CUDA events (mean of 2) and a
       ``torch.profiler`` window of 2 steps; the loader's ms
       a sample and a batch (8 threads); the trainer loop's device idle
       share (loader, copy and step, torch's defaults). No TPU kernel's
       counterpart runs here either; the labels are kernel A's (phase 11).
17. evaluation, multi-task training and HRNet on phase 11's labels and
    phase 16's checkpoints:
    a. ``python -m omnidata_tpu_torch.eval_depth`` (``--align none`` and
       ``ssi``, ``--checkpoint`` the depth trainer's best checkpoint
       directory) and ``eval_normal`` (``--model dpt``, seeded, and
       ``--model unet`` on the normal trainer's best directory; on the
       annotated views, and on an OASIS fixture made from phase 11's rgb
       and normal PNGs with and without ``--tta``), 4 images each, as
       subprocesses on the card at once (TF32 off through
       ``NVIDIA_TF32_OVERRIDE=0``): finite metrics, each within 1e-3
       relative of the same run on the CPU (medians within 0.05 degrees,
       the shares of pixels within 1e-3 relative or 1e-5, 6 of the ~590k
       pixels scored); eval_depth ``--align ssi`` also on seeded weights
       (the trained depth net outputs zeros, which alignment keeps);
       then eval_depth's loop on all 16 views in torch's defaults, its
       forwards by CUDA events: img/s and the device's idle share;
    b. ``python -m omnidata_tpu_torch.train_multitask`` for each of the
       four ``--arch`` values (6 steps, GradNorm every 2) as subprocesses
       at once: finite losses, GradNorm weights summing to 2 (an update
       whose weights come out NaN is skipped and logged); one step's losses
       on the card within 1e-3 of the CPU's (TF32 off); step times by CUDA
       events (median, min, max of 6 after 2) at batch 4 and 256² in
       torch's defaults, img/s, training FLOPs (``model_flops``, 3
       forwards), share of 67 TFLOP/s, peak memory;
    c. HRNet-W18 and W48 (``create_model("hrnet_w18" | "hrnet_w48")``):
       card against CPU at 129² within 1e-3 of max |CPU| (float32, TF32
       off); forwards at 513², batch 1 and 4, float32 and bfloat16, with
       deterministic and autotuned cuDNN (median, min, max of 3 reps of
       4): img/s, FLOPs, share of 67 (989 for bfloat16) TFLOP/s, peak
       memory. No TPU kernel's counterpart runs in phase 17.
18. MiDaS v2.1 and the refocus augmentation:
    a. ``create_model("midas_v21")`` (ResNeXt101-32x8d-WSL, 256-wide fusion,
       seeded) on the card against the CPU at 128² within 1e-3 of max |CPU|
       (float32, TF32 off); on ``midas_transform_v21`` of a seeded 640x480
       image (3 x 288 x 384); forwards at 384², batch 1, 8, 16 with
       deterministic and autotuned cuDNN (median, min, max of 3 reps by CUDA
       events): img/s, GFLOP an image (``model_flops``), share of 67 TFLOP/s,
       peak memory, a profile window at batch 16;
    b. the same for ``midas_v21_small`` (EfficientNet-Lite3) at 256², and
       ``MidasNetSmall`` card against CPU at 64²;
    c. ``python -m omnidata_tpu_torch.demo_refocus`` as a subprocess on the
       card over 4 of phase 11's rgb / depth_euclidean pairs (512²): its PNGs
       within one 8-bit step of the CPU's ``refocus_image`` at the same draws;
       ``refocus_augmentation`` at 512², batch 1 and 8, 10 and 8 quantiles,
       beside its FP32 operations' bound. No TPU kernel's counterpart runs in
       phase 18 (the JAX MiDaS nets, transforms and refocus reach no
       ``pallas_call``).
19. the per-view path, sharded annotation, the packed cache and the video:
    a. ``annotator.annotate_view`` on 4 bench views at 512², tile 32: kernel
       A launched once a view (count reset just before, read just after:
       4); labels within the integer rule of ``annotate_views`` on the same
       views; ``render_view`` (plain torch on the card, at the CLI's cap
       from ``tile_candidate_counts``) against kernel A's render
       (``render_view_fused``): valid and faces equal, t within 1e-4, and
       its labels within the integer rule; per-view viewpoints/s of both
       routes by CUDA events (median of 5), beside phase 5's batched rate;
    b. ``annotate_views_sharded`` over ``make_annotate_mesh()`` (every card
       of the machine) on 8 bench views: every label equal to
       ``annotate_views``' bit for bit;
    c. ``PackedDataset`` on phase 11's labels (rgb, normal, depth_zbuffer,
       mask_valid): every item equal to the direct dataset's for equal
       seeds; the loader's samples/s from PNGs and packed, with 1 and 8
       threads; ``train_depth`` with ``packed_cache`` for 3 steps as a
       subprocess (finite losses, train and val packs built); ``make_video``
       on phase 11's rgb frames (mp4 through ffmpeg when present, else the
       port's GIF), its kind, size and seconds.
    Hypersim and the downloader are not driven on the card: its machine has
    no h5py (hypersim's keyframes and labels are HDF5) and no network.
20. multi-device training (``train/parallel``, ``train/multihost``), each
    part a process of its own (``chip_smoke.py --phase20 ...``):
    a. ``init_process_group("nccl")`` at world size 1, DPT-hybrid-384 at its
       published widths, seeded, 384², batch 2 of phase 11's views, TF32
       off, deterministic algorithms: one depth step before and one after
       the 15k switch through the sharded path (``make_mesh``,
       ``shard_module``, the mesh in the train state) equal to the
       one-device step bit for bit (loss terms and every parameter); then
       ``graft_entry.dryrun_multichip(1)`` (a sharded step of the tiny DPT
       and ``annotate_views_sharded`` on ``make_annotate_mesh(1)``);
    b. ``python -m torch.distributed.run --nproc_per_node 1 -m
       omnidata_tpu_torch.train_depth`` with ``data_parallel: 1`` on phase
       11's labels, 2 steps, then ``--resume --max_steps 4``: finite
       losses, validation, the resumed run going on from step 2 to 4, and
       'last' read by the one-device loader;
    c. gloo ranks sharing the card, 2x1 and 2x2 (data, model), the full
       DPT at 128², batch 1 a data rank, against the world-size-1 step on
       the global batch with its forward run image by image as the ranks
       run theirs (see ``par_worker_gloo``): steps from fresh moments at
       step 0 and past the switch, and the step after the latter from the
       state the world-size-1 step left (warm moments); each step's loss
       terms within PAR_RTOL, its gradients (the data group's sum) and
       clip norms (all tensors; the model-split ones) within
       PAR_GRAD_RTOL (PAR_GRAD_RTOL_VNL_CUT past the switch at 2x2, where
       VNL's 25% cut moves), and the warm step's parameters within 2 lr and its
       moves within PAR_MOVE_RTOL in L2; seconds a step (gloo through
       host memory: not a multi-GPU number). 20b and 20c's two grids run
       at once, after 20a and 20d;
    d. the depth step past the switch at batch 8, 384², torch's defaults,
       by CUDA events (median, min, max of 10 after 2, one device then
       sharded): the sharded path at world size 1 against the one-device
       step, beside the card's name and power limit.
21. the offline accuracy chain: ``accuracy_benchmark.main`` in this
    process on the card in torch's defaults, ``--train_scenes 2
    --val_scenes 1 --normal_steps 12 --depth_steps 12`` and the tool's
    defaults otherwise (512² renders through the CLI's batched route, the
    UNet at batch 16 and DPT-hybrid-384 at batch 8 at their published
    widths, seeded), root and report under ``build/chip_smoke_accuracy/``:
    kernel A launched at least once a render batch (counters reset just
    before, read just after), B and C not at all; every metric of the
    report finite, untrained and trained rows of both models; the card's
    name in the report. Prints the view counts, each stage's seconds and
    the depth net's share of exactly-zero outputs on the held-out views.
The CLI phases work in ``build/chip_smoke_cli/`` and log the CLI's own
output to ``build/chip_smoke_cli/cli.log``; a failing CLI call prints the
log's last lines to stderr.

Prints the kernel table as one JSON line (per kernel its K = 32 time,
plain version, bound and work items, its main-path launches; no PyTorch
call computes these kernels' function, so ``library_ms`` is null; phases
14-21's numbers under "device_prefixes", "dpt", "train",
"eval_multitask_hrnet", "midas", "refocus", "phase19", "phase20" and
"phase21"), the
card's name and power limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when no CUDA device is present.

Run: ``python3 chip_smoke.py`` from the repository root.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
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
PLAIN48_VIEWS = 8  # phase 9: C at ccap 48 against its plain version on these views' rows

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
PANO_CAMERAS = 1
CLI_PLAIN_VIEWS = 2  # the CLI batch's hardest views held against the plain pipeline
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
    views with the most such rows, and every written output of its
    CLI_PLAIN_VIEWS hardest views equal to annotate_views on the plain
    rasters with the CLI's arguments. -> what was checked."""
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
    # the plain pipeline on the batch's CLI_PLAIN_VIEWS hardest views (views
    # are independent, so their outputs are the whole batch's)
    hard = per_view.argsort(descending=True, stable=True)[:CLI_PLAIN_VIEWS]
    views = [views[i] for i in hard.sort().values.tolist()]
    del inp, args, ckw, got
    t0 = time.perf_counter()
    with plain_raster():
        want = render_batch(cli, views, mesh, curv, settings, mods, dev)
    unequal = unequal_outputs(d, views, want)
    log(f"CLI outputs of batch {b}'s {len(views)} hardest views vs "
        f"annotate_views on the plain rasters ({len(want)} labels each, "
        f"{time.perf_counter() - t0:.1f} s): {len(unequal)} unequal")
    if unequal:
        raise AssertionError(f"CLI outputs differ from the plain pipeline: "
                             f"{unequal[:8]}")
    return {"checked_batch": b, "checked_views": len(views),
            "checked_scan_all_rows": rows_of[b][0],
            "checked_block_rows": rows_of[b][1], "max_abs_err_kernel_c": err,
            "checked_items": items}


# ---------------------------------------------------------------------------
# phase 14: the host cues' device prefixes
# ---------------------------------------------------------------------------

ALL_PREFIXES = {"narf": True, "seg2d": True, "seg25d": True}
CUE_INPUTS = ("depth_zbuffer", "rgb", "normal", "edge_occlusion")
HOST_CUES = ("keypoints3d", "segment_unsup2d", "segment_unsup25d")


def check_device_maps(what: str, out, cams, settings) -> dict:
    """The host cues' input maps of one rendered K = 32 batch on the card
    against the port on the CPU from the same label codes: every code equal
    (NARF change, direction and shadow at every level; the 2D and 2.5D seg
    codes). The CPU computes the NARF maps of the batch's first K_CHECK
    views (views are independent) and the seg maps of all. -> numbers."""
    from omnidata_tpu_torch.annotator import cli

    def maps(o, fov, **on):
        return cli.device_cue_maps(o, fov, settings, dict(ALL_PREFIXES, **on))

    ms = cuda_ms(lambda: maps(out, cams.fov), 3)
    gpu = maps(out, cams.fov)
    t0 = time.perf_counter()
    cpu_narf = maps({k: out[k][:K_CHECK].cpu() for k in CUE_INPUTS},
                    cams.fov[:K_CHECK].cpu(), seg2d=False, seg25d=False)["narf"]
    cpu_seg = maps({k: out[k].cpu() for k in CUE_INPUTS}, cams.fov.cpu(), narf=False)
    s_cpu = time.perf_counter() - t0
    differ = {"change": 0, "cdir": 0, "shadow": 0}
    for g, c in zip(gpu["narf"], cpu_narf):
        for name, gm, cm in zip(differ, g, c):
            differ[name] += int((gm[:K_CHECK].cpu().int() != cm.int()).sum())
    for k in ("seg2d_q", "seg25d_q"):
        differ[k] = int((gpu[k].cpu().int() != cpu_seg[k].int()).sum())
    log(f"device prefixes, {what} (K={out['rgb'].shape[0]} at {RES}², "
        f"{len(gpu['narf'])} NARF levels): card {ms:.3f} ms for NARF + seg "
        f"maps; codes differing from the CPU's ({s_cpu:.1f} s; NARF on "
        f"{K_CHECK} views): {differ}")
    if any(differ.values()):
        raise AssertionError(f"device prefixes on the card differ from the CPU ({what})")
    return {"ms": ms, "codes_differing": differ}


def cues_from_pngs(cli, d: str, view: dict, settings, dev, out_dir: str,
                   with_maps: bool) -> float:
    """One view's three host cues from its written label PNGs into out_dir,
    with the device maps computed on the card (as the CLI's device-prefix
    route does) or wholly on the host. -> host-cue seconds."""
    import torch

    pngs = {t: load_output(output_path(d, view, t)) for t in CUE_INPUTS}
    vmaps = None
    if with_maps:
        cams = cli.view_batch([view], settings.RESOLUTION, dev)
        maps = cli.device_cue_maps(
            {t: torch.from_numpy(a)[None].to(dev) for t, a in pngs.items()},
            cams.fov, settings, ALL_PREFIXES)
        maps = {k: ([[m.cpu().numpy() for m in lvl] for lvl in v] if k == "narf"
                    else v.cpu().numpy()) for k, v in maps.items()}
        vmaps = cli.view_cue_maps(maps, 0, view, settings.RESOLUTION)
    t0 = time.perf_counter()
    cli.host_cues_for_view(out_dir, view, HOST_CUES, settings, pngs.__getitem__,
                           dev_maps=vmaps)
    return time.perf_counter() - t0


def check_cli_route(cli, bdir: str, views, settings, dev, route_calls: int) -> dict:
    """The bench CLI run of phase 11 took the device-prefix route: its
    keypoints3d and segment PNGs equal the host cues recomputed from its
    label PNGs with maps computed on the card, on K_CHECK views; the host
    route's differ. Then the host-cue seconds per view, serially here, with
    the maps and without, and of run_device_tasks with the three host cues
    (its device prefixes on, then off). -> numbers."""
    import numpy as np

    if route_calls < 1:
        raise AssertionError("the bench CLI run computed no device prefixes")
    s_with, s_without, differ = [], [], 0
    warm = str(CLI_DIR / "cues_warm-up")
    for t in HOST_CUES:
        Path(warm, t).mkdir(parents=True, exist_ok=True)
    for with_maps in (True, False):  # native libraries loaded, caches warm
        cues_from_pngs(cli, bdir, views[0], settings, dev, warm, with_maps)
    for view in views[:K_CHECK]:
        for with_maps, secs in ((True, s_with), (False, s_without)):
            out_dir = str(CLI_DIR / f"cues_{'maps' if with_maps else 'host'}")
            for t in HOST_CUES:
                Path(out_dir, t).mkdir(parents=True, exist_ok=True)
            secs.append(cues_from_pngs(cli, bdir, view, settings, dev, out_dir,
                                       with_maps))
            for t in HOST_CUES:
                same = np.array_equal(load_output(output_path(bdir, view, t)),
                                      load_output(output_path(out_dir, view, t)))
                if with_maps and not same:
                    raise AssertionError(f"CLI {t} of view {view['view_id']} is not "
                                         "the device-prefix route's")
                differ += (not with_maps) and not same
    log(f"CLI --task all (bench) took the device-prefix route: "
        f"device_cue_maps {route_calls} calls; keypoints3d and segment PNGs of "
        f"{K_CHECK} views equal to the cues recomputed with card maps; the host "
        f"route differs on {differ} of {K_CHECK * len(HOST_CUES)}")
    log(f"host-cue seconds per view, serial ({settings.RESOLUTION}², 3 cues, "
        f"{K_CHECK} views): with device "
        f"prefixes {statistics.mean(s_with):.3f}, without "
        f"{statistics.mean(s_without):.3f}")
    rdir = CLI_DIR / "route"
    rdir.mkdir()
    shutil.copy(Path(bdir, "mesh.ply"), rdir)
    shutil.copytree(Path(bdir, "point_info"), rdir / "point_info")
    prefixes, s_pass = cli.device_prefixes, {}
    try:
        for on in (True, False):
            if not on:  # the same pass with every prefix on the host
                cli.device_prefixes = lambda *a: dict.fromkeys(ALL_PREFIXES, False)
            t0 = time.perf_counter()
            run_cli(cli.run_device_tasks, str(rdir), list(CUE_INPUTS), settings,
                    host_tasks=HOST_CUES, device=dev)
            s_pass[on] = (time.perf_counter() - t0) / len(views)
    finally:
        cli.device_prefixes = prefixes
    log(f"run_device_tasks, 4 label tasks + 3 host cues, {len(views)} bench "
        f"views: {s_pass[True]:.3f} s/view with device prefixes, "
        f"{s_pass[False]:.3f} without (pool of {min(128, os.cpu_count() or 1)} "
        f"workers, spawn included)")
    return {"route_calls": route_calls, "host_route_differs": differ,
            "serial_s_per_view_with": statistics.mean(s_with),
            "serial_s_per_view_without": statistics.mean(s_without),
            "pass_s_per_view_with": s_pass[True],
            "pass_s_per_view_without": s_pass[False]}


# ---------------------------------------------------------------------------
# phase 15: DPT-hybrid-384
# ---------------------------------------------------------------------------

DPT_RES = 384
DPT_BATCHES = (1, 8, 16)
DPT_REPS = 3
DPT_F32_TOL = 1e-3  # max |card - CPU| / max |CPU|, float32 without TF32
# dense peaks of one H100 SXM (data sheet): FP32 without tensor cores (TF32
# off), BF16 tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
DEMO_TIMEOUT_S = 300


def model_flops(model, x) -> float:
    """Multiply-adds x 2 of one forward on x, from the layer shapes: every
    convolution and linear layer, and attention's two matrix products (no
    interpolation, normalisation or elementwise work)."""
    import torch

    from omnidata_tpu_torch.models.layers import Attention

    total = [0.0]

    def conv(m, inp, out):
        total[0] += 2.0 * out.numel() * (m.in_channels // m.groups) \
            * m.kernel_size[0] * m.kernel_size[1]

    def linear(m, inp, out):
        total[0] += 2.0 * out.numel() * m.in_features

    def attention(m, inp, out):
        B, N, C = inp[0].shape
        total[0] += 2.0 * 2 * B * N * N * C  # q k^T and attn v over all heads

    hooks = []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear))
        elif isinstance(m, Attention):
            hooks.append(m.register_forward_hook(attention))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return total[0] / x.shape[0]


def seeded_png(path: Path, seed: int = 0) -> None:
    """A seeded 640x480 RGB photo stand-in: gradients, discs, noise."""
    import numpy as np

    from omnidata_tpu_torch.cues.encode import save_png

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    img = np.stack([xx / 640, yy / 480, 0.5 + 0.5 * np.sin(xx / 37 + yy / 53)], -1)
    for _ in range(6):
        cy, cx, r = rng.rand() * 480, rng.rand() * 640, 30 + rng.rand() * 90
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.rand(3)
    img = img + 0.05 * rng.standard_normal(img.shape)
    save_png(str(path), (np.clip(img, 0, 1) * 255).astype(np.uint8))


def dpt_profile(net, bs: int, gen, dev, what: str) -> dict:
    """profile_window over 3 forwards of net at batch bs."""
    import torch

    x = torch.rand(bs, 3, DPT_RES, DPT_RES, generator=gen).to(dev)
    with torch.no_grad():
        net(x)
        r = profile_window(lambda: net(x), 3)
    log(f"DPT profile, {what} ({DPT_RES}², 3 forwards): wall {r['wall_ms']:.2f} ms "
        f"a forward, kernels {r['kernel_ms']:.2f} ms, idle share "
        f"{r['idle_share']:.3f}; top kernels (ms a forward, launches): " + "; ".join(
            f"{t['kernel']} {t['ms']:.2f} x{t['launches']}" for t in r["top"]))
    return r


def phase_dpt(dev, card: str) -> dict:
    """DPT-hybrid-384, depth and normal heads, seeded weights, at 384²."""
    import numpy as np
    import torch

    from omnidata_tpu_torch.models import create_model
    from omnidata_tpu_torch.models import layers as L
    from omnidata_tpu_torch.models.registry import cast_params_bf16, init_weights

    gen = torch.Generator().manual_seed(0)
    x1 = torch.rand(1, 3, DPT_RES, DPT_RES, generator=gen)
    res = {}
    for name in ("depth_dpt_hybrid_384", "surface_normal_dpt_hybrid_384"):
        cpu = create_model(name, device="cpu", generator=torch.Generator().manual_seed(0))
        t0 = time.perf_counter()
        with torch.no_grad():
            want = cpu(x1)
        s_cpu = time.perf_counter() - t0
        model = cpu.to(dev)
        del cpu
        with torch.no_grad():
            got = model(x1.to(dev)).cpu()
        err = float((got - want).abs().max()) / float(want.abs().max())
        log(f"DPT {name} f32 at {DPT_RES}², batch 1: card vs CPU ({s_cpu:.1f} s) "
            f"max |diff| / max |CPU| = {err:.3g} (tol {DPT_F32_TOL}); output "
            f"{tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        if not err <= DPT_F32_TOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: the card's float32 output differs from the CPU")
        res[name] = {"f32_card_vs_cpu": err}
    flops = model_flops(model.net, x1.to(dev))

    # bf16 against f32 on the card: one block, and the whole net
    blk = L.EncoderBlock(768, 12)
    init_weights(blk, gen)
    with torch.no_grad():
        blk = blk.to(dev)
        xb = torch.randn(1, 10, 768, generator=gen).to(dev)
        a = blk(xb)
        b = cast_params_bf16(blk)(xb.to(torch.bfloat16)).float()
    block_rel = float((a - b).abs().max() / (a.abs().max() + 1e-6))
    m16 = create_model("surface_normal_dpt_hybrid_384", dtype="bfloat16",
                       device=dev, generator=torch.Generator().manual_seed(0))
    xg = x1.to(dev)
    with torch.no_grad():
        y32, y16 = model(xg).flatten(), m16(xg).flatten()
    corr = float(torch.corrcoef(torch.stack([y32, y16]))[0, 1])
    log(f"DPT bf16 vs f32 on the card: one EncoderBlock(768, 12) max rel err "
        f"{block_rel:.4g} (< 0.01); whole net (normals, {DPT_RES}²) correlation "
        f"{corr:.4f} (> 0.9)")
    if not block_rel < 0.01 or not corr > 0.9:
        raise AssertionError("bf16 DPT out of tests/test_models.py:302's bounds")

    # throughput: CUDA events, median / min / max over DPT_REPS reps; with
    # cuDNN as phase 1 set it (deterministic algorithms), then as a server
    # would run it (autotuned, cudnn.benchmark)
    rates = {}
    torch.cuda.reset_peak_memory_stats(dev)
    for cudnn_mode in ("deterministic", "benchmark"):
        torch.backends.cudnn.deterministic = cudnn_mode == "deterministic"
        torch.backends.cudnn.benchmark = cudnn_mode == "benchmark"
        for dtype, net in (("float32", model), ("bfloat16", m16)):
            for bs in DPT_BATCHES:
                xb = torch.rand(bs, 3, DPT_RES, DPT_RES, generator=gen).to(dev)
                with torch.no_grad():
                    net(xb)  # warm-up (and the autotuner's search)
                    iters = max(2, 8 // bs)
                    per = sorted(cuda_ms(lambda: net(xb), iters)
                                 for _ in range(DPT_REPS))
                ips = [bs / (ms / 1e3) for ms in per]
                med = statistics.median(ips)
                rates[f"{dtype}_b{bs}_{cudnn_mode}"] = {
                    "img_s_median": med, "img_s_min": min(ips), "img_s_max": max(ips),
                    "share_of_peak": med * flops / PEAK_FLOPS[dtype]}
                log(f"DPT {dtype} batch {bs} at {DPT_RES}², cuDNN {cudnn_mode}: "
                    f"{med:.2f} img/s (min {min(ips):.2f}, max {max(ips):.2f}; "
                    f"{DPT_REPS} reps of {iters}); {med * flops / 1e12:.2f} TFLOP/s "
                    f"= {med * flops / PEAK_FLOPS[dtype]:.3f} of the "
                    f"{PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s {dtype} peak; card {card}")
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"DPT: {flops / 1e9:.2f} GFLOP per image at {DPT_RES}² (convs, linears, "
        f"attention products); peak device memory {peak_gib:.2f} GiB")
    profiles = {f"{dtype}_b{bs}": dpt_profile(net, bs, gen, dev, f"{dtype} batch {bs}")
                for dtype, net, bs in (("bfloat16", m16, 16), ("float32", model, 16),
                                       ("float32", model, 1))}
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    del model, m16

    # the demo, as a user runs it, both tasks at once
    ddir = CLI_DIR / "demo"
    ddir.mkdir()
    seeded_png(ddir / "photo.png")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "omnidata_tpu_torch.demo", "--task", task,
         "--img_path", str(ddir / "photo.png"), "--output_path", str(ddir / "out")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for task in ("depth", "normal")]
    for p in procs:
        text, _ = p.communicate(timeout=DEMO_TIMEOUT_S)
        if p.returncode:
            print(text[-4000:], file=sys.stderr)
            raise AssertionError(f"demo exited {p.returncode}")
    s_demo = time.perf_counter() - t0
    shapes = {}
    for name in ("photo_rgb", "photo_depth", "photo_normal"):
        a = load_output(str(ddir / "out" / f"{name}.png"))
        if len(np.unique(a.reshape(-1, a.shape[-1]), axis=0)) < 2:
            raise AssertionError(f"demo output {name} is constant")
        shapes[name] = a.shape
    log(f"demo (python -m omnidata_tpu_torch.demo, depth and normal at once on "
        f"a 640x480 PNG): {s_demo:.1f} s; outputs decode and vary: {shapes}")
    return {"gflop_per_image": flops / 1e9, "peak_gib": peak_gib,
            "bf16_block_rel_err": block_rel, "bf16_net_corr": corr,
            "img_s": rates, "profiles": profiles, "checks": res, "demo_s": s_demo}


# ---------------------------------------------------------------------------
# phase 16: training
# ---------------------------------------------------------------------------

DEPTH_RES, NORMAL_RES = 384, 512
DEPTH_BS, NORMAL_BS = 8, 16
TRAIN_WARMUP, TRAIN_TIMED = 2, 6
TRAINER_TIMEOUT_S = 420
STEP_LOSS_TOL = 1e-3  # |card - CPU| / |CPU| of the loss, TF32 off
STEP_GRAD_TOL = 3.0  # per parameter: card's error vs float64 <= 3x the CPU's + 1e-2
STEP_UPDATE_TOL = 0.1  # x lr: the update from the same gradients (a flip is 2 lr)
DEPTH_TASKS = ("rgb", "depth_zbuffer", "mask_valid")
NORMAL_TASKS = ("rgb", "normal", "mask_valid")


def bench_dataset(bdir: str, tasks, size: int):
    from omnidata_tpu_torch.data.dataset import OmnidataDataset, Options

    return OmnidataDataset(Options(data_path=bdir, tasks=tasks, image_size=size,
                                   random_flip=False))


def train_batch(bdir: str, tasks, size: int, n: int, depth_rgb: bool) -> dict:
    """The first n views of phase 11's CLI output as the trainers' batch
    (CPU tensors): rgb in [0, 1] (depth_rgb: in [-1, 1]), labels, bool mask."""
    import torch

    b = next(bench_dataset(bdir, tasks, size).batches(n, shuffle=False))
    out = {"rgb": torch.from_numpy(b["rgb"] * 2.0 - 1.0 if depth_rgb else b["rgb"]),
           "mask_valid": torch.from_numpy(b["mask_valid"] > 0.5)}
    if "depth_zbuffer" in b:
        out["depth"] = torch.from_numpy(b["depth_zbuffer"])
    else:
        out["normal"] = torch.from_numpy(b["normal"])
    return out


def one_step(dev, net, tx, pred_fn, loss_fn, batch, step: int, cotangent=None,
             grads=None, dtype=None):
    """One step (forward, loss, backward, optimizer) of a copy of net on
    dev -> dict of the loss, dL/dpred, the parameters' gradients and the
    parameters after, on the CPU. cotangent: backpropagate it from the
    prediction in place of the loss's own; grads: step the optimizer on
    these in place of the computed ones; dtype: the net's and the batch's
    floats (float32 by default)."""
    import copy

    import torch

    from omnidata_tpu_torch import train as T

    dtype = dtype or torch.float32
    state = T.create_train_state(copy.deepcopy(net).to(dev, dtype), tx)
    state.step = step
    b = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
         for k, v in batch.items()}
    pred = pred_fn(state.net, b)
    pred.retain_grad()
    loss, _ = loss_fn(pred, b, step)
    if cotangent is None:
        loss.backward()
    else:
        pred.backward(cotangent.to(dev, dtype))
    named = dict(state.net.named_parameters())
    got = {n: named[n].grad.detach().cpu().clone() for n in state.names
           if named[n].grad is not None}
    if grads is not None:
        for n in state.names:
            named[n].grad = grads[n].to(dev, copy=True) if n in grads else None
    state.apply_gradients()
    return {"loss": float(loss.detach()), "cotangent": pred.grad.detach().cpu().clone(),
            "grads": got, "after": {n: named[n].detach().cpu().clone() for n in state.names}}


def rel_err(a, b) -> float:
    return float((a - b).norm() / b.norm()) if float(b.norm()) else float((a - b).norm())


def step_card_vs_cpu(what: str, dev, net, tx, pred_fn, loss_fn, batch, step: int) -> dict:
    """One step from the same weights on the CPU and on the card, TF32 off.
    Held to tolerance: the loss (STEP_LOSS_TOL); each parameter's gradient
    backpropagated on the card from the CPU's dL/dpred, against the same
    backpropagated in float64 on the CPU: within STEP_GRAD_TOL times the
    CPU float32's own error plus 1e-2 of its norm (DPT's weight-standardized
    convolutions and GroupNorms make float32 gradients ill-conditioned:
    the CPU's reach 2.3% from float64 on some backbone tensors at 384²);
    the optimizer's update on the card from the CPU's gradients
    (STEP_UPDATE_TOL lr, plus the rounding of p + u: well short of the 2 lr
    of a sign flip). Printed: the whole step on the card against the CPU
    (the loss's median and hard-example
    selections take other elements when the prediction differs in its last
    bits, and Adam's first step maps each gradient to ±lr by its sign);
    whether two card steps agree bit for bit."""
    import torch

    cpu = torch.device("cpu")
    args = (tx, pred_fn, loss_fn, batch, step)
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    t0 = time.perf_counter()
    c = one_step(cpu, net, *args)
    s_cpu = time.perf_counter() - t0
    g = one_step(dev, net, *args)
    g2 = one_step(dev, net, *args)
    same_cot = one_step(dev, net, *args, cotangent=c["cotangent"])
    cpu_cot = one_step(cpu, net, *args, cotangent=c["cotangent"])
    f64 = one_step(cpu, net, *args, cotangent=c["cotangent"], dtype=torch.float64)
    same_grads = one_step(dev, net, *args, grads=c["grads"])
    loss_err = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    card_err, cpu_err, over = {}, {}, {}
    for n in c["grads"]:
        ref = f64["grads"][n].double()
        card_err[n] = rel_err(same_cot["grads"][n].double(), ref)
        cpu_err[n] = rel_err(cpu_cot["grads"][n].double(), ref)
        over[n] = card_err[n] / (STEP_GRAD_TOL * cpu_err[n] + 1e-2)
    worst = max(over, key=over.get)
    own = max(rel_err(c["grads"][n], cpu_cot["grads"][n]) for n in c["grads"])
    lr = tx.lr
    upd_over = max(float(((same_grads["after"][n] - c["after"][n]).abs()
                          - 2**-22 * c["after"][n].abs()).max()) / lr for n in c["after"])
    flat = lambda d, names: torch.cat([d[n].flatten() for n in names])
    names = list(c["after"])
    moves = rel_err(flat(g["after"], names) - flat(start, names),
                    flat(c["after"], names) - flat(start, names))
    flips = int(((flat(g["after"], names) - flat(c["after"], names)).abs() > lr).sum())
    gnames = list(c["grads"])
    res = {"loss_rel_err": loss_err, "grad_err_vs_f64_card": max(card_err.values()),
           "grad_err_vs_f64_cpu": max(cpu_err.values()), "worst_tensor": worst,
           "worst_card_cpu_err": (card_err[worst], cpu_err[worst]),
           "update_diff_over_lr_same_grads": upd_over, "cpu_own_vs_cotangent": own,
           "step_cotangent_rel_err": rel_err(g["cotangent"], c["cotangent"]),
           "step_grad_rel_err": rel_err(flat(g["grads"], gnames), flat(c["grads"], gnames)),
           "step_moves_rel_err": moves, "step_flipped_params": flips,
           "params": len(flat(start, names)),
           "repeat_bitwise": g["loss"] == g2["loss"] and all(
               torch.equal(g["grads"][n], g2["grads"][n]) for n in gnames),
           "s_cpu": s_cpu}
    log(f"train step {what}, card vs CPU ({s_cpu:.1f} s on the CPU): loss {g['loss']:.6g} "
        f"vs {c['loss']:.6g} (rel err {loss_err:.3g}, tol {STEP_LOSS_TOL}); gradients "
        f"from the CPU's dL/dpred against float64: card largest {res['grad_err_vs_f64_card']:.3g}, "
        f"CPU float32 largest {res['grad_err_vs_f64_cpu']:.3g}; tightest tensor {worst} card "
        f"{card_err[worst]:.3g} vs CPU {cpu_err[worst]:.3g} (tol {STEP_GRAD_TOL}x CPU + 1e-2; "
        f"the CPU's own backward against its dL/dpred backpropagated: {own:.3g}); update "
        f"from the CPU's gradients within {upd_over:.3g} lr (tol {STEP_UPDATE_TOL}). The whole "
        f"step: dL/dpred rel err {res['step_cotangent_rel_err']:.3g}, gradients "
        f"{res['step_grad_rel_err']:.3g}, moves {moves:.3g}, {flips} of {res['params']} "
        f"parameters more than lr apart; two card steps bit for bit equal: "
        f"{res['repeat_bitwise']}")
    if not (loss_err <= STEP_LOSS_TOL and over[worst] <= 1.0 and upd_over <= STEP_UPDATE_TOL):
        raise AssertionError(f"train step {what}: the card differs from the CPU")
    return res


def depth_fns(triplets, params):
    """(pred_fn, loss_fn) of the depth step with fixed triplets."""
    from omnidata_tpu_torch import train as T

    def loss_fn(pred, b, step):
        return T.depth_loss_fn(pred, b, step, triplets.to(pred.device), params)

    return (lambda net, b: net(b["rgb"])[:, 0]), loss_fn


def normal_fns():
    from omnidata_tpu_torch import train as T

    return (lambda net, b: net(b["rgb"])), (lambda pred, b, step: T.normal_loss_fn(pred, b))


def write_config(path: Path, cfg: dict) -> str:
    """A trainer config in the YAML subset the port reads."""
    from omnidata_tpu_torch.utils.config import dumps

    path.write_text(dumps(cfg))
    return str(path)


def trainer_runs(runs) -> list:
    """Each (module, args) as `python -m module args`, all at once ->
    their outputs; a non-zero exit fails with the output's tail."""
    procs = [subprocess.Popen([sys.executable, "-m", m, *a], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for m, a in runs]
    outs = []
    for (m, _), p in zip(runs, procs):
        text, _ = p.communicate(timeout=TRAINER_TIMEOUT_S)
        if p.returncode:
            print(text[-4000:], file=sys.stderr)
            raise AssertionError(f"{m} exited {p.returncode}")
        outs.append(text)
    return outs


def check_trained(what: str, out: str, ckpt: Path, loss_key: str, steps: int,
                  val_steps, size: int) -> dict:
    """Finite logged losses, the validation loss logged at val_steps, top-k
    scores on it, decodable validation images, 'last' at the final step."""
    import ast
    import math

    import torch

    from omnidata_tpu_torch.cues.encode import load_png

    logged = [ast.literal_eval(line.split(": ", 1)[1].rsplit(" (", 1)[0])
              for line in out.splitlines()
              if line.startswith("step ") and ": {" in line]
    if not logged or not all(math.isfinite(v) for m in logged for v in m.values()):
        raise AssertionError(f"{what}: logged losses {logged}")
    vals = [float(line.rsplit(" ", 1)[1]) for line in out.splitlines()
            if f": {loss_key} " in line]
    scores = json.loads((ckpt / "scores.json").read_text())
    if len(vals) != len(val_steps) or sorted(scores) != sorted(f"step_{s}" for s in val_steps):
        raise AssertionError(f"{what}: validation {vals}, scores {scores}")
    for s in val_steps:
        img = load_png(str(ckpt / "val_images" / f"step{s}_sample0.png"))
        if img.shape != (size, 3 * size, 3):
            raise AssertionError(f"{what}: validation image {img.shape}")
    last = torch.load(ckpt / "last" / "state.pt", map_location="cpu", weights_only=True)
    if int(last["step"]) != steps or int(last["opt_state"]["count"]) != steps:
        raise AssertionError(f"{what}: last at step {int(last['step'])}")
    s_step = [float(line.rsplit("(", 1)[1].split("s/step")[0]) for line in out.splitlines()
              if "s/step)" in line]
    log(f"{what}: {steps} steps, losses {[round(m['loss'], 5) for m in logged]}, "
        f"{loss_key} {vals}, scores {scores}, last at step {steps}; s/step as "
        f"logged {s_step}")
    return {"losses": [m["loss"] for m in logged], "val": vals, "s_per_step": s_step,
            "last": last}


def same_tree(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def trainers_end_to_end(bdir: str) -> dict:
    """16b: both trainers as users run them on phase 11's labels, then
    again with --resume."""
    tdir = CLI_DIR / "train"
    tdir.mkdir()
    common = {"val_fraction": 0.25, "augment": True, "num_workers": 8,
              "save_top_k": 2, "log_step": 2}
    depth_cfg = write_config(tdir / "depth.yml", {
        "image_size": DEPTH_RES, "batch_size": 8, "max_steps": 6, "val_step": 3,
        "ckpt_step": 3, "checkpoint_dir": str(tdir / "depth"), **common,
        "data_paths": {"bench": bdir}})
    normal_cfg = write_config(tdir / "normal.yml", {
        "model": "unet", "image_size": NORMAL_RES, "batch_size": 4, "max_steps": 6,
        "val_step": 3, "ckpt_step": 3, "checkpoint_dir": str(tdir / "normal"), **common,
        "data_paths": {"bench": bdir}})
    runs = [("omnidata_tpu_torch.train_depth", ["--config_file", depth_cfg]),
            ("omnidata_tpu_torch.train_normal", ["--config_file", normal_cfg])]
    t0 = time.perf_counter()
    outs = trainer_runs(runs)
    s_first = time.perf_counter() - t0
    res = {"depth": check_trained("train_depth", outs[0], tdir / "depth",
                                  "val_depth_loss", 6, (3, 6), DEPTH_RES),
           "normal": check_trained("train_normal", outs[1], tdir / "normal",
                                   "val_normal_loss", 6, (3, 6), NORMAL_RES)}
    t0 = time.perf_counter()
    outs = trainer_runs([(m, a + ["--resume"]) for m, a in runs])
    s_resume = time.perf_counter() - t0
    for (name, steps), out in zip((("depth", 6), ("normal", 6)), outs):
        if "resumed from" not in out or f"at step {steps}" not in out:
            raise AssertionError(f"train_{name} --resume: {out[-2000:]}")
        import torch

        again = torch.load(tdir / name / "last" / "state.pt", map_location="cpu",
                           weights_only=True)
        if not same_tree(again, res[name].pop("last")):
            raise AssertionError(f"train_{name} --resume changed 'last'")
    log(f"trainers end to end (depth and normal at once): {s_first:.1f} s; "
        f"again with --resume: {s_resume:.1f} s, each resumed at its last step "
        "and left 'last' equal bit for bit")
    return {**res, "s_first": s_first, "s_resume": s_resume}


def paeth_png(arr) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes with every row Paeth-filtered (filter 4),
    as encoders that choose filters per row often write them; the CLI's
    encoder writes filter 0."""
    import struct
    import zlib

    import numpy as np

    from omnidata_tpu_torch.cues.encode import _png_chunk

    H, W, C = arr.shape
    x = arr.reshape(H, W * C).astype(np.int16)
    a = np.pad(x, ((0, 0), (C, 0)))[:, :-C]  # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]  # up
    c = np.pad(b, ((0, 0), (C, 0)))[:, :-C]  # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = ((x - pred) & 255).astype(np.uint8)
    raw = np.concatenate([np.full((H, 1), 4, np.uint8), rows], 1)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _png_chunk(b"IEND", b""))


def decode_ms(bdir: str) -> dict:
    """ms to decode one of the CLI's 512² rgb PNGs (filter 0) and the same
    pixels Paeth-filtered (the decoder undoes Paeth pixel by pixel in
    Python)."""
    import glob

    import numpy as np

    from omnidata_tpu_torch.cues.encode import decode_png, encode_png

    rgb = decode_png(open(sorted(glob.glob(f"{bdir}/rgb/*.png"))[0], "rb").read())
    out = {}
    for name, data in (("filter0", encode_png(rgb)), ("paeth", paeth_png(rgb))):
        t0 = time.perf_counter()
        got = decode_png(data)
        out[name] = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(got, rgb):
            raise AssertionError(f"{name} PNG decodes to other pixels")
    return out


def cudnn_mode(mode: str) -> None:
    """'phase1': TF32 off, deterministic cuDNN (the script's setting);
    'defaults': what the trainers run with, torch's defaults (cuDNN may use
    TF32 and pick nondeterministic algorithms; matmuls stay float32)."""
    import torch

    torch.backends.cudnn.allow_tf32 = mode == "defaults"
    torch.backends.cudnn.deterministic = mode == "phase1"


def step_times(step, timed: int = TRAIN_TIMED) -> list:
    """ms of each of timed calls after TRAIN_WARMUP, by CUDA events."""
    import torch

    for _ in range(TRAIN_WARMUP):
        step()
    out = []
    for _ in range(timed):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        step()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def split_step(state, batch, gen, pred_fn, loss_fn, image_size: int, depth: bool) -> dict:
    """Device ms of one training step's parts, by CUDA events between them:
    augment, forward, loss, backward, optimizer."""
    import torch

    from omnidata_tpu_torch.augment import augment_batch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    b = augment_batch(batch, gen, image_size, normalize=depth)
    ev[1].record()
    pred = pred_fn(state.net, b)
    ev[2].record()
    loss, _ = loss_fn(pred, b, state.step)
    ev[3].record()
    loss.backward()
    ev[4].record()
    state.apply_gradients()
    ev[5].record()
    ev[5].synchronize()
    names = ("augment", "forward", "loss", "backward", "optimizer")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def profile_window(run, reps: int, top: int = 6) -> dict:
    """torch.profiler over reps calls of run: wall time, the kernels' busy
    time, the device's idle share, the kernels that take most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    kern = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {"wall_ms": wall_ms / reps, "kernel_ms": busy_ms / reps,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "launches": sum(e.count for e in events) // reps,
            "top": [{"kernel": e.key[:60], "ms": e.self_device_time_total / 1e3 / reps,
                     "launches": e.count // reps} for e in kern]}


def train_timings(dev, bdir: str, card: str) -> dict:
    """16c: the depth step (DPT, bs 8, 384²) before and after the switch in
    both cuDNN modes and the normal step (UNet, bs 16, 512²) with remat on
    and off in torch's defaults (the trainers' mode); img/s, FLOPs, share of
    peak, peak memory; the step split; the loader; the trainer loop's idle
    share."""
    import numpy as np
    import torch

    from omnidata_tpu_torch import train as T
    from omnidata_tpu_torch.data.loader import MixedLoader
    from omnidata_tpu_torch.losses import VNLParams, sample_triplets
    from omnidata_tpu_torch.models import DPTHybrid, UNet
    from omnidata_tpu_torch.models.registry import init_weights
    from omnidata_tpu_torch.train.driver import to_device

    res = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    vnl = VNLParams(1.0, 1.0, (DEPTH_RES, DEPTH_RES))
    configs = []  # (name, net factory, batch, step fn, optimizer, first step, size,
    # cuDNN modes: the first also times the parts and the profile window)
    dbatch = {k: v.to(dev) for k, v in
              train_batch(bdir, DEPTH_TASKS, DEPTH_RES, DEPTH_BS, False).items()}
    nbatch = {k: v.to(dev) for k, v in
              train_batch(bdir, NORMAL_TASKS, NORMAL_RES, NORMAL_BS, False).items()}

    def dpt_apply(net, rgb):
        return net(rgb)[:, 0]

    def unet_apply(net, rgb):
        return net(rgb)

    for sched, step0 in (("ssi_only", 0), ("full_loss", T.SSI_ONLY_STEPS + 1)):
        configs.append((f"dpt_depth_bs{DEPTH_BS}_{sched}", lambda: DPTHybrid(num_channels=1),
                        dbatch, T.make_depth_train_step(dpt_apply, vnl, True, DEPTH_RES),
                        T.depth_optimizer(1e-5), step0, DEPTH_RES, ("phase1", "defaults")))
    for remat in (True, False):
        configs.append((f"unet_normal_bs{NORMAL_BS}_remat_{'on' if remat else 'off'}",
                        lambda r=remat: UNet(out_channels=3, downsample=6, remat=r),
                        nbatch, T.make_normal_train_step(unet_apply, True, NORMAL_RES),
                        T.normal_optimizer(1e-4), 0, NORMAL_RES, ("defaults",)))
    for name, make, batch, step_fn, tx, step0, size, modes in configs:
        net = make()
        init_weights(net, torch.Generator().manual_seed(0))
        net = net.to(dev)
        fwd_flops = model_flops(net, torch.zeros(1, 3, size, size, device=dev))
        state = T.create_train_state(net, tx)
        state.step = step0
        entry = {"train_gflop_per_image": 3 * fwd_flops / 1e9}
        for mode in modes:
            cudnn_mode(mode)
            torch.cuda.reset_peak_memory_stats(dev)
            ms = step_times(lambda: step_fn(state, batch, gen))
            med = statistics.median(ms)
            bs = batch["rgb"].shape[0]
            ips = bs / (med / 1e3)
            entry[mode] = {"ms_median": med, "ms_min": min(ms), "ms_max": max(ms),
                           "img_s": ips, "share_of_fp32_peak": ips * 3 * fwd_flops / 67e12,
                           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
            log(f"train step {name} at {size}², cuDNN {mode}: {med:.1f} ms (min "
                f"{min(ms):.1f}, max {max(ms):.1f}; {TRAIN_TIMED} steps after "
                f"{TRAIN_WARMUP}) = {ips:.2f} img/s; {3 * fwd_flops / 1e9:.1f} GFLOP "
                f"a training image (3x forward) = {ips * 3 * fwd_flops / 1e12:.2f} "
                f"TFLOP/s = {ips * 3 * fwd_flops / 67e12:.3f} of 67 TFLOP/s; peak "
                f"{entry[mode]['peak_gib']:.2f} GiB; card {card}")
        cudnn_mode(modes[0])
        depth = name.startswith("dpt")
        fns = depth_fns(sample_triplets(gen, vnl, dev), vnl) if depth else normal_fns()
        parts = [split_step(state, batch, gen, *fns, size, depth) for _ in range(3)][1:]
        entry["split_ms"] = {k: statistics.mean(p[k] for p in parts) for k in parts[0]}
        entry["profile"] = profile_window(lambda: step_fn(state, batch, gen), 2)
        cudnn_mode("phase1")
        log(f"train step {name}, parts (device ms, cuDNN {modes[0]}): " + ", ".join(
            f"{k} {v:.1f}" for k, v in entry["split_ms"].items()) + "; profile: "
            f"wall {entry['profile']['wall_ms']:.1f} ms, kernels "
            f"{entry['profile']['kernel_ms']:.1f} ms, idle share "
            f"{entry['profile']['idle_share']:.3f}; top kernels: " + "; ".join(
                f"{t['kernel']} {t['ms']:.1f} x{t['launches']}"
                for t in entry["profile"]["top"]))
        res[name] = entry
        del state, net
        torch.cuda.empty_cache()

    # the loader: one thread's decode + PIL-equal resize, and 8 threads
    ds = bench_dataset(bdir, DEPTH_TASKS, DEPTH_RES)
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds.item(i, i)
    ms_sample = (time.perf_counter() - t0) * 1e3 / len(ds)
    loader = MixedLoader([ds], DEPTH_BS, num_workers=8)
    stamps = []
    for _ in loader.batches(steps=12, seed=0):
        stamps.append(time.perf_counter())
    ms_batch = (stamps[-1] - stamps[1]) * 1e3 / (len(stamps) - 2)
    png_ms = decode_ms(bdir)
    res["loader"] = {"ms_per_sample_one_thread": ms_sample, "ms_per_batch_8_threads": ms_batch,
                     "decode_ms_rgb512": png_ms}
    log(f"loader (rgb, depth, mask PNGs at 512² -> {DEPTH_RES}²): {ms_sample:.1f} ms a "
        f"sample on one thread; {ms_batch:.1f} ms a batch of {DEPTH_BS} with 8 threads "
        f"(the depth step takes {res[f'dpt_depth_bs{DEPTH_BS}_ssi_only']['defaults']['ms_median']:.1f} "
        f"ms); decoding one 512² rgb PNG: {png_ms['filter0']:.1f} ms as the CLI writes "
        f"it (filter 0), {png_ms['paeth']:.1f} ms Paeth-filtered")

    # the trainer's loop at steady state: loader, host-to-card copy, step
    cudnn_mode("defaults")
    net = DPTHybrid(num_channels=1)
    init_weights(net, torch.Generator().manual_seed(0))
    state = T.create_train_state(net.to(dev), T.depth_optimizer(1e-5))
    step_fn = T.make_depth_train_step(dpt_apply, vnl, True, DEPTH_RES)
    batches = MixedLoader([ds], DEPTH_BS, num_workers=8).batches(steps=12, seed=1)

    def loop_step():
        b = next(batches)
        step_fn(state, to_device({"rgb": b["rgb"].astype(np.float32),
                                  "depth": b["depth_zbuffer"].astype(np.float32),
                                  "mask_valid": b["mask_valid"] > 0.5}, dev), gen)

    for _ in range(4):
        loop_step()
    res["trainer_loop"] = profile_window(loop_step, 6)
    cudnn_mode("phase1")
    log(f"trainer loop (depth, bs {DEPTH_BS}, loader + copy + step, torch defaults): "
        f"{res['trainer_loop']['wall_ms']:.1f} ms a step, kernels "
        f"{res['trainer_loop']['kernel_ms']:.1f} ms, device idle share "
        f"{res['trainer_loop']['idle_share']:.3f}")
    del state, net
    torch.cuda.empty_cache()
    return res


def phase_train(dev, card: str, bdir: str) -> dict:
    """Phase 16: training on phase 11's labels (see the module doc)."""
    checks = train_checks(dev, bdir)
    # 16b. the trainers, annotate -> train, then resume
    trainers = trainers_end_to_end(bdir)
    # 16c. times
    times = train_timings(dev, bdir, card)
    return {"checks": checks, "trainers": trainers, "times": times}


def train_checks(dev, bdir: str) -> dict:
    """16a: the depth and normal steps, card against CPU, TF32 off."""
    import torch

    from omnidata_tpu_torch import train as T
    from omnidata_tpu_torch.losses import VNLParams, sample_triplets
    from omnidata_tpu_torch.models import DPTHybrid, UNet
    from omnidata_tpu_torch.models.registry import init_weights

    checks = {}
    net = DPTHybrid(num_channels=1)
    init_weights(net, torch.Generator().manual_seed(0))
    batch = train_batch(bdir, DEPTH_TASKS, DEPTH_RES, 1, True)
    vnl = VNLParams(1.0, 1.0, (DEPTH_RES, DEPTH_RES))
    triplets = sample_triplets(torch.Generator().manual_seed(1), vnl)
    for sched, step in (("ssi_only", 0), ("full_loss", T.SSI_ONLY_STEPS + 1)):
        checks[f"dpt_depth_{sched}"] = step_card_vs_cpu(
            f"DPT depth {DEPTH_RES}² bs 1 {sched}", dev, net, T.depth_optimizer(1e-5),
            *depth_fns(triplets, vnl), batch, step)
    # remat off: the same values (tests/test_torch_train.py), less CPU time;
    # batch 1 (GroupNorm couples no images), as the DPT's
    net = UNet(out_channels=3, downsample=6)
    init_weights(net, torch.Generator().manual_seed(0))
    checks["unet_normal"] = step_card_vs_cpu(
        f"UNet normal {NORMAL_RES}² bs 1", dev, net, T.normal_optimizer(1e-4), *normal_fns(),
        train_batch(bdir, NORMAL_TASKS, NORMAL_RES, 1, False), 0)
    return checks


# ---- 17. evaluation, multi-task training, HRNet -----------------------------

EVAL_IMAGES = 4  # the images each eval run scores (--max_batches 1 --batch_size 4)
EVAL_RES = 384  # the eval drivers' default --image_size
EVAL_RTOL, EVAL_MEDIAN_ATOL = 1e-3, 0.05  # card vs CPU: metrics relative, medians in degrees
# the shares of pixels within 11.25/22.5/30 degrees count pixels: one pixel
# whose angle moves across a threshold by float32 rounding moves a share by
# 1 / 590k on 4 images, more than 1e-3 of a share of 0.001; 1e-5 is 6 pixels
EVAL_SHARE_ATOL = 1e-5
EVAL_TIMEOUT_S = 300
MT_ARCHS = ("multitask", "mtan", "padnet", "crossstitch")
MT_RES, MT_BS, MT_STEPS, MT_BALANCE = 256, 4, 6, 2  # train_multitask's defaults, 6 steps
MT_LOSS_TOL = 1e-3  # |card - CPU| / |CPU| of one step's losses, TF32 off
HRNET_VARIANTS = ("w18", "w48")
HRNET_RES, HRNET_CHECK_RES, HRNET_BATCHES, HRNET_REPS = 513, 129, (1, 4), 3
HRNET_TOL = 1e-3  # max |card - CPU| / max |CPU|, float32 without TF32


def oasis_fixture(bdir: str, out: Path, n: int) -> str:
    """An OASIS-layout CSV over the first n of phase 11's views: each rgb
    PNG as the image, its normal PNG decoded to [-1, 1] with z flipped into
    OASIS's frame (z toward the viewer) as the ROI pickle, the ROI a box
    inset by 1/8 of each side, pixels without a valid label zero (masked)."""
    import pickle

    import numpy as np

    from omnidata_tpu_torch.cues.encode import load_png

    out.mkdir(parents=True, exist_ok=True)
    rows = ["Image,unused1,unused2,Normal"]
    names = sorted(os.listdir(os.path.join(bdir, "rgb")))[:n]
    for i, name in enumerate(names):
        shutil.copy(os.path.join(bdir, "rgb", name), out / f"im{i}.png")
        stem = name.replace("_domain_rgb.png", "")
        normal = load_png(os.path.join(bdir, "normal", f"{stem}_domain_normal.png"))
        valid = load_png(os.path.join(bdir, "mask_valid", f"{stem}_domain_mask_valid.png"))
        n3 = normal[..., :3].astype(np.float32) / 255.0 * 2.0 - 1.0
        n3[..., 2] *= -1.0
        n3[valid == 0] = 0.0
        H, W = n3.shape[:2]
        y0, y1, x0, x1 = H // 8, H - H // 8 - 1, W // 8, W - W // 8 - 1
        with open(out / f"n{i}.pkl", "wb") as fh:
            pickle.dump({"min_y": y0, "max_y": y1, "min_x": x0, "max_x": x1,
                         "normal": n3[y0:y1 + 1, x0:x1 + 1]}, fh)
        rows.append(f"im{i}.png,,,n{i}.pkl")
    (out / "oasis.csv").write_text("\n".join(rows) + "\n")
    return str(out / "oasis.csv")


def run_in_process(main, argv: list) -> dict:
    """An entry point's main in this process, its JSON stdout parsed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue())


def eval_runs(bdir: str, depth_ckpt: str, normal_ckpt: str, oasis_csv: str) -> dict:
    """name -> (module, argv) of each eval run phase 17 checks."""
    four = ["--max_batches", "1", "--batch_size", str(EVAL_IMAGES), "--image_size",
            str(EVAL_RES)]
    data = ["--data_path", bdir] + four
    oasis = ["--oasis_csv", oasis_csv, "--oasis_root", str(Path(oasis_csv).parent)] + four
    runs = {f"eval_depth align {a}": ("eval_depth", data + ["--checkpoint", depth_ckpt,
                                                           "--align", a])
            for a in ("none", "ssi")}
    # seeded weights as well: from this seed the trained checkpoint's depth
    # goes to all zeros within a few steps, which the scale-shift alignment
    # leaves as it is. JAX's trainer does the same from the same weights
    # (tests/depth_collapse_experiment.py; tests/test_torch_train_collapse.py
    # pins the dead head)
    runs["eval_depth seeded align ssi"] = ("eval_depth", data + ["--align", "ssi"])
    for model, ck in (("dpt", []), ("unet", ["--checkpoint", normal_ckpt])):
        runs[f"eval_normal {model}"] = ("eval_normal", data + ["--model", model] + ck)
        for tta in ([], ["--tta"]):
            runs[f"eval_normal {model} oasis{' tta' if tta else ''}"] = (
                "eval_normal", oasis + ["--model", model] + ck + tta)
    return runs


def check_eval(name: str, got: dict, want: dict) -> float:
    """Finite metrics, the card's within EVAL_RTOL of the CPU's (medians
    within EVAL_MEDIAN_ATOL degrees, shares of pixels within EVAL_RTOL or
    EVAL_SHARE_ATOL) -> the largest relative difference."""
    import math

    worst = 0.0
    if set(got) != set(want) or not all(math.isfinite(v) for v in got.values()):
        raise AssertionError(f"{name}: card {got}, CPU {want}")
    for k, v in want.items():
        d = abs(got[k] - v)
        if "median" in k or k == "MDAE":
            ok = d <= EVAL_MEDIAN_ATOL
        elif k.startswith("percentage_within") or k in ("11.25", "22.5", "30"):
            ok = d <= max(EVAL_RTOL * abs(v), EVAL_SHARE_ATOL)
        else:
            ok = d <= EVAL_RTOL * abs(v) + 1e-9
        if not ok:
            raise AssertionError(f"{name}: {k} card {got[k]!r} vs CPU {v!r}")
        worst = max(worst, d / max(abs(v), 1e-12))
    return worst


def phase_eval(dev, card: str, bdir: str) -> dict:
    """17a: the eval drivers as subprocesses on the card (TF32 off through
    NVIDIA_TF32_OVERRIDE=0) against the same runs on the CPU in this
    process; then eval_depth in this process on all of phase 11's views,
    its forwards timed by CUDA events: img/s and the loop's idle share."""
    import torch

    from omnidata_tpu_torch import eval_depth, eval_normal
    from omnidata_tpu_torch import models as M

    tdir = CLI_DIR / "train"
    best = {}
    for name in ("depth", "normal"):
        scores = json.loads((tdir / name / "scores.json").read_text())
        best[name] = str(tdir / name / min(scores, key=scores.get))
    csv = oasis_fixture(bdir, CLI_DIR / "oasis", EVAL_IMAGES)
    runs = eval_runs(bdir, best["depth"], best["normal"], csv)
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen([sys.executable, "-m", f"omnidata_tpu_torch.{m}", *a],
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for n, (m, a) in runs.items()}
    try:
        t1 = time.perf_counter()
        mains = {"eval_depth": eval_depth.main, "eval_normal": eval_normal.main}
        want = {n: run_in_process(mains[m], a + ["--device", "cpu"])
                for n, (m, a) in runs.items()}
        s_cpu = time.perf_counter() - t1
        got = {}
        for n, p in procs.items():
            out, err = p.communicate(timeout=EVAL_TIMEOUT_S)
            if p.returncode:
                print(err[-4000:], file=sys.stderr)
                raise AssertionError(f"{n} exited {p.returncode}")
            got[n] = json.loads(out)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    s_card = time.perf_counter() - t0
    res = {"checkpoints": best, "runs": {}}
    for n in runs:
        worst = check_eval(n, got[n], want[n])
        res["runs"][n] = {"card": got[n], "cpu": want[n], "max_rel_diff": worst}
        log(f"{n} ({EVAL_IMAGES} images): card {json.dumps(got[n])}; largest "
            f"relative difference from the CPU {worst:.3g}")
    log(f"eval runs: {len(runs)} subprocesses on the card at once, {s_card:.1f} s; "
        f"the same runs on the CPU in this process {s_cpu:.1f} s")

    # eval_depth's loop on the card, torch's defaults (as a user runs it)
    fwd_ms, marks = [], {}
    create = M.create_model

    def timed_model(*args, **kw):
        model = create(*args, **kw)

        def run(x):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            y = model(x)
            e1.record()
            fwd_ms.append((e0, e1))
            return y

        marks["start"] = time.perf_counter()  # the model built: the loop starts
        return run

    cudnn_mode("defaults")
    n_views = len(os.listdir(os.path.join(bdir, "rgb")))
    M.create_model = timed_model
    try:
        res["timing"] = {}
        for rep in range(2):  # the first run warms cuDNN's autotuner up
            fwd_ms.clear()
            marks.clear()
            run_in_process(eval_depth.main, ["--data_path", bdir, "--checkpoint",
                                             best["depth"], "--batch_size", "8",
                                             "--image_size", str(EVAL_RES)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - marks["start"]
        busy = sum(e0.elapsed_time(e1) for e0, e1 in fwd_ms) / 1e3
    finally:
        M.create_model = create
        cudnn_mode("phase1")
    res["timing"] = {"images": n_views, "s_loop": wall, "img_s": n_views / wall,
                     "forward_ms": busy * 1e3 / len(fwd_ms),
                     "idle_share": max(0.0, 1 - busy / wall)}
    log(f"eval_depth loop on the card ({n_views} views at {EVAL_RES}², batch 8, "
        f"torch defaults): {res['timing']['img_s']:.2f} img/s, {wall:.2f} s once the "
        f"model was built (data loading, forwards, metrics); forwards {busy:.3f} s by CUDA events, device idle share "
        f"{res['timing']['idle_share']:.3f}; card {card}")
    return res


def mt_batch(bdir: str) -> dict:
    """The first MT_BS of phase 11's views at MT_RES as train_multitask's
    batch (CPU tensors)."""
    import torch

    from omnidata_tpu_torch.train_multitask import to_batch

    ds = bench_dataset(bdir, ("rgb", "depth_zbuffer", "normal", "mask_valid"), MT_RES)
    return to_batch(next(ds.batches(MT_BS, shuffle=False)), torch.device("cpu"))


def check_multitask_log(arch: str, out: str) -> list:
    """train_multitask's lines: GradNorm at every MT_BALANCE steps with
    finite losses and weights summing to 2, then 'done'; the GradNorm
    updates it skipped (non-finite weights) are logged."""
    import ast
    import math

    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    want_steps = list(range(MT_BALANCE, MT_STEPS + 1, MT_BALANCE))
    logged = []
    for ln in lines:
        losses = ast.literal_eval(ln.split("losses=", 1)[1].split(" weights=")[0])
        weights = ast.literal_eval(ln.split("weights=", 1)[1].rsplit(" (", 1)[0])
        logged.append({"step": int(ln.split(":")[0][5:]), "losses": losses,
                       "weights": weights})
    skipped = [ln for ln in out.splitlines() if ln.startswith("GradNorm at step ")]
    for ln in skipped:
        log(f"train_multitask --arch {arch}: {ln}")
    if [m["step"] for m in logged] != want_steps or f"done: {MT_STEPS} steps" not in out \
            or not all(math.isfinite(v) for m in logged for v in m["losses"].values()) \
            or not all(abs(sum(m["weights"].values()) - 2.0) <= 1e-5 for m in logged):
        raise AssertionError(f"train_multitask --arch {arch}: {out[-2000:]}")
    return logged


def phase_multitask(dev, card: str, bdir: str) -> dict:
    """17b: train_multitask for each architecture as a subprocess (all at
    once), one step's losses on the card against the CPU (TF32 off), and
    step times by CUDA events in torch's defaults."""
    import copy

    import torch

    from omnidata_tpu_torch import train_multitask as tm
    from omnidata_tpu_torch.train.state import Optimizer, create_train_state

    t0 = time.perf_counter()
    procs = {a: subprocess.Popen(
        [sys.executable, "-m", "omnidata_tpu_torch.train_multitask", "--data_path", bdir,
         "--arch", a, "--max_steps", str(MT_STEPS), "--balance_every", str(MT_BALANCE)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a in MT_ARCHS}
    res = {}
    try:
        batch = mt_batch(bdir)
        w = {"depth_zbuffer": 1.0, "normal": 1.0}
        for arch in MT_ARCHS:
            net = tm.build_model(arch)
            cpu_l, card_l = ({k: float(v) for k, v in tm.train_step(
                create_train_state(copy.deepcopy(net).to(d), Optimizer(lr=1e-4)),
                {k: v.to(d) for k, v in batch.items()}, w).items()}
                for d in (torch.device("cpu"), dev))
            err = max(abs(card_l[k] - v) / abs(v) for k, v in cpu_l.items())
            if not err <= MT_LOSS_TOL:
                raise AssertionError(f"{arch}: step losses card {card_l} CPU {cpu_l}")
            res[arch] = {"losses_card": card_l, "losses_cpu": cpu_l, "loss_rel_diff": err}
        outs = {}
        for a, p in procs.items():
            outs[a], _ = p.communicate(timeout=TRAINER_TIMEOUT_S)
            if p.returncode:
                print(outs[a][-4000:], file=sys.stderr)
                raise AssertionError(f"train_multitask --arch {a} exited {p.returncode}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    s_runs = time.perf_counter() - t0
    for arch in MT_ARCHS:
        res[arch]["log"] = check_multitask_log(arch, outs[arch])
        log(f"train_multitask --arch {arch}: {MT_STEPS} steps, GradNorm "
            f"{[(m['step'], {k: round(v, 4) for k, v in m['weights'].items()}) for m in res[arch]['log']]}; "
            f"one step's losses card vs CPU within {res[arch]['loss_rel_diff']:.3g} "
            f"(tol {MT_LOSS_TOL})")
    log(f"train_multitask, the {len(MT_ARCHS)} architectures at once as subprocesses "
        f"(with the checks above): {s_runs:.1f} s")

    cudnn_mode("defaults")
    try:
        db = {k: v.to(dev) for k, v in batch.items()}
        for arch in MT_ARCHS:
            net = tm.build_model(arch).to(dev)
            fwd = model_flops(net, torch.zeros(1, 3, MT_RES, MT_RES, device=dev))
            st = create_train_state(net, Optimizer(lr=1e-4))
            torch.cuda.reset_peak_memory_stats(dev)
            ms = step_times(lambda: tm.train_step(st, db, w))
            med = statistics.median(ms)
            ips = MT_BS / (med / 1e3)
            res[arch].update(ms_median=med, ms_min=min(ms), ms_max=max(ms), img_s=ips,
                             train_gflop_per_image=3 * fwd / 1e9,
                             share_of_fp32_peak=ips * 3 * fwd / PEAK_FLOPS["float32"],
                             peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
            log(f"train_multitask step {arch}, batch {MT_BS} at {MT_RES}², torch "
                f"defaults: {med:.2f} ms (min {min(ms):.2f}, max {max(ms):.2f}; "
                f"{TRAIN_TIMED} after {TRAIN_WARMUP}) = {ips:.1f} img/s; "
                f"{3 * fwd / 1e9:.1f} GFLOP a training image = "
                f"{res[arch]['share_of_fp32_peak']:.3f} of 67 TFLOP/s; peak "
                f"{res[arch]['peak_gib']:.2f} GiB; card {card}")
            del st, net
            torch.cuda.empty_cache()
    finally:
        cudnn_mode("phase1")
    return res


def phase_hrnet(dev, card: str) -> dict:
    """17c: HRNet-W18 and W48 through create_model: card against CPU at
    HRNET_CHECK_RES² (float32, TF32 off); forwards at HRNET_RES², batch 1
    and 4, float32 (TF32 off) and bfloat16, with phase 1's deterministic
    cuDNN and autotuned, by CUDA events."""
    import torch

    from omnidata_tpu_torch.models import create_model

    res = {}
    gen = torch.Generator().manual_seed(0)
    xc = torch.rand(1, 3, HRNET_CHECK_RES, HRNET_CHECK_RES, generator=gen)
    for v in HRNET_VARIANTS:
        name = f"hrnet_{v}"
        cpu = create_model(name, device="cpu")
        with torch.no_grad():
            want = cpu(xc)
            got = cpu.to(dev)(xc.to(dev)).cpu()
        del cpu
        err = float((got - want).abs().max()) / float(want.abs().max())
        if not err <= HRNET_TOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: card vs CPU {err} at {HRNET_CHECK_RES}²")
        res[name] = {"check_rel_err": err}
        log(f"{name} f32 at {HRNET_CHECK_RES}²: card vs CPU max |diff| / max |CPU| = "
            f"{err:.3g} (tol {HRNET_TOL})")
        for dtype in ("float32", "bfloat16"):
            model = create_model(name, device=dev, dtype=dtype)
            fwd = model_flops(model, torch.zeros(1, 3, HRNET_RES, HRNET_RES, device=dev))
            for mode in ("deterministic", "benchmark"):  # phase 1's cuDNN; autotuned
                torch.backends.cudnn.deterministic = mode == "deterministic"
                torch.backends.cudnn.benchmark = mode == "benchmark"
                for bs in HRNET_BATCHES:
                    x = torch.rand(bs, 3, HRNET_RES, HRNET_RES, generator=gen).to(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    with torch.no_grad():
                        y = model(x)  # warm-up (and the autotuner's search)
                        if y.shape != (bs, 21, HRNET_RES, HRNET_RES) or \
                                not bool(torch.isfinite(y).all()):
                            raise AssertionError(f"{name} {dtype}: output {tuple(y.shape)}")
                        ms = [cuda_ms(lambda: model(x), 4) for _ in range(HRNET_REPS)]
                    med = statistics.median(ms)
                    ips = bs / (med / 1e3)
                    e = {"ms_median": med, "ms_min": min(ms), "ms_max": max(ms),
                         "img_s": ips, "gflop_per_image": fwd / 1e9,
                         "share_of_peak": ips * fwd / PEAK_FLOPS[dtype],
                         "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
                    res[name][f"{dtype}_bs{bs}_{mode}"] = e
                    log(f"{name} {dtype} at {HRNET_RES}², batch {bs}, cuDNN {mode}: "
                        f"{med:.2f} ms (min {min(ms):.2f}, max {max(ms):.2f}; {HRNET_REPS} "
                        f"reps of 4) = {ips:.1f} img/s; {fwd / 1e9:.1f} GFLOP an image = "
                        f"{e['share_of_peak']:.3f} of {PEAK_FLOPS[dtype] / 1e12:.0f} "
                        f"TFLOP/s; peak {e['peak_gib']:.2f} GiB; card {card}")
            torch.backends.cudnn.benchmark = False
            torch.backends.cudnn.deterministic = True
            del model
            torch.cuda.empty_cache()
    return res


def phase_eval_multitask(dev, card: str, bdir: str) -> dict:
    """Phase 17 (see the module doc)."""
    t0 = time.perf_counter()
    res = {"eval": phase_eval(dev, card, bdir),
           "multitask": phase_multitask(dev, card, bdir),
           "hrnet": phase_hrnet(dev, card)}
    res["s_phase"] = time.perf_counter() - t0
    log(f"phase 17: {res['s_phase']:.1f} s")
    return res


# ---- 18. MiDaS v2.1 and the refocus augmentation ----------------------------

MIDAS_CELLS = (("midas_v21", 384), ("midas_v21_small", 256))  # hub names, their sizes
MIDAS_CHECK_RES = 128
MIDAS_BATCHES = (1, 8, 16)
MIDAS_REPS = 3
MIDAS_TOL = 1e-3  # max |card - CPU| / max |CPU|, float32 without TF32
REFOCUS_PAIRS = 4
REFOCUS_RES = 512  # the demo's transforms' size
REFOCUS_BATCHES = (1, 8)
REFOCUS_QUANTILES = (10, 8)  # the demo's default, the function's
REFOCUS_REPS = 5
REFOCUS_TIMEOUT_S = 300


def midas_card_vs_cpu(net, x, dev) -> float:
    """max |card - CPU| / max |CPU| of net (on the CPU, moved to dev) on x;
    the outputs must be finite and non-negative."""
    import torch

    with torch.no_grad():
        want = net(x)
        got = net.to(dev)(x.to(dev)).cpu()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) or \
            float(got.min()) < 0:
        raise AssertionError(f"output {tuple(got.shape)}, min {float(got.min())}")
    return float((got - want).abs().max()) / float(want.abs().max())


def phase_midas(dev, card: str) -> dict:
    """18a, 18b: midas_v21 at 384² and midas_v21_small at 256² through
    create_model, seeded: card against CPU at MIDAS_CHECK_RES²; the large
    net on midas_transform_v21 of a seeded 640x480 image, MidasNetSmall
    card against CPU at 64²; forwards at batch 1, 8, 16 with deterministic
    and autotuned cuDNN (float32, TF32 off), by CUDA events."""
    import numpy as np
    import torch

    from omnidata_tpu_torch.models import MidasNetSmall, create_model, midas_transform_v21
    from omnidata_tpu_torch.models.registry import init_weights

    res = {}
    gen = torch.Generator().manual_seed(0)
    for name, size in MIDAS_CELLS:
        base = torch.cuda.memory_allocated(dev)  # earlier phases' tensors
        cpu = create_model(name, device="cpu")
        xc = torch.rand(1, 3, MIDAS_CHECK_RES, MIDAS_CHECK_RES, generator=gen)
        err = midas_card_vs_cpu(cpu, xc, dev)
        model = cpu
        log(f"{name} f32 at {MIDAS_CHECK_RES}²: card vs CPU max |diff| / max |CPU| = "
            f"{err:.3g} (tol {MIDAS_TOL})")
        if not err <= MIDAS_TOL:
            raise AssertionError(f"{name}: the card's float32 output differs from the CPU")
        e = {"check_rel_err": err}
        if name == "midas_v21":
            img = np.random.RandomState(0).rand(480, 640, 3).astype(np.float32)
            xt = torch.from_numpy(midas_transform_v21()({"image": img})["image"])[None]
            with torch.no_grad():
                yt = model(xt.to(dev))
            if tuple(xt.shape) != (1, 3, 288, 384) or tuple(yt.shape) != (1, 288, 384) \
                    or not bool(torch.isfinite(yt).all()):
                raise AssertionError(f"transformed 640x480: {tuple(xt.shape)} -> "
                                     f"{tuple(yt.shape)}")
            log(f"{name} on midas_transform_v21 of a 640x480 image: input "
                f"{tuple(xt.shape)}, depth {tuple(yt.shape)}, finite")
        else:
            small = MidasNetSmall()
            init_weights(small, torch.Generator().manual_seed(0))
            e["midas_net_small_rel_err"] = midas_card_vs_cpu(
                small.eval(), torch.rand(1, 3, 64, 64, generator=gen), dev)
            log(f"MidasNetSmall f32 at 64²: card vs CPU {e['midas_net_small_rel_err']:.3g} "
                f"(tol {MIDAS_TOL})")
            if not e["midas_net_small_rel_err"] <= MIDAS_TOL:
                raise AssertionError("MidasNetSmall: the card differs from the CPU")
            del small
        fwd = model_flops(model, torch.zeros(1, 3, size, size, device=dev))
        e["gflop_per_image"] = fwd / 1e9
        for mode in ("deterministic", "benchmark"):  # phase 1's cuDNN; autotuned
            torch.backends.cudnn.deterministic = mode == "deterministic"
            torch.backends.cudnn.benchmark = mode == "benchmark"
            for bs in MIDAS_BATCHES:
                x = torch.rand(bs, 3, size, size, generator=gen).to(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                iters = max(2, 8 // bs)
                with torch.no_grad():
                    y = model(x)  # warm-up (and the autotuner's search)
                    if tuple(y.shape) != (bs, size, size) or not bool(torch.isfinite(y).all()):
                        raise AssertionError(f"{name}: output {tuple(y.shape)}")
                    ms = [cuda_ms(lambda: model(x), iters) for _ in range(MIDAS_REPS)]
                med = statistics.median(ms)
                ips = bs / (med / 1e3)
                t = {"ms_median": med, "ms_min": min(ms), "ms_max": max(ms), "img_s": ips,
                     "img_s_min": bs / (max(ms) / 1e3), "img_s_max": bs / (min(ms) / 1e3),
                     "share_of_peak": ips * fwd / PEAK_FLOPS["float32"],
                     "peak_gib": (torch.cuda.max_memory_allocated(dev) - base) / 2**30}
                e[f"bs{bs}_{mode}"] = t
                log(f"{name} f32 at {size}², batch {bs}, cuDNN {mode}: {med:.2f} ms "
                    f"(min {min(ms):.2f}, max {max(ms):.2f}; {MIDAS_REPS} reps of {iters}) = "
                    f"{ips:.1f} img/s; {fwd / 1e9:.2f} GFLOP an image = "
                    f"{t['share_of_peak']:.3f} of 67 TFLOP/s; peak {t['peak_gib']:.2f} GiB "
                    f"(weights and activations); "
                    f"card {card}")
        x = torch.rand(MIDAS_BATCHES[-1], 3, size, size, generator=gen).to(dev)
        with torch.no_grad():
            e["profile"] = profile_window(lambda: model(x), 3)
        r = e["profile"]
        log(f"{name} profile (batch {MIDAS_BATCHES[-1]}, autotuned, 3 forwards): wall "
            f"{r['wall_ms']:.2f} ms, kernels {r['kernel_ms']:.2f} ms, idle share "
            f"{r['idle_share']:.3f}; top kernels (ms a forward, launches): " + "; ".join(
                f"{k['kernel']} {k['ms']:.2f} x{k['launches']}" for k in r["top"]))
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        res[name] = e
        del model, cpu, x
        torch.cuda.empty_cache()
    return res


def refocus_work(n_quantiles: int, res: int, max_cutoff: int = 61) -> tuple:
    """(FP32 operations, bytes) of one image's refocus: the two blur passes
    over 3 channels x (n_quantiles + 1) levels (the vertical one on the
    padded width), a multiply and an add a tap; rgb and depth read once,
    the image written once."""
    pad = res + max_cutoff - 1
    taps = 3 * (n_quantiles + 1) * max_cutoff * (res * pad + res * res)
    return 2.0 * taps, (3 + 1 + 3) * 4.0 * res * res


def phase_refocus(dev, card: str, bdir: str) -> dict:
    """18c: ``python -m omnidata_tpu_torch.demo_refocus`` on the card over
    REFOCUS_PAIRS of phase 11's rgb / depth_euclidean pairs: its PNGs
    against the CPU's refocus_image at the same draws; refocus_augmentation
    timed at 512², batch 1 and 8."""
    import numpy as np
    import torch

    from omnidata_tpu_torch import demo_refocus as dr
    from omnidata_tpu_torch.augment import (
        compute_quantiles,
        refocus_augmentation,
        refocus_draws,
        refocus_image,
    )

    rdir = CLI_DIR / "refocus"
    inp, out = rdir / "in", rdir / "out"
    inp.mkdir(parents=True)
    rgbs = sorted(Path(bdir, "rgb").glob("*.png"))[:REFOCUS_PAIRS]
    for f in rgbs:
        shutil.copy(f, inp)
        shutil.copy(Path(bdir, "depth_euclidean", f.name.replace("rgb", "depth_euclidean")), inp)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "omnidata_tpu_torch.demo_refocus", "--input_path", str(inp),
         "--output_path", str(out), "--seed", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=REFOCUS_TIMEOUT_S)
    s_demo = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-4000:], file=sys.stderr)
        raise AssertionError(f"demo_refocus exited {proc.returncode}")
    gen = torch.Generator().manual_seed(0)
    pairs, steps, exact, off, off_no_tf32 = [], [], 0, [], []
    for f in sorted(inp.glob("*rgb*.png")):
        rgb, depth = dr.load_pair(str(f), str(inp / f.name.replace("rgb", "depth_euclidean")))
        f_idx, aperture = refocus_draws(1, gen, 10, 0.001, 6.0)
        args = [torch.from_numpy(rgb), torch.from_numpy(depth)]
        qv = compute_quantiles(args[1], 10)
        args += [torch.gather(qv, 1, f_idx), aperture, qv]
        want = dr.to_png_u8(refocus_image(*args)[0])
        got = load_output(str(out / f"{f.stem}_refocused.png"))
        diff = np.abs(got.astype(np.int64) - want)
        step = int(diff.max())
        steps.append(step)
        off.append(float((diff > 0).mean()))
        # the same on the card in this process (TF32 off)
        here = dr.to_png_u8(refocus_image(*(a.to(dev) for a in args))[0])
        off_no_tf32.append(float((here != want).mean()))
        exact += int(step == 0)
        pairs.append((rgb, depth))
    log(f"demo_refocus (python -m omnidata_tpu_torch.demo_refocus, {len(pairs)} pairs at "
        f"{REFOCUS_RES}², card): {s_demo:.1f} s; PNGs against the CPU's refocus_image at "
        f"the same draws: max step {max(steps)}, {exact} of {len(steps)} equal, "
        f"{max(off):.2e} of a PNG's values off at most (the subprocess runs torch's "
        f"defaults); on the card in this process, TF32 off, {max(off_no_tf32):.2e}")
    if len(pairs) != REFOCUS_PAIRS or max(steps) > 1:
        raise AssertionError(f"demo_refocus: {len(pairs)} pairs, steps {steps}")
    rgb = torch.from_numpy(np.concatenate([p[0] for p in pairs]))
    depth = torch.from_numpy(np.concatenate([p[1] for p in pairs]))
    res = {"demo_s": s_demo, "png_max_step": max(steps), "png_equal": exact,
           "png_share_off": max(off), "png_share_off_tf32_off": max(off_no_tf32)}
    for nq in REFOCUS_QUANTILES:
        ops, nbytes = refocus_work(nq, REFOCUS_RES)
        for bs in REFOCUS_BATCHES:
            reps = -(-bs // len(pairs))
            r = torch.cat([rgb] * reps)[:bs].to(dev)
            d = torch.cat([depth] * reps)[:bs].to(dev)
            g = torch.Generator().manual_seed(1)
            with torch.no_grad():
                refocus_augmentation(r, d, g, n_quantiles=nq)  # warm-up
                ms = [cuda_ms(lambda: refocus_augmentation(r, d, g, n_quantiles=nq), 4)
                      for _ in range(REFOCUS_REPS)]
            med = statistics.median(ms)
            bound = bs * max(ops / PEAK_FLOPS["float32"], nbytes / 3.35e12) * 1e3
            res[f"q{nq}_bs{bs}"] = {
                "ms_median": med, "ms_min": min(ms), "ms_max": max(ms),
                "img_s": bs / (med / 1e3), "gflop_per_image": ops / 1e9,
                "bound_ms": bound, "share_of_bound": bound / med}
            log(f"refocus_augmentation {REFOCUS_RES}², {nq} quantiles, batch {bs}: "
                f"{med:.3f} ms (min {min(ms):.3f}, max {max(ms):.3f}; {REFOCUS_REPS} reps "
                f"of 4) = {bs / (med / 1e3):.1f} img/s; {ops / 1e9:.2f} GFLOP an image, "
                f"bound {bound:.4f} ms (operations) = {bound / med:.4f}; card {card}")
    return res


PER_VIEW_VIEWS = 4  # 19a: bench views through annotate_view
SHARDED_VIEWS = 8  # 19b
PACKED_TASKS = ("rgb", "normal", "depth_zbuffer", "mask_valid")
LOADER_BATCHES = 4  # 19c: batches of 8 timed per loader (tools/loader_rate.py)
PACKED_TRAIN_STEPS = 3


def int_label_rule(got, want) -> tuple:
    """tests/test_mesh.py:366-375's rule for integer labels: max |diff| <= 1
    on < 2% of pixels, or <= 32 on < 0.1% -> (ok, max diff, share)."""
    import numpy as np

    diff = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    share = float((diff > 0).mean())
    dmax = int(diff.max()) if diff.size else 0
    return (dmax <= 1 and share < 0.02) or (dmax <= 32 and share < 1e-3), dmax, share


def phase_per_view(card: str, mesh, curv, cams, batched_vps: float) -> dict:
    """19a: ``annotate_view`` on the bench scene, one view at a time."""
    import torch

    from omnidata_tpu_torch.annotator import annotate_view, annotate_views
    from omnidata_tpu_torch.annotator.cli import view_cap
    from omnidata_tpu_torch.annotator.settings import load_settings
    from omnidata_tpu_torch.core.cameras import Camera
    from omnidata_tpu_torch.mesh import raster as raster_mod
    from omnidata_tpu_torch.mesh import raster_kernels as rk

    views = [Camera(cams.location[k], cams.R[k], cams.fov[k], RES)
             for k in range(PER_VIEW_VIEWS)]
    kw = dict(tile=TILE, chunk=CHUNK)
    rk.raster_tiles_chunklist.launches = 0
    outs = [annotate_view(c, mesh, curv, **kw) for c in views]
    torch.cuda.synchronize()
    launches = rk.raster_tiles_chunklist.launches
    log(f"19a annotate_view on {PER_VIEW_VIEWS} bench views: kernel A launches "
        f"{launches}; card {card}")
    if launches != PER_VIEW_VIEWS:
        raise AssertionError(f"annotate_view launched kernel A {launches} times "
                             f"for {PER_VIEW_VIEWS} views")
    batched = annotate_views(cams, mesh, curv, **kw)
    worst = {}
    for k, out in enumerate(outs):
        if set(out) != set(batched):
            raise AssertionError(f"annotate_view labels {sorted(out)}")
        for name, v in out.items():
            ok, dmax, share = int_label_rule(v.cpu().numpy(), batched[name][k].cpu().numpy())
            if not ok:
                raise AssertionError(f"view {k} {name}: max diff {dmax} on {share:.5f}")
            worst[name] = max(worst.get(name, (0, 0.0)), (dmax, share))
    log(f"19a annotate_view vs annotate_views: every label within the integer "
        f"rule; worst (max diff, share) {worst}; card {card}")

    settings = load_settings([f"RASTER_TILE={TILE}", f"RASTER_CHUNK={CHUNK}"])
    caps = [view_cap(c, mesh, settings) for c in views]
    t_err, n_valid = 0.0, 0
    for c, cap in zip(views, caps):
        got = raster_mod.render_view(c, mesh, TILE, cap, CHUNK)
        want = raster_mod.render_view_fused(c, mesh, TILE, CHUNK)
        if not (torch.equal(got.valid, want.valid) and torch.equal(got.face, want.face)):
            raise AssertionError("render_view and kernel A's render differ in "
                                 "valid pixels or faces")
        m = want.valid
        t_err = max(t_err, float((got.t[m] - want.t[m]).abs().max()))
        n_valid += int(m.sum())
    if t_err > 1e-4:
        raise AssertionError(f"render_view t differs from kernel A's by {t_err}")
    plain_outs = [annotate_view(c, mesh, curv, cap=cap, use_pallas=False, **kw)
                  for c, cap in zip(views, caps)]
    for k, (a, b) in enumerate(zip(plain_outs, outs)):
        for name in b:
            ok, dmax, share = int_label_rule(a[name].cpu().numpy(), b[name].cpu().numpy())
            if not ok:
                raise AssertionError(f"plain route view {k} {name}: {dmax} on {share}")
    log(f"19a render_view (plain torch on the card, caps {caps} from "
        f"tile_candidate_counts) vs kernel A's render: valid and faces equal, "
        f"t within {t_err:.3g} on {n_valid} valid pixels; its labels within the "
        f"integer rule of the kernel route's; card {card}")

    def run(route):
        return lambda: [annotate_view(c, mesh, curv, cap=cap, **route, **kw)
                        for c, cap in zip(views, caps)]

    reps = {name: sorted(cuda_ms(run(route), 1) for _ in range(TIMED_REPS))
            for name, route in (("kernel", {}), ("render_view", dict(use_pallas=False)))}
    ms_probe = cuda_ms(lambda: [view_cap(c, mesh, settings) for c in views], 1)
    vps = {name: PER_VIEW_VIEWS / (statistics.median(r) / 1e3) for name, r in reps.items()}
    log(f"19a per-view viewpoints/s on the bench scene ({PER_VIEW_VIEWS} views, "
        f"median of {TIMED_REPS}): kernel A route {vps['kernel']:.2f} (reps "
        f"{[round(PER_VIEW_VIEWS / r * 1e3, 2) for r in reps['kernel']]}), "
        f"render_view route {vps['render_view']:.2f} (reps "
        f"{[round(PER_VIEW_VIEWS / r * 1e3, 2) for r in reps['render_view']]}); "
        f"the cap probe {ms_probe / PER_VIEW_VIEWS:.3f} ms a view; batched "
        f"annotate_views K={K_MAIN} {batched_vps:.2f} (phase 5); card {card}")
    prof = {name: profile_window(run(route), 1, top=4)
            for name, route in (("kernel", {}), ("render_view", dict(use_pallas=False)))}
    for name, p in prof.items():
        log(f"19a profile, {name} route, {PER_VIEW_VIEWS} views: "
            f"{p['wall_ms'] / PER_VIEW_VIEWS:.2f} ms a view, kernels "
            f"{p['kernel_ms'] / PER_VIEW_VIEWS:.2f} ms, {p['launches'] // PER_VIEW_VIEWS} "
            f"launches a view, idle {p['idle_share']:.3f}; top "
            f"{[(t['kernel'], round(t['ms'], 3)) for t in p['top']]}; card {card}")
    return {"launches": launches, "label_worst": worst, "caps": caps, "profile": prof,
            "render_view_t_err": t_err, "vps_kernel": vps["kernel"],
            "vps_render_view": vps["render_view"], "ms_reps": reps,
            "ms_probe_per_view": ms_probe / PER_VIEW_VIEWS,
            "vps_batched_phase5": batched_vps}


def phase_sharded(card: str, mesh, curv, cams) -> dict:
    """19b: ``annotate_views_sharded`` over ``make_annotate_mesh()``."""
    import torch

    from omnidata_tpu_torch.annotator import (
        annotate_views,
        annotate_views_sharded,
        make_annotate_mesh,
    )

    devices = make_annotate_mesh()
    t0 = time.perf_counter()
    got = annotate_views_sharded(cams, mesh, curv, device_mesh=devices, tile=TILE,
                                 chunk=CHUNK)
    torch.cuda.synchronize()
    s_sharded = time.perf_counter() - t0
    want = annotate_views(cams, mesh, curv, tile=TILE, chunk=CHUNK)
    unequal = [k for k in want if not torch.equal(got[k], want[k])]
    log(f"19b annotate_views_sharded over {len(devices)} device(s), "
        f"{SHARDED_VIEWS} bench views: {len(want) - len(unequal)}/{len(want)} "
        f"labels equal to annotate_views bit for bit; {s_sharded:.3f} s "
        f"(mesh copies included); card {card}")
    if set(got) != set(want) or unequal:
        raise AssertionError(f"sharded labels differ: {unequal}")
    return {"devices": len(devices), "views": SHARDED_VIEWS, "s": s_sharded}


def phase_data(card: str, bdir: str) -> dict:
    """19c: the packed cache on phase 11's labels, a trainer on it, and the
    trajectory video of its rgb frames."""
    import ast
    import glob
    import math

    import numpy as np

    from loader_rate import rate

    from omnidata_tpu_torch.data import loader
    from omnidata_tpu_torch.data.dataset import OmnidataDataset, Options
    from omnidata_tpu_torch.data.packed_cache import PackedDataset
    from omnidata_tpu_torch.utils.video import make_video

    ds = OmnidataDataset(Options(data_path=bdir, tasks=PACKED_TASKS, random_flip=True))
    t0 = time.perf_counter()
    pds = PackedDataset.build(ds, str(CLI_DIR / "pack"), num_workers=8)
    s_pack = time.perf_counter() - t0
    for i in range(len(ds)):
        ds.rng, pds.rng = np.random.RandomState(i), np.random.RandomState(i)
        a, b = ds[i], pds[i]
        if a.keys() != b.keys() or not all(
                np.array_equal(a[k], b[k]) for k in a if isinstance(a[k], np.ndarray)):
            raise AssertionError(f"packed item {i} differs from the direct one")
    rates = {f"{name}_{w}": rate(loader, d, 8, w, LOADER_BATCHES) for w in (1, 8)
             for name, d in (("png", ds), ("packed", pds))}
    log(f"19c PackedDataset on phase 11's {len(ds)} views ({', '.join(PACKED_TASKS)} "
        f"at {RES}²): built in {s_pack:.2f} s, every item equal to the direct "
        f"one for equal seeds; loader samples/s (batch 8) PNG {rates['png_1']:.1f} "
        f"/ packed {rates['packed_1']:.1f} with 1 thread, PNG {rates['png_8']:.1f} "
        f"/ packed {rates['packed_8']:.1f} with 8, on the card's host; card {card}")

    tdir = CLI_DIR / "train_packed"
    tdir.mkdir(parents=True, exist_ok=True)
    cfg = write_config(tdir / "depth.yml", {
        "image_size": DEPTH_RES, "batch_size": 2, "max_steps": PACKED_TRAIN_STEPS,
        "log_step": 1, "val_step": 1000, "ckpt_step": 1000, "val_fraction": 0.25,
        "num_workers": 8, "checkpoint_dir": str(tdir / "depth"),
        "packed_cache": str(tdir / "pack"), "data_paths": {"bench": bdir}})
    t0 = time.perf_counter()
    (out,) = trainer_runs([("omnidata_tpu_torch.train_depth", ["--config_file", cfg])])
    s_train = time.perf_counter() - t0
    losses = [ast.literal_eval(line.split(": ", 1)[1].rsplit(" (", 1)[0])["loss"]
              for line in out.splitlines() if line.startswith("step ") and ": {" in line]
    packs = glob.glob(str(tdir / "pack" / "*" / "manifest.json"))
    if len(losses) != PACKED_TRAIN_STEPS or not all(map(math.isfinite, losses)) \
            or len(packs) != 2:
        raise AssertionError(f"train_depth on a packed cache: losses {losses}, "
                             f"packs {packs}")
    log(f"19c train_depth with packed_cache: {PACKED_TRAIN_STEPS} steps, losses "
        f"{[round(x, 5) for x in losses]}, train and val packs built; {s_train:.1f} s "
        f"as a subprocess; card {card}")

    frames = glob.glob(f"{bdir}/rgb/point_*_view_*_domain_rgb.png")
    (CLI_DIR / "video").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    video = make_video(f"{bdir}/rgb", "rgb", str(CLI_DIR / "video" / "rgb.mp4"))
    s_video = time.perf_counter() - t0
    kind = "mp4 (ffmpeg)" if video.endswith(".mp4") else "GIF (no ffmpeg on PATH)"
    size = os.path.getsize(video)
    if size == 0:
        raise AssertionError(f"make_video wrote an empty {video}")
    log(f"19c make_video on phase 11's {len(frames)} rgb frames: {kind}, "
        f"{size} bytes, {s_video:.2f} s on the card's host; card {card}")
    return {"items": len(ds), "s_pack": s_pack, "loader_samples_per_s": rates,
            "train_losses": losses, "s_train": s_train, "video": kind,
            "video_frames": len(frames), "s_video": s_video}


# ---- 20. multi-device training ---------------------------------------------

PAR_RES = 384  # DPT-hybrid-384's size
PAR_BATCH = 2  # 20a, 20c: the global batch (one image a data rank in 20c)
PAR_TIMED_BATCH = 8  # 20d, phase 16's
PAR_TIMED_STEPS = 10  # 20d: one round of each
PAR_RTOL = 1e-5  # 20c: loss terms against world size 1 (the CPU tests' bounds)
# 20c: gradients (all, in L2) and clip norms against world size 1. Set
# from one run on an H100: 2x1 at most 2.5e-6; 2x2 4.0e-6 SSI only,
# 1.23e-5 from warm moments (VNL 0 at that step), 1.02e-3 (norms 2.1e-4,
# 4.0e-4) past the switch from fresh moments, where the model split's
# rounding moves a triplet across VNL's 25% cut, whose place is not
# continuous in the parameters (loss terms within 1.1e-7). Averaged
# gradients are off by 1/2, a split tensors' norm without the model
# group's sum by about 1 - 1/sqrt(2).
PAR_GRAD_RTOL = 1e-4
PAR_GRAD_RTOL_VNL_CUT = 1e-2  # the step past the switch with a model split
PAR_MOVE_RTOL = 0.01  # 20c: L2 of the warm step's moves
PAR_GLOO_GRIDS = ((2, 1), (2, 2))
# 20c's images: at 384² one step's moves are not reproducible across any
# change of rounding (see par_worker_gloo); at 128² they are within 1%
PAR_GLOO_RES = 128
PAR_TORCHRUN_STEPS = 4  # 20b: half of them, then --resume to all
PAR_TIMEOUT_S = 600
PAR_DIR = ROOT / "build" / "chip_smoke_parallel"


def par_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def par_exact_mode(on: bool) -> None:
    """TF32 off, deterministic cuDNN and deterministic algorithms (the
    CUDA atomics' orders fixed: two runs of a step give the same bits), or
    torch's defaults."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = not on
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on)


def par_batch(bdir: str, rows: slice, dev, res: int = PAR_RES) -> dict:
    """Phase 11's first views at res² as the depth trainer's batch (rgb in
    [0, 1]: the step augments and normalises), the given rows."""
    b = train_batch(bdir, DEPTH_TASKS, res, PAR_BATCH, depth_rgb=False)
    return {k: v[rows].to(dev) for k, v in b.items()}


def par_net(dev, **model_kw):
    """DPT-hybrid-384 (depth head) on seeded weights, at the published
    widths unless model_kw says otherwise."""
    import torch

    from omnidata_tpu_torch.models import DPTHybrid
    from omnidata_tpu_torch.models.registry import init_weights

    net = DPTHybrid(num_channels=1, **model_kw)
    init_weights(net, torch.Generator().manual_seed(0))
    return net.to(dev)


class ParSeen:
    """par_step's optimizer wrapper: records the gradients the step gives
    the optimizer (the data group's sum when sharded) and the clip's
    global norm, of all the tensors and of the model-split ones."""

    def __init__(self, tx, names):
        self.tx, self.names, self.seen = tx, names, {}

    def init(self, params):
        return self.tx.init(params)

    def step(self, params, grads, state, split=None, model_group=None):
        from omnidata_tpu_torch.train.parallel import split_dim

        norm = self.tx.global_norm
        self.seen["grads"] = [g.detach().clone() for g in grads]
        self.seen["norm"] = float(norm(grads, split, model_group))
        sub = [g for n, g in zip(self.names, grads) if split_dim(n) is not None]
        self.seen["norm_split"] = float(norm(sub, [True] * len(sub), model_group)
                                        if model_group is not None else norm(sub))
        self.tx.step(params, grads, state, split, model_group)


def par_step(net, mesh, batch: dict, step_no: int, dev, per_image: bool = False,
             warm: dict | None = None, record: bool = False) -> dict:
    """One depth step (augmentation on) of net, in place (sharded over mesh
    when one is given; its forward image by image when per_image), from
    fresh moments or from warm (count, and unsharded mu and nu lists in
    the train state's order) -> global metrics, the unsharded parameters
    after it on the CPU, its seconds and the optimizer state it leaves
    ("opt"); with record, the unsharded gradients it stepped on (CPU) and
    ParSeen's norms."""
    import torch

    from omnidata_tpu_torch import train as T
    from omnidata_tpu_torch.losses import VNLParams
    from omnidata_tpu_torch.train.parallel import (gather_state_dict, gather_tensor,
                                                   shard_module, shard_tensor)

    if mesh is not None:
        shard_module(net, mesh)
    state = T.create_train_state(net, T.depth_optimizer(), mesh)
    seen = ParSeen(state.tx, state.names)
    state.tx = seen
    state.step = step_no
    if warm is not None:
        n_model, index = (mesh.n_model, mesh.model_index) if mesh is not None else (1, 0)
        state.opt_state["count"] = torch.tensor(warm["count"], dtype=torch.int32)
        for k in ("mu", "nu"):
            state.opt_state[k] = [shard_tensor(n, t, n_model, index).clone()
                                  for n, t in zip(state.names, warm[k])]

    def apply_fn(m, x):
        if per_image:
            return torch.cat([m(x[i:i + 1]) for i in range(x.shape[0])])[:, 0]
        return m(x)[:, 0]

    res = batch["rgb"].shape[-1]
    step = T.make_depth_train_step(apply_fn, VNLParams(1.0, 1.0, (res, res)),
                                   augment=True, image_size=res)
    gen = torch.Generator(device=dev).manual_seed(0)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    metrics = step(state, batch, gen)
    sync()
    s = time.perf_counter() - t0
    full = gather_state_dict(net, mesh) if mesh is not None else net.state_dict()
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": {k: full[k].detach().cpu() for k in state.names}, "s": s,
           "opt": {"count": int(state.opt_state["count"]),
                   **{k: state.opt_state[k] for k in ("mu", "nu")}}}
    if record:
        out["grads"] = {n: (gather_tensor(n, g, mesh) if mesh is not None else g).cpu()
                        for n, g in zip(state.names, seen.seen["grads"])}
        out.update(norm=seen.seen["norm"], norm_split=seen.seen["norm_split"])
    return out


def par_grads_close(got: dict, want: dict) -> dict:
    """Gradients and clip norms of a sharded step against world size 1:
    the relative L2 distance of all the gradients as one vector, the
    worst tensor's, and the norms' relative distances."""
    d2 = n2 = 0.0
    worst = (None, 0.0)
    for k, w in want["grads"].items():
        d, n = float((got["grads"][k] - w).norm()), float(w.norm())
        d2, n2 = d2 + d * d, n2 + n * n
        if n and d / n > worst[1]:
            worst = (k, d / n)
    return {"grad_rel": (d2 / n2) ** 0.5, "worst_tensor": worst,
            **{f"{k}_rel": abs(got[k] - want[k]) / want[k] for k in ("norm", "norm_split")}}


def par_close(got: dict, want: dict, start: dict, lr: float = 1e-5) -> dict:
    """The CPU tests' measures of a step against another: the loss terms'
    relative distances, the worst parameter's distance less the rounding
    of p + u in lr, and the moves' relative distance in L2."""
    import torch

    rel = {k: abs(got["metrics"][k] - v) / abs(v) if v else
           (0.0 if got["metrics"][k] == v else float("inf"))
           for k, v in want["metrics"].items()}
    names = list(want["params"])
    excess = max(float(((got["params"][k] - want["params"][k]).abs()
                        - 2**-22 * want["params"][k].abs()).max()) for k in names) / lr
    d_got = torch.cat([(got["params"][k] - start[k]).flatten() for k in names])
    d_want = torch.cat([(want["params"][k] - start[k]).flatten() for k in names])
    move = float((d_got - d_want).norm() / d_want.norm())
    return {"loss_rel": rel, "param_err_over_lr": excess, "move_rel": move}


def par_worker_nccl1(bdir: str, out: str) -> None:
    """20a and 20d, in a process of its own: NCCL at world size 1."""
    import copy

    import torch
    import torch.distributed as dist

    from omnidata_tpu_torch import graft_entry
    from omnidata_tpu_torch.train import SSI_ONLY_STEPS
    from omnidata_tpu_torch.train.parallel import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{par_free_port()}",
                            rank=0, world_size=1)
    res = {"backend": dist.get_backend()}
    try:
        par_exact_mode(True)
        net = par_net(dev)
        batch = par_batch(bdir, slice(0, PAR_BATCH), dev)
        for step_no in (0, SSI_ONLY_STEPS + 1):
            one = par_step(copy.deepcopy(net), None, batch, step_no, dev)
            sharded = par_step(copy.deepcopy(net), make_mesh(), batch, step_no, dev)
            same = (one["metrics"] == sharded["metrics"] and all(
                torch.equal(one["params"][k], sharded["params"][k]) for k in one["params"]))
            res[f"step_{step_no}"] = {"metrics": one["metrics"], "bitwise": same}
            if not same:
                raise AssertionError(f"world size 1, step {step_no}: sharded "
                                     f"{sharded['metrics']} vs one device {one['metrics']}")
        par_exact_mode(False)
        graft_entry.dryrun_multichip(1)  # the sharded step and annotation on make_annotate_mesh(1)
        # 20d: torch's defaults, batch 8, the step past the switch
        timed = {}
        big = {k: torch.cat([v] * (PAR_TIMED_BATCH // PAR_BATCH)) for k, v in batch.items()}
        for what in ("one device", "sharded, world 1"):
            from omnidata_tpu_torch import train as T
            from omnidata_tpu_torch.losses import VNLParams
            from omnidata_tpu_torch.train.parallel import shard_module

            m = make_mesh() if what.startswith("sharded") else None
            n = copy.deepcopy(net)
            state = T.create_train_state(shard_module(n, m) if m else n, T.depth_optimizer(), m)
            state.step = SSI_ONLY_STEPS + 1
            step = T.make_depth_train_step(lambda mm, x: mm(x)[:, 0],
                                           VNLParams(1.0, 1.0, (PAR_RES, PAR_RES)),
                                           augment=True, image_size=PAR_RES)
            gen = torch.Generator(device=dev).manual_seed(0)
            timed[what] = step_times(lambda: step(state, big, gen), PAR_TIMED_STEPS)
            del state, n
        res["timed_ms"] = {k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                               "n": len(v)} for k, v in timed.items()}
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))


def par_worker_gloo(bdir: str, out: str, n_model: int) -> None:
    """20c, one rank of a gloo group on the one card (torchrun's
    variables), at PAR_GLOO_RES², batch 1 a data rank, against the
    world-size-1 step on the global batch with its forward run image by
    image, as the batch-1 ranks run theirs (cuDNN rounds a convolution by
    its batch size: a batched forward's step past the switch sat 7.5e-2
    from it in L2 of the moves on an H100). Three steps, sharded and
    at world size 1 from the same state: from fresh moments at step 0 (SSI
    only) and past the switch (SSI, regularizer, VNL), then the step after
    the latter from the state the world-size-1 step left (warm moments;
    deterministic algorithms make every rank's copy of that step equal).
    Each is held on its loss terms (PAR_RTOL), the gradients the
    optimizer is given (the data group's sum, in L2 over all of them) and
    the clip norms (all tensors; the model-split ones). One Adam step from
    zero moments moves each parameter by about ±lr by its gradient's sign,
    which rounding flips where a gradient is near zero, so only the warm
    step's moves are held (2 lr; PAR_MOVE_RTOL in L2)."""
    import copy

    import torch
    import torch.distributed as dist

    from omnidata_tpu_torch.train import SSI_ONLY_STEPS, multihost
    from omnidata_tpu_torch.train.parallel import make_mesh

    if not multihost.initialize("cpu"):  # gloo, whose ranks share the card
        raise RuntimeError("no process group from the environment")
    dev = torch.device("cuda", multihost.local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    par_exact_mode(True)
    rank, world = multihost.rank(), multihost.world_size()
    lead = rank == 0
    net = par_net(dev)
    late = SSI_ONLY_STEPS + 1
    start = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    whole = par_batch(bdir, slice(0, PAR_BATCH), dev, PAR_GLOO_RES)
    mesh = make_mesh(world // n_model, n_model)
    per = PAR_BATCH // mesh.n_data
    mine = {k: v[mesh.data_index * per:(mesh.data_index + 1) * per] for k, v in whole.items()}
    after = copy.deepcopy(net)  # becomes the warm state's parameters
    want = {"full_loss": par_step(after, None, whole, late, dev, per_image=True, record=lead)}
    warm = want["full_loss"]["opt"]
    got = {"full_loss": par_step(copy.deepcopy(net), mesh, mine, late, dev, record=True),
           "ssi_only": par_step(copy.deepcopy(net), mesh, mine, 0, dev, record=True),
           "warm": par_step(copy.deepcopy(after), mesh, mine, late + 1, dev, warm=warm,
                            record=True)}
    if lead:
        want["ssi_only"] = par_step(copy.deepcopy(net), None, whole, 0, dev, per_image=True,
                                    record=True)
        want["warm"] = par_step(copy.deepcopy(after), None, whole, late + 1, dev,
                                per_image=True, warm=warm, record=True)
        starts = {"ssi_only": start, "full_loss": start, "warm": want["full_loss"]["params"]}
        res = {"grid": [mesh.n_data, mesh.n_model], "res": PAR_GLOO_RES,
               "s_step": got["full_loss"]["s"], "s_step_world_1": want["full_loss"]["s"],
               "steps": {k: {"metrics": got[k]["metrics"],
                             **par_close(got[k], want[k], starts[k]),
                             **par_grads_close(got[k], want[k])} for k in got}}
        grad_rtol = {"ssi_only": PAR_GRAD_RTOL, "warm": PAR_GRAD_RTOL,
                     "full_loss": PAR_GRAD_RTOL if n_model == 1 else PAR_GRAD_RTOL_VNL_CUT}
        res["grad_rtol"] = grad_rtol
        bad = [k for k, c in res["steps"].items()
               if max(c["loss_rel"].values()) > PAR_RTOL
               or max(c["grad_rel"], c["norm_rel"], c["norm_split_rel"]) > grad_rtol[k]
               or (k == "warm" and (c["param_err_over_lr"] > 2
                                    or c["move_rel"] > PAR_MOVE_RTOL))]
        Path(out).write_text(json.dumps(res))
        if bad:
            raise AssertionError(f"sharded steps {bad} against world size 1: {res}")
    multihost.barrier("compared")
    dist.destroy_process_group()


def par_run(args: list, env=None) -> str:
    """`python chip_smoke.py --phase20 ...` (or any argv) as a subprocess ->
    its output; a non-zero exit fails with the output's tail."""
    p = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True, timeout=PAR_TIMEOUT_S)
    if p.returncode:
        print(p.stdout[-4000:], file=sys.stderr)
        raise AssertionError(f"{args[:4]} exited {p.returncode}")
    return p.stdout


def par_torchrun(bdir: str) -> dict:
    """20b: ``train_depth`` under torchrun at world size 1 on phase 11's
    labels, half the steps, then ``--resume`` to all of them."""
    import ast
    import math

    import torch

    from omnidata_tpu_torch.models import DPTHybrid
    from omnidata_tpu_torch.train.driver import load_pretrained

    tdir = PAR_DIR / "torchrun"
    tdir.mkdir()
    half = PAR_TORCHRUN_STEPS // 2
    cfg = write_config(tdir / "depth.yml", {
        "image_size": PAR_RES, "batch_size": PAR_BATCH, "max_steps": half,
        "val_step": half, "ckpt_step": 100, "log_step": 1,
        "val_fraction": 0.25, "num_workers": 4, "save_top_k": 2, "data_parallel": 1,
        "checkpoint_dir": str(tdir / "ck"), "data_paths": {"bench": bdir}})
    run = ["-m", "torch.distributed.run", "--nproc_per_node", "1", "--master_port",
           str(par_free_port()), "-m", "omnidata_tpu_torch.train_depth", "--config_file", cfg]
    t0 = time.perf_counter()
    out1 = par_run(run)
    trained = check_trained("torchrun train_depth", out1, tdir / "ck", "val_depth_loss",
                            half, (half,), PAR_RES)
    out2 = par_run(run + ["--resume", "--max_steps", str(PAR_TORCHRUN_STEPS)])
    resumed = [ast.literal_eval(line.split(": ", 1)[1].rsplit(" (", 1)[0])["loss"]
               for line in out2.splitlines() if line.startswith("step ") and ": {" in line]
    again = torch.load(tdir / "ck" / "last" / "state.pt", map_location="cpu", weights_only=True)
    if (f"resumed from {tdir / 'ck'}/last at step {half}" not in out2
            or len(resumed) != PAR_TORCHRUN_STEPS - half
            or not all(math.isfinite(x) for x in resumed)
            or int(again["step"]) != PAR_TORCHRUN_STEPS
            or int(again["opt_state"]["count"]) != PAR_TORCHRUN_STEPS
            or sorted(json.loads((tdir / "ck" / "scores.json").read_text()))
            != sorted(f"step_{k}" for k in (half, PAR_TORCHRUN_STEPS))):
        raise AssertionError(f"torchrun train_depth --resume: {out2[-2000:]}")
    net = DPTHybrid(num_channels=1)
    load_pretrained(net, str(tdir / "ck" / "last"))
    if not all(torch.equal(net.state_dict()[k], v) for k, v in again["params"].items()):
        raise AssertionError("the one-device loader read another 'last'")
    return {"losses": trained["losses"] + resumed, "val": trained["val"],
            "s": time.perf_counter() - t0}


def par_gloo(bdir: str, n_data: int, n_model: int, env: dict) -> dict:
    """20c on one grid: its ranks as processes of ``chip_smoke.py --phase20
    gloo``, with torchrun's variables -> rank 0's results."""
    world = n_data * n_model
    out = PAR_DIR / f"c_{n_data}x{n_model}.json"
    port = par_free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--phase20", "gloo", bdir, str(out), str(n_model)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(env, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="2"))
        for r in range(world)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=PAR_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode:
            print(text[-4000:], file=sys.stderr)
            raise AssertionError(f"20c {n_data}x{n_model} rank {r} exited {p.returncode}")
    return json.loads(out.read_text())


def phase_parallel(card: str, bdir: str) -> dict:
    """Phase 20: multi-device training on the one card (see the module doc).
    20a and 20d run alone; 20b and 20c's two grids then run at once."""
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    if PAR_DIR.exists():
        shutil.rmtree(PAR_DIR)
    PAR_DIR.mkdir(parents=True)
    # 20a + 20d: NCCL at world size 1, deterministic (cuBLAS's workspace fixed)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    text = par_run([__file__, "--phase20", "nccl1", bdir, str(PAR_DIR / "a.json")], env)
    a = json.loads((PAR_DIR / "a.json").read_text())
    s_a = time.perf_counter() - t0
    lines = [ln for ln in text.splitlines() if ln.startswith("dryrun_multichip")]
    if len(lines) != 2:
        raise AssertionError(f"dryrun_multichip(1) printed {lines}")
    losses = {k: v["metrics"]["loss"] for k, v in a.items() if k.startswith("step_")}
    log(f"20a NCCL world size 1, DPT-hybrid-384 at {PAR_RES}², batch {PAR_BATCH}, TF32 off, "
        f"deterministic: the sharded step equals the one-device step bit for bit before "
        f"and after the switch (losses {losses}); {lines[0]}; {lines[1]}; {s_a:.1f} s")
    t = a["timed_ms"]
    log(f"20d depth step past the switch, batch {PAR_TIMED_BATCH}, {PAR_RES}², torch's "
        f"defaults, ms by CUDA events (median/min/max of {PAR_TIMED_STEPS} after "
        f"{TRAIN_WARMUP}, one device then sharded): one device "
        f"{t['one device']['median']:.1f}/{t['one device']['min']:.1f}/"
        f"{t['one device']['max']:.1f}; sharded world 1 "
        f"{t['sharded, world 1']['median']:.1f}/{t['sharded, world 1']['min']:.1f}/"
        f"{t['sharded, world 1']['max']:.1f}; card {card}")
    # 20b and 20c at once: their processes share the card and the host
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1 + len(PAR_GLOO_GRIDS)) as pool:
        fb = pool.submit(par_torchrun, bdir)
        fc = {f"{d}x{m}": pool.submit(par_gloo, bdir, d, m, env) for d, m in PAR_GLOO_GRIDS}
        b = fb.result()
        gloo = {k: f.result() for k, f in fc.items()}
    s_bc = time.perf_counter() - t0
    half = PAR_TORCHRUN_STEPS // 2
    log(f"20b torchrun --nproc_per_node 1 train_depth ({half} steps, then --resume to "
        f"{PAR_TORCHRUN_STEPS}): losses {[round(x, 5) for x in b['losses']]}, the resumed run "
        f"going on from step {half}, 'last' at step {PAR_TORCHRUN_STEPS} read by the "
        f"one-device loader; {b['s']:.1f} s beside 20c")
    for grid, c in gloo.items():
        held = "; ".join(
            f"{k} (loss {v['metrics']['loss']:.5f}): loss terms "
            f"{max(v['loss_rel'].values()):.3e}, gradients {v['grad_rel']:.3e} of L2 (worst "
            f"tensor {v['worst_tensor'][0]} {v['worst_tensor'][1]:.3e}), clip norm "
            f"{v['norm_rel']:.3e}, model-split tensors' norm {v['norm_split_rel']:.3e}, "
            f"parameters {v['param_err_over_lr']:.4f} lr, moves {v['move_rel']:.3e}"
            for k, v in c["steps"].items())
        log(f"20c gloo {grid} on one card, {PAR_GLOO_RES}² (gloo through host memory, one "
            f"card, beside 20b and the other grid; not a multi-GPU number): "
            f"{c['s_step']:.2f} s a step (world size 1 {c['s_step_world_1']:.2f} s); against "
            f"the world-size-1 step on batch {PAR_BATCH}, forward image by image (bounds: "
            f"loss terms {PAR_RTOL:.0e}, gradients and norms {c['grad_rtol']}; warm: 2 lr, "
            f"moves {PAR_MOVE_RTOL:.0e}): {held}")
    s_phase = time.perf_counter() - t_phase
    log(f"phase 20: {s_phase:.1f} s (20b and 20c at once: {s_bc:.1f} s)")
    return {"nccl_world_1": {k: v for k, v in a.items() if k != "timed_ms"},
            "torchrun": b, "gloo_one_card": gloo, "timed_ms": t, "s_phase": s_phase,
            "card": card}


# ---------------------------------------------------------------------------
# phase 21: the offline accuracy chain

ACC_DIR = ROOT / "build" / "chip_smoke_accuracy"
ACC_ARGS = ["--train_scenes", "2", "--val_scenes", "1", "--normal_steps", "12",
            "--depth_steps", "12"]  # the rest at the tool's defaults
ACC_ROWS = ("untrained init", "trained")
ACC_VIEWS_PER_DISPATCH = 32  # the tool's default: one raster launch a batch


def phase_accuracy(card: str) -> dict:
    """Phase 21: ``accuracy_benchmark.main`` in this process on the card
    (see the module doc): kernel A launched once a render batch at least,
    B and C not at all; every metric of the report finite, both rows of
    both models; the card in the report."""
    import math

    from omnidata_tpu_torch import accuracy_benchmark as ab
    from omnidata_tpu_torch.mesh import raster_kernels as rk

    shutil.rmtree(ACC_DIR, ignore_errors=True)
    ACC_DIR.mkdir(parents=True)
    report, tool_log = ACC_DIR / "ACCURACY_TORCH.md", ACC_DIR / "accuracy.log"
    counters = ((rk.raster_tiles_chunklist, "launches"), (rk.raster_tiles_compact, "launches"),
                (rk.raster_tiles_compact, "count_launches"),
                (rk.raster_tiles_streamed, "launches"),
                (rk.raster_tiles_streamed, "count_launches"))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    cudnn_mode("defaults")  # as the tool runs alone
    t0 = time.perf_counter()
    with open(tool_log, "w") as fh, contextlib.redirect_stdout(fh):
        try:
            out = ab.main(ACC_ARGS + ["--root", str(ACC_DIR / "run"), "--out", str(report)])
        except BaseException:
            fh.flush()
            print(tool_log.read_text()[-4000:], file=sys.stderr)
            raise
        finally:
            cudnn_mode("phase1")
    s_phase = time.perf_counter() - t0
    launches_a, launches_b, count_b, launches_c, count_c = (
        getattr(fn, attr) for fn, attr in counters)
    batches = 0
    for split in ("train", "val"):
        for scene in sorted((ACC_DIR / "run" / split).iterdir()):
            n = len(list((scene / "rgb").iterdir()))
            batches += -(-n // ACC_VIEWS_PER_DISPATCH)
    sec = out["seconds"]
    log(f"21 accuracy chain ({' '.join(ACC_ARGS)}, 512², UNet bs 16, DPT-hybrid-384 bs 8): "
        f"{out['n_train_views']} train / {out['n_val_views']} val views; kernel A launches "
        f"{launches_a} for {batches} render batches, B {launches_b} (count passes "
        f"{count_b}), C {launches_c} (count passes {count_c}); {s_phase:.1f} s; card {card}")
    log("21 stage seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in sec.items()))
    log(f"21 depth zero share on the held-out views: untrained "
        f"{out['depth_untrained_zero_share']:.6f}, trained {out['depth_trained_zero_share']:.6f}")
    if launches_a < batches or launches_b or count_b or launches_c or count_c:
        raise AssertionError("the accuracy chain must launch kernel A once a render batch "
                             "or more, and neither B nor C")
    text = report.read_text()
    rows = ab.report_rows(text)
    bad = [(sec_, m) for sec_ in ("Surface", "Depth") for m in ACC_ROWS
           if len(rows.get((sec_, m), ())) != 7
           or not all(map(math.isfinite, rows[(sec_, m)]))]
    if bad:
        raise AssertionError(f"accuracy report rows missing or not finite: {bad}")
    if card.split(",")[0] not in text:
        raise AssertionError(f"the accuracy report does not name the card {card!r}")
    log(f"21 report: both rows of both models finite; UNet mean angular error "
        f"{out['normal_untrained']['ang_error_mean']:.3f} -> "
        f"{out['normal_trained']['ang_error_mean']:.3f}; DPT SSI-aligned L1 "
        f"{out['depth_untrained']['eval_L1']:.3f} -> {out['depth_trained']['eval_L1']:.3f}")
    return {"s_phase": s_phase, "render_batches": batches, "launches_a": launches_a,
            "launches_b": launches_b + count_b, "launches_c": launches_c + count_c,
            "results": out, "card": card}


def phase20_worker(argv: list) -> int:
    """`chip_smoke.py --phase20 nccl1 BDIR OUT` or `--phase20 gloo BDIR OUT
    N_MODEL`: phase 20's processes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if argv[0] == "nccl1":
        par_worker_nccl1(argv[1], argv[2])
    else:
        par_worker_gloo(argv[1], argv[2], int(argv[3]))
    return 0


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
    # C at the CLI's ccap 48 against its plain version on the rows of the
    # PLAIN48_VIEWS views with the most staged faces (rows are independent)
    v48 = staged48.reshape(K_MAIN, -1).sum(1).argsort(
        descending=True, stable=True)[:PLAIN48_VIEWS].sort().values
    r48 = (v48[:, None] * linp48.tiles_per_view
           + torch.arange(linp48.tiles_per_view, device=dev)).reshape(-1)
    l48_hard = (linp48.ids[r48], linp48.counts[r48], linp48.origins[v48], linp48.pack,
                tuple(p[r48] for p in linp48.dir_planes))
    # name -> (ms, work, kernel call, plain version, (wrapper, counts,
    # chunks, overlaps[, stage cap]) of the item list's check, the rows of
    # the kernel's output that the plain version computes (None: all))
    k32 = {
        "A": (ms_a32, raster_work(inp32, staged_b),
              lambda: chunklist(*args32, inp32.dir_planes, **kw32),
              lambda: by_views(rk.raster_tiles_chunklist_reference)(
                  *args32, inp32.dir_planes, **kw32),
              (chunklist, inp32.counts, n_bchunks, None), None),
        "B": (ms_b32, raster_work(inp32, staged_b, reads_bbox_words=True),
              lambda: rk.raster_tiles_compact(
                  *args32, inp32.bbox_words, inp32.dir_planes, **kw32),
              lambda: by_views(rk.raster_tiles_compact_reference)(
                  *args32, inp32.bbox_words, inp32.dir_planes, **kw32),
              (rk.raster_tiles_compact, inp32.counts, n_bchunks, staged_b,
               rk.STAGE_CAP), None),
        "C plain body": (lms_cp, raster_work(linpC, staged),
                         lambda: streamed(*lC, **kwA),
                         lambda: by_views(rk.raster_tiles_streamed_reference)(
                             *lC, **kwA),
                         (streamed, linpC.counts, n_lchunks, None), None),
        "C compacting": (lms_cc, raster_work(linpC, staged, reads_bbox_words=True),
                         lambda: streamed(*lC, bbox_words=linpC.bbox_words, **kwA),
                         lambda: by_views(rk.raster_tiles_streamed_reference)(
                             *lC, bbox_words=linpC.bbox_words, **kwA),
                         (streamed, linpC.counts, n_lchunks, staged), None),
        "C compacting, ccap 48": (
            lms_c48, raster_work(linp48, staged48, reads_bbox_words=True),
            lambda: streamed(*l48, bbox_words=linp48.bbox_words, **kwA),
            lambda: by_views(rk.raster_tiles_streamed_reference)(
                *l48_hard, bbox_words=linp48.bbox_words[v48], **kwA),
            (streamed, linp48.counts, n_lchunks, staged48), r48),
    }
    for name, (ms, work, run, plain, sched_of, rows) in k32.items():
        got = run()
        if rows is not None:
            got = tuple(g[rows] for g in got)
        work.update(check_schedule(f"kernel {name} K={K_MAIN}", *sched_of))
        work["plain_ms"], want = timed(plain)
        work["max_abs_err"] = check_kernel(
            f"kernel {name} K={K_MAIN} vs plain ({want[0].shape[0]} rows"
            + (f": views {v48.tolist()}, the most staged faces" if rows is not None
               else "") + ")", got, want)
        del got, want
        log(f"kernel {name} K={K_MAIN}: {ms:.3f} ms; {work['pairs']:.4g} "
            f"pixel-face pairs (bbox-overlapping faces), bound "
            f"{work['bound_ms']:.3f} ms (by {work['bound_by']}; operations "
            f"{work['ops_ms']:.3f}, {work['ops_ms_unfused']:.3f} unfused; bytes "
            f"{work['bytes_ms']:.3f}), {work['bound_ms'] / ms:.3f} of the bound; "
            f"items {work['items']}, split rows {work['split_rows']}; plain version "
            f"{work['plain_ms']:.1f} ms; card {card}")
    del linp48, l48, l48_hard
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
    device_cue_maps, route_calls = cli.device_cue_maps, []

    def counted_cue_maps(out, fov, settings, prefixes):
        maps = device_cue_maps(out, fov, settings, prefixes)
        route_calls.append(sorted(maps))
        return maps

    cli.device_cue_maps = counted_cue_maps
    t0 = time.perf_counter()
    try:
        run_cli(cli.main, ["--model_path", bdir, "--task", "all", *CLI_BENCH_ARGS])
    finally:
        cli.device_cue_maps = device_cue_maps
    torch.cuda.synchronize()
    s_cli_bench = time.perf_counter() - t0
    route_calls = sum(m == ["narf", "seg25d_q", "seg2d_q"] for m in route_calls)
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

    # 14. the host cues' device prefixes ----------------------------------
    dsettings = load_settings([])
    prefixes = {}
    for what, cams_, args_ in (
            ("bench batch", cams_main, (mesh, curv, dict(tile=TILE, chunk=CHUNK))),
            ("large batch", lcams_main, (lmesh, lcurv, lkw_ann))):
        out = annotate_views(cams_, *args_[:2], modalities=DEVICE_MODALITIES, **args_[2])
        prefixes[what] = check_device_maps(what, out, cams_, dsettings)
        del out
    prefixes["cli"] = check_cli_route(cli, bdir, bviews, bsettings, dev, route_calls)

    # 15. DPT-hybrid-384 and the demo ---------------------------------------
    dpt = phase_dpt(dev, card)

    # 16. training on phase 11's labels --------------------------------------
    train = phase_train(dev, card, bdir)

    # 17. evaluation, multi-task training and HRNet ---------------------------
    eval_mt = phase_eval_multitask(dev, card, bdir)

    # 18. MiDaS v2.1 and the refocus augmentation ----------------------------
    t0 = time.perf_counter()
    midas = phase_midas(dev, card)
    refocus = phase_refocus(dev, card, bdir)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")

    # 19. per-view path, sharded annotation, packed cache and video ---------
    t0 = time.perf_counter()
    per_view = phase_per_view(card, mesh, curv, batch(0, PER_VIEW_VIEWS), vps)
    sharded = phase_sharded(card, mesh, curv, batch(0, SHARDED_VIEWS))
    data = phase_data(card, bdir)
    s19 = time.perf_counter() - t0
    log(f"phase 19: {s19:.1f} s; card {card}")

    # 20. multi-device training ----------------------------------------------
    parallel = phase_parallel(card, bdir)

    # 21. the offline accuracy chain ------------------------------------------
    accuracy = phase_accuracy(card)

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
              launches_cli_bench=cli_a_bench,
              launches_annotate_view=per_view["launches"],
              launches_accuracy_chain=accuracy["launches_a"]),
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
              plain_ms_ccap48=work48["plain_ms"], plain_views_ccap48=PLAIN48_VIEWS,
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
        "pano_s": pano_s, "pano_tests_per_s": pano_rate,
        "device_prefixes": prefixes, "dpt": dpt, "train": train,
        "eval_multitask_hrnet": eval_mt, "midas": midas, "refocus": refocus,
        "phase19": {"per_view": per_view, "sharded": sharded, "data": data,
                    "s": s19}, "phase20": parallel, "phase21": accuracy,
        "card": card}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(phase20_worker(sys.argv[2:]) if sys.argv[1:2] == ["--phase20"] else main())
