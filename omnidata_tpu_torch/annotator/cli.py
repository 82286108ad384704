"""omnidata-annotate: the end-to-end annotator CLI of the PyTorch port.

The JAX package's argv grammar, task names, settings vocabulary and output
layout (``--model_path=... --task=... with KEY=VAL ...``; task ``all`` fans
out), plus ``--device`` (default ``cuda``; a CUDA request without a card
raises):

    python -m omnidata_tpu_torch.annotator.cli --model_path /path/to/mesh_dir \\
        --task all [--device cuda] with NUM_POINTS=12 RESOLUTION=512

The mesh is <model_path>/mesh.ply or mesh.obj. Outputs land in
<model_path>/<task>/point_{p}_view_{v}_domain_{task}.png plus
point_info/*.json and camera_poses.json.

The device labels take one of two routes, as in the JAX CLI:
- batched (``--device cuda``, or FORCE_BATCHED_PATH=1 on the CPU):
  ``annotate_views``, K = VIEWS_PER_DISPATCH views per raster launch, which
  picks the raster kernel by the size of the scene pack
  (``mesh.raster.render_views_fused``);
- per view (``--device cpu`` without the flag): ``annotate_view`` on the
  plain ``render_view``, its per-tile face capacity doubled from
  RASTER_CAP until it covers the view's largest tile candidate count
  (``mesh.raster.tile_candidate_counts``), so no candidate is dropped.
The host cues (keypoints3d,
segment_unsup2d, segment_unsup25d) run in a spawned process pool kept off
the card. On ``--device cuda`` (or with FORCE_BATCHED_PATH=1 on the CPU,
the JAX CLI's batched path off a TPU) their convolution-shaped prefixes run
on the device beside the render — NARF border maps
(``cues.narf_device``), the 2D blur and 2.5D channel maps
(``cues.seg_device``) — and the pool runs only the sequential cores
(region growing, Kruskal, normalized cuts) on those codes. On ``--device
cpu`` without the flag the cues run wholly on the host, as the JAX CLI's
per-view path does.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import numpy as np
import torch

from ..utils import profiler

TASKS_ALL = [
    "points",
    "trajectory",
    "pano",
    "rgb",
    "normal",
    "depth_zbuffer",
    "depth_euclidean",
    "mask_valid",
    "reshading",
    "principal_curvature",
    "edge_texture",
    "edge_occlusion",
    "keypoints2d",
    "keypoints3d",
    "semantic",
    "fragments",
    "segment_unsup2d",
    "segment_unsup25d",
    "vanishing_points",
]

DEVICE_TASKS = {
    "rgb", "normal", "depth_zbuffer", "depth_euclidean", "mask_valid",
    "reshading", "principal_curvature", "edge_texture", "edge_occlusion",
    "keypoints2d", "semantic", "fragments",
}

_AXIS_VECS = {
    "X": (1, 0, 0), "Y": (0, 1, 0), "Z": (0, 0, 1),
    "-X": (-1, 0, 0), "-Y": (0, -1, 0), "-Z": (0, 0, -1),
}


def _obj_axis_matrix(forward: str, up: str):
    """Blender OBJ-import axis remap (OBJ_AXIS_FORWARD/UP): map the file's
    (forward, up) axes onto the world's (+Y forward, +Z up). (Y, Z) is the
    identity; Blender's default OBJ flags (-Z, Y) give (x, y, z) -> (x, -z,
    y)."""
    f = np.asarray(_AXIS_VECS[forward.upper()], np.float64)
    u = np.asarray(_AXIS_VECS[up.upper()], np.float64)
    r = np.cross(f, u)  # file-frame right axis -> world +X
    return np.stack([r, f, u])


def resolve_device(name: str) -> torch.device:
    """torch.device(name); a CUDA device without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev


def find_mesh(model_path: str, settings=None, task: str | None = None,
              device: torch.device | str = "cpu"):
    """Load the scene mesh onto ``device``. Honors MODEL_FILE (plus
    RGB_MODEL_FILE / SEMANTIC_MODEL_FILE for their tasks), TEXTURE_FILE, the
    OBJ_AXIS_FORWARD/UP import remap and MAX_FACE_EDGE_METERS. OBJs with a
    sibling .mtl load through the per-face-material path (load_obj_mtl)."""
    from ..mesh.mesh import (
        from_arrays,
        load_obj,
        load_obj_mtl,
        load_ply,
        subdivide_mesh,
    )

    tex = (getattr(settings, "TEXTURE_FILE", "") or None) if settings else None
    if tex and not os.path.isabs(tex):
        tex = os.path.join(model_path, tex)

    def host(a, rows=None):
        return None if a is None else a[:rows].cpu().numpy()

    def load_any(p):
        if p.endswith(".ply"):
            return load_ply(p, device=device)
        mtl_exists = False
        with open(p) as fh:
            for line in fh:
                if line.startswith("mtllib"):
                    mtl = os.path.join(os.path.dirname(p), line.split()[-1])
                    mtl_exists = os.path.exists(mtl)
                    break
        mesh = (load_obj_mtl(p, device=device)[0] if mtl_exists
                else load_obj(p, texture_path=tex, device=device))
        fwd = getattr(settings, "OBJ_AXIS_FORWARD", "Y") if settings else "Y"
        up = getattr(settings, "OBJ_AXIS_UP", "Z") if settings else "Z"
        if (fwd.upper(), up.upper()) != ("Y", "Z"):
            M = _obj_axis_matrix(fwd, up)
            nf = mesh.num_faces
            mesh = from_arrays(
                host(mesh.vertices) @ M.T, host(mesh.faces, nf),
                vertex_colors=host(mesh.vertex_colors),
                face_labels=host(mesh.face_labels, nf),
                vertex_uvs=host(mesh.vertex_uvs), texture=host(mesh.texture),
                face_colors=host(mesh.face_colors, nf), device=device)
        return mesh

    names = []
    if settings is not None:
        if task == "rgb" and getattr(settings, "RGB_MODEL_FILE", ""):
            names.append(settings.RGB_MODEL_FILE)
        if task == "semantic" and getattr(settings, "SEMANTIC_MODEL_FILE", ""):
            names.append(settings.SEMANTIC_MODEL_FILE)
        if getattr(settings, "MODEL_FILE", ""):
            names.append(settings.MODEL_FILE)
    names += ["mesh.ply", "mesh.obj", "mesh_semantic.ply", "semantic.obj"]
    for name in names:
        p = os.path.join(model_path, name)
        if os.path.exists(p):
            mesh = load_any(p)
            max_edge = getattr(settings, "MAX_FACE_EDGE_METERS", 0) if settings else 0
            if max_edge:
                mesh = subdivide_mesh(mesh, float(max_edge))
            return mesh
    raise FileNotFoundError(f"no mesh.ply/mesh.obj under {model_path}")


def run_points(model_path: str, settings, device: torch.device | str = "cpu") -> None:
    from ..sampling import (
        generate_points,
        prune_points,
        sample_camera_locations_building,
        sample_camera_locations_object,
        save_camera_poses,
        save_point_info,
    )

    mesh = find_mesh(model_path, settings, device=device)
    rng = np.random.RandomState(settings.RANDOM_SEED)
    pose_file = os.path.join(model_path, settings.CAMERA_POSE_FILE)
    if not settings.GENERATE_CAMERAS:
        if not os.path.exists(pose_file):
            # an explicit reuse request must not silently resample (new
            # cameras would desynchronize point_info from rendered images)
            raise FileNotFoundError(
                f"GENERATE_CAMERAS=False but {pose_file} does not exist")
        with open(pose_file) as fh:
            cams = np.asarray([c["location"] for c in json.load(fh)], np.float32)
    elif settings.SCENE:
        spacing = settings.MIN_CAMERA_DISTANCE or settings.MIN_CAMERA_SPACING
        cams = sample_camera_locations_building(
            mesh, rng,
            min_spacing=spacing,
            min_height=settings.MIN_CAMERA_HEIGHT,
            max_height=settings.MAX_CAMERA_HEIGHT,
            min_clearance=settings.MIN_CAMERA_DISTANCE_TO_MESH,
            max_cameras=settings.NUM_CAMERAS or None,
        )
    else:
        cams = sample_camera_locations_object(mesh, rng, max(settings.NUM_POINTS, 16),
                                              settings.SPHERE_SCALING_FACTOR)
    if settings.NUM_CAMERAS and len(cams) > settings.NUM_CAMERAS:
        # uniform subsample, not a positional prefix (poisson-disc order
        # grows outward from the seed: a prefix is a spatial blob)
        keep = rng.choice(len(cams), settings.NUM_CAMERAS, replace=False)
        cams = cams[np.sort(keep)]
    if len(cams) == 0:
        raise RuntimeError("no viable camera locations found")
    if settings.POINT_TYPE == "SWEEP":
        # per-camera sweep / pano cube-face views with K/RT matrices
        from ..sampling.sweep import generate_points_per_camera

        poses = {
            str(i).zfill(4): {
                "position": cams[i],
                "rotation": (np.pi / 2, 0.0, rng.uniform(-np.pi, np.pi)),
            }
            for i in range(len(cams))
        }
        infos = generate_points_per_camera(
            poses, num_points=settings.NUM_POINTS_PER_CAMERA,
            resolution=settings.RESOLUTION, rng=rng,
            panos=settings.CREATE_PANOS,
        )
        save_point_info(model_path, infos)
        save_camera_poses(model_path, cams)
        n_views = sum(len(v) for v in infos)
        print(f"[points] SWEEP: {len(infos)} cameras, {n_views} views")
        return
    infos = generate_points(
        mesh, cams, rng,
        n_points=settings.NUM_POINTS,
        min_views_per_point=settings.MIN_VIEWS_PER_POINT,
        max_views_per_point=settings.MAX_VIEWS_PER_POINT,
        resolution=settings.RESOLUTION,
    )
    infos = prune_points(infos, min_views=settings.MIN_VIEWS_AFTER_PRUNE,
                         min_nonfixated=settings.MIN_NONFIXATED_AFTER_PRUNE)
    save_point_info(model_path, infos)
    save_camera_poses(model_path, cams)
    n_views = sum(len(v) for v in infos)
    print(f"[points] {len(infos)} points, {n_views} views -> {model_path}/point_info")


def run_trajectory(model_path: str, settings) -> None:
    """Smooth-trajectory frames for each point: interpolated frames between
    the views' own (fixated) rotations, camera_uuid = zero-padded frame
    index, saved into point_info in place of the point's views."""
    import glob

    from ..core.rotations import (
        euler_xyz_to_matrix,
        matrix_to_euler_xyz,
        matrix_to_quat,
        quat_to_matrix,
    )
    from ..sampling import interpolate_trajectory, load_point_info, save_point_info
    from ..sampling.points import _f32

    def rotation_of(v):
        if "camera_rotation_final_quaternion" in v:
            return quat_to_matrix(_f32(v["camera_rotation_final_quaternion"])).numpy()
        return euler_xyz_to_matrix(_f32(v["camera_rotation_final"])).numpy()

    infos = load_point_info(model_path)
    out = []
    for views in infos:
        if len(views) < 2:
            continue
        pt = np.asarray(views[0]["point_location"], np.float32)
        cams = np.stack([np.asarray(v["camera_location"], np.float32) for v in views])
        key_Rs = np.stack([rotation_of(v) for v in views])
        locs, Rs, key_view, is_key = interpolate_trajectory(cams, pt, key_Rs)
        frames = []
        for t, (loc, R) in enumerate(zip(locs, Rs)):
            # interpolated frames copy the governing keyframe's point_info
            v = dict(views[int(key_view[t])])
            v["camera_uuid"] = str(t).zfill(4)
            v["view_id"] = t
            v["fixated"] = bool(is_key[t])
            v["camera_location"] = [float(x) for x in loc]
            v["camera_rotation_final"] = [
                float(x) for x in matrix_to_euler_xyz(_f32(R)).numpy()]
            v["camera_rotation_final_quaternion"] = [
                float(x) for x in matrix_to_quat(_f32(R)).numpy()]
            v["camera_distance"] = float(np.linalg.norm(pt - loc))
            frames.append(v)
        out.append(frames)
    # a trajectory REPLACES its point's view set: clear the old view JSONs
    # first, or renders mix stale views with trajectory frames
    d = os.path.join(model_path, "point_info")
    for frames in out:
        pat = os.path.join(
            d, f"point_{frames[0]['point_uuid']}_view_*_domain_fixatedpose.json")
        for f in glob.glob(pat):
            os.remove(f)
    skipped = [v[0]["point_uuid"] for v in infos if len(v) < 2]
    if skipped:
        print(f"[trajectory] skipped single-view points (kept as-is): "
              f"{skipped[:8]}{'…' if len(skipped) > 8 else ''}")
    save_point_info(model_path, out)
    n = sum(len(v) for v in out)
    print(f"[trajectory] {len(out)} trajectories, {n} frames")


def view_batch(views: list, resolution: int, device: torch.device | str):
    """One Camera batch for point_info view dicts (rotations computed on
    the host, then moved to ``device``)."""
    from ..core.cameras import Camera, camera_from_view_dict

    cams = [camera_from_view_dict(v, resolution=resolution) for v in views]
    return Camera(torch.stack([c.location for c in cams]).to(device),
                  torch.stack([c.R for c in cams]).to(device),
                  torch.stack([c.fov for c in cams]).to(device), resolution)


def view_camera(view: dict, resolution: int, device: torch.device | str):
    """One point_info view's camera (location (3,), R (3,3), fov ()) on
    ``device``."""
    from ..core.cameras import Camera, camera_from_view_dict

    c = camera_from_view_dict(view, resolution=resolution)
    return Camera(c.location.to(device), c.R.to(device), c.fov.to(device),
                  resolution)


def annotate_kwargs(settings, mods: tuple) -> dict:
    """The keyword arguments a device pass gives ``annotate_views`` for the
    modalities ``mods``; the raster kernel is left to its size rule."""
    kb = int(getattr(settings, "KEYPOINT_BLUR_RADIUS", 0))
    # cv2's kernel-size -> sigma rule
    kb_sigma = 0.3 * ((kb - 1) * 0.5 - 1) + 0.8 if kb > 1 else 0.0
    return dict(tile=settings.RASTER_TILE, chunk=settings.RASTER_CHUNK,
                modalities=mods, keypoint_blur_sigma=kb_sigma)


def prepare_device_mesh(model_path: str, tasks, settings, mesh_task=None,
                        device: torch.device | str = "cpu"):
    """The mesh a device pass renders and its curvature mesh: a colourless
    mesh gets neutral grey vertex colours (rgb/edge/keypoint cues stay
    defined); curvature colours are baked when principal_curvature is
    asked for. -> (mesh, curvature mesh or None)."""
    from ..cues.curvature import bake_curvature_colors

    mesh = find_mesh(model_path, settings,
                     task=mesh_task or (tasks[0] if len(tasks) == 1 else None),
                     device=device)
    if mesh.vertex_colors is None and mesh.face_colors is None:
        mesh = mesh._replace(vertex_colors=torch.full(
            (mesh.num_vertices, 3), 0.5, device=mesh.vertices.device))
    curv = None
    if "principal_curvature" in tasks:
        curv = bake_curvature_colors(mesh, min_radius=settings.MIN_CURVATURE_RADIUS)
    return mesh, curv


def device_views(model_path: str, settings) -> list:
    """The views a device pass renders, in order: this process's stripe of
    the points, at most STOP_VIEW_NUMBER + 1 views each when it is set."""
    from ..sampling import load_point_info
    from ..train.multihost import stripe

    infos = stripe(load_point_info(model_path))
    stop = int(getattr(settings, "STOP_VIEW_NUMBER", -1))
    if stop >= 0:
        infos = [views[: stop + 1] for views in infos]
    return [v for views in infos for v in views]


def device_prefixes(host_tasks, mods, settings, device: torch.device | str) -> dict:
    """Which of the host cues' prefixes a pass computes on the device: those
    whose cue it feeds and whose inputs it renders, on a card (the JAX CLI's
    batched path on a TPU) or on the CPU with FORCE_BATCHED_PATH set (that
    path off a TPU); none otherwise -> {"narf", "seg2d", "seg25d": bool}."""
    route = batched_route(settings, device)
    return {
        "narf": route and "keypoints3d" in host_tasks and "depth_zbuffer" in mods,
        "seg2d": (route and "segment_unsup2d" in host_tasks and "rgb" in mods
                  and float(settings.SEGMENTATION_2D_BLUR) > 0),
        "seg25d": route and "segment_unsup25d" in host_tasks and all(
            m in mods for m in ("depth_zbuffer", "normal", "edge_occlusion")),
    }


def device_cue_maps(out: dict, fov: torch.Tensor, settings, prefixes: dict) -> dict:
    """The host cues' input maps of one rendered batch, on its device:
    "narf" (per level (change, cdir, shadow) codes, every view at
    ``max_levels_for(RESOLUTION)`` levels), "seg2d_q" and "seg25d_q" (uint16
    codes), as ``prefixes`` asks."""
    maps = {}
    if prefixes["narf"]:
        from ..cues import narf_device

        res = settings.RESOLUTION
        maxm = float(settings.DEPTH_ZBUFFER_MAX_DISTANCE_METERS)
        depth_m = out["depth_zbuffer"].to(torch.int32).to(torch.float32) * (
            maxm / 65535.0)
        maps["narf"] = narf_device.narf_border_maps(
            depth_m, narf_device.focal_px(fov, res),
            narf_device.max_levels_for(res, res), maxm)
    if prefixes["seg2d"] and "rgb" in out:
        from ..cues.seg_device import seg2d_blur_maps

        maps["seg2d_q"] = seg2d_blur_maps(
            out["rgb"], sigma=float(settings.SEGMENTATION_2D_BLUR))
    if prefixes["seg25d"]:
        from ..cues.seg_device import seg25d_channel_maps

        maps["seg25d_q"] = seg25d_channel_maps(
            out["depth_zbuffer"], out["normal"], out["edge_occlusion"])
    return maps


def view_cue_maps(maps: dict, vi: int, view: dict, resolution: int) -> dict | None:
    """One view's slice of a fetched batch's device maps: the NARF levels cut
    to its own pyramid depth (n_levels_for its focal)."""
    vmaps = {}
    if "narf" in maps:
        from ..cues.narf_device import n_levels_for

        f_px = resolution / (2.0 * math.tan(view["field_of_view_rads"] / 2.0))
        S = min(len(maps["narf"]), n_levels_for(f_px, resolution, resolution))
        vmaps["narf"] = [(lvl[0][vi], lvl[1][vi], lvl[2][vi])
                         for lvl in maps["narf"][:S]]
    for key in ("seg2d_q", "seg25d_q"):
        if key in maps:
            vmaps[key] = maps[key][vi]
    return vmaps or None


def fetch_to_host(tree, ready=None, stream=None):
    """Tensors of a tree of dicts, lists and tuples -> the same tree of numpy
    arrays.

    With a side ``stream`` (on a card), each tensor is copied into a pinned
    host buffer on that stream once the event ``ready`` (recorded after the
    work that made the tree) has fired, so the copy waits only for that work
    and not for what the main stream has enqueued since; then the copies are
    waited for. Without one, each tensor is ``.cpu()``'d in turn.

    The copies are span ``pipeline.fetch`` (``utils.profiler``; on a card
    its events sit on the side stream, after the wait for ``ready``); the
    bytes copied go to counter ``fetch.bytes`` and, where torch keeps the
    pinned allocator's statistics, the pinned host bytes newly allocated
    through CUDA to ``fetch.pinned_alloc_bytes``."""
    if stream is None:
        with profiler.span("pipeline.fetch"):
            out = tree_map(lambda x: x.cpu().numpy(), tree)
        if profiler.recording():
            profiler.count("fetch.bytes", _tree_bytes(tree))
        return out

    def copy(x):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        x.record_stream(stream)
        host.copy_(x, non_blocking=True)
        return host

    on = profiler.recording()
    pinned = _pinned_bytes() if on else None
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        with profiler.span("pipeline.fetch", stream=stream):
            host = tree_map(copy, tree)
        done = torch.cuda.Event()
        done.record(stream)
    if on:
        profiler.count("fetch.bytes", _tree_bytes(tree))
        if pinned is not None:
            profiler.count("fetch.pinned_alloc_bytes", _pinned_bytes() - pinned)
    done.synchronize()
    return tree_map(lambda x: x.numpy(), host)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _pinned_bytes() -> int | None:
    """Pinned host bytes the caching host allocator has allocated through
    CUDA so far, or None where torch does not report it."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return None if stats is None else stats().get("allocated_bytes.allocated")


def tree_map(fn, tree):
    """fn on each leaf of a tree of dicts, lists and tuples -> the same tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def render_batches(batches, mesh, curv, kw: dict, labels, settings, prefixes: dict):
    """The batched route's pipeline: ``annotate_views`` and
    ``device_cue_maps`` on each camera batch in turn -> yields, in order,
    each batch's (labels named in ``labels``, cue maps) on the host.

    Batch b is yielded once batch b+1's render is enqueued and its fetch
    submitted. One fetch thread copies each batch as soon as its own work
    is done: on a card into pinned host buffers on a side stream
    (``fetch_to_host``), so batch b's copy runs beside batch b+1's render
    instead of queueing behind it on the one stream.

    Each batch is a ``utils.profiler`` batch, read once as it is pulled:
    its spans and counts, in this thread and in the fetch thread, share its
    id and record when it began while recording. The wait for a batch's
    fetch is span ``pipeline.wait`` (host time)."""
    from concurrent.futures import ThreadPoolExecutor

    from .pipeline import annotate_views

    def fetched(fut, batch):
        with profiler.in_batch(batch), profiler.span("pipeline.wait", device=False):
            return fut.result()

    dev = mesh.vertices.device
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    with ThreadPoolExecutor(max_workers=1) as fetcher:
        prev = None
        for cams in batches:
            batch = profiler.new_batch()
            with profiler.in_batch(batch):
                out = annotate_views(cams, mesh, curv, **kw)
                tree = ({t: out[t] for t in labels if t in out},
                        device_cue_maps(out, cams.fov, settings, prefixes))
            ready = None
            if side is not None:
                ready = torch.cuda.Event()
                ready.record()
            fut = fetcher.submit(profiler.call_in_batch, batch, fetch_to_host,
                                 tree, ready, side)
            del out, tree
            if prev is not None:
                yield fetched(*prev)
            prev = fut, batch
        if prev is not None:
            yield fetched(*prev)


def batched_route(settings, device: torch.device | str) -> bool:
    """The JAX CLI's route rule: batched on a card (a TPU there) or with
    FORCE_BATCHED_PATH set, per view otherwise."""
    return (torch.device(device).type == "cuda"
            or bool(getattr(settings, "FORCE_BATCHED_PATH", 0)))


def view_cap(cam, mesh, settings) -> int:
    """RASTER_CAP doubled until it covers the view's largest per-tile
    candidate count: ``render_view`` drops candidates past its cap."""
    from ..mesh.raster import tile_candidate_counts

    cap = int(settings.RASTER_CAP)
    need = int(tile_candidate_counts(cam, mesh, tile=settings.RASTER_TILE).max())
    while cap < need:
        cap *= 2
    return cap


def run_device_tasks(model_path: str, tasks: list[str], settings,
                     host_tasks: tuple = (), mesh_task: str | None = None,
                     device: torch.device | str = "cpu") -> None:
    """Render the device labels of every view: on the batched route
    (``batched_route``) K views per launch, else one view at a time through
    ``annotate_view`` at ``view_cap``.

    Batched, ``render_batches`` renders and fetches the batches while the
    main thread hands each fetched batch to the PNG writers (8 threads)
    and, for host_tasks (keypoints3d / segment_*), to the host-cue pool,
    which computes them from the in-flight arrays. On the device-prefix
    route (``device_prefixes``) the cues' input maps are computed on the
    device from each batch and fetched with it, in the same copy."""
    from concurrent.futures import ThreadPoolExecutor

    from ..cues.encode import save_png
    from ..sampling import file_name_for
    from ..utils.profiler import Profiler
    from .pipeline import annotate_view

    mesh, curv = prepare_device_mesh(model_path, tasks, settings, mesh_task, device)
    for t in list(tasks) + list(host_tasks):
        os.makedirs(os.path.join(model_path, t), exist_ok=True)
    flat_views = device_views(model_path, settings)
    n_imgs = len(flat_views)

    mods = tuple(t for t in tasks if t in DEVICE_TASKS)
    kw = annotate_kwargs(settings, mods)
    K = int(getattr(settings, "VIEWS_PER_DISPATCH", 32))
    host_kv = _host_cue_settings_kv(settings) if host_tasks else None
    prefixes = device_prefixes(host_tasks, mods, settings, device)
    batched = batched_route(settings, device)
    pending: list = []

    def write_outputs(view, arrs, io_pool, host_pool, dev_maps=None):
        """arrs: {modality: host array} for one view (a subset of mods, e.g.
        no 'semantic' without face labels); dev_maps: its device-computed
        cue input maps (``view_cue_maps``)."""
        for t in arrs:
            ext = "npy" if t == "fragments" else settings.PREFERRED_IMG_EXT
            path = file_name_for(os.path.join(model_path, t),
                                 view["point_uuid"], view["view_id"], t, ext)
            writer = np.save if t == "fragments" else save_png
            pending.append(io_pool.submit(writer, path, arrs[t]))
        if host_pool is not None:
            cue_in = {t: arrs[t] for t in _HOST_CUE_INPUTS if t in arrs}
            if dev_maps and "seg25d_q" in dev_maps:
                # segment_25d then reads only the channel maps: send the
                # pool no normal or edge planes
                cue_in.pop("normal", None)
                cue_in.pop("edge_occlusion", None)
            pending.append(host_pool.submit(
                _host_cue_job, model_path, view, tuple(host_tasks), host_kv,
                cue_in, dev_maps))

    i = 0
    host_pool_cm = _host_cue_pool() if host_tasks else contextlib.nullcontext()
    with Profiler("Render") as pflr, \
            ThreadPoolExecutor(max_workers=8) as io_pool, \
            host_pool_cm as host_pool:
        if batched:
            chunks = [flat_views[s: s + K] for s in range(0, n_imgs, K)]
            cams = (view_batch(c, settings.RESOLUTION, mesh.vertices.device)
                    for c in chunks)
            fetched = render_batches(cams, mesh, curv, kw, mods, settings, prefixes)
            for chunk_views, (arrs, maps) in zip(chunks, fetched):
                for vi, view in enumerate(chunk_views):
                    write_outputs(view, {t: a[vi] for t, a in arrs.items()},
                                  io_pool, host_pool,
                                  view_cue_maps(maps, vi, view, settings.RESOLUTION))
                    i += 1
                    pflr.step(f"finished img {i}/{n_imgs}")
        else:
            for view in flat_views:
                cam = view_camera(view, settings.RESOLUTION, mesh.vertices.device)
                out = annotate_view(cam, mesh, curv,
                                    cap=view_cap(cam, mesh, settings), **kw)
                write_outputs(view, fetch_to_host({t: out[t] for t in mods
                                                   if t in out}),
                              io_pool, host_pool)
                i += 1
                pflr.step(f"finished img {i}/{n_imgs}")
        for f in pending:
            f.result()  # surface any write or cue error
    print(f"[annotate] {n_imgs} views, {len(mods)} device tasks")


def run_pano(model_path: str, settings, device: torch.device | str = "cpu") -> None:
    """Equirectangular panoramas at each camera of camera_poses.json
    (PANO_RESOLUTION, default 2048x1024): depth_euclidean, depth_zbuffer
    (the ray length, for an equirectangular camera), normal (world-frame
    colours), reshading (point lamp at the camera), and rgb / semantic when
    the mesh carries colours / labels."""
    from ..core.rotations import euler_xyz_to_matrix
    from ..cues.encode import encode_depth_16bit, img_as_uint8, save_png
    from ..cues.reshading import reshade
    from ..mesh.pano import pano_rays, render_pano
    from ..mesh.shade import (
        face_labels,
        smooth_normals_world,
        textured_colors,
        vertex_colors,
    )

    mesh = find_mesh(model_path, settings, device=device)
    dev = mesh.vertices.device
    with open(os.path.join(model_path, "camera_poses.json")) as fh:
        cams = json.load(fh)
    W, H = settings.PANO_RESOLUTION
    R_level = euler_xyz_to_matrix(
        torch.tensor([np.pi / 2, 0.0, 0.0], dtype=torch.float32, device=dev))
    has_tex = mesh.texture is not None and mesh.vertex_uvs is not None
    has_rgb = mesh.vertex_colors is not None or has_tex
    tasks = ("depth_euclidean", "depth_zbuffer", "normal", "reshading")
    tasks += ("rgb",) if has_rgb else ()
    tasks += ("semantic",) if mesh.face_labels is not None else ()
    for t in tasks:
        os.makedirs(os.path.join(model_path, t), exist_ok=True)

    def host(x):
        return x.cpu().numpy()

    for cam in cams:
        loc = torch.tensor(cam["location"], dtype=torch.float32, device=dev)
        frag = render_pano(loc, R_level, mesh, width=W, height=H)
        uid = cam["camera_id"]

        def fn(task):
            return os.path.join(
                model_path, task,
                f"point_{uid}_view_equirectangular_domain_{task}.png")

        save_png(fn("depth_euclidean"), host(encode_depth_16bit(
            frag.t, frag.valid, settings.DEPTH_EUCLIDEAN_MAX_DISTANCE_METERS)))
        save_png(fn("depth_zbuffer"), host(encode_depth_16bit(
            frag.z, frag.valid, settings.DEPTH_ZBUFFER_MAX_DISTANCE_METERS)))
        n_world = smooth_normals_world(frag, mesh)
        # world-frame colours, R inverted like the pinhole normal encoding
        col = torch.stack([0.5 - 0.5 * n_world[..., 0], 0.5 + 0.5 * n_world[..., 1],
                           0.5 + 0.5 * n_world[..., 2]], -1)
        col = torch.where(frag.valid[..., None], torch.clamp(col, 0, 1), 0.5)
        save_png(fn("normal"), host(img_as_uint8(col)))
        _, dirs = pano_rays(loc, R_level, W, H)
        save_png(fn("reshading"), host(img_as_uint8(reshade(
            frag.t, n_world, dirs, frag.valid,
            settings.LAMP_ENERGY, settings.LAMP_HALF_LIFE_DISTANCE))))
        if has_rgb:
            rgb = textured_colors(frag, mesh) if has_tex else vertex_colors(frag, mesh)
            rgb = torch.where(frag.valid[..., None], torch.clamp(rgb, 0, 1), 0.0)
            save_png(fn("rgb"), host(img_as_uint8(rgb)))
        if mesh.face_labels is not None:
            save_png(fn("semantic"),
                     host(face_labels(frag, mesh, 0).to(torch.uint8)))
    print(f"[pano] {len(cams)} panoramas at {W}x{H}")


HOST_CUE_TASKS = ("keypoints3d", "segment_unsup2d", "segment_unsup25d")

# inputs a host-cue worker may need from the device batch
_HOST_CUE_INPUTS = ("depth_zbuffer", "rgb", "normal", "edge_occlusion")
# the only settings host_cues_for_view reads (a plain dict, so jobs pickle
# into spawned worker processes)
_HOST_CUE_SETTING_KEYS = (
    "PREFERRED_IMG_EXT", "RESOLUTION", "KEYPOINT_SUPPORT_SIZE",
    "DEPTH_ZBUFFER_MAX_DISTANCE_METERS",
    "SEGMENTATION_2D_SCALE", "SEGMENTATION_2D_BLUR",
    "SEGMENTATION_2D_CUT_THRESH", "SEGMENTATION_2D_SELF_EDGE_WEIGHT",
    "SEGMENTATION_25D_DEPTH_WEIGHT", "SEGMENTATION_25D_NORMAL_WEIGHT",
    "SEGMENTATION_25D_EDGE_WEIGHT", "SEGMENTATION_25D_SCALE",
    "SEGMENTATION_25D_CUT_THRESH", "SEGMENTATION_25D_SELF_EDGE_WEIGHT",
)


def _host_cue_settings_kv(settings) -> dict:
    return {k: getattr(settings, k) for k in _HOST_CUE_SETTING_KEYS}


@contextlib.contextmanager
def _host_cue_pool():
    """Workers for the CPU-bound host cues: a spawned process pool when the
    host has more than one core (felzenszwalb/ncut hold the interpreter lock
    in their numpy/scipy glue), two threads otherwise. The native cores are
    built first, once, so workers only load them.

    Workers must not touch the card: CUDA_VISIBLE_DEVICES is empty in the
    environment they inherit, from the pool's creation until its shutdown
    (workers spawn lazily, on submit). A parent that renders on the card has
    initialised CUDA before this point, so the variable does not reach it."""
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from .._build import build_libraries

    build_libraries(hosts=("narf", "felzenszwalb"))
    ncpu = os.cpu_count() or 1
    if ncpu == 1:
        with ThreadPoolExecutor(max_workers=2) as pool:
            yield pool
        return
    import multiprocessing as mp

    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        with ProcessPoolExecutor(max_workers=min(128, ncpu),
                                 mp_context=mp.get_context("spawn")) as pool:
            yield pool
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


def _host_cue_job(model_path, view, tasks, settings_kv, arrs,
                  dev_maps=None) -> None:
    """Pool entry: host cues for one view from in-memory arrays."""
    from types import SimpleNamespace

    host_cues_for_view(model_path, view, tasks, SimpleNamespace(**settings_kv),
                       arrs.__getitem__, dev_maps=dev_maps)


def _host_cue_disk_job(model_path, view, tasks, settings_kv) -> None:
    """Pool entry: host cues for one view, inputs read from disk (the
    standalone `--task keypoints3d/segment_*` pass)."""
    from types import SimpleNamespace

    from ..cues.encode import load_png
    from ..sampling import file_name_for

    s = SimpleNamespace(**settings_kv)
    p, v = view["point_uuid"], view["view_id"]

    def get(task):
        return load_png(file_name_for(
            os.path.join(model_path, task), p, v, task, s.PREFERRED_IMG_EXT))

    host_cues_for_view(model_path, view, tasks, s, get)


def host_cues_for_view(model_path: str, view: dict, tasks, settings, get,
                       dev_maps=None) -> None:
    """Compute and write one view's host cues (keypoints3d / segment_2d /
    segment_25d); ``get(task)`` returns the task's decoded image, from disk
    or from the in-flight device batch. dev_maps: the view's device-computed
    input maps, if any — "narf" (keypoints3d then runs only its
    region-growing interest stage), "seg2d_q" / "seg25d_q" (the segmentation
    cues then skip their host gaussians)."""
    from ..cues.encode import save_png
    from ..sampling import file_name_for

    dev_maps = dev_maps or {}
    p, v = view["point_uuid"], view["view_id"]

    def out_path(task):
        return file_name_for(os.path.join(model_path, task), p, v, task,
                             settings.PREFERRED_IMG_EXT)

    if "keypoints3d" in tasks:
        from ..cues.keypoints3d import keypoints3d_from_depth_code

        out = keypoints3d_from_depth_code(
            get("depth_zbuffer"), view["field_of_view_rads"],
            settings.RESOLUTION, support_size=settings.KEYPOINT_SUPPORT_SIZE,
            max_meters=settings.DEPTH_ZBUFFER_MAX_DISTANCE_METERS,
            border_maps=dev_maps.get("narf"),
        )
        save_png(out_path("keypoints3d"), out)
    if "segment_unsup2d" in tasks:
        from ..cues.seg_device import seg2d_blurred_from_maps
        from ..cues.segmentation import segment_2d

        blurred = None
        if "seg2d_q" in dev_maps:
            blurred = seg2d_blurred_from_maps(dev_maps["seg2d_q"])
        # keep uint8: felzenszwalb's img_as_float scaling depends on the
        # dtype (a float64 0-255 array would be double-scaled)
        labels = segment_2d(
            np.asarray(get("rgb")),
            scale=settings.SEGMENTATION_2D_SCALE,
            blur=settings.SEGMENTATION_2D_BLUR,
            cut_thresh=settings.SEGMENTATION_2D_CUT_THRESH,
            self_edge_weight=settings.SEGMENTATION_2D_SELF_EDGE_WEIGHT,
            blurred255=blurred,
        )
        save_png(out_path("segment_unsup2d"), labels.astype(np.uint8))
    if "segment_unsup25d" in tasks:
        from ..cues.seg_device import seg25d_input_from_maps
        from ..cues.segmentation import segment_25d

        input_img = None
        if "seg25d_q" in dev_maps:
            input_img = seg25d_input_from_maps(
                dev_maps["seg25d_q"], settings.SEGMENTATION_25D_DEPTH_WEIGHT,
                settings.SEGMENTATION_25D_NORMAL_WEIGHT,
                settings.SEGMENTATION_25D_EDGE_WEIGHT)
        labels = segment_25d(
            get("depth_zbuffer"),
            None if input_img is not None else get("normal"),
            None if input_img is not None else get("edge_occlusion"),
            depth_weight=settings.SEGMENTATION_25D_DEPTH_WEIGHT,
            normal_weight=settings.SEGMENTATION_25D_NORMAL_WEIGHT,
            edge_weight=settings.SEGMENTATION_25D_EDGE_WEIGHT,
            scale=settings.SEGMENTATION_25D_SCALE,
            cut_thresh=settings.SEGMENTATION_25D_CUT_THRESH,
            self_edge_weight=settings.SEGMENTATION_25D_SELF_EDGE_WEIGHT,
            input_img=input_img,
        )
        save_png(out_path("segment_unsup25d"), labels.astype(np.uint8))


def run_host_tasks(model_path: str, tasks: list[str], settings) -> None:
    from ..cues.vanishing import vanishing_points
    from ..sampling import load_point_info, save_point_info

    infos = load_point_info(model_path)
    for t in tasks:
        if t != "vanishing_points":
            os.makedirs(os.path.join(model_path, t), exist_ok=True)

    cue_tasks = [t for t in tasks if t in HOST_CUE_TASKS]
    if cue_tasks:
        kv = _host_cue_settings_kv(settings)
        with _host_cue_pool() as pool:
            futures = [
                pool.submit(_host_cue_disk_job, model_path, view,
                            tuple(cue_tasks), kv)
                for views in infos for view in views
            ]
            for f in futures:
                f.result()

    if "vanishing_points" in tasks:
        for views in infos:
            for view in views:
                img_vps, sphere_vps = vanishing_points(view, settings.RESOLUTION)
                view["vanishing_points_image"] = {
                    k: list(map(float, xy)) for k, xy in zip("xyz", img_vps)
                }
                view["vanishing_points_gaussian_sphere"] = {
                    k: list(map(float, p3)) for k, p3 in zip("xyz", sphere_vps)
                }
        save_point_info(model_path, infos)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # `with KEY=VAL ...` tail (the reference's settings vocabulary)
    overrides = []
    if "with" in argv:
        i = argv.index("with")
        overrides = argv[i + 1:]
        argv = argv[:i]

    p = argparse.ArgumentParser(prog="omnidata-annotate")
    p.add_argument("--model_path", required=True)
    p.add_argument("--task", required=True, help=f"one of {TASKS_ALL} or 'all'")
    p.add_argument("--device", default="cuda",
                   help="torch device for meshes and renders (default cuda)")
    args = p.parse_args(argv)

    from .settings import load_settings

    settings = load_settings(overrides)
    if settings.RESOLUTION_X or settings.RESOLUTION_Y:
        # reference RESOLUTION_X/Y aliases: only square renders supported
        rx = settings.RESOLUTION_X or settings.RESOLUTION_Y
        ry = settings.RESOLUTION_Y or settings.RESOLUTION_X
        if rx != ry:
            raise SystemExit(f"non-square renders unsupported (RESOLUTION_X={rx}, "
                             f"RESOLUTION_Y={ry})")
        from dataclasses import replace

        settings = replace(settings, RESOLUTION=rx)
    device = resolve_device(args.device)
    tasks = TASKS_ALL if args.task == "all" else [args.task]

    t0 = time.time()
    if "points" in tasks:
        run_points(args.model_path, settings, device)
    if args.task == "trajectory" or (settings.CREATE_TRAJECTORY and "points" in tasks):
        run_trajectory(args.model_path, settings)
    if args.task == "pano" or (settings.CREATE_PANOS and "points" in tasks):
        run_pano(args.model_path, settings, device)
    device_tasks = [t for t in tasks if t in DEVICE_TASKS]
    host = [t for t in tasks if t in HOST_CUE_TASKS + ("vanishing_points",)]
    # host cues whose device inputs are part of this run compute from the
    # device batches instead of a separate PNG-reloading pass
    deps = {
        "keypoints3d": {"depth_zbuffer"},
        "segment_unsup2d": {"rgb"},
        "segment_unsup25d": {"depth_zbuffer", "normal", "edge_occlusion"},
    }
    overlapped = tuple(t for t in host if t in deps and deps[t] <= set(device_tasks))
    # RGB_MODEL_FILE / SEMANTIC_MODEL_FILE pick a different mesh for those
    # labels; the rgb-derived cues (edge_texture/keypoints2d) ride with rgb
    groups: list[tuple[list, str | None]] = []
    if getattr(settings, "RGB_MODEL_FILE", "") and len(device_tasks) > 1:
        g = [t for t in device_tasks if t in ("rgb", "edge_texture", "keypoints2d")]
        if g:
            device_tasks = [t for t in device_tasks if t not in g]
            groups.append((g, "rgb"))
    if getattr(settings, "SEMANTIC_MODEL_FILE", "") and "semantic" in device_tasks \
            and len(device_tasks) > 1:
        device_tasks.remove("semantic")
        groups.append((["semantic"], "semantic"))
    if device_tasks:
        groups.insert(0, (device_tasks, None))
    done_overlapped: set = set()
    for tasks_g, mesh_task in groups:
        overlapped_g = tuple(t for t in overlapped
                             if t not in done_overlapped and deps[t] <= set(tasks_g))
        run_device_tasks(args.model_path, tasks_g, settings, host_tasks=overlapped_g,
                         mesh_task=mesh_task, device=device)
        done_overlapped.update(overlapped_g)
    host = [t for t in host if t not in done_overlapped]
    if host:
        run_host_tasks(args.model_path, host, settings)
    print(f"[omnidata-annotate] done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
