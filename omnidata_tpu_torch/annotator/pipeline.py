"""The device annotation pipeline: K cameras + one mesh -> every device label
modality as (K, H, W, ...) tensors (``annotate_views``), or one camera ->
(H, W, ...) tensors (``annotate_view``).

``annotate_views``: one raster kernel launch renders all K views with the
vertex attributes the labels need (normals, colours, curvature colours)
interpolated at each pixel's winning face; the cue stack then runs batched
over the views. ``annotate_view`` renders one view with the raster kernel
(K = 1) or with the plain ``render_view``, and shades from the fragments
unless asked for the kernel's interpolated attributes.

Modalities: depth_zbuffer (u16) · depth_euclidean (u16) · mask_valid (u8) ·
normal (u8 RGB) · reshading (u8) · rgb (u8) · principal_curvature (u8 RG) ·
edge_occlusion (u16) · edge_texture (u16) · keypoints2d (u16) · semantic
(u8, meshes with face labels) · fragments (i32 face ids).
"""
from __future__ import annotations

import torch

from ..core.cameras import Camera, camera_rays
from ..cues.edges import edge_occlusion, edge_texture, gaussian_blur_constant
from ..cues.encode import (
    encode_depth_16bit,
    encode_normals_color,
    img_as_uint8,
    img_as_uint16,
    mask_valid_image,
)
from ..cues.keypoints2d import keypoints2d
from ..cues.reshading import reshade
from ..mesh.mesh import TriangleMesh
from ..mesh.raster import Fragments, _one_view, render_view, render_views_fused
from ..mesh.shade import (
    face_flat_colors,
    face_labels,
    sample_texture,
    smooth_normals_world,
    textured_colors,
    vertex_colors,
)
from ..utils import profiler

DEVICE_MODALITIES = (
    "depth_zbuffer",
    "depth_euclidean",
    "mask_valid",
    "normal",
    "reshading",
    "rgb",
    "principal_curvature",
    "edge_occlusion",
    "edge_texture",
    "keypoints2d",
    "semantic",
    "fragments",
)

_RGB_CUES = ("rgb", "edge_texture", "keypoints2d")


def _gather_attrs(mesh: TriangleMesh, curvature_mesh: TriangleMesh | None,
                  modalities: tuple):
    """Vertex-attribute columns to interpolate at the winning face, and the
    channel slice of each -> (vertex_attrs (V,C) or None, slices)."""
    needs_normals = "normal" in modalities or "reshading" in modalities
    needs_rgb = any(m in modalities for m in _RGB_CUES)
    has_texture = mesh.texture is not None and mesh.vertex_uvs is not None
    cols, attr_slices = [], {}

    def add(name, a):
        start = sum(c.shape[1] for c in cols)
        attr_slices[name] = slice(start, start + a.shape[1])
        cols.append(a)

    if needs_normals:
        add("normal", mesh.vertex_normals)
    if needs_rgb and has_texture:
        add("uv", mesh.vertex_uvs)
    elif needs_rgb and mesh.vertex_colors is not None:
        add("rgb", mesh.vertex_colors)
    if "principal_curvature" in modalities and curvature_mesh is not None:
        add("curv", curvature_mesh.vertex_colors)
    vertex_attrs = torch.cat(cols, -1) if cols else None
    return vertex_attrs, attr_slices


def _rotate_to_camera(R: torch.Tensor, n_world: torch.Tensor) -> torch.Tensor:
    """n_cam = R^T n per view: (K,3,3), (K,H,W,3) -> (K,H,W,3)."""
    Rt = R.transpose(-1, -2)[:, None, None]
    return (Rt[..., :, 0] * n_world[..., 0:1] + Rt[..., :, 1] * n_world[..., 1:2]
            + Rt[..., :, 2] * n_world[..., 2:3])


def annotate_views(
    cameras: Camera,
    mesh: TriangleMesh,
    curvature_mesh: TriangleMesh | None = None,
    tile: int = 64,
    chunk: int = 128,
    modalities: tuple = DEVICE_MODALITIES,
    keypoint_blur_sigma: float = 0.0,
    ccap: int | None = None,
    streamed: bool | None = None,
) -> dict[str, torch.Tensor]:
    """Batched annotation: K cameras (leading batch dim on location/R/fov)
    -> {modality: (K, H, W, ...)}.

    curvature_mesh: the same geometry with curvature RG vertex colours baked
    (cues.curvature.bake_curvature_colors); it shares the fragments.
    streamed: render with the streamed, compacting raster kernel (True),
    the chunk-list kernel (False), or by the size of the scene pack (None;
    ``mesh.raster.render_views_fused``). The cue stack is span
    ``annotate.labels`` (``utils.profiler``), keypoints2d within it
    ``cues.keypoints2d``."""
    vertex_attrs, attr_slices = _gather_attrs(mesh, curvature_mesh, modalities)
    if vertex_attrs is not None:
        frag, attr_img = render_views_fused(
            cameras, mesh, tile, chunk, vertex_attrs, ccap=ccap,
            streamed=streamed)
    else:
        frag = render_views_fused(cameras, mesh, tile, chunk, ccap=ccap,
                                  streamed=streamed)
        attr_img = None
    with profiler.span("annotate.labels"):
        return _labels(frag, cameras, mesh, curvature_mesh, modalities,
                       keypoint_blur_sigma, attr_img, attr_slices)


def annotate_view(
    camera: Camera,
    mesh: TriangleMesh,
    curvature_mesh: TriangleMesh | None = None,
    tile: int = 64,
    cap: int = 1024,
    chunk: int = 128,
    parallel_tiles: bool = False,
    modalities: tuple = DEVICE_MODALITIES,
    use_pallas: bool | None = None,
    fused_attrs: bool = False,
    keypoint_blur_sigma: float = 0.0,
) -> dict[str, torch.Tensor]:
    """One view (location (3,), R (3,3), fov ()) -> {modality: (H, W, ...)}
    (``omnidata_tpu.annotator.pipeline.annotate_view``).

    use_pallas: render with the raster kernel, ``render_views_fused`` at
    K = 1 (True), or with the plain ``render_view`` (False); None takes the
    kernel when the mesh is on a CUDA device and ``render_view`` elsewhere.
    The kernel route shades from the fragments (interpolated vertex
    normals and colours, texture, face colours and labels) unless
    fused_attrs, which takes the kernel's interpolated attributes instead.
    cap: ``render_view``'s per-tile face capacity (the kernels need none);
    parallel_tiles is accepted for the JAX signature and ignored."""
    del parallel_tiles
    if use_pallas is None:
        use_pallas = mesh.vertices.device.type == "cuda"
    cams = _one_view(camera)
    attr_img, attr_slices = None, {}
    if not use_pallas:
        frag = Fragments(*(x[None] for x in render_view(camera, mesh, tile, cap,
                                                         chunk)))
    else:
        vertex_attrs = None
        if fused_attrs:
            vertex_attrs, attr_slices = _gather_attrs(mesh, curvature_mesh,
                                                      modalities)
        frag = render_views_fused(cams, mesh, tile, chunk, vertex_attrs)
        if vertex_attrs is not None:
            frag, attr_img = frag
    out = _labels(frag, cams, mesh, curvature_mesh, modalities,
                  keypoint_blur_sigma, attr_img, attr_slices)
    return {k: v[0] for k, v in out.items()}


def _labels(frag: Fragments, cameras: Camera, mesh: TriangleMesh,
            curvature_mesh: TriangleMesh | None, modalities: tuple,
            keypoint_blur_sigma: float, attr_img: torch.Tensor | None,
            attr_slices: dict) -> dict[str, torch.Tensor]:
    """The cue stack on (K,H,W) fragments. Normals, colours and curvature
    colours come from attr_img (the kernel's interpolated attributes,
    sliced by attr_slices) when it is given, else are shaded from the
    fragments."""
    needs_normals = "normal" in modalities or "reshading" in modalities
    needs_rgb = any(m in modalities for m in _RGB_CUES)
    has_colors = mesh.vertex_colors is not None
    has_texture = mesh.texture is not None and mesh.vertex_uvs is not None

    out: dict[str, torch.Tensor] = {}
    if "depth_zbuffer" in modalities or "edge_occlusion" in modalities:
        out["depth_zbuffer"] = encode_depth_16bit(frag.z, frag.valid)
    if "depth_euclidean" in modalities:
        out["depth_euclidean"] = encode_depth_16bit(frag.t, frag.valid)
    if "mask_valid" in modalities:
        out["mask_valid"] = mask_valid_image(frag.valid)

    if needs_normals and attr_img is not None:
        n = attr_img[..., attr_slices["normal"]]
        norm = torch.sqrt(torch.sum(n * n, -1, keepdim=True))
        n_world = n / torch.clamp(norm, min=1e-12)
    elif needs_normals:
        n_world = smooth_normals_world(frag, mesh)
    if "normal" in modalities:
        n_cam = _rotate_to_camera(cameras.R, n_world)
        out["normal"] = img_as_uint8(encode_normals_color(n_cam, frag.valid))
    if "reshading" in modalities:
        _, dirs = camera_rays(cameras)
        out["reshading"] = img_as_uint8(
            reshade(frag.t, n_world, dirs, frag.valid))

    has_face_colors = mesh.face_colors is not None
    if needs_rgb and (has_colors or has_texture or has_face_colors):
        valid = frag.valid[..., None]
        if attr_img is not None and "uv" in attr_slices:
            # the JAX package's _sample_texture: clamped uvs, bilinear
            rgb = torch.where(
                valid, sample_texture(attr_img[..., attr_slices["uv"]],
                                      mesh.texture), 0.0)
        elif attr_img is not None and "rgb" in attr_slices:
            rgb = torch.where(
                valid, torch.clamp(attr_img[..., attr_slices["rgb"]], 0.0, 1.0),
                0.0)
        elif attr_img is None and has_texture:
            rgb = textured_colors(frag, mesh)
        elif attr_img is None and has_colors:
            rgb = vertex_colors(frag, mesh)
        else:  # per-face material colours
            rgb = face_flat_colors(frag, mesh)
        if "rgb" in modalities:
            out["rgb"] = img_as_uint8(rgb)
        gray = torch.mean(rgb, -1)
        if "edge_texture" in modalities:
            out["edge_texture"] = img_as_uint16(edge_texture(gray, sigma=3.0))
        if "keypoints2d" in modalities:
            kg = gray
            if keypoint_blur_sigma > 0:  # KEYPOINT_BLUR_RADIUS preprocessing
                kg = gaussian_blur_constant(kg, keypoint_blur_sigma)
            with profiler.span("cues.keypoints2d"):
                kp = keypoints2d(kg)
            out["keypoints2d"] = img_as_uint16(torch.clamp(kp, 0.0, 1.0))

    if "principal_curvature" in modalities and curvature_mesh is not None:
        if attr_img is not None:
            cc = torch.where(
                frag.valid[..., None],
                torch.clamp(attr_img[..., attr_slices["curv"]], 0.0, 1.0), 0.0)
        else:
            cc = vertex_colors(frag, curvature_mesh)
        out["principal_curvature"] = img_as_uint8(cc)

    if "fragments" in modalities:
        out["fragments"] = frag.face.to(torch.int32)

    if "semantic" in modalities and mesh.face_labels is not None:
        out["semantic"] = face_labels(frag, mesh, background=0).to(torch.uint8)

    if "edge_occlusion" in modalities:
        out["edge_occlusion"] = img_as_uint16(
            edge_occlusion(out["depth_zbuffer"]))
        if "depth_zbuffer" not in modalities:
            del out["depth_zbuffer"]

    return out
