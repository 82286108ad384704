"""The device annotation pipeline: K cameras + one mesh -> every device label
modality as (K, H, W, ...) tensors.

One raster kernel launch renders all K views with the vertex attributes the
labels need (normals, colours, curvature colours) interpolated at each
pixel's winning face; the cue stack then runs batched over the views.

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
from ..mesh.raster import render_views_fused
from ..mesh.shade import sample_texture

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
    ``mesh.raster.render_views_fused``)."""
    needs_normals = "normal" in modalities or "reshading" in modalities
    needs_rgb = any(m in modalities for m in _RGB_CUES)
    has_colors = mesh.vertex_colors is not None
    has_texture = mesh.texture is not None and mesh.vertex_uvs is not None

    vertex_attrs, attr_slices = _gather_attrs(mesh, curvature_mesh, modalities)
    if vertex_attrs is not None:
        frag, attr_img = render_views_fused(
            cameras, mesh, tile, chunk, vertex_attrs, ccap=ccap,
            streamed=streamed)
    else:
        frag = render_views_fused(cameras, mesh, tile, chunk, ccap=ccap,
                                  streamed=streamed)
        attr_img = None

    out: dict[str, torch.Tensor] = {}
    if "depth_zbuffer" in modalities or "edge_occlusion" in modalities:
        out["depth_zbuffer"] = encode_depth_16bit(frag.z, frag.valid)
    if "depth_euclidean" in modalities:
        out["depth_euclidean"] = encode_depth_16bit(frag.t, frag.valid)
    if "mask_valid" in modalities:
        out["mask_valid"] = mask_valid_image(frag.valid)

    if needs_normals:
        n = attr_img[..., attr_slices["normal"]]
        norm = torch.sqrt(torch.sum(n * n, -1, keepdim=True))
        n_world = n / torch.clamp(norm, min=1e-12)
    if "normal" in modalities:
        n_cam = _rotate_to_camera(cameras.R, n_world)
        out["normal"] = img_as_uint8(encode_normals_color(n_cam, frag.valid))
    if "reshading" in modalities:
        _, dirs = camera_rays(cameras)
        out["reshading"] = img_as_uint8(
            reshade(frag.t, n_world, dirs, frag.valid))

    has_face_colors = mesh.face_colors is not None
    if needs_rgb and (has_colors or has_texture or has_face_colors):
        if "uv" in attr_slices:
            rgb = torch.where(
                frag.valid[..., None],
                sample_texture(attr_img[..., attr_slices["uv"]], mesh.texture),
                0.0)
        elif "rgb" in attr_slices:
            rgb = torch.where(
                frag.valid[..., None],
                torch.clamp(attr_img[..., attr_slices["rgb"]], 0.0, 1.0), 0.0)
        else:  # per-face material colours
            rgb = torch.where(
                frag.valid[..., None],
                mesh.face_colors[torch.clamp(frag.face, min=0).long()], 0.0)
        if "rgb" in modalities:
            out["rgb"] = img_as_uint8(rgb)
        gray = torch.mean(rgb, -1)
        if "edge_texture" in modalities:
            out["edge_texture"] = img_as_uint16(edge_texture(gray, sigma=3.0))
        if "keypoints2d" in modalities:
            kg = gray
            if keypoint_blur_sigma > 0:  # KEYPOINT_BLUR_RADIUS preprocessing
                kg = gaussian_blur_constant(kg, keypoint_blur_sigma)
            out["keypoints2d"] = img_as_uint16(
                torch.clamp(keypoints2d(kg), 0.0, 1.0))

    if "principal_curvature" in modalities and curvature_mesh is not None:
        cc = torch.where(
            frag.valid[..., None],
            torch.clamp(attr_img[..., attr_slices["curv"]], 0.0, 1.0), 0.0)
        out["principal_curvature"] = img_as_uint8(cc)

    if "fragments" in modalities:
        out["fragments"] = frag.face.to(torch.int32)

    if "semantic" in modalities and mesh.face_labels is not None:
        lab = mesh.face_labels[torch.clamp(frag.face, min=0).long()]
        out["semantic"] = torch.where(frag.valid, lab, 0).to(torch.uint8)

    if "edge_occlusion" in modalities:
        out["edge_occlusion"] = img_as_uint16(
            edge_occlusion(out["depth_zbuffer"]))
        if "depth_zbuffer" not in modalities:
            del out["depth_zbuffer"]

    return out
