"""Batched ray-cast renderer for K views of one mesh: chunk admission, the
raster kernel, winner decode.

``render_views_fused`` is the annotator's render stage:
1. per view and face, conservative near-plane-aware screen bboxes;
2. per (view, tile), the ascending list of 128-face Morton chunks that hold
   at least one face whose bbox overlaps the tile (``admission_lists``);
3. a raster kernel (``raster_kernels``) sweeps the listed chunks and keeps,
   per pixel, the winner's packed key and its scene-pack columns: kernel A
   (chunk list), B (compacting: only the faces whose ``bbox_words`` overlap
   the tile) or C (streamed: the pack chunk-major, compacting by default);
4. ``raster_kernels.decode_winners`` recomputes the winner's exact t/u/v and
   interpolates vertex attributes; tiles are put back into images.

Tie semantics, admission encoding and outputs are those of
``omnidata_tpu.mesh.raster.render_views_fused``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.cameras import Camera, camera_rays, extrinsic_RT, intrinsic_matrix
from .mesh import TriangleMesh
from .raster_kernels import (
    CHUNK_LIST_CAP,
    STAGE_CAP,
    STREAMED_STAGE_CAP,
    decode_winners,
    raster_tiles_chunklist,
    raster_tiles_compact,
    raster_tiles_streamed,
)

_BIG = 1e30
_NEAR = 1e-4
_BIGF = 1e9  # bbox value of dead faces: any overlap test fails

# meshes with more chunks than this use two-stage (block -> chunk)
# admission lists; below it the flat per-chunk top-k is cheap enough
HIER_ADMISSION_MIN_CHUNKS = 1024
EXPAND_BCAP = 32  # hier stage-2 sort width = 8*EXPAND_BCAP candidate chunks

# render_views_fused(streamed=None) takes the streamed kernel (C) for scene
# packs larger than this. The bound is the JAX package's TPU one (its
# chunk-list kernel keeps the whole pack in VMEM), kept so both packages run
# the same kernel on the same scene; no crossover of A and C was measured
# for it on a card. All three kernels render bitwise alike.
STREAMED_PACK_BYTES = 8 * 1024 * 1024


def pack_bytes(n_faces: int, n_attr_channels: int) -> int:
    """Bytes of the scene pack: per face 10 + 3 x attribute channels
    float32 columns, plus the 13 face planes the JAX package counts."""
    return n_faces * (10 + 3 * n_attr_channels + 13) * 4


class Fragments(NamedTuple):
    """Per-pixel geometry buffers, (K,H,W) unless noted.

    t: euclidean distance along the ray · z: distance along the camera
    forward axis · face: hit face index or -1 · bary: (K,H,W,2) barycentric
    (u,v) · valid: hit mask."""

    t: torch.Tensor
    z: torch.Tensor
    face: torch.Tensor
    bary: torch.Tensor
    valid: torch.Tensor


def _affine3(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rows of M (...,3,C) applied to points p (...,3): out_i = sum_j
    M_ij p_j (+ M_i3 when C == 4), summed left to right."""
    out = (M[..., 0] * p[..., 0:1] + M[..., 1] * p[..., 1:2]
           + M[..., 2] * p[..., 2:3])
    return out + M[..., 3] if M.shape[-1] == 4 else out


def face_screen_bboxes(cameras: Camera, mesh: TriangleMesh,
                       tris_w: torch.Tensor | None = None):
    """Conservative per-face screen bboxes for a batch of K cameras:
    lo, hi (K,F,2) and the live mask (K,F).

    Near-plane-aware: faces entirely behind z = near are dead; faces that
    straddle the plane get a bbox over their in-front vertices plus the
    edge/near-plane crossings. Dead and off-screen faces carry lo = +BIG,
    hi = -BIG so any overlap test fails. tris_w: optional pre-gathered
    (F,3,3) world-space corners."""
    res = cameras.resolution
    Kmat = intrinsic_matrix(cameras.fov, res)  # (K,3,3)
    RT = extrinsic_RT(cameras.location, cameras.R)  # (K,3,4)
    if tris_w is None:
        tris_w = mesh.vertices[mesh.faces.long()]
    tri_cam = _affine3(RT[:, None, None], tris_w[None])  # (K,F,3,3)
    tri_z = tri_cam[..., 2]  # (K,F,3)

    def to_uv(pts_cam):  # (K,...,3) camera-frame points
        lead = (1,) * (pts_cam.dim() - 2)
        uvw = _affine3(Kmat.reshape(-1, *lead, 3, 3), pts_cam)
        zz = torch.clamp(uvw[..., 2], min=_NEAR)
        return uvw[..., :2] / zz[..., None]

    front = tri_z > _NEAR
    any_front = front.any(-1)
    uv_v = to_uv(tri_cam)  # garbage where behind; masked below

    K, F = tri_z.shape[:2]
    lo = torch.full((K, F, 2), _BIGF, device=tri_z.device)
    hi = torch.full((K, F, 2), -_BIGF, device=tri_z.device)
    for i in range(3):
        m = front[..., i:i + 1]
        lo = torch.minimum(lo, torch.where(m, uv_v[:, :, i], _BIGF))
        hi = torch.maximum(hi, torch.where(m, uv_v[:, :, i], -_BIGF))
        j = (i + 1) % 3
        a, b = tri_cam[:, :, i], tri_cam[:, :, j]
        za, zb = tri_z[..., i], tri_z[..., j]
        crosses = (za > _NEAR) != (zb > _NEAR)
        tcl = (_NEAR - za) / torch.where(zb == za, 1.0, zb - za)
        pc = a + tcl[..., None] * (b - a)
        pc = torch.cat([pc[..., :2], torch.full_like(pc[..., 2:], _NEAR)], -1)
        uv_c = to_uv(pc)
        cm = crosses[..., None]
        lo = torch.minimum(lo, torch.where(cm, uv_c, _BIGF))
        hi = torch.maximum(hi, torch.where(cm, uv_c, -_BIGF))

    real = torch.arange(F, device=tri_z.device) < mesh.num_faces
    live = real & any_front
    on_screen = ((hi[..., 0] >= 0) & (lo[..., 0] <= res)
                 & (hi[..., 1] >= 0) & (lo[..., 1] <= res))
    live = live & on_screen
    lo = torch.where(live[..., None], lo, _BIGF)
    hi = torch.where(live[..., None], hi, -_BIGF)
    return lo, hi, live


def scene_pack(mesh: TriangleMesh, attrs: tuple = ()) -> torch.Tensor:
    """(F, 10 + 3*C) per-face columns: v0/e1/e2 xyz, the face id (float32,
    exact below 2^24), then the three corner values of each attribute
    channel. The kernel reads its geometry from rows 0-8 of the transpose
    and copies the winner's whole column."""
    F = mesh.faces.shape[0]
    faces = mesh.faces.long()
    tris = mesh.vertices[faces]  # (F,3,3)
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    fid = torch.arange(F, dtype=torch.float32, device=tris.device)[:, None]
    cols = [v0, e1, e2, fid]
    for a in attrs:
        ca = a[faces]  # (F,3,C)
        cols.append(ca.transpose(1, 2).reshape(F, -1))  # (F,3C)
    return torch.cat(cols, 1)


def _ascending_first(mask: torch.Tensor, k: int):
    """top-k of the keys (2n - i where mask, -i elsewhere): the ascending
    indices of set entries first, then the unset ones. Returns (vals, idx)
    as int32. The keys are distinct, so the order is unique."""
    n = mask.shape[-1]
    iota = torch.arange(n, dtype=torch.int32, device=mask.device)
    keys = torch.where(mask, 2 * n - iota, -iota)
    vals, idx = torch.topk(keys, k, dim=-1)
    return vals, idx.to(torch.int32)


def admission_lists(overlap: torch.Tensor, true_counts: torch.Tensor,
                    ccap: int, hier: bool, expand_bcap: int | None = None):
    """Per-tile ascending chunk-id lists from the (rows, n_chunks) overlap
    matrix -> (ids (rows, ccap) int32, counts (rows,) int32).

    counts encoding (read by the kernel's chunk selector):
      >= 0  exact list of that many chunk ids;
      == -1 scan all chunks (the list overflowed ccap);
      <= -2 block mode: ids hold bcount = -count-2 ascending 8-chunk Morton
            BLOCK ids, each expanded to its 8 chunks. Winner-exact: a face
            that hits a tile pixel has a bbox overlapping the tile, so extra
            chunks riding in an admitted block only add misses.

    hier=False: one top-k over all chunks. hier=True: top-k over 8-chunk
    blocks, then an exact per-chunk top-k over the first expand_bcap
    admitted blocks' chunks; rows with more admitted blocks take block mode
    when their block list fits ccap, else scan-all. Both paths give the same
    ids/counts on rows where the hier path returns an exact list."""
    rows, n_chunks = overlap.shape
    true_counts = true_counts.to(torch.int32)
    counts = torch.where(true_counts > ccap, -1, true_counts)
    if not hier:
        vals, idx = _ascending_first(overlap, min(ccap, n_chunks))
        ids = torch.where(vals > n_chunks, idx, 0)
        if n_chunks < ccap:
            ids = torch.nn.functional.pad(ids, (0, ccap - n_chunks))
        return ids, counts
    ab = 8
    ncb = -(-n_chunks // ab)
    pad = torch.nn.functional.pad
    ovb_any = pad(overlap, (0, ncb * ab - n_chunks)).reshape(rows, ncb, ab).any(-1)
    bcount = ovb_any.sum(-1).to(torch.int32)
    bcap = min(ccap, ncb)
    bvals, bidx = _ascending_first(ovb_any, bcap)
    blist = torch.where(bvals > ncb, bidx, ncb)  # pad -> all-zero sentinel block
    if expand_bcap is None:
        expand_bcap = EXPAND_BCAP
    if expand_bcap < 1:
        raise ValueError(f"expand_bcap must be >= 1, got {expand_bcap}")
    bcap2 = min(bcap, expand_bcap)
    lanes = torch.arange(ab, dtype=torch.int32, device=overlap.device)
    cand = (blist[:, :bcap2, None] * ab + lanes).reshape(rows, bcap2 * ab)
    ov2p = pad(overlap, (0, (ncb + 1) * ab - n_chunks))
    ovc = torch.gather(ov2p, 1, cand.long())  # (rows, bcap2*ab)
    ca = bcap2 * ab
    k2 = min(ccap, ca)
    vals2, idx2 = _ascending_first(ovc, k2)
    ids = torch.where(vals2 > ca, torch.gather(cand, 1, idx2.long()), 0)
    if k2 < ccap:
        ids = pad(ids, (0, ccap - k2))
    ids_block = torch.where(bvals > ncb, bidx, 0)
    if bcap < ccap:
        ids_block = pad(ids_block, (0, ccap - bcap))
    exact = (true_counts <= k2) & (bcount <= bcap2)
    block_mode = ~exact & (bcount <= bcap)
    ids = torch.where(block_mode[:, None], ids_block, ids)
    counts = torch.where(exact, true_counts,
                         torch.where(bcount <= bcap, -bcount - 2, -1))
    return ids.contiguous(), counts.to(torch.int32)


def padded_bboxes(cameras: Camera, mesh: TriangleMesh, chunk: int):
    """``face_screen_bboxes`` padded to whole chunks: lo, hi (K, Fp, 2), the
    padding dead (lo = +BIG, hi = -BIG)."""
    F = mesh.faces.shape[0]
    padF = -F % chunk
    tris = mesh.vertices[mesh.faces.long()]  # gathered once for all views
    lo, hi, _ = face_screen_bboxes(cameras, mesh, tris_w=tris)
    lo = torch.nn.functional.pad(lo, (0, 0, 0, padF), value=_BIGF)
    hi = torch.nn.functional.pad(hi, (0, 0, 0, padF), value=-_BIGF)
    return lo, hi


def tile_admission(lo: torch.Tensor, hi: torch.Tensor, res: int, tile: int,
                   chunk: int, ccap: int, hier_min_chunks: int | None = None,
                   expand_bcap: int | None = None):
    """Face-granular chunk admission for every (view, tile) from the padded
    bboxes (``padded_bboxes``): a chunk is listed for a tile when at least
    one of its faces' bboxes overlaps the tile. The per-chunk any-face
    overlap is a separable y/x test contracted over the chunk's faces (a
    float32 batched matmul of 0/1 values, exact).
    -> (ids (K*T, ccap), counts (K*T,)) as in ``admission_lists``."""
    n1d = res // tile
    T = n1d * n1d
    K, Fp = lo.shape[:2]
    n_chunks = Fp // chunk

    txs = torch.arange(n1d, dtype=torch.float32, device=lo.device) * tile
    ov_x = (hi[..., 0:1] >= txs) & (lo[..., 0:1] <= txs + tile)  # (K,Fp,n1d)
    ov_y = (hi[..., 1:2] >= txs) & (lo[..., 1:2] <= txs + tile)
    ovy_f = ov_y.reshape(K * n_chunks, chunk, n1d).to(torch.float32)
    ovx_f = ov_x.reshape(K * n_chunks, chunk, n1d).to(torch.float32)
    cnt = torch.bmm(ovy_f.transpose(1, 2), ovx_f)  # (K*NC, Ty, Tx)
    overlap = (cnt > 0).reshape(K, n_chunks, T).transpose(1, 2)  # (K,T,NC)
    true_counts = overlap.sum(-1)
    hier_min = (HIER_ADMISSION_MIN_CHUNKS if hier_min_chunks is None
                else hier_min_chunks)
    return admission_lists(
        overlap.reshape(K * T, n_chunks), true_counts.reshape(K * T), ccap,
        hier=n_chunks > hier_min, expand_bcap=expand_bcap)


def bbox_words(lo: torch.Tensor, hi: torch.Tensor, res: int,
               tile: int) -> torch.Tensor:
    """Per-view per-face screen bboxes (padded, ``padded_bboxes``) as one
    int32 word each, (K, Fp): lo_tx | hi_tx<<8 | lo_by<<16 | hi_by<<24, x at
    tile granularity and y in 8-row bands, clipped to 0..255. One pixel of
    slack keeps the quantized test a superset of the float one; dead faces
    quantize to lo 255 > hi 0 and never stage. The compacting kernels test
    these words against each tile (``raster_kernels.band_mask_and_flags``)."""
    n1d = res // tile
    if n1d > 256 or res > 2048:
        raise ValueError(
            f"compacting kernels pack tile indices ({n1d}/axis) and 8-px "
            f"y-bands ({res // 8}) as u8 (resolution {res} / tile {tile}): "
            "raise the tile size or pass compact=False")

    def q(x, step):
        return torch.clamp(torch.floor(x / step), 0, 255).to(torch.int32)

    lo_t, hi_t = q(lo - 1.0, tile), q(hi + 1.0, tile)
    lo_b, hi_b = q(lo - 1.0, 8.0), q(hi + 1.0, 8.0)
    return (lo_t[..., 0] | (hi_t[..., 0] << 8)
            | (lo_b[..., 1] << 16) | (hi_b[..., 1] << 24)).contiguous()


def _tiles(x: torch.Tensor, K: int, n1d: int, tile: int) -> torch.Tensor:
    """(K,H,W,...) images -> (K*T, P, ...) tile-major pixel blocks."""
    shp = x.shape[3:]
    return (x.reshape(K, n1d, tile, n1d, tile, *shp)
            .transpose(2, 3).reshape(K * n1d * n1d, tile * tile, *shp))


def _untile(x: torch.Tensor, K: int, n1d: int, tile: int) -> torch.Tensor:
    """(K*T, P, ...) -> (K,H,W,...)."""
    shp = x.shape[2:]
    return (x.reshape(K, n1d, n1d, tile, tile, *shp).transpose(2, 3)
            .reshape(K, n1d * tile, n1d * tile, *shp))


class RasterInputs(NamedTuple):
    """Everything a raster kernel reads for K views (rows = K*T tiles):
    admission lists, per-view ray origins (K,3), the scene pack (COLS, Fp),
    or chunk-major (NC, COLS, chunk) for the streamed kernel, per-tile ray
    directions 3 x (rows, P), the bbox words (K, Fp) when compacting (else
    None); plus the (K,H,W,3) ray image."""

    ids: torch.Tensor
    counts: torch.Tensor
    origins: torch.Tensor
    pack: torch.Tensor
    dir_planes: tuple
    tiles_per_view: int
    dirs: torch.Tensor
    bbox_words: torch.Tensor | None


def prepare_raster(cameras: Camera, mesh: TriangleMesh, tile: int = 64,
                   chunk: int = 128, vertex_attrs: torch.Tensor | None = None,
                   ccap: int | None = None, hier_min_chunks: int | None = None,
                   expand_bcap: int | None = None, compact: bool = False,
                   streamed: bool = False) -> RasterInputs:
    """Admission, rays and scene pack for one raster launch over K views;
    the bbox words when compact, the pack chunk-major when streamed."""
    res = cameras.resolution
    if res % tile:
        raise ValueError(f"resolution {res} is not a multiple of tile {tile}")
    n1d = res // tile
    K = cameras.location.shape[0]
    F = mesh.faces.shape[0]
    n_chunks = -(-F // chunk)
    ccap = min(ccap or CHUNK_LIST_CAP, n_chunks)
    lo, hi = padded_bboxes(cameras, mesh, chunk)
    ids, counts = tile_admission(lo, hi, res, tile, chunk, ccap,
                                 hier_min_chunks, expand_bcap)
    words = bbox_words(lo, hi, res, tile) if compact else None
    del lo, hi
    origins, dirs = camera_rays(cameras)  # (K,3), (K,H,W,3)
    tile_dirs = _tiles(dirs, K, n1d, tile)  # (K*T, P, 3)
    dir_planes = tuple(tile_dirs[..., i].contiguous() for i in range(3))
    attrs = () if vertex_attrs is None else (vertex_attrs,)
    pack = scene_pack(mesh, attrs)
    pack = torch.nn.functional.pad(pack, (0, 0, 0, n_chunks * chunk - F))
    if streamed:  # (NC, COLS, chunk): one contiguous block per chunk
        pack = pack.reshape(n_chunks, chunk, -1).transpose(1, 2)
    else:
        pack = pack.T
    return RasterInputs(ids, counts, origins.contiguous(), pack.contiguous(),
                        dir_planes, n1d * n1d, dirs, words)


def render_views_fused(
    cameras: Camera,
    mesh: TriangleMesh,
    tile: int = 64,
    chunk: int = 128,
    vertex_attrs: torch.Tensor | None = None,
    ccap: int | None = None,
    hier_min_chunks: int | None = None,
    expand_bcap: int | None = None,
    streamed: bool | None = None,
    compact: bool | None = None,
    stage_cap: int | None = None,
):
    """Render K cameras (leading batch dim on location/R/fov) in one raster
    kernel launch, with optional barycentric interpolation of per-vertex
    attributes (V,C) at the winning face.

    Returns batched Fragments (K,H,W,...), and (Fragments, attr_img
    (K,H,W,C)) when vertex_attrs is given. Candidate admission is by
    128-face chunk, at most ``ccap`` (default CHUNK_LIST_CAP) per tile;
    tiles that need more take block mode or a full scan, so no candidate is
    ever dropped.

    The kernel: streamed=True takes kernel C (the pack chunk-major),
    compacting unless compact=False; otherwise compact=True takes kernel B
    and the default kernel A. streamed=None picks C when the scene pack
    exceeds STREAMED_PACK_BYTES, as the JAX package does on a TPU; compact
    defaults to streamed, as there. stage_cap overrides the compacting
    kernels' cap (STAGE_CAP for B, STREAMED_STAGE_CAP for C); past it a
    tile gets kernel A's sweep of its raw list. All views go to one launch:
    the JAX package's other TPU limits (views split by scalar memory, an
    XLA fallback) have no counterpart on a card."""
    if streamed is None:
        n_attr = 0 if vertex_attrs is None else vertex_attrs.shape[1]
        streamed = pack_bytes(mesh.faces.shape[0], n_attr) > STREAMED_PACK_BYTES
    if compact is None:
        compact = streamed
    inp = prepare_raster(cameras, mesh, tile, chunk, vertex_attrs, ccap,
                         hier_min_chunks, expand_bcap, compact, streamed)
    args = (inp.ids, inp.counts, inp.origins, inp.pack)
    kw = dict(chunk=chunk, tiles_per_view=inp.tiles_per_view)
    if streamed:
        packed, acc = raster_tiles_streamed(
            *args, inp.dir_planes, bbox_words=inp.bbox_words,
            stage_cap=stage_cap or STREAMED_STAGE_CAP, **kw)
    elif compact:
        packed, acc = raster_tiles_compact(
            *args, inp.bbox_words, inp.dir_planes,
            stage_cap=stage_cap or STAGE_CAP, **kw)
    else:
        packed, acc = raster_tiles_chunklist(*args, inp.dir_planes, **kw)
    valid, t, u, v, f, attr_t = decode_winners(
        packed, acc, inp.origins, inp.dir_planes, inp.tiles_per_view)
    del packed, acc

    K = cameras.location.shape[0]
    n1d = cameras.resolution // tile
    t_img = _untile(t, K, n1d, tile)
    valid_img = _untile(valid, K, n1d, tile)
    forward = -cameras.R[:, :, 2]  # R @ (0, 0, -1)
    fw = forward[:, None, None, :]
    d = inp.dirs
    cosang = d[..., 0] * fw[..., 0] + d[..., 1] * fw[..., 1] + d[..., 2] * fw[..., 2]
    frag = Fragments(
        t=torch.where(valid_img, t_img, _BIG),
        z=torch.where(valid_img, t_img * cosang, _BIG),
        face=_untile(f, K, n1d, tile),
        bary=_untile(torch.stack([u, v], -1), K, n1d, tile),
        valid=valid_img,
    )
    if vertex_attrs is None:
        return frag
    return frag, _untile(attr_t, K, n1d, tile)
