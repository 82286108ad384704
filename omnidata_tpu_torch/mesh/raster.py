"""Batched ray-cast renderer for K views of one mesh: chunk admission, the
raster kernel, winner decode.

``render_views_fused`` is the annotator's render stage:
1. per view and face, conservative near-plane-aware screen bboxes;
2. per (view, tile), the ascending list of 128-face Morton chunks that hold
   at least one face whose bbox overlaps the tile, every row's exact list,
   uncapped, in one flat buffer at the row's offset (``exact_lists``);
3. a raster kernel (``raster_kernels``) sweeps the listed chunks and keeps,
   per pixel, the winner's packed key and its scene-pack columns: kernel A
   (chunk list), B (compacting: only the faces whose ``bbox_words`` overlap
   the tile) or C (streamed: the pack chunk-major, compacting by default);
4. ``raster_kernels.decode_winners`` recomputes the winner's exact t/u/v and
   interpolates vertex attributes; tiles are put back into images.
On a card steps 1 and 2 (and the bbox words) are CUDA kernels (``admission``,
``csrc/raster_admission.cu``); on the CPU they are their plain version
(``admission_exact_reference``). Both write the same lists.

Tie semantics and outputs are those of
``omnidata_tpu.mesh.raster.render_views_fused``, whose capped lists (at most
``ccap`` chunks a row, else block mode or a scan of every chunk) sweep the
same candidates, so the winners are the same; ``render_view_fused`` is its
one-view form.

``render_view`` is the other renderer, the JAX package's XLA path in plain
PyTorch on any device: per-tile face lists of at most ``cap`` faces
(``bin_triangles``; candidates past ``cap`` are dropped, lowest face ids
kept) swept chunk by chunk with the same packed winner key.
``tile_candidate_counts`` tells a caller how large ``cap`` must be.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._build import call_kernel
from ..core.cameras import Camera, camera_rays, extrinsic_RT, intrinsic_matrix
from ..utils import profiler
from .mesh import TriangleMesh
from .raster_kernels import (
    _BIG,
    BIG_PACKED,
    CHUNK_LIST_CAP,
    LANE_MASK,
    STAGE_CAP,
    STREAMED_STAGE_CAP,
    _mt_packed_keys,
    _mt_precompute,
    decode_winners,
    raster_tiles_chunklist,
    raster_tiles_compact,
    raster_tiles_streamed,
)

_NEAR = 1e-4
_BIGF = 1e9  # bbox value of dead faces: any overlap test fails

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


def tile_overlap(lo: torch.Tensor, hi: torch.Tensor, res: int, tile: int,
                 chunk: int) -> torch.Tensor:
    """Face-granular chunk admission for every (view, tile) from the padded
    bboxes (``padded_bboxes``): (K*T, n_chunks) bool, a chunk set for a
    tile when at least one of its faces' bboxes overlaps the tile. The
    per-chunk any-face overlap is a separable y/x test contracted over the
    chunk's faces (a float32 batched matmul of 0/1 values, exact)."""
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
    return overlap.reshape(K * T, n_chunks)


def exact_lists(overlap: torch.Tensor, slots: int):
    """The card's encoding of the (rows, n_chunks) overlap matrix: every
    row's set chunks, ascending and uncapped, in one flat buffer of rows *
    slots at the row's offset. -> (ids (rows * slots,), counts (rows,),
    offsets (rows,)), int32. The rows of at most ``slots`` chunks come
    first, at the exclusive prefix sums of their counts, and always fit;
    the longer rows follow in row order. A longer row whose list would end
    past the buffer (and so every later longer row) lists nothing and has
    count -1, scan every chunk, which is winner-exact; its offset is its
    start clamped to the buffer's end. The slots past the last list are
    zero."""
    rows = overlap.shape[0]
    capacity = rows * slots
    n = overlap.sum(1)
    short = n <= slots
    first = torch.cumsum(torch.where(short, n, 0), 0)
    ends = torch.where(short, first, torch.where(short, 0, n).cumsum(0)
                       + torch.where(short, n, 0).sum())
    fits = ends <= capacity
    offsets = torch.clamp(ends - n, max=capacity)
    ids = torch.zeros(capacity, dtype=torch.int32, device=overlap.device)
    r, c = torch.nonzero(overlap & fits[:, None], as_tuple=True)
    rank = torch.cumsum(overlap, 1)[r, c] - 1
    ids[offsets[r] + rank] = c.to(torch.int32)
    return (ids, torch.where(fits, n, -1).to(torch.int32),
            offsets.to(torch.int32))


def _check_word_range(res: int, tile: int) -> None:
    n1d = res // tile
    if n1d > 256 or res > 2048:
        raise ValueError(
            f"compacting kernels pack tile indices ({n1d}/axis) and 8-px "
            f"y-bands ({res // 8}) as u8 (resolution {res} / tile {tile}): "
            "raise the tile size or pass compact=False")


def bbox_words(lo: torch.Tensor, hi: torch.Tensor, res: int,
               tile: int) -> torch.Tensor:
    """Per-view per-face screen bboxes (padded, ``padded_bboxes``) as one
    int32 word each, (K, Fp): lo_tx | hi_tx<<8 | lo_by<<16 | hi_by<<24, x at
    tile granularity and y in 8-row bands, clipped to 0..255. One pixel of
    slack keeps the quantized test a superset of the float one; dead faces
    quantize to lo 255 > hi 0 and never stage. The compacting kernels test
    these words against each tile (``raster_kernels.band_mask_and_flags``)."""
    _check_word_range(res, tile)

    def q(x, step):
        return torch.clamp(torch.floor(x / step), 0, 255).to(torch.int32)

    lo_t, hi_t = q(lo - 1.0, tile), q(hi + 1.0, tile)
    lo_b, hi_b = q(lo - 1.0, 8.0), q(hi + 1.0, 8.0)
    return (lo_t[..., 0] | (hi_t[..., 0] << 8)
            | (lo_b[..., 1] << 16) | (hi_b[..., 1] << 24)).contiguous()


def admission_rows_reference(bits: torch.Tensor, n_chunks: int, slots: int):
    """The algorithm of the rows kernels (``csrc/raster_admission.cu``) in
    plain PyTorch: ``exact_lists`` of the overlap matrix packed as bits
    (rows, ceil(n_chunks / 32)) int32, chunk c at bit c % 32 of word c //
    32. -> (ids (rows * slots,), counts (rows,), offsets (rows,)) int32."""
    rows, nw = bits.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    ov = ((bits[:, :, None] >> shifts) & 1).bool().reshape(rows, nw * 32)
    return exact_lists(ov[:, :n_chunks], slots)


class Admission(NamedTuple):
    """The exact lists of K views' (view, tile) rows (``exact_lists``):
    ``ids`` flat, ``counts`` and ``offsets`` (rows,), count -1 for a row
    past the buffer; and, when compacting, the bbox words (K, Fp) (else
    None)."""

    ids: torch.Tensor
    counts: torch.Tensor
    bbox_words: torch.Tensor | None
    offsets: torch.Tensor


def list_slots(ccap: int, n_chunks: int) -> int:
    """List slots a row of the card's buffer: ccap, or the words a row of
    the tile-overlap bit matrix, ceil(n_chunks / 32), where that is more. A
    buffer as large as the bit matrix grows with the scene, so that on a
    large one the longer rows of large tiles still fit."""
    return max(ccap, -(-n_chunks // 32))


def admission_exact_reference(cameras: Camera, mesh: TriangleMesh, tile: int,
                              chunk: int, ccap: int,
                              compact: bool = False) -> Admission:
    """Plain version of ``admission`` on a card: ``padded_bboxes``,
    ``tile_overlap`` encoded by ``exact_lists`` in a buffer of ``list_slots``
    slots a row and, when compact, ``bbox_words``, on the mesh's device.
    -> Admission(ids (K*T*slots,), counts (K*T,), bbox words or None,
    offsets (K*T,))."""
    res = cameras.resolution
    lo, hi = padded_bboxes(cameras, mesh, chunk)
    overlap = tile_overlap(lo, hi, res, tile, chunk)
    ids, counts, offsets = exact_lists(overlap,
                                       list_slots(ccap, overlap.shape[1]))
    words = bbox_words(lo, hi, res, tile) if compact else None
    return Admission(ids, counts, words, offsets)


def admission(cameras: Camera, mesh: TriangleMesh, tile: int, chunk: int,
              ccap: int, compact: bool = False) -> Admission:
    """Chunk admission of K views and, when compact, their bbox words, in a
    buffer of ``list_slots`` slots a row: CUDA tensors launch the kernels
    (``_admission_kernels``), CPU tensors take their plain version
    (``admission_exact_reference``). While the recorder records, counter
    ``raster.rows_fused`` gains the rows the kernels admitted (none on the
    CPU)."""
    if mesh.vertices.device.type != "cpu":
        return _admission_kernels(cameras, mesh, tile, chunk, ccap, compact)
    if profiler.recording():
        profiler.count("raster.rows_fused", 0)
    return admission_exact_reference(cameras, mesh, tile, chunk, ccap, compact)


def _admission_kernels(cameras: Camera, mesh: TriangleMesh, tile: int,
                       chunk: int, ccap: int, compact: bool) -> Admission:
    """``admission`` on a card: the kernels of ``csrc/raster_admission.cu``
    (face bboxes -> tile-overlap bits and bbox words; bits -> every row's
    exact list in a buffer of ``list_slots`` slots a row, no host sync),
    built on first use, which equal ``admission_exact_reference`` bit for
    bit, and raise on what they do not take or if they fail to build or
    launch. Each launch adds one to ``admission.launches``."""
    res = cameras.resolution
    dev = mesh.vertices.device
    if compact:
        _check_word_range(res, tile)
    K = cameras.location.shape[0]
    F = mesh.faces.shape[0]
    n_chunks = -(-F // chunk)
    rt = extrinsic_RT(cameras.location, cameras.R).contiguous()
    km = intrinsic_matrix(cameras.fov, res).contiguous()
    tensors = (mesh.vertices, mesh.faces, rt, km)
    checks = [
        (dev.type == "cuda", lambda: f"no kernel for {dev}"),
        (all(t.device == dev for t in tensors),
         lambda: "the mesh and the cameras must be on one device"),
        (mesh.vertices.dtype == torch.float32 and rt.dtype == torch.float32
         and km.dtype == torch.float32,
         lambda: f"vertices and cameras must be float32, got "
         f"{mesh.vertices.dtype}, {rt.dtype}"),
        (mesh.faces.dtype == torch.int32 and mesh.faces.dim() == 2
         and mesh.faces.shape[1] == 3,
         lambda: f"faces must be int32 (F, 3), got {mesh.faces.dtype} "
         f"{tuple(mesh.faces.shape)}"),
        (mesh.vertices.is_contiguous() and mesh.faces.is_contiguous(),
         lambda: "vertices and faces must be contiguous"),
        (ccap >= 1 and chunk >= 1 and res % tile == 0,
         lambda: f"ccap {ccap} and chunk {chunk} must be >= 1, tile {tile} "
         f"divide resolution {res}"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"admission: {msg()}")
    rows = K * (res // tile) ** 2
    slots = list_slots(ccap, n_chunks)
    with torch.cuda.device(dev):
        bits = torch.empty((rows, -(-n_chunks // 32)), dtype=torch.int32,
                           device=dev)
        ids = torch.empty(rows * slots, dtype=torch.int32, device=dev)
        counts = torch.empty(rows, dtype=torch.int32, device=dev)
        offsets = torch.empty(rows + 1, dtype=torch.int32, device=dev)
        words = (torch.empty((K, n_chunks * chunk), dtype=torch.int32,
                             device=dev) if compact else None)
        call_kernel("raster_admission", "admission_launch",
              [mesh.vertices.data_ptr(), mesh.faces.data_ptr(), rt.data_ptr(),
               km.data_ptr(), None if words is None else words.data_ptr(),
               bits.data_ptr(), ids.data_ptr(), counts.data_ptr(),
               offsets.data_ptr()],
              [mesh.num_faces, F, K, res, tile, chunk, n_chunks, slots])
    admission.launches += 1
    if profiler.recording():
        profiler.count("raster.rows_fused", rows)
    # offsets[rows] is the kernels' own: the listed slots, where the zeros start
    return Admission(ids, counts, words, offsets[:rows])


admission.launches = 0


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
    admission lists (``Admission``'s exact form: ids, counts, offsets),
    per-view ray origins (K,3), the scene pack (COLS, Fp),
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
    offsets: torch.Tensor


def prepare_raster(cameras: Camera, mesh: TriangleMesh, tile: int = 64,
                   chunk: int = 128, vertex_attrs: torch.Tensor | None = None,
                   ccap: int | None = None, compact: bool = False,
                   streamed: bool = False) -> RasterInputs:
    """Admission (``admission``: exact lists, from the kernels on a card),
    rays and scene pack for one raster launch over K views; the bbox words
    when compact, the pack chunk-major when streamed. While the recorder
    records (``utils.profiler``), the admission rows go to counters
    ``raster.rows`` and ``raster.rows_scan_all`` (the rows that scan every
    chunk: longer rows past the list buffer); ``admission`` counts
    ``raster.rows_fused``, the rows its kernels admitted."""
    res = cameras.resolution
    if res % tile:
        raise ValueError(f"resolution {res} is not a multiple of tile {tile}")
    n1d = res // tile
    K = cameras.location.shape[0]
    F = mesh.faces.shape[0]
    n_chunks = -(-F // chunk)
    ccap = min(ccap or CHUNK_LIST_CAP, n_chunks)
    ids, counts, words, offsets = admission(cameras, mesh, tile, chunk, ccap,
                                            compact)
    if profiler.recording():
        profiler.count("raster.rows", counts.numel())
        profiler.count("raster.rows_scan_all", (counts == -1).sum())
        # no block mode; benchmark/metrics/rows_over_ccap_pct.py reads it
        profiler.count("raster.rows_block", 0)
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
                        dir_planes, n1d * n1d, dirs, words, offsets)


def render_views_fused(
    cameras: Camera,
    mesh: TriangleMesh,
    tile: int = 64,
    chunk: int = 128,
    vertex_attrs: torch.Tensor | None = None,
    ccap: int | None = None,
    streamed: bool | None = None,
    compact: bool | None = None,
    stage_cap: int | None = None,
):
    """Render K cameras (leading batch dim on location/R/fov) in one raster
    kernel launch, with optional barycentric interpolation of per-vertex
    attributes (V,C) at the winning face.

    Returns batched Fragments (K,H,W,...), and (Fragments, attr_img
    (K,H,W,C)) when vertex_attrs is given. Candidate admission is by
    128-face chunk: every tile's exact list, in a buffer of ``list_slots``
    slots a tile (at least ``ccap``, default CHUNK_LIST_CAP), where only
    tiles of more chunks than that can fall back to a full scan. No
    candidate is ever dropped.

    The kernel: streamed=True takes kernel C (the pack chunk-major),
    compacting unless compact=False; otherwise compact=True takes kernel B
    and the default kernel A. streamed=None picks C when the scene pack
    exceeds STREAMED_PACK_BYTES, as the JAX package does on a TPU; compact
    defaults to streamed, as there. stage_cap overrides the compacting
    kernels' cap (STAGE_CAP for B, STREAMED_STAGE_CAP for C); past it a
    tile gets kernel A's sweep of its raw list. All views go to one launch:
    the JAX package's other TPU limits (views split by scalar memory, an
    XLA fallback) have no counterpart on a card. Spans (``utils.profiler``):
    ``raster.prepare`` (``prepare_raster``), then ``raster.render`` (the
    kernel, the decode and the untiling)."""
    if streamed is None:
        n_attr = 0 if vertex_attrs is None else vertex_attrs.shape[1]
        streamed = pack_bytes(mesh.faces.shape[0], n_attr) > STREAMED_PACK_BYTES
    if compact is None:
        compact = streamed
    with profiler.span("raster.prepare"):
        inp = prepare_raster(cameras, mesh, tile, chunk, vertex_attrs, ccap,
                             compact, streamed)
    with profiler.span("raster.render"):
        args = (inp.ids, inp.counts, inp.origins, inp.pack)
        kw = dict(chunk=chunk, tiles_per_view=inp.tiles_per_view,
                  offsets=inp.offsets)
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
        frag = _fragments(valid, t, u, v, f, inp.dirs, cameras.R, n1d, tile)
        if vertex_attrs is None:
            return frag
        return frag, _untile(attr_t, K, n1d, tile)


def _fragments(valid, t, u, v, f, dirs, R, n1d: int, tile: int) -> Fragments:
    """Decoded (K*T, P) winner planes -> (K,H,W) Fragments; z is t times the
    cosine between each ray (dirs (K,H,W,3)) and its view's forward axis."""
    K = R.shape[0]
    t_img = _untile(t, K, n1d, tile)
    valid_img = _untile(valid, K, n1d, tile)
    fw = -R[:, None, None, :, 2]  # R @ (0, 0, -1)
    cosang = (dirs[..., 0] * fw[..., 0] + dirs[..., 1] * fw[..., 1]
              + dirs[..., 2] * fw[..., 2])
    return Fragments(
        t=torch.where(valid_img, t_img, _BIG),
        z=torch.where(valid_img, t_img * cosang, _BIG),
        face=_untile(f, K, n1d, tile),
        bary=_untile(torch.stack([u, v], -1), K, n1d, tile),
        valid=valid_img,
    )


def _one_view(camera: Camera) -> Camera:
    """A camera with location (3,), R (3,3), fov () as a batch of one."""
    return Camera(camera.location.reshape(1, 3), camera.R.reshape(1, 3, 3),
                  torch.as_tensor(camera.fov).reshape(1), camera.resolution)


def _first(frag: Fragments) -> Fragments:
    return Fragments(*(x[0] for x in frag))


def render_view_fused(camera: Camera, mesh: TriangleMesh, tile: int = 64,
                      chunk: int = 128, vertex_attrs: torch.Tensor | None = None,
                      **kwargs):
    """One view through ``render_views_fused`` (K = 1: one raster kernel
    launch on a card); the counterpart of
    ``omnidata_tpu.mesh.raster.render_view_pallas``, whose ``cap`` the
    kernels do not need. camera: location (3,), R (3,3), fov (). kwargs go
    to ``render_views_fused`` (ccap, streamed, compact, ...).
    -> (H,W) Fragments, and (Fragments, attr_img (H,W,C)) with
    vertex_attrs."""
    out = render_views_fused(_one_view(camera), mesh, tile, chunk,
                             vertex_attrs, **kwargs)
    if vertex_attrs is None:
        return _first(out)
    return _first(out[0]), out[1][0]


def _tile_origins(n1d: int, tile: int, device) -> torch.Tensor:
    return torch.arange(n1d, dtype=torch.float32, device=device) * tile


def bin_triangles(camera: Camera, mesh: TriangleMesh, tile: int, cap: int):
    """Per-tile face lists (T, cap) int32 and per-tile candidate counts
    (T,) int32 for one view (``omnidata_tpu.mesh.raster.bin_triangles``).

    Two-level admission: per tile the ascending ids of the 128-face chunks
    whose union bbox overlaps it (at most 256 chunks), then the faces of
    those chunks whose own bbox overlaps it, ascending. Past ``cap`` faces
    the lowest ids are kept; unused slots hold the last (degenerate) face
    F - 1. counts are the faces the listed chunks hold that overlap the
    tile."""
    res = camera.resolution
    n1d = res // tile
    T = n1d * n1d
    F = mesh.faces.shape[0]
    chunk = 128
    lo, hi = padded_bboxes(_one_view(camera), mesh, chunk)
    lo, hi = lo[0], hi[0]
    n_chunks = lo.shape[0] // chunk
    dev = lo.device
    txs = _tile_origins(n1d, tile, dev)

    # level 1: per-tile lists of chunks whose union bbox overlaps the tile
    clo = lo.reshape(n_chunks, chunk, 2).amin(1)
    chi = hi.reshape(n_chunks, chunk, 2).amax(1)
    cov_x = (chi[:, 0:1] >= txs) & (clo[:, 0:1] <= txs + tile)
    cov_y = (chi[:, 1:2] >= txs) & (clo[:, 1:2] <= txs + tile)
    cov = (cov_y[:, :, None] & cov_x[:, None, :]).reshape(n_chunks, T).T
    cvals, cidx = _ascending_first(cov, min(256, n_chunks))
    clist = torch.where(cvals > n_chunks, cidx, n_chunks - 1)  # (T, ccap)

    # level 2: face-level overlap over the listed chunks' faces only
    lanes = torch.arange(chunk, dtype=torch.int32, device=dev)
    fids = (clist[:, :, None] * chunk + lanes).reshape(T, -1)  # (T, A)
    A = fids.shape[1]
    flo, fhi = lo[fids.long()], hi[fids.long()]  # (T, A, 2)
    ty = txs.repeat_interleave(n1d)[:, None]
    tx = txs.repeat(n1d)[:, None]
    ov = ((fhi[..., 0] >= tx) & (flo[..., 0] <= tx + tile)
          & (fhi[..., 1] >= ty) & (flo[..., 1] <= ty + tile))
    counts = ov.sum(1).to(torch.int32)
    k = min(cap, A)
    vals, idx = _ascending_first(ov, k)
    tile_tris = torch.where(vals > A, torch.gather(fids, 1, idx.long()), F - 1)
    # padded face ids (>= num_faces) are degenerate: the F-1 pad slot
    tile_tris = torch.where(tile_tris >= mesh.num_faces, F - 1, tile_tris)
    if k < cap:  # tiny meshes: fill the capacity with degenerate slots
        tile_tris = torch.nn.functional.pad(tile_tris, (0, cap - k), value=F - 1)
    return tile_tris.to(torch.int32), counts


def tile_candidate_counts(camera: Camera, mesh: TriangleMesh,
                          tile: int = 64) -> torch.Tensor:
    """True per-tile bbox-overlap face counts (T,) int32 of one view: the
    overflow probe for ``render_view``, which keeps only the lowest ``cap``
    face ids of a tile. An upper bound of ``bin_triangles``' counts. The
    separable y/x overlap is contracted in float64, exact for any face
    count and untouched by TF32."""
    n1d = camera.resolution // tile
    lo, hi, _ = face_screen_bboxes(_one_view(camera), mesh)
    lo, hi = lo[0], hi[0]
    txs = _tile_origins(n1d, tile, lo.device)
    ovx = (hi[:, 0:1] >= txs) & (lo[:, 0:1] <= txs + tile)  # (F, n1d)
    ovy = (hi[:, 1:2] >= txs) & (lo[:, 1:2] <= txs + tile)
    cnt = ovy.to(torch.float64).T @ ovx.to(torch.float64)  # (ty, tx)
    return cnt.reshape(-1).to(torch.int32)


def _tri_soa(mesh: TriangleMesh) -> list:
    """9 (F,) planes: v0.xyz, e1.xyz, e2.xyz."""
    tris = mesh.vertices[mesh.faces.long()]  # (F,3,3)
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    return [*v0.unbind(1), *e1.unbind(1), *e2.unbind(1)]


def render_view(camera: Camera, mesh: TriangleMesh, tile: int = 64,
                cap: int = 2048, chunk: int = 128,
                parallel_tiles: bool = True) -> Fragments:
    """Render one view (location (3,), R (3,3), fov ()) to (H,W) Fragments
    with plain PyTorch operations on the mesh's device
    (``omnidata_tpu.mesh.raster.render_view``, the JAX package's XLA path).

    Each tile sweeps its ``bin_triangles`` list in ``cap // chunk`` chunks;
    per pixel the winner is the least packed key: the float32 bits of t
    with the low 13 bits replaced by the face's slot in the tile's list,
    so the lowest slot wins a masked tie. Candidates past ``cap`` per tile
    are dropped (probe ``tile_candidate_counts`` to size cap); t, u, v are
    recomputed exactly for the winner. parallel_tiles is accepted for the
    JAX signature and ignored."""
    del parallel_tiles
    if not chunk <= cap <= LANE_MASK + 1:
        raise ValueError(f"cap {cap}: at least one chunk ({chunk}), and the "
                         "candidate slot must fit the key's 13 low bits "
                         f"(cap <= {LANE_MASK + 1})")
    res = camera.resolution
    n1d = res // tile
    T = n1d * n1d
    P = tile * tile
    tile_tris, _ = bin_triangles(camera, mesh, tile, cap)

    origin, dirs = camera_rays(camera)  # (3,), (H,W,3)
    dirs = dirs[None]
    dx, dy, dz = _tiles(dirs, 1, n1d, tile).unbind(-1)  # 3 x (T, P)
    soa = _tri_soa(mesh)
    g = [a[tile_tris.long()] for a in soa]  # one gather per view: (T, cap)
    dev = origin.device
    best = torch.full((T, P), BIG_PACKED, dtype=torch.int32, device=dev)
    best_j = torch.zeros((T, P), dtype=torch.int32, device=dev)
    d = (dx[:, :, None], dy[:, :, None], dz[:, :, None])
    for c0 in range(0, cap - chunk + 1, chunk):
        rows = [a[:, None, c0:c0 + chunk] for a in g]  # (T, 1, chunk)
        pre = _mt_precompute(rows, origin[0], origin[1], origin[2])
        slot = torch.arange(c0, c0 + chunk, dtype=torch.int32, device=dev)
        pj = _mt_packed_keys(pre, *d, slot).amin(-1)  # (T, P)
        best_j = torch.where(pj < best, pj & LANE_MASK, best_j)
        best = torch.minimum(best, pj)

    # the winner's face and its exact t / u / v
    valid = best < BIG_PACKED
    f = torch.where(valid, torch.gather(tile_tris, 1, best_j.long()), -1)
    fi = f.clamp(min=0).long()
    acc = torch.stack([a[fi] for a in soa] + [f.to(torch.float32)], 1)
    valid, t, u, v, f, _ = decode_winners(best, acc, origin[None], (dx, dy, dz), T)
    return _first(_fragments(valid, t, u, v, f, dirs, camera.R[None], n1d, tile))


def render_views(cameras: Camera, mesh: TriangleMesh, tile: int = 64,
                 cap: int = 2048, chunk: int = 128,
                 parallel_tiles: bool = True) -> Fragments:
    """``render_view`` of each camera of a batch (leading dim on
    location/R/fov) -> (K,H,W) Fragments."""
    frags = [render_view(Camera(cameras.location[k], cameras.R[k],
                                cameras.fov[k], cameras.resolution),
                         mesh, tile, cap, chunk, parallel_tiles)
             for k in range(cameras.location.shape[0])]
    return Fragments(*(torch.stack(x) for x in zip(*frags)))
