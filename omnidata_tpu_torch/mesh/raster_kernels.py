"""The chunk-list raster kernel: its wrapper, its plain PyTorch version and
the winner decode.

Per (view, tile) row the caller supplies the ascending ids of the 128-face
Morton chunks admitted for that tile (``raster.admission_lists``). For every
pixel ray and every face of every listed chunk, Möller–Trumbore runs in the
factored form det = -D·n, u·det = D·r, v·det = D·q, t·det = e2·q, with
n = e1×e2, q = tvec×e1, r = e2×tvec and e2·q computed once per face
(``_mt_precompute``). Per pixel the winner is the minimum of a packed int32
key: the float bits of t with the low 13 mantissa bits replaced by the lane
(the face's index in its chunk). Within a chunk the full key decides, so
the lowest lane wins a masked tie; across chunks a later chunk replaces the
winner only on strict improvement of the masked key. Lists ascend in chunk
id, so the lowest face id wins every tie.

Outputs per row: ``packed`` (rows, P) int32, the winning key or BIG_PACKED
for a miss, and ``acc`` (rows, COLS, P) float32, the winner's scene-pack
column [v0|e1|e2|face_id|attr corners] or zeros for a miss.
``decode_winners`` turns these into t/u/v, face ids and attributes.

``raster_tiles_chunklist`` runs the CUDA kernel (csrc/raster_chunklist.cu)
for CUDA tensors and the plain version for CPU tensors. Both compute the
same operations in the same order without fused multiply-adds, so on one
card they agree bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

_BIG = 1e30
_EPS = 1e-7
_EDGE_EPS = 1e-5
_IDX_BITS = 13  # low mantissa bits of t that carry the lane
_LANE_BITS = 7  # lanes fit 7 bits: chunk <= 128
TIE_MASK = ~((1 << _IDX_BITS) - 1)
BIG_PACKED = int(np.float32(_BIG).view(np.int32)) & TIE_MASK

CHUNK_LIST_CAP = 48  # default chunks listed per tile (raster.admission_lists)


def chunk_schedule(ids: torch.Tensor, counts: torch.Tensor, n_chunks: int):
    """Decode each row's list -> (trip (rows,), chunk_of).

    counts >= 0: ``count`` listed chunks; -1: all n_chunks chunks in order;
    <= -2: block mode, the list holds -count-2 8-chunk block ids, each
    expanded to its 8 chunks (trip = 8 * blocks). The id is clamped to the
    last chunk: a tail block may run past it, and a re-swept duplicate chunk
    cannot strictly improve any winner. chunk_of(i) gives the chunk at list
    position i for every row (meaningful where i < trip)."""
    ccap = ids.shape[1]
    full = counts == -1
    block = counts < -1
    trip = torch.where(full, n_chunks,
                       torch.where(block, (-counts - 2) * 8, counts))

    def chunk_of(i: int) -> torch.Tensor:
        j = torch.clamp(torch.where(block, i // 8, i), max=ccap - 1)
        listed = torch.gather(ids, 1, j[:, None].long())[:, 0]
        ci = torch.where(block, listed * 8 + i % 8, listed)
        ci = torch.where(full, i, ci)
        return torch.clamp(ci, max=n_chunks - 1)

    return trip, chunk_of


def _mt_precompute(rows, ox, oy, oz):
    """Per-face Möller–Trumbore invariants from the 9 geometry rows
    (v0/e1/e2 xyz) and the ray origin -> (nx, ny, nz, qx, qy, qz, rx, ry,
    rz, e2q). The CUDA kernel computes the same expressions in this order."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    rx = e2y * tvz - e2z * tvy
    ry = e2z * tvx - e2x * tvz
    rz = e2x * tvy - e2y * tvx
    e2q = e2x * qx + e2y * qy + e2z * qz
    return nx, ny, nz, qx, qy, qz, rx, ry, rz, e2q


def _mt_packed_keys(pre, dx, dy, dz, lane):
    """Packed candidate keys (t float bits & TIE_MASK) | lane; misses carry
    t = BIG. The constants are rounded once to float32 from their double
    values, as the JAX package and the CUDA kernel round them."""
    nx, ny, nz, qx, qy, qz, rx, ry, rz, e2q = pre
    det = -(dx * nx + dy * ny + dz * nz)
    udet = dx * rx + dy * ry + dz * rz
    vdet = dx * qx + dy * qy + dz * qz
    adet = torch.abs(det)
    pos = det >= 0.0
    us = torch.where(pos, udet, -udet)
    vs = torch.where(pos, vdet, -vdet)
    ts = torch.where(pos, e2q, -e2q)
    hit = (
        (adet >= _EPS)
        & (us >= -_EDGE_EPS * adet)
        & (vs >= -_EDGE_EPS * adet)
        & (us + vs <= (1.0 + _EDGE_EPS) * adet)
        & (ts > _EPS * adet)
    )
    t = torch.where(hit, ts / torch.clamp(adet, min=_EPS * _EPS), _BIG)
    return (t.view(torch.int32) & TIE_MASK) | lane


def _check_inputs(ids, counts, origins, pack, dir_planes, chunk,
                  tiles_per_view):
    rows, P = dir_planes[0].shape
    cols, Fp = pack.shape
    dev = pack.device
    checks = [
        (ids.dtype == torch.int32 and ids.dim() == 2 and ids.shape[0] == rows,
         f"ids must be int32 (rows={rows}, ccap), got {ids.dtype} {tuple(ids.shape)}"),
        (counts.dtype == torch.int32 and tuple(counts.shape) == (rows,),
         f"counts must be int32 ({rows},), got {counts.dtype} {tuple(counts.shape)}"),
        (origins.dtype == torch.float32 and origins.dim() == 2
         and origins.shape[1] == 3 and origins.shape[0] * tiles_per_view == rows,
         f"origins must be float32 ({rows // tiles_per_view}, 3), got "
         f"{origins.dtype} {tuple(origins.shape)}"),
        (pack.dtype == torch.float32 and cols >= 10 and (cols - 10) % 3 == 0,
         f"pack must be float32 (10 + 3C, Fp), got {pack.dtype} {tuple(pack.shape)}"),
        (0 < chunk <= (1 << _LANE_BITS) and Fp % chunk == 0,
         f"chunk {chunk} must be in 1..128 and divide Fp={Fp}"),
        (Fp < (1 << 24), f"face ids ride as float32: Fp={Fp} must be < 2^24"),
        (all(d.dtype == torch.float32 and tuple(d.shape) == (rows, P)
             for d in dir_planes), "dir planes must be 3 float32 (rows, P)"),
        (all(t.device == dev for t in (ids, counts, origins, *dir_planes)),
         "all inputs must be on one device"),
        (all(t.is_contiguous() for t in (ids, counts, origins, pack, *dir_planes)),
         "all inputs must be contiguous"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"raster_tiles_chunklist: {msg}")


def raster_tiles_chunklist_reference(ids, counts, origins, pack, dir_planes,
                                     chunk: int = 128,
                                     tiles_per_view: int = 64):
    """Plain PyTorch version of the kernel: a loop over list positions, each
    step sweeping one chunk for every row whose list is that long. Same keys,
    same strict masked improvement. -> (packed (rows, P) int32, acc (rows,
    COLS, P) float32)."""
    rows, P = dir_planes[0].shape
    n_chunks = pack.shape[1] // chunk
    dev = pack.device
    trip, chunk_of = chunk_schedule(ids, counts, n_chunks)
    view = torch.arange(rows, device=dev) // tiles_per_view
    o = origins[view]  # (rows, 3)
    lane = torch.arange(chunk, dtype=torch.int32, device=dev)
    best = torch.full((rows, P), BIG_PACKED, dtype=torch.int32, device=dev)
    win = torch.zeros((rows, P), dtype=torch.int64, device=dev)
    for i in range(int(trip.max()) if rows else 0):
        r = torch.nonzero(trip > i)[:, 0]
        ci = chunk_of(i)[r]
        faces = ci[:, None].long() * chunk + lane  # (r, chunk)
        geo = pack[:9][:, faces][:, :, None, :]  # 9 x (r, 1, chunk)
        pre = _mt_precompute(tuple(geo), o[r, 0, None, None],
                             o[r, 1, None, None], o[r, 2, None, None])
        d = [p[r][:, :, None] for p in dir_planes]  # 3 x (r, P, 1)
        pj = _mt_packed_keys(pre, *d, lane).amin(-1)  # (r, P)
        b = best[r]
        improved = (pj & TIE_MASK) < (b & TIE_MASK)
        best[r] = torch.where(improved, pj, b)
        face = ci[:, None].long() * chunk + (pj & ((1 << _IDX_BITS) - 1)).long()
        win[r] = torch.where(improved, face, win[r])
    hit = best < BIG_PACKED
    acc = torch.where(hit[:, None], pack[:, win].permute(1, 0, 2), 0.0)
    return best, acc.contiguous()


def raster_tiles_chunklist(ids, counts, origins, pack, dir_planes,
                           chunk: int = 128, tiles_per_view: int = 64):
    """Chunk-list raster over all (view, tile) rows.

    ids (rows, ccap) int32, non-negative chunk (or block) ids as
    ``raster.admission_lists`` makes them · counts (rows,) int32 (see
    chunk_schedule) ·
    origins (K, 3) float32 with K * tiles_per_view == rows · pack (COLS, Fp)
    float32, geometry in rows 0-8 · dir_planes 3 x (rows, P) float32.
    -> (packed (rows, P) int32, acc (rows, COLS, P) float32).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which is built on first use, and raise if it fails to build or launch.
    Each launch adds one to ``raster_tiles_chunklist.launches``."""
    _check_inputs(ids, counts, origins, pack, dir_planes, chunk,
                  tiles_per_view)
    if pack.device.type == "cpu":
        return raster_tiles_chunklist_reference(
            ids, counts, origins, pack, dir_planes, chunk, tiles_per_view)
    if pack.device.type != "cuda":
        raise ValueError(f"raster_tiles_chunklist: no kernel for {pack.device}")
    launch = _kernel_launcher()
    rows, P = dir_planes[0].shape
    cols, Fp = pack.shape
    packed = torch.empty((rows, P), dtype=torch.int32, device=pack.device)
    acc = torch.empty((rows, cols, P), dtype=torch.float32, device=pack.device)
    with torch.cuda.device(pack.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            ids.data_ptr(), counts.data_ptr(), origins.data_ptr(),
            pack.data_ptr(), *(d.data_ptr() for d in dir_planes),
            packed.data_ptr(), acc.data_ptr(),
            rows, P, cols, Fp, chunk, ids.shape[1], tiles_per_view,
            Fp // chunk, stream)
    if err != 0:
        raise RuntimeError(
            f"raster_chunklist kernel launch failed: CUDA error {err}")
    raster_tiles_chunklist.launches += 1
    return packed, acc


raster_tiles_chunklist.launches = 0


def _kernel_launcher():
    """The C entry point of csrc/raster_chunklist.cu (built on first use):
    9 pointers, 8 ints, the stream; returns cudaGetLastError()."""
    from .._build import load_kernel_library

    fn = load_kernel_library("raster_chunklist").raster_chunklist_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_winners(packed, acc, origins, dir_planes, tiles_per_view: int):
    """Exact one-shot Möller–Trumbore recompute of each winner's t/u/v from
    its extracted geometry columns, face-id decode and barycentric
    attribute interpolation -> (valid, t, u, v, face, attrs (rows, P, C))."""
    rows, cols, P = acc.shape
    n_attr = (cols - 10) // 3
    valid = packed < BIG_PACKED
    dx, dy, dz = dir_planes
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = acc[:, :9].unbind(1)
    o = origins.repeat_interleave(tiles_per_view, 0)[:, :, None]  # (rows,3,1)
    tvx, tvy, tvz = o[:, 0] - v0x, o[:, 1] - v0y, o[:, 2] - v0z
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = torch.where(torch.abs(det) < _EPS, 0.0,
                      1.0 / torch.where(det == 0.0, 1.0, det))
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    u = (tvx * px + tvy * py + tvz * pz) * inv
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    t = torch.where(valid, t, _BIG)
    f = torch.where(valid, acc[:, 9].to(torch.int32), -1)
    corners = acc[:, 10:].reshape(rows, n_attr, 3, P)
    w0 = (1.0 - u - v)[:, None]
    attrs = (corners[:, :, 0] * w0 + corners[:, :, 1] * u[:, None]
             + corners[:, :, 2] * v[:, None])
    return valid, t, u, v, f, attrs.transpose(1, 2)
