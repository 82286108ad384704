"""The raster kernels: their wrappers, their plain PyTorch versions and the
winner decode.

Per (view, tile) row the caller supplies the ascending ids of the 128-face
Morton chunks admitted for that tile in the exact form that admission
writes (``raster.admission``): ``ids`` one flat int32 buffer, ``offsets``
(rows,) int32 and ``counts`` (rows,) int32; row r lists the ``counts[r]``
chunks ``ids[offsets[r]:offsets[r] + counts[r]]``, every chunk that holds a
face whose bbox overlaps the tile, uncapped (a CSR layout: a flat list plus
row offsets). A row whose list would have run past the buffer has count
-1: scan every chunk.

For every pixel ray and every swept face, Möller–Trumbore runs in the
factored form det = -D·n, u·det = D·r, v·det = D·q, t·det = e2·q, with n =
e1×e2, q = tvec×e1, r = e2×tvec and e2·q computed once per face
(``_mt_precompute``). Per pixel the winner is the minimum of a packed int32
key: the float bits of t with the low 13 mantissa bits replaced by the lane
(the face's index in the swept chunk). Within a chunk the full key decides,
so the lowest lane wins a masked tie; across chunks a later chunk replaces
the winner only on strict improvement of the masked key. Lists ascend in
chunk id, so the lowest face id wins every tie.

Three kernels share that contract:
- A, chunk list (``raster_tiles_chunklist``): sweeps every listed chunk.
- B, compacting (``raster_tiles_compact``): first stages, per row, the faces
  of the listed chunks whose tile-quantized bbox overlaps the tile
  (``stage_faces``), then sweeps ceil(staged / chunk) dense chunks of them;
  lane = slot % chunk. A row that stages more than ``stage_cap`` faces gets
  A's result for its raw list. Winners and decoded outputs equal A's;
  ``packed``'s low bits hold the dense lane.
- C, streamed (``raster_tiles_streamed``): the pack chunk-major (NC, COLS,
  chunk); without ``bbox_words`` A's function, ``packed`` included, with
  them B's function at ``STREAMED_STAGE_CAP``.

Outputs per row: ``packed`` (rows, P) int32, the winning key or BIG_PACKED
for a miss, and ``acc`` (rows, COLS, P) float32, the winner's scene-pack
column [v0|e1|e2|face_id|attr corners] or zeros for a miss.
``decode_winners`` turns these into t/u/v, face ids and attributes.

Each wrapper runs its CUDA kernel (``csrc/raster_chunklist.cu`` for A,
``csrc/raster_compact.cu`` for B and C) for CUDA tensors and its plain
version for CPU tensors. Both compute the same operations in the same order
without fused multiply-adds, so on one card they agree bit for bit.

Kernels A, B and C cut each row's raw-list sweep into work items of at
most ``SPLIT_SEG`` list positions (``split_schedule``; the compacting
kernels keep one item per row that stages at most its cap) and merge a
row's items in segment order, which gives the sequential sweep's winners
exactly (``raster_tiles_split_reference`` is that merge, plainly). B and C
run one count pass and one sweep kernel, on their two pack layouts.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._build import call_kernel
from ..utils import profiler

_BIG = 1e30
_EPS = 1e-7
_EDGE_EPS = 1e-5
_IDX_BITS = 13  # low mantissa bits of t that carry the lane
_LANE_BITS = 7  # lanes fit 7 bits: chunk <= 128
TIE_MASK = ~((1 << _IDX_BITS) - 1)
LANE_MASK = (1 << _IDX_BITS) - 1
BIG_PACKED = int(np.float32(_BIG).view(np.int32)) & TIE_MASK
_INT32_MAX = 2**31 - 1

CHUNK_LIST_CAP = 48  # default floor of a row's list slots (raster.list_slots)
STAGE_CAP = 512  # compacting kernel B: staged faces per row before fallback
STREAMED_STAGE_CAP = 8192  # kernel C's compacting body
# list positions per work item of kernels A, B and C (about 2.1 M pixel-face
# pairs at chunk 128 and 1,024 pixels a tile); an argument of the wrappers
# only so that tests can force every multi-chunk row to split
SPLIT_SEG = 16
_MAX_SEGMENTS = 1 << 13  # segment indices ride in the key's 13 tie bits


def list_trips(counts: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """List positions each row sweeps (see ``chunk_schedule``)."""
    return torch.where(counts == -1, n_chunks, counts)


def chunk_schedule(ids: torch.Tensor, counts: torch.Tensor, n_chunks: int,
                   offsets: torch.Tensor):
    """Decode each row's list (module docstring) -> (trip (rows,),
    chunk_of): counts >= 0, ``count`` listed chunks at the row's offset;
    -1, all n_chunks chunks in order. chunk_of(i) gives the chunk at list
    position i for every row (meaningful where i < trip)."""
    full = counts == -1
    trip = list_trips(counts, n_chunks)
    last = max(ids.numel() - 1, 0)

    def chunk_of(i: int) -> torch.Tensor:
        listed = ids[(offsets.long() + i).clamp(0, last)]
        return torch.where(full, i, listed)

    return trip, chunk_of


def band_mask_and_flags(bb: torch.Tensor, tx, ty, tile: int, pblk: int,
                        nblocks: int):
    """Decode u8-packed bbox words (lo_tx | hi_tx<<8 | lo_by<<16 |
    hi_by<<24: x in tiles, y in 8-row bands; ``raster.bbox_words``) against
    tile (tx, ty) -> (mask, flags (nblocks, *mask.shape)), both bool.

    mask: the bbox overlaps the tile, the compacting kernels' staging test.
    flags[b]: it also overlaps the image rows of pixel block b (the tile's
    row-major pixels [b*pblk, (b+1)*pblk)), conservative for any tile and
    pblk. The TPU kernels skip staged chunks by these flags; the kernels
    here sweep every staged face, which gives the same winners."""
    lo_tx = bb & 0xFF
    hi_tx = (bb >> 8) & 0xFF
    lo_by = (bb >> 16) & 0xFF
    hi_by = (bb >> 24) & 0xFF
    y0 = ty * tile
    m = ((lo_tx <= tx) & (tx <= hi_tx)
         & (lo_by <= (y0 + tile - 1) // 8) & (hi_by >= y0 // 8))
    flags = []
    for b in range(nblocks):
        r0 = (b * pblk) // tile  # rows of block b within the tile
        r1 = ((b + 1) * pblk - 1) // tile
        flags.append(m & (lo_by <= (y0 + r1) // 8) & (hi_by >= (y0 + r0) // 8))
    return m, torch.stack(flags)


def stage_faces(ids, counts, bbox_words, n_chunks: int, chunk: int,
                tiles_per_view: int, tile: int, stage_cap: int, *, offsets):
    """Pass 1 of the compacting kernels, plainly: per row, the faces of the
    listed chunks whose bbox word overlaps the row's tile, in list order
    then lane order (ascending face id). -> (staged (rows,) int64, the count
    with the faces past stage_cap; slots (rows, stage_cap) int64 face ids,
    -1 where empty).

    A dead face (behind the near plane or off screen) has the bbox word of
    lo 255 > hi 0 and is never staged: a face whose vertices all lie within
    1e-4 m in front of the camera is never swept by B or C, while A sweeps
    it whenever a chunkmate admits its chunk, so no kernel renders such
    faces dependably (as in the JAX package)."""
    rows = counts.shape[0]
    dev = ids.device
    n1d = math.isqrt(tiles_per_view)
    trip, chunk_of = chunk_schedule(ids, counts, n_chunks, offsets)
    row = torch.arange(rows, device=dev)
    view, tiv = row // tiles_per_view, row % tiles_per_view
    ty, tx = tiv // n1d, tiv % n1d
    lane = torch.arange(chunk, device=dev)
    staged = torch.zeros(rows, dtype=torch.int64, device=dev)
    slots = torch.full((rows, stage_cap), -1, dtype=torch.int64, device=dev)
    for i in range(int(trip.max()) if rows else 0):
        r = torch.nonzero(trip > i)[:, 0]
        faces = chunk_of(i)[r, None].long() * chunk + lane  # (r, chunk)
        bb = bbox_words[view[r, None], faces]
        m, _ = band_mask_and_flags(bb, tx[r, None], ty[r, None], tile,
                                   tile * tile, 1)
        pos = staged[r, None] + torch.cumsum(m, 1) - 1
        keep = m & (pos < stage_cap)
        slots[r[:, None].expand_as(faces)[keep], pos[keep]] = faces[keep]
        staged[r] += m.sum(1)
    return staged, slots


class SplitSchedule(NamedTuple):
    """Work items of one launch of kernel A, B or C. Item j belongs to row
    order[p] for the first p with ends[p] > j and is that row's segment
    j - (ends[p] - n_items[order[p]])."""

    order: torch.Tensor  # (rows,) int32: rows, largest items first
    ends: torch.Tensor  # (rows,) int32: inclusive prefix sum of n_items[order]
    n_items: torch.Tensor  # (rows,) int32: items per row, >= 1
    # (rows,) faces staged per row, past the cap included (compacting body;
    # a row staging at most its cap is one dense item), else None
    staged: torch.Tensor | None


def cost_bucket(cost: torch.Tensor) -> torch.Tensor:
    """The items' sort key: monotone in cost, 4 buckets per power of two
    (0..127 for int32 costs), as the kernels' schedule computes it."""
    cost = cost.long()
    e = torch.frexp(cost.double().clamp(min=1))[1].long() - 1  # floor(log2)
    top = cost >> torch.clamp(e - 2, min=0)
    return torch.where(cost < 4, cost, 4 * e + top - 8)


def split_schedule(counts, staged, n_chunks: int, seg: int,
                   chunk: int = 128,
                   stage_cap: int = STREAMED_STAGE_CAP) -> SplitSchedule:
    """The item list of kernels A, B and C, plainly (the kernels build it
    on the card, ``schedule_kernel`` in ``csrc/raster_common.cuh``, and
    equal this bit for bit): each row's list cut into ceil(trip / seg)
    segments of at most seg positions (one item for an empty list), except
    that with ``staged`` (the compacting kernels: faces staged per row) a
    row staging at most stage_cap faces is one dense item. Rows are in a
    stable sort by the ``cost_bucket`` of the pixel-face pairs of their
    largest item (min(trip, seg) * chunk faces for a raw-list row,
    ``staged`` for a dense one), largest first, so the persistent CTAs
    start the long work first."""
    trip = list_trips(counts, n_chunks).long()
    n_items = torch.clamp((trip + seg - 1) // seg, min=1)
    cost = torch.clamp(trip, max=seg) * chunk
    if staged is not None:
        dense = staged.long() <= stage_cap
        n_items = torch.where(dense, 1, n_items)
        cost = torch.where(dense, staged.long(), cost)
    order = torch.argsort(cost_bucket(cost), descending=True, stable=True)
    ends = torch.cumsum(n_items[order], 0)
    return SplitSchedule(order.int(), ends.int(), n_items.int(), staged)


def schedule_items(sched: SplitSchedule):
    """Every item of a schedule in the order the kernels take them -> (row,
    segment) int64 tensors (syncs with the host)."""
    n = sched.n_items[sched.order.long()].long()
    rows = torch.repeat_interleave(sched.order.long(), n)
    start = torch.repeat_interleave(sched.ends.long() - n, n)
    return rows, torch.arange(rows.shape[0], device=rows.device) - start


def _mt_precompute(rows, ox, oy, oz):
    """Per-face Möller–Trumbore invariants from the 9 geometry rows
    (v0/e1/e2 xyz) and the ray origin -> (nx, ny, nz, qx, qy, qz, rx, ry,
    rz, e2q). The CUDA kernels compute the same expressions in this order."""
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
    values, as the JAX package and the CUDA kernels round them."""
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


def _sweep(o, dir_planes, pack, n_units, faces_of):
    """The strict-improvement sweep of every row over its units i <
    n_units[row], in order. faces_of(i, r) -> (len(r), chunk) face ids of
    unit i for rows r, the column being the lane; -1 marks an empty slot.
    o: (rows, 3) ray origins. -> (best (rows, P) int32, win (rows, P) int64
    winning face ids)."""
    rows, P = dir_planes[0].shape
    dev = pack.device
    best = torch.full((rows, P), BIG_PACKED, dtype=torch.int32, device=dev)
    win = torch.zeros((rows, P), dtype=torch.int64, device=dev)
    for i in range(int(n_units.max()) if rows else 0):
        r = torch.nonzero(n_units > i)[:, 0]
        faces = faces_of(i, r)
        lane = torch.arange(faces.shape[1], dtype=torch.int32, device=dev)
        geo = pack[:9][:, faces.clamp(min=0)][:, :, None, :]  # 9 x (r, 1, chunk)
        pre = _mt_precompute(tuple(geo), o[r, 0, None, None],
                             o[r, 1, None, None], o[r, 2, None, None])
        d = [p[r][:, :, None] for p in dir_planes]  # 3 x (r, P, 1)
        keys = _mt_packed_keys(pre, *d, lane)
        keys = torch.where(faces[:, None, :] >= 0, keys, _INT32_MAX)
        pj = keys.amin(-1)  # (r, P)
        b = best[r]
        improved = (pj & TIE_MASK) < (b & TIE_MASK)
        best[r] = torch.where(improved, pj, b)
        face = torch.gather(faces, 1, (pj & LANE_MASK).long())
        win[r] = torch.where(improved, face, win[r])
    return best, win


def _sweep_lists(ids, counts, offsets, o, pack, dir_planes, chunk):
    """Kernel A's sweep of each row's raw list -> (best, win)."""
    trip, chunk_of = chunk_schedule(ids, counts, pack.shape[1] // chunk,
                                    offsets)
    lane = torch.arange(chunk, device=pack.device)
    return _sweep(o, dir_planes, pack, trip,
                  lambda i, r: chunk_of(i)[r, None].long() * chunk + lane)


def _row_origins(origins, rows, tiles_per_view):
    return origins[torch.arange(rows, device=origins.device) // tiles_per_view]


def _winner_columns(best, win, pack):
    hit = best < BIG_PACKED
    acc = torch.where(hit[:, None], pack[:, win].permute(1, 0, 2), 0.0)
    return acc.contiguous()


def raster_tiles_chunklist_reference(ids, counts, origins, pack, dir_planes,
                                     chunk: int = 128,
                                     tiles_per_view: int = 64, *, offsets):
    """Plain PyTorch version of kernel A: a loop over list positions, each
    step sweeping one chunk for every row whose list is that long. Same keys,
    same strict masked improvement. -> (packed (rows, P) int32, acc (rows,
    COLS, P) float32)."""
    o = _row_origins(origins, counts.shape[0], tiles_per_view)
    best, win = _sweep_lists(ids, counts, offsets, o, pack, dir_planes, chunk)
    return best, _winner_columns(best, win, pack)


def raster_tiles_compact_reference(ids, counts, origins, pack, bbox_words,
                                   dir_planes, chunk: int = 128,
                                   tiles_per_view: int = 64,
                                   stage_cap: int = STAGE_CAP, *, offsets):
    """Plain PyTorch version of kernel B: ``stage_faces``, then per row
    either the dense sweep of its staged faces or, past stage_cap, kernel
    A's sweep of its raw list. -> (packed, acc) as kernel A's."""
    rows, P = dir_planes[0].shape
    staged, slots = stage_faces(ids, counts, bbox_words, pack.shape[1] // chunk,
                                chunk, tiles_per_view, math.isqrt(P), stage_cap,
                                offsets=offsets)
    o = _row_origins(origins, rows, tiles_per_view)
    best = torch.full((rows, P), BIG_PACKED, dtype=torch.int32, device=pack.device)
    win = torch.zeros((rows, P), dtype=torch.int64, device=pack.device)
    fb = staged > stage_cap
    if fb.any():
        best[fb], win[fb] = _sweep_lists(ids, counts[fb], offsets[fb], o[fb],
                                         pack, [d[fb] for d in dir_planes],
                                         chunk)
    dn = ~fb
    if dn.any():
        dense = torch.nn.functional.pad(slots[dn], (0, -stage_cap % chunk),
                                        value=-1)
        best[dn], win[dn] = _sweep(
            o[dn], [d[dn] for d in dir_planes], pack,
            (staged[dn] + chunk - 1) // chunk,
            lambda i, r: dense[r, i * chunk:(i + 1) * chunk])
    return best, _winner_columns(best, win, pack)


def raster_tiles_streamed_reference(ids, counts, origins, pack, dir_planes,
                                    chunk: int = 128,
                                    tiles_per_view: int = 64,
                                    bbox_words=None,
                                    stage_cap: int = STREAMED_STAGE_CAP, *,
                                    offsets):
    """Plain PyTorch version of kernel C on the chunk-major pack (NC, COLS,
    chunk): kernel A's function without bbox_words, kernel B's with them."""
    flat = pack.permute(1, 0, 2).reshape(pack.shape[1], -1)
    if bbox_words is None:
        return raster_tiles_chunklist_reference(
            ids, counts, origins, flat, dir_planes, chunk, tiles_per_view,
            offsets=offsets)
    return raster_tiles_compact_reference(
        ids, counts, origins, flat, bbox_words, dir_planes, chunk,
        tiles_per_view, stage_cap, offsets=offsets)


def raster_tiles_split_reference(ids, counts, origins, pack, dir_planes,
                                 chunk: int = 128, tiles_per_view: int = 64,
                                 seg: int = SPLIT_SEG, bbox_words=None,
                                 stage_cap: int = STREAMED_STAGE_CAP, *,
                                 offsets):
    """Plain version of the work items of kernels A, B and C: the items of
    ``split_schedule`` (with ``stage_faces``' counts when bbox_words are
    given), each swept from scratch over its segment of the row's raw list
    or, for a dense row, over its staged faces; then each row's segments
    folded in segment order with the strict masked improvement. pack (COLS,
    Fp) or chunk-major (NC, COLS, chunk). Equal bit for bit to
    ``raster_tiles_chunklist_reference`` (no bbox_words),
    ``raster_tiles_compact_reference`` and ``raster_tiles_streamed_reference``
    at any seg."""
    if pack.dim() == 3:
        pack = pack.permute(1, 0, 2).reshape(pack.shape[1], -1)
    rows, P = dir_planes[0].shape
    dev = pack.device
    n_chunks = pack.shape[1] // chunk
    o = _row_origins(origins, rows, tiles_per_view)
    staged = slots = None
    if bbox_words is not None:
        staged, slots = stage_faces(ids, counts, bbox_words, n_chunks, chunk,
                                    tiles_per_view, math.isqrt(P), stage_cap,
                                    offsets=offsets)
    sched = split_schedule(counts, staged, n_chunks, seg, chunk, stage_cap)
    item_row, item_seg = schedule_items(sched)
    best = torch.full((rows, P), BIG_PACKED, dtype=torch.int32, device=dev)
    win = torch.zeros((rows, P), dtype=torch.int64, device=dev)
    dense = (torch.zeros(rows, dtype=torch.bool, device=dev)
             if staged is None else staged <= stage_cap)
    if dense.any():
        slots = torch.nn.functional.pad(slots[dense], (0, -stage_cap % chunk),
                                        value=-1)
        best[dense], win[dense] = _sweep(
            o[dense], [d[dense] for d in dir_planes], pack,
            (staged[dense] + chunk - 1) // chunk,
            lambda i, r: slots[r, i * chunk:(i + 1) * chunk])
    raw = ~dense[item_row]
    item_row, item_seg = item_row[raw], item_seg[raw]
    trip, chunk_of = chunk_schedule(ids, counts, n_chunks, offsets)
    lane = torch.arange(chunk, device=dev)
    for s in range(int(item_seg.max()) + 1 if item_seg.numel() else 0):
        r = item_row[item_seg == s]
        b, w = _sweep(o[r], [d[r] for d in dir_planes], pack,
                      torch.clamp(trip[r] - s * seg, max=seg),
                      lambda i, rr: chunk_of(s * seg + i)[r[rr], None].long()
                      * chunk + lane)
        improved = (b & TIE_MASK) < (best[r] & TIE_MASK)
        best[r] = torch.where(improved, b, best[r])
        win[r] = torch.where(improved, w, win[r])
    return best, _winner_columns(best, win, pack)


def _check_inputs(name, ids, counts, offsets, origins, pack, cols, Fp,
                  dir_planes, chunk, tiles_per_view, bbox_words=None,
                  stage_cap=1, seg=None):
    """Raise ValueError on what no kernel takes (each message formed only
    on failure: the check runs on every launch)."""
    rows, P = dir_planes[0].shape
    dev = pack.device
    tensors = (ids, counts, offsets, origins, pack, *dir_planes)
    checks = [
        (ids.dtype == torch.int32 and ids.dim() == 1 and ids.numel() > 0,
         lambda: f"ids must be flat non-empty int32, got {ids.dtype} "
         f"{tuple(ids.shape)}"),
        (offsets.dtype == torch.int32 and offsets.shape == (rows,),
         lambda: f"offsets must be int32 ({rows},), got {offsets.dtype} "
         f"{tuple(offsets.shape)}"),
        (counts.dtype == torch.int32 and counts.shape == (rows,),
         lambda: f"counts must be int32 ({rows},), got {counts.dtype} "
         f"{tuple(counts.shape)}"),
        (origins.dtype == torch.float32 and origins.dim() == 2
         and origins.shape[1] == 3 and origins.shape[0] * tiles_per_view == rows,
         lambda: f"origins must be float32 ({rows // tiles_per_view}, 3), got "
         f"{origins.dtype} {tuple(origins.shape)}"),
        (pack.dtype == torch.float32 and cols >= 10 and (cols - 10) % 3 == 0,
         lambda: f"pack must be float32 with 10 + 3C columns, got {pack.dtype} "
         f"{tuple(pack.shape)}"),
        (0 < chunk <= (1 << _LANE_BITS) and Fp % chunk == 0,
         lambda: f"chunk {chunk} must be in 1..128 and divide Fp={Fp}"),
        (Fp < (1 << 24),
         lambda: f"face ids ride as float32: Fp={Fp} must be < 2^24"),
        (all(d.dtype == torch.float32 and d.shape == (rows, P)
             for d in dir_planes), lambda: "dir planes must be 3 float32 (rows, P)"),
    ]
    if bbox_words is not None:
        tile, n1d = math.isqrt(P), math.isqrt(tiles_per_view)
        tensors += (bbox_words,)
        checks += [
            (bbox_words.dtype == torch.int32
             and bbox_words.shape == (origins.shape[0], Fp),
             lambda: f"bbox_words must be int32 ({origins.shape[0]}, {Fp}), "
             f"got "
             f"{bbox_words.dtype} {tuple(bbox_words.shape)}"),
            (tile * tile == P and n1d * n1d == tiles_per_view and n1d <= 256,
             lambda: f"tiles must be square, at most 256 a side: P={P}, "
             f"tiles_per_view={tiles_per_view}"),
            (stage_cap >= 1, lambda: f"stage_cap must be >= 1, got {stage_cap}"),
        ]
    if seg is not None:
        longest = Fp // chunk  # every chunk
        checks.append((seg >= 1 and -(-longest // seg) <= _MAX_SEGMENTS,
                       lambda: f"seg {seg} must be >= 1 and cut a list of "
                       f"{longest} positions into at most {_MAX_SEGMENTS} "
                       "segments"))
    checks += [
        (all(t.device == dev for t in tensors),
         lambda: "all inputs must be on one device"),
        (all(t.is_contiguous() for t in tensors),
         lambda: "all inputs must be contiguous"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"{name}: {msg()}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {dev}")


def _launch(lib: str, symbol: str, ptrs, ints, rows, P, cols, dev):
    """Allocate the outputs and call a kernel's C entry point (pointers...,
    packed, acc, ints..., stream) as ``call_kernel`` does."""
    packed = torch.empty((rows, P), dtype=torch.int32, device=dev)
    acc = torch.empty((rows, cols, P), dtype=torch.float32, device=dev)
    call_kernel(lib, symbol, [*ptrs, packed.data_ptr(), acc.data_ptr()], ints)
    return packed, acc


class _Items(NamedTuple):
    """Uninitialised memory for the item list that an entry point builds
    and the merge words it fills: ``work`` holds order, ends, n_items, done
    (rows each) and next (1). The caller holds it until the launch is
    enqueued; the caching allocator then keeps the memory for this
    stream's kernels."""

    work: torch.Tensor
    merge: torch.Tensor
    rows: int

    @staticmethod
    def new(rows: int, P: int, dev) -> "_Items":
        return _Items(torch.empty(4 * rows + 1, dtype=torch.int32, device=dev),
                      torch.empty((rows, P), dtype=torch.int64, device=dev),
                      rows)

    def ptrs(self) -> list:
        """order, ends, n_items, done, next."""
        p = self.work.data_ptr()
        return [p + 4 * self.rows * i for i in range(5)]

    def schedule(self, staged=None) -> SplitSchedule:
        r = self.rows
        return SplitSchedule(self.work[:r], self.work[r:2 * r],
                             self.work[2 * r:3 * r], staged)


def _ptrs(*tensors) -> list:
    return [None if t is None else t.data_ptr() for t in tensors]


def raster_tiles_chunklist(ids, counts, origins, pack, dir_planes,
                           chunk: int = 128, tiles_per_view: int = 64, *,
                           offsets, seg: int = SPLIT_SEG):
    """Kernel A over all (view, tile) rows.

    ids (flat) int32, counts (rows,) int32 and offsets (rows,) int32: the
    lists (module docstring, ``chunk_schedule``) ·
    origins (K, 3) float32 with K * tiles_per_view == rows · pack (COLS, Fp)
    float32, geometry in rows 0-8 · dir_planes 3 x (rows, P) float32.
    -> (packed (rows, P) int32, acc (rows, COLS, P) float32).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which is built on first use, and raise if it fails to build or launch.
    The launch builds the items of ``split_schedule`` on the card
    (segments of ``seg`` list positions; seg is for tests) and sweeps them.
    Each launch adds one to ``raster_tiles_chunklist.launches`` and leaves
    its schedule in ``raster_tiles_chunklist.last_schedule``."""
    cols, Fp = pack.shape
    _check_inputs("raster_tiles_chunklist", ids, counts, offsets, origins,
                  pack, cols, Fp, dir_planes, chunk, tiles_per_view, seg=seg)
    if pack.device.type == "cpu":
        return raster_tiles_chunklist_reference(
            ids, counts, origins, pack, dir_planes, chunk, tiles_per_view,
            offsets=offsets)
    rows, P = dir_planes[0].shape
    with torch.cuda.device(pack.device):
        items = _Items.new(rows, P, pack.device)
        out = _launch(
            "raster_chunklist", "raster_chunklist_launch",
            [*_ptrs(ids, offsets, counts, origins, pack, *dir_planes),
             *items.ptrs(), items.merge.data_ptr()],
            [rows, P, cols, Fp, chunk, tiles_per_view, Fp // chunk, seg],
            rows, P, cols, pack.device)
    raster_tiles_chunklist.launches += 1
    raster_tiles_chunklist.last_schedule = items.schedule()
    return out


raster_tiles_chunklist.launches = 0
raster_tiles_chunklist.last_schedule = None


def _sweep_launch(wrapper, symbol, ids, counts, offsets, origins, pack,
                  bbox_words, dir_planes, cols, Fp, chunk, tiles_per_view,
                  stage_cap, seg):
    """Kernel B or C on CUDA tensors (``symbol``: its sweep's entry point).
    With bbox_words, first the count pass (its own launch, over items of
    ``seg`` list positions: each row's staged faces), then the sweep of
    ``split_schedule``'s items with those counts; both launches build their
    items on the card. Adds one to ``wrapper.count_launches`` for the count
    pass and to ``wrapper.launches`` for the sweep, and leaves the sweep's
    schedule (with the counted staged faces) in ``wrapper.last_schedule``.
    While the recorder records (``utils.profiler``), the rows staging more
    than stage_cap faces go to counter ``raster.rows_past_stage_cap``."""
    rows, P = dir_planes[0].shape
    dev = pack.device
    nc = Fp // chunk
    shape = [Fp, chunk, tiles_per_view, nc, math.isqrt(P),
             math.isqrt(tiles_per_view)]
    with torch.cuda.device(dev):
        items = _Items.new(rows, P, dev)
        order, ends, n_items, done, next_item = items.ptrs()
        staged = seg_counts = None
        if bbox_words is not None:
            max_seg = -(-nc // seg)  # the longest list's
            counted = torch.empty(rows * (1 + max_seg), dtype=torch.int32, device=dev)
            staged, seg_counts = counted[:rows], counted[rows:]
            call_kernel("raster_compact", "raster_count_launch",
                  [*_ptrs(ids, offsets, counts, bbox_words), order, ends,
                   n_items, next_item, staged.data_ptr(), seg_counts.data_ptr()],
                  [rows, P, *shape, seg])
            wrapper.count_launches += 1
            if profiler.recording():
                profiler.count("raster.rows_past_stage_cap",
                               (staged > stage_cap).sum())
        out = _launch(
            "raster_compact", symbol,
            [*_ptrs(ids, offsets, counts, origins, pack, bbox_words,
                    *dir_planes),
             order, ends, n_items, done, next_item, items.merge.data_ptr(),
             *_ptrs(staged, seg_counts)],
            [rows, P, cols, *shape, stage_cap, seg],
            rows, P, cols, dev)
    wrapper.launches += 1
    wrapper.last_schedule = items.schedule(staged)
    return out


def raster_tiles_compact(ids, counts, origins, pack, bbox_words, dir_planes,
                         chunk: int = 128, tiles_per_view: int = 64,
                         stage_cap: int = STAGE_CAP, *, offsets,
                         seg: int = SPLIT_SEG):
    """Kernel B: kernel A's inputs plus bbox_words (K, Fp) int32
    (``raster.bbox_words``); tiles square (P = tile², tiles_per_view =
    n1d²). Same outputs and dispatch as ``raster_tiles_chunklist``. A CUDA
    launch runs the count pass and then sweeps ``split_schedule``'s items
    (one per dense row, one per ``seg`` list positions of a row past the
    cap; seg is for tests), as kernel C's compacting body does on its pack.
    Each sweep adds one to ``raster_tiles_compact.launches``, each count
    pass one to ``raster_tiles_compact.count_launches``; the sweep's
    schedule is left in ``raster_tiles_compact.last_schedule``."""
    cols, Fp = pack.shape
    _check_inputs("raster_tiles_compact", ids, counts, offsets, origins, pack,
                  cols, Fp, dir_planes, chunk, tiles_per_view, bbox_words,
                  stage_cap, seg=seg)
    if pack.device.type == "cpu":
        return raster_tiles_compact_reference(
            ids, counts, origins, pack, bbox_words, dir_planes, chunk,
            tiles_per_view, stage_cap, offsets=offsets)
    return _sweep_launch(raster_tiles_compact, "raster_compact_launch", ids,
                         counts, offsets, origins, pack, bbox_words,
                         dir_planes, cols, Fp, chunk, tiles_per_view,
                         stage_cap, seg)


raster_tiles_compact.launches = 0
raster_tiles_compact.count_launches = 0
raster_tiles_compact.last_schedule = None


def raster_tiles_streamed(ids, counts, origins, pack, dir_planes,
                          chunk: int = 128, tiles_per_view: int = 64,
                          bbox_words=None,
                          stage_cap: int = STREAMED_STAGE_CAP, *,
                          offsets, seg: int = SPLIT_SEG):
    """Kernel C: kernel A's inputs with the pack chunk-major (NC, COLS,
    chunk); with bbox_words (K, Fp) int32 the compacting body, without them
    the plain body. Same outputs and dispatch as ``raster_tiles_chunklist``.
    The compacting body first counts each row's staged faces (the count
    pass: its own launch, over items of ``seg`` list positions), then
    sweeps ``split_schedule``'s items with those counts; both launches
    build their items on the card. Each sweep adds one to
    ``raster_tiles_streamed.launches``, each count pass one to
    ``raster_tiles_streamed.count_launches``; the sweep's schedule (with
    the counted staged faces) is left in
    ``raster_tiles_streamed.last_schedule``."""
    if pack.dim() != 3 or pack.shape[2] != chunk:
        raise ValueError(f"raster_tiles_streamed: pack must be chunk-major "
                         f"(NC, COLS, {chunk}), got {tuple(pack.shape)}")
    nc, cols, _ = pack.shape
    Fp = nc * chunk
    _check_inputs("raster_tiles_streamed", ids, counts, offsets, origins,
                  pack, cols, Fp, dir_planes, chunk, tiles_per_view, bbox_words,
                  stage_cap, seg=seg)
    if pack.device.type == "cpu":
        return raster_tiles_streamed_reference(
            ids, counts, origins, pack, dir_planes, chunk, tiles_per_view,
            bbox_words, stage_cap, offsets=offsets)
    return _sweep_launch(raster_tiles_streamed, "raster_streamed_launch", ids,
                         counts, offsets, origins, pack, bbox_words,
                         dir_planes, cols, Fp, chunk, tiles_per_view,
                         stage_cap, seg)


raster_tiles_streamed.launches = 0
raster_tiles_streamed.count_launches = 0
raster_tiles_streamed.last_schedule = None


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
