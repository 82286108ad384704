"""Timing and work counts of the port's raster kernels on one NVIDIA GPU,
shared by ``chip_smoke.py`` and ``tools/profile_torch_annotator.py``.

Imports no JAX and, at import, nothing of the port: the profiling tool
loads ``omnidata_tpu_torch`` from the checkout it is asked to time
(``--root``), and these helpers use whichever one is loaded.
"""
from __future__ import annotations

import subprocess

FLOPS_PER_PAIR = 20  # FP32 multiplies and adds per (pixel, face) pair
# H100 SXM, FP32 outside the tensor cores, at 700 W; it counts a fused
# multiply-add as two operations
FP32_PEAK = 67e12
# the kernels are built with -fmad=false (bit-exact with the plain
# versions): each multiply and each add is an instruction of its own, so
# their rate is half the peak
FP32_UNFUSED_PEAK = FP32_PEAK / 2
HBM_BYTES_PER_S = 3.35e12


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over reps calls, by CUDA events."""
    return timed(fn, reps)[0]


def timed(fn, reps: int = 1):
    """(mean milliseconds per call of fn over reps calls by CUDA events, the
    last call's result)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def trips(counts, n_chunks: int):
    """List positions each row sweeps (raster_kernels.list_trips)."""
    import torch

    return torch.where(counts == -1, n_chunks,
                       torch.where(counts < -1, (-counts - 2) * 8, counts))


def overlap_counts(inp, chunk: int):
    """Faces per row whose tile-quantized bbox overlaps the row's tile, of
    the row's listed chunks, with no cap: ``stage_faces`` at cap 1 on
    prepare_raster's inputs (which need ``bbox_words``)."""
    from omnidata_tpu_torch.mesh import raster_kernels as rk

    streamed = inp.pack.dim() == 3
    n_chunks = inp.pack.shape[0] if streamed else inp.pack.shape[1] // chunk
    tile = int(round(inp.dir_planes[0].shape[1] ** 0.5))
    offsets = getattr(inp, "offsets", None)  # exact lists (not in older checkouts)
    kw = {} if offsets is None else {"offsets": offsets}
    return rk.stage_faces(inp.ids, inp.counts, inp.bbox_words, n_chunks, chunk,
                          inp.tiles_per_view, tile, 1, **kw)[0]


def raster_work(inp, overlaps, reads_bbox_words: bool = False) -> dict:
    """What a raster launch on prepare_raster's inputs must do, whichever
    kernel computes it: sweep each pixel against the faces whose bbox
    overlaps its tile (``overlaps``, per row, from ``overlap_counts``; the
    winner is among them), at FLOPS_PER_PAIR FP32 operations a pair; read
    each input once and write packed and acc once. -> pairs, bytes, the
    least time of each at the card's peaks (``ops_ms`` at FP32_PEAK,
    ``ops_ms_unfused`` at FP32_UNFUSED_PEAK, ``bytes_ms``), ``bound_ms``
    (the larger of ops_ms and bytes_ms) and what binds it."""
    rows, P = inp.dir_planes[0].shape
    cols = inp.pack.shape[1] if inp.pack.dim() == 3 else inp.pack.shape[0]
    pairs = int(overlaps.sum()) * P
    ins = [inp.ids, inp.counts, inp.origins, inp.pack, *inp.dir_planes]
    if getattr(inp, "offsets", None) is not None:
        ins.append(inp.offsets)
    if reads_bbox_words:
        ins.append(inp.bbox_words)
    n_bytes = sum(t.numel() * t.element_size() for t in ins) + rows * P * 4 * (1 + cols)
    ops_ms = pairs * FLOPS_PER_PAIR / FP32_PEAK * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"pairs": pairs, "bytes": n_bytes, "ops_ms": ops_ms,
            "ops_ms_unfused": pairs * FLOPS_PER_PAIR / FP32_UNFUSED_PEAK * 1e3,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def item_counts(sched) -> dict:
    """Work items and split rows of a kernel A or C launch's schedule."""
    return {"items": int(sched.ends[-1]),
            "split_rows": int((sched.n_items > 1).sum())}
