"""The raster kernels' share of their roofline, in percent: the least time
of a batch (``benchmark.work``: bbox-overlapping pixel-face pairs at 20 FP32
operations and 67 TFLOP/s, or bytes at 3.35 TB/s, the larger; the mean over
the batches pulled in the traced stretch) over a batch's device time in the
raster kernels (``raster_ms``)."""
from .raster_ms import batches, raster_seconds


def read(rec):
    tr, work = rec.get("trace"), rec.get("work")
    if not tr or not work or not tr["pool_idx"] or not batches(tr):
        return None
    least = sum(work[b]["least_s"] for b in tr["pool_idx"]) / len(tr["pool_idx"])
    return 100.0 * least * batches(tr) / raster_seconds(tr)
