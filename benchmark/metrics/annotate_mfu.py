"""Percent of the card's FP32 peak (67 TFLOP/s) that the window's needed
raster operations (``benchmark.work`` over every batch finished in the
window) make over the window's seconds. A lower bound of the whole step's
share: the cue stack's operations are not counted."""
from ..work import FP32_PEAK


def read(rec):
    work = rec.get("work")
    if not work or not rec["completed_pool_idx"]:
        return None
    ops = sum(work[b]["ops"] for b in rec["completed_pool_idx"])
    return 100.0 * ops / (rec["seconds"] * FP32_PEAK)
