"""Percent of the card's dense bfloat16 peak (989 TFLOP/s) that the
window's images make over its seconds, each counted at
``benchmark.dpt_work``'s FLOPs (convolutions, linear layers and
attention's products)."""
from ..dpt_work import BF16_PEAK


def read(rec):
    work = rec.get("work")
    if not work or not rec["completed_pool_idx"]:
        return None
    flops = sum(work[b]["flops"] for b in rec["completed_pool_idx"])
    return 100.0 * flops / (rec["seconds"] * BF16_PEAK)
