"""Milliseconds a batch in ``mesh.raster.prepare_raster`` (admission lists,
rays, the scene pack) as the window's entry calls it: ``annotate_views``
with the cell's settings runs on pool batches, and each call it makes to
``prepare_raster`` is bracketed by CUDA events on the current stream. The
route, the attributes and the pack are the program's own choice; where the
entry makes no such call, the metric is left out."""
import statistics


def measure(cell, torch):
    from omnidata_tpu_torch.annotator.pipeline import annotate_views
    from omnidata_tpu_torch.mesh import raster

    real = raster.prepare_raster
    spans: list = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    batches = cell.stage_batches()
    runs = []
    raster.prepare_raster = timed
    try:
        for rep in range(4):  # the first pass warms
            spans.clear()
            for b in batches:
                annotate_views(b, cell.mesh, cell.curv, **cell.kw)
            torch.cuda.synchronize()
            if not spans:
                return None
            if rep:
                runs.append(sum(s.elapsed_time(e) for s, e in spans) / len(batches))
    finally:
        raster.prepare_raster = real
    return statistics.median(runs)


def read(rec):
    return rec["stages"].get("admission_ms")
