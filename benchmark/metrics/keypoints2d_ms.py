"""Milliseconds a batch of ``cues.keypoints2d`` alone (the cue stack's
largest stage) on a batch of seeded grey images, by CUDA events: one warm
call a pool batch, then the median of three passes."""
import statistics


def measure(cell, torch):
    from omnidata_tpu_torch.cues.keypoints2d import keypoints2d

    g = torch.Generator(device=cell.device).manual_seed(0)
    gray = torch.rand((cell.K, cell.res, cell.res), generator=g, device=cell.device)
    n = len(cell.stage_batches())
    for _ in range(n):
        keypoints2d(gray)
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            keypoints2d(gray)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return statistics.median(runs)


def read(rec):
    return rec["stages"].get("keypoints2d_ms")
