"""Device milliseconds a batch in the raster kernels (count pass, item
schedule, merge set-up and sweep of kernels A, B and C) over the traced
stretch; a batch is one sweep launch."""

KERNELS = ("raster_chunklist_kernel", "raster_count_kernel",
           "raster_sweep_kernel", "schedule_kernel", "merge_init_kernel")
SWEEPS = ("raster_chunklist_kernel", "raster_sweep_kernel")


def raster_seconds(tr) -> float:
    return sum(v for k, v in tr["device_s"].items() if any(n in k for n in KERNELS))


def batches(tr) -> int:
    """Batches rendered in the stretch: one sweep launch each."""
    return sum(v for k, v in tr["device_n"].items() if any(n in k for n in SWEEPS))


def read(rec):
    tr = rec.get("trace")
    if not tr or not batches(tr):
        return None
    return raster_seconds(tr) / batches(tr) * 1e3
