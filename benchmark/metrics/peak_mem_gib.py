"""GiB of device memory at the window's peak (``max_memory_allocated``
after ``reset_peak_memory_stats`` at its start)."""


def read(rec):
    return rec["peak_bytes"] / 2**30 if rec["peak_bytes"] else None
