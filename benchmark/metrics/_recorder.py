"""Readers of the program's own spans and counters
(``omnidata_tpu_torch.utils.profiler``), recorded while the traced stretch
ran the profiler. Each metric's ``measure`` reads the recorder's summary
and runs nothing; a program without the recorder, or a stretch that
recorded no such span or counter, gives None."""


def summary() -> dict:
    try:
        from omnidata_tpu_torch.utils import profiler
    except ImportError:
        return {}
    read = getattr(profiler, "summary", None)
    return read() if read is not None else {}


def span_ms(name: str, clock: str):
    """Mean ms a batch of span ``name``: clock "device_ms" (between its
    events on its stream) or "host_ms"."""
    span = summary().get("spans", {}).get(name)
    return None if span is None else span.get(clock)


def counter_pct(parts: tuple, whole: str):
    """100 x the sum of counters ``parts`` over counter ``whole``."""
    c = summary().get("counters", {})
    if whole not in c or not c[whole]["total"] or any(p not in c for p in parts):
        return None
    return 100.0 * sum(c[p]["total"] for p in parts) / c[whole]["total"]
