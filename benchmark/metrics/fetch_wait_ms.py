"""Host milliseconds a batch that the pipeline's main thread waits for the
fetch thread (the program's span ``pipeline.wait``) over the traced
stretch."""
from ._recorder import span_ms


def measure(cell, torch):
    return span_ms("pipeline.wait", "host_ms")


def read(rec):
    return rec["stages"].get("fetch_wait_ms")
