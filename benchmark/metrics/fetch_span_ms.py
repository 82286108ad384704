"""Milliseconds a batch of the program's span ``pipeline.fetch`` on the
fetch's side stream (from the batch's ready event to the end of its
copies to pinned host memory) over the traced stretch."""
from ._recorder import span_ms


def measure(cell, torch):
    return span_ms("pipeline.fetch", "device_ms")


def read(rec):
    return rec["stages"].get("fetch_span_ms")
