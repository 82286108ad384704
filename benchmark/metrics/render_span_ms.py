"""Device milliseconds a batch of the program's span ``raster.render`` (the
raster kernel's count pass and sweep, ``decode_winners``, the fragments)
over the traced stretch."""
from ._recorder import span_ms


def measure(cell, torch):
    return span_ms("raster.render", "device_ms")


def read(rec):
    return rec["stages"].get("render_span_ms")
