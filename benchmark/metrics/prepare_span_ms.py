"""Device milliseconds a batch of the program's span ``raster.prepare``
(``mesh.raster.prepare_raster``: admission lists, rays, the scene pack)
over the traced stretch."""
from ._recorder import span_ms


def measure(cell, torch):
    return span_ms("raster.prepare", "device_ms")


def read(rec):
    return rec["stages"].get("prepare_span_ms")
