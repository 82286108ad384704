"""Device milliseconds a batch of the program's span ``cues.keypoints2d``
(``keypoints2d`` on the rendered grey images, inside the cue stack) over
the traced stretch."""
from ._recorder import span_ms


def measure(cell, torch):
    return span_ms("cues.keypoints2d", "device_ms")


def read(rec):
    return rec["stages"].get("keypoints2d_span_ms")
