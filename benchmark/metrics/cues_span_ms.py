"""Device milliseconds a batch of the program's span ``annotate.labels``
(the cue stack, ``annotator.pipeline._labels``) over the traced stretch."""
from ._recorder import span_ms


def measure(cell, torch):
    return span_ms("annotate.labels", "device_ms")


def read(rec):
    return rec["stages"].get("cues_span_ms")
