"""Device milliseconds a batch of the program's span ``dpt.encoder``
(``models.dpt.DPTHybrid.forward``: the patch projection, the position
embedding and the transformer blocks) over the traced stretch."""
from ._recorder import span_ms


def measure(cell, torch):
    return span_ms("dpt.encoder", "device_ms")


def read(rec):
    return rec["stages"].get("dpt_encoder_span_ms")
