"""Device milliseconds a batch of the program's span ``dpt.decoder``
(``models.dpt.DPTHybrid.forward``: reassemble, fusion and head) over the
traced stretch."""
from ._recorder import span_ms


def measure(cell, torch):
    return span_ms("dpt.decoder", "device_ms")


def read(rec):
    return rec["stages"].get("dpt_decoder_span_ms")
