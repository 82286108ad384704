"""Device milliseconds a batch of the program's span ``dpt.backbone``
(``models.dpt.DPTHybrid.forward``: the ResNet stem and stages) over the
traced stretch."""
from ._recorder import span_ms


def measure(cell, torch):
    return span_ms("dpt.backbone", "device_ms")


def read(rec):
    return rec["stages"].get("dpt_backbone_span_ms")
