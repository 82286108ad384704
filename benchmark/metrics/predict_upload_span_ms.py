"""Device milliseconds a batch of the program's span ``predict.upload``
(``models.predict.predict_batches``: the images' copy to the device and
their normalisation) over the traced stretch."""
from ._recorder import span_ms


def measure(cell, torch):
    return span_ms("predict.upload", "device_ms")


def read(rec):
    return rec["stages"].get("predict_upload_span_ms")
