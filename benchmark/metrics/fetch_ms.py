"""Device milliseconds a batch of device-to-host copies (the label fetch of
``cli.fetch_to_host``) over the traced stretch; a batch is one raster sweep
launch."""
from .raster_ms import batches


def read(rec):
    tr = rec.get("trace")
    if not tr or not batches(tr):
        return None
    s = sum(v for k, v in tr["device_s"].items() if "DtoH" in k)
    return s / batches(tr) * 1e3 if s > 0 else None
