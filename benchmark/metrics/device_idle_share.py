"""Percent of the traced stretch in which no kernel, copy or set ran on the
device."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["stretch_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["stretch_s"])
