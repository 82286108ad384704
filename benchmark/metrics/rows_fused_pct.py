"""Percent of admission rows that the fused admission kernels admitted
(the program's counter ``raster.rows_fused`` over ``raster.rows``) over the
traced stretch."""
from ._recorder import counter_pct


def measure(cell, torch):
    return counter_pct(("raster.rows_fused",), "raster.rows")


def read(rec):
    return rec["stages"].get("rows_fused_pct")
