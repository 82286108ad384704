"""Percent of admission rows that staged more faces than the compacting
kernel's stage cap and fell back to the raw list sweep (the program's
counter ``raster.rows_past_stage_cap`` over ``raster.rows``) over the traced
stretch."""
from ._recorder import counter_pct


def measure(cell, torch):
    return counter_pct(("raster.rows_past_stage_cap",), "raster.rows")


def read(rec):
    return rec["stages"].get("rows_past_stage_cap_pct")
