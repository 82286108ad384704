"""Percent of admission rows whose chunk list overflowed the chunk-list cap
(block mode or a scan of all chunks: the program's counters
``raster.rows_block`` and ``raster.rows_scan_all`` over ``raster.rows``)
over the traced stretch."""
from ._recorder import counter_pct


def measure(cell, torch):
    return counter_pct(("raster.rows_block", "raster.rows_scan_all"), "raster.rows")


def read(rec):
    return rec["stages"].get("rows_over_ccap_pct")
