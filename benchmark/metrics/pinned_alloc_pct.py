"""Percent of the bytes fetched to the host that needed pinned host memory
newly allocated through CUDA (the program's counters
``fetch.pinned_alloc_bytes`` over ``fetch.bytes``) over the traced stretch."""
from ._recorder import counter_pct


def measure(cell, torch):
    return counter_pct(("fetch.pinned_alloc_bytes",), "fetch.bytes")


def read(rec):
    return rec["stages"].get("pinned_alloc_pct")
