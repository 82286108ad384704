"""Seconds from the start of the process to the start of the window:
imports, the scene, the program's mesh and bake, the warm pass (and, in a
checkout's first run, the kernels' build)."""


def read(rec):
    return rec["setup_s"]
