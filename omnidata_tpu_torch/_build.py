"""Builds the CUDA sources in ``csrc/`` with nvcc at first use and loads
them with ctypes (a plain C interface; nothing includes PyTorch's headers).

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>-<hash>.so`` at the
repository root, keyed by the source, every header in ``csrc/`` and the
flags, so an edited source or shared header is rebuilt and an unchanged one
is reused. The compiler's output, including ptxas's register and
shared-memory report, is kept beside it as ``<name>.log``. A missing nvcc or
a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

# -fmad=false and IEEE division/sqrt without flushing denormals: the kernels
# must round exactly as their plain PyTorch versions do
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def build_log_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.log"


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` header (a source may
    include any of them) and the flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(name)}.so"


def build_kernel_libraries(names) -> None:
    """Build every named source whose library is missing: one nvcc process
    per source, all started together, each waited for."""
    jobs = []
    try:
        for name in names:
            lib = library_path(name)
            if lib.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".tmp{os.getpid()}")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(SRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, lib, tmp, cmd, proc))
        for name, lib, tmp, cmd, proc in jobs:
            out, _ = proc.communicate()
            log = f"$ {' '.join(cmd)}\n{out}"
            build_log_path(name).write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
            os.replace(tmp, lib)
    finally:
        for *_, proc in jobs:  # an early raise leaves no compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@functools.cache
def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    build_kernel_libraries([name])
    return ctypes.CDLL(str(library_path(name)))
