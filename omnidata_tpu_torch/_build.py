"""Builds the CUDA sources in ``csrc/`` with nvcc at first use and loads
them with ctypes (a plain C interface; nothing includes PyTorch's headers).

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>-<hash>.so`` at the
repository root, keyed by the source and the flags, so an edited source is
rebuilt and an unchanged one is reused. The compiler's output, including
ptxas's register and shared-memory report, is kept beside it as
``<name>.log``. A missing nvcc or a failed build raises.
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


@functools.cache
def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        build_log_path(name).write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src.name}:\n{log}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
