"""Builds the native sources at first use and loads them with ctypes (plain
C interfaces; nothing includes PyTorch's headers).

Each CUDA source ``csrc/<name>.cu`` becomes
``build/kernels/lib<name>-<hash>.so`` at the repository root, keyed by the
source, every header in ``csrc/`` and the flags, so an edited source or
shared header is rebuilt and an unchanged one is reused. The compiler's
output, including ptxas's register and shared-memory report, is kept beside
it as ``<name>.log``. The host-cue cores ``native/<name>.cpp`` are built the
same way with g++ into ``build/native/``. A missing compiler or a failed
build raises.
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
NATIVE_DIR = Path(__file__).resolve().parent / "native"
HOST_BUILD_DIR = BUILD_DIR.parent / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

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


def _build_all(jobs_spec) -> None:
    """(name, library path, log path, command) for each library to build:
    one compiler process each, all started together, each waited for. A
    library is written under a temporary name and renamed into place, so a
    concurrent reader never loads a half-written file."""
    jobs = []
    try:
        for name, lib, log_path, cmd in jobs_spec:
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".tmp{os.getpid()}")
            proc = subprocess.Popen([*cmd, "-o", str(tmp)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, lib, log_path, tmp, cmd, proc))
        for name, lib, log_path, tmp, cmd, proc in jobs:
            out, _ = proc.communicate()
            log = f"$ {' '.join(cmd)} -o {tmp}\n{out}"
            log_path.write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"failed to build {name}:\n{log}")
            os.replace(tmp, lib)
    finally:
        for *_, proc in jobs:  # an early raise leaves no compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def host_library_path(name: str) -> Path:
    src = NATIVE_DIR / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode())
    return HOST_BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(kernels=(), hosts=()) -> None:
    """Build every named CUDA source ``csrc/<name>.cu`` (nvcc) and host-cue
    core ``native/<name>.cpp`` (g++) whose library is missing, all
    compilers started together."""
    _build_all([
        (f"{name}.cu", library_path(name), build_log_path(name),
         [find_nvcc(), *NVCC_FLAGS, str(SRC_DIR / f"{name}.cu")])
        for name in kernels if not library_path(name).exists()] + [
        (f"{name}.cpp", host_library_path(name),
         HOST_BUILD_DIR / f"{name}.log",
         ["g++", *GXX_FLAGS, str(NATIVE_DIR / f"{name}.cpp")])
        for name in hosts if not host_library_path(name).exists()])


@functools.cache
def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    build_libraries(kernels=[name])
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def load_host_library(name: str) -> ctypes.CDLL:
    """Build ``native/<name>.cpp`` if needed and load it (once per
    process)."""
    build_libraries(hosts=[name])
    return ctypes.CDLL(str(host_library_path(name)))
