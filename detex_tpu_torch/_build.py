"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

The library is compiled at first use from the sources under csrc/ into
csrc/build/<hash of the sources and flags>/, so an edited source builds
anew and an unchanged one loads the earlier build.  Only a machine with
the CUDA toolkit can build it; nothing here is imported by the CPU path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bc7.cuh", "bc7.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "libdtx_cuda.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                           f"({home}); the CUDA kernels cannot be built")
    return path


def build_dir() -> Path:
    """Directory of the build for the current sources and flags."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return CSRC / "build" / h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this build does not exist yet; return its
    path.  The compiler's report (registers, spills) is kept beside it in
    nvcc.log."""
    out = build_dir() / LIB_NAME
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "bc7.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.dtx_bc7_decode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
