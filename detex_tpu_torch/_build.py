"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

The library is compiled at first use from the sources under csrc/ into
csrc/build/<hash of every file under csrc/ and the flags>/, so an edited
source builds anew and an unchanged one loads the earlier build.  Each
.cu file compiles in its own nvcc process, all started together, and
the objects link into one libdtx_cuda.so.  Only a machine with the CUDA
toolkit can build it; nothing here is imported by the CPU path.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# Every file under csrc/ (headers and host shims included) enters the
# build hash; the .cu files are the translation units.
SOURCES = tuple(sorted(p.name for p in CSRC.iterdir() if p.is_file()))
UNITS = tuple(name for name in SOURCES if name.endswith(".cu"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
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
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs, cmds = [], []
    for unit in UNITS:
        obj = out.with_name(f"{unit}.{tag}.o")
        cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                     str(CSRC / unit)])
        objs.append(obj)
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    start = time.perf_counter()

    def compile_unit(cmd):
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        return proc, time.perf_counter() - start

    # One nvcc per unit, all started together.
    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        results = list(pool.map(compile_unit, cmds))
    log, failed = [], []
    for unit, cmd, (proc, seconds) in zip(UNITS, cmds, results):
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        log.append(f"nvcc wall {unit}: {seconds:.1f} s\n")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{proc.stdout}")
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n"
                          f"{proc.stdout}{proc.stderr}")
    (out.parent / "nvcc.log").write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
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
    # bc.cu, etc_eac.cu, bc6h.cu: (words, n, mode_mask, flags, variant,
    # pixels, valid, stream).
    for name in ("dtx_bc1_decode", "dtx_bc23_decode", "dtx_rgtc1_decode",
                 "dtx_rgtc2_decode", "dtx_etc_decode", "dtx_etc2_eac_decode",
                 "dtx_eac_r11_decode", "dtx_eac_rg11_decode",
                 "dtx_bc6h_decode"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                       ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # bc7_pre.cu: (words, pre, n, mode_mask, flags, pixels, valid, stream).
    lib.dtx_bc7_pre_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    # interleave.cu: (x, lanes, out, stream).
    for name in ("dtx_planar_add1", "dtx_rows_interleave"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                       ctypes.c_void_p, ctypes.c_void_p]
    # mix_probe.cu: (x, n, family, out, stream).
    lib.dtx_mix_probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
    for name in ("dtx_bc7_pre_decode", "dtx_planar_add1",
                 "dtx_rows_interleave", "dtx_mix_probe"):
        getattr(lib, name).restype = ctypes.c_int
    return lib
