"""ctypes bindings for the native C++ host runtime (csrc/native/dtxnative.cpp).

The port's own copy of detex_tpu/native.py and of the sources under
native/, so that the port imports nothing of the JAX package; the two are
held equal by tests/test_torch_host_copies.py.

The shared library is built on first use with g++, with the flags of
native/Makefile, into csrc/build/native-<hash of the sources and flags>/
libdtxnative.so (csrc/build/ is not committed; the nvcc build of the CUDA
kernels reads only the files directly under csrc/).  It provides:

  decode(family, blocks, mode_mask, flags, n_threads)
      -> (out_bytes (N, out_bytes) u8, valid (N,) bool)
      multithreaded CPU block decode, bit-exact vs the C reference;
      output byte layout identical to the reference decoders'
      pixel_buffer (and to the framework's golden packers).

  assemble_linear(block_pixels, wb, hb, width, height, ps) -> u8 image
      tiled -> linear assembly with edge cropping (texture.c:105-145).

Use `available()` to check (and lazily build) the library; it is False
where no C++ toolchain exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_CSRC = Path(__file__).resolve().parent / "csrc"
_NATIVE_DIR = _CSRC / "native"
_SOURCES = ("dtxnative.cpp", "dtx_tables.h")
# native/Makefile's CXXFLAGS and LDFLAGS.
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
          "-pthread")

# Family ids must match `enum Family` in dtxnative.cpp.
FAMILIES = {
    "BC1": 0, "BC1A": 1, "BC2": 2, "BC3": 3,
    "RGTC1": 4, "SIGNED_RGTC1": 5, "RGTC2": 6, "SIGNED_RGTC2": 7,
    "BPTC_FLOAT": 8, "BPTC_SIGNED_FLOAT": 9, "BPTC": 10,
    "ETC1": 11, "ETC2": 12, "ETC2_PUNCHTHROUGH": 13, "ETC2_EAC": 14,
    "EAC_R11": 15, "EAC_SIGNED_R11": 16, "EAC_RG11": 17,
    "EAC_SIGNED_RG11": 18,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def lib_path() -> Path:
    """Where the build of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES:
        h.update((_NATIVE_DIR / name).read_bytes())
    return _CSRC / "build" / f"native-{h.hexdigest()[:16]}" / \
        "libdtxnative.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_NATIVE_DIR / "dtxnative.cpp"),
                        "-o", str(tmp)], check=True, capture_output=True,
                       text=True, timeout=300)
        os.replace(tmp, out)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.dtx_decode.restype = ctypes.c_int
        lib.dtx_decode.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
        lib.dtx_family_info.restype = ctypes.c_int
        lib.dtx_family_info.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.dtx_assemble_linear.restype = ctypes.c_int
        lib.dtx_assemble_linear.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    """True if the native library is present (building it if needed)."""
    return _load() is not None


def family_info(family: str) -> Tuple[int, int]:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    bb = ctypes.c_int()
    ob = ctypes.c_int()
    if lib.dtx_family_info(FAMILIES[family], ctypes.byref(bb),
                           ctypes.byref(ob)) != 0:
        raise ValueError(f"unknown family {family}")
    return bb.value, ob.value


def decode(family: str, blocks_u8: np.ndarray, mode_mask: int = 0xFFFFFFFF,
           flags: int = 0, n_threads: int = 0):
    """Decode (N, block_bytes) u8 blocks on the CPU.  Returns
    ((N, out_bytes) u8 — invalid blocks zero-filled, (N,) bool valid)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    bb, ob = family_info(family)
    blocks = np.ascontiguousarray(blocks_u8, dtype=np.uint8)
    if blocks.ndim != 2 or blocks.shape[1] != bb:
        raise ValueError(f"{family}: expected (N, {bb}) blocks, "
                         f"got {blocks.shape}")
    n = blocks.shape[0]
    out = np.empty((n, ob), np.uint8)
    valid = np.empty((n,), np.uint8)
    rc = lib.dtx_decode(FAMILIES[family], blocks.ctypes.data, n,
                        out.ctypes.data, valid.ctypes.data,
                        ctypes.c_uint32(mode_mask & 0xFFFFFFFF),
                        ctypes.c_uint32(flags & 0xFFFFFFFF), n_threads)
    if rc != 0:
        raise RuntimeError(f"dtx_decode failed: {rc}")
    return out, valid.astype(bool)


def assemble_linear(block_pixels: np.ndarray, wb: int, hb: int,
                    width: int, height: int, ps: int) -> np.ndarray:
    """(N, 16*ps) per-block pixel bytes -> (height*width*ps,) linear."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    bp = np.ascontiguousarray(block_pixels, dtype=np.uint8)
    out = np.zeros((height * width * ps,), np.uint8)
    lib.dtx_assemble_linear(bp.ctypes.data, wb, hb, width, height, ps,
                            out.ctypes.data)
    return out
