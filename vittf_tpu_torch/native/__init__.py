"""ctypes bindings for the shared host library ``native/vittf_native.cpp``.

The port's copy of the ``vittf_tpu.native`` loader, for the two
connected-component entry points. The library is compiled at first use with

    g++ -O3 -shared -fPIC native/vittf_native.cpp -o vittf_tpu_torch/_build/libvittf_native_<hash>.so

(the name carries a hash of the source and flags; nothing is written next to
the source). A missing compiler or a failed build raises: there is no
fallback. Both functions take and return numpy arrays.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG.parent / "native" / "vittf_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libvittf_native_{h.hexdigest()[:16]}.so"


def get_lib() -> ctypes.CDLL:
    """Load the native library, building it if needed; raises on failure."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(
                "g++ not found on PATH; vittf_tpu_torch builds native/vittf_native.cpp "
                "at first use"
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i32 = ctypes.c_int32
    lib.cc3d_label.restype = i32
    lib.cc3d_label.argtypes = [u8p, i32, i32, i32, i32p]
    lib.cc3d_largest.restype = ctypes.c_int64
    lib.cc3d_largest.argtypes = [u8p, i32, i32, i32, u8p]
    _lib = lib
    return lib


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _mask3d(mask) -> np.ndarray:
    mask = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if mask.ndim != 3:
        raise ValueError(f"expected a 3D mask, got shape {mask.shape}")
    return mask


def cc3d_label(mask) -> tuple[np.ndarray, int]:
    """(W, H, D) bool/uint8 → (int32 labels 1..n in scan order, n): the
    6-connected components by two-pass union-find."""
    mask = _mask3d(mask)
    labels = np.zeros(mask.shape, np.int32)
    n = get_lib().cc3d_label(_as_ptr(mask, ctypes.c_uint8), *mask.shape,
                             _as_ptr(labels, ctypes.c_int32))
    return labels, int(n)


def cc3d_largest(mask) -> np.ndarray:
    """Largest 6-connected island of a 3D mask (bool out; all False when the
    mask is empty; ties go to the island met first in scan order)."""
    mask = _mask3d(mask)
    out = np.zeros(mask.shape, np.uint8)
    get_lib().cc3d_largest(_as_ptr(mask, ctypes.c_uint8), *mask.shape,
                           _as_ptr(out, ctypes.c_uint8))
    return out.astype(bool)
