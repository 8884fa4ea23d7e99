"""Build and load the package's hand-written CUDA kernels.

The sources in ``vittf_tpu_torch/csrc/*.cu`` are compiled at first use, one
``nvcc`` process per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu -o _build/<name>.o

and linked (``nvcc -shared``) into one shared library
``vittf_tpu_torch/_build/libvittf_kernels_<hash>.so`` with a plain C
interface, loaded with ``ctypes``.
The file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads from the cache. Pointers and the CUDA
stream pass as ``c_void_p``; every entry point returns the
``cudaGetLastError()`` seen right after its launch, and ``check`` raises on a
nonzero code. Nothing here runs at import: the CPU tests import every module
on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # set by the call that built or loaded the library


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of vittf_tpu_torch are built from source at first use"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvittf_kernels_{h.hexdigest()[:16]}.so"


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, f32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint64
    lib.vittf_attention_fwd.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, i32, vp, f32, vp,
    ]
    lib.vittf_attention_fwd.restype = i32
    lib.vittf_rope_attention_fwd.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, vp, f32, vp, i32, i32, i32, vp,
    ]
    lib.vittf_rope_attention_fwd.restype = i32
    lib.vittf_similarity.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, f32, f32, i32, vp,
    ]
    lib.vittf_similarity.restype = i32
    lib.vittf_bls_splat.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, f32, i32, vp]
    lib.vittf_bls_splat.restype = i32
    lib.vittf_bls_slice.argtypes = [
        vp, vp, vp, i32, i32, i32, i32, i32, f32, i32, u64, u64, u64, vp,
    ]
    lib.vittf_bls_slice.restype = i32
    lib.vittf_bls_blur.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.vittf_bls_blur.restype = i32
    lib.vittf_bls_reblock.argtypes = [vp, vp, i32, i32, i32, i32, i32, ctypes.c_uint, vp]
    lib.vittf_bls_reblock.restype = i32
    lib.vittf_bls_unreblock.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp]
    lib.vittf_bls_unreblock.restype = i32
    lib.vittf_bls_splat_blocked.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
    lib.vittf_bls_splat_blocked.restype = i32
    lib.vittf_bls_slice_blocked.argtypes = [vp, vp, vp, i32, i32, i32, i32, u64, vp]
    lib.vittf_bls_slice_blocked.restype = i32
    lib.vittf_fused_block.argtypes = [vp, i32, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.vittf_fused_block.restype = i32
    lib.vittf_chain_gemm.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, vp]
    lib.vittf_chain_gemm.restype = i32
    lib.vittf_swiglu.argtypes = [vp, vp, ctypes.c_longlong, i32, vp]
    lib.vittf_swiglu.restype = i32
    lib.vittf_layer_norm.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, i32, f32, vp]
    lib.vittf_layer_norm.restype = i32
    lib.vittf_lattice_solve.argtypes = [
        vp, vp, vp, ctypes.c_longlong, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32,
        i32, f32, f32, f32, i32, i32, vp,
    ]
    lib.vittf_lattice_solve.restype = i32


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = BUILD_DIR / f"{so.stem}.{os.getpid()}"
        nvcc = _nvcc()
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [f"{tag}.{s.stem}.o" for s in srcs]
        try:
            with ThreadPoolExecutor(len(srcs)) as pool:
                list(pool.map(_run_nvcc, ([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o]
                                          for s, o in zip(srcs, objs))))
            _run_nvcc([nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tag}.tmp.so", *objs])
        finally:
            for obj in objs:
                Path(obj).unlink(missing_ok=True)
        os.replace(f"{tag}.tmp.so", so)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


def _run_nvcc(cmd: list[str]) -> str:
    """Run one nvcc command; returns what it wrote to stderr, raises on failure."""
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    return res.stderr


def ptxas_report() -> dict[str, str]:
    """Per source, what ``nvcc -Xptxas -v`` prints: each kernel's registers,
    shared memory and spills. Compiles every source once more (objects are
    discarded); the loaded library is not touched."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [str(BUILD_DIR / f"ptxas.{os.getpid()}.{s.stem}.o") for s in srcs]
    try:
        with ThreadPoolExecutor(len(srcs)) as pool:
            logs = list(pool.map(_run_nvcc, ([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(s),
                                              "-o", o] for s, o in zip(srcs, objs))))
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    return {s.name: log for s, log in zip(srcs, logs)}


def check(code: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
