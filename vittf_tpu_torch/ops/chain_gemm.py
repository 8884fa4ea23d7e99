"""Chained square GEMM: ``x <- f(x @ W)``, ``chain`` times.

Port of the three Pallas bodies of ``scripts/bench_int8_gemm.py`` (the probe
that asks whether an int8 variant of the fused ViT block is worth building,
epilogue included):

    mode            dtypes                       f
    'bf16'          bf16, fp32 accumulate        bf16(y)
    'int8+requant'  int8, int32 accumulate       m = max|float(y)| per row;
                                                 int8(round(float(y) · 127 / max(m, 1e-6)))
    'int8+shift'    int8, int32 accumulate       int8(y >> 8), wrapping

On CUDA tensors ``chain_gemm`` launches ``csrc/chain_gemm.cu`` (the whole chain
in one launch: every product a warpgroup MMA in the kernel's own body, the
column tiles of a row block one thread block cluster that meets at a barrier
between steps and shares its row maxima); on CPU tensors it runs
``chain_gemm_plain``, which rounds where the bodies round. The integer modes
are bit-defined: round half to even, IEEE division and multiply, arithmetic
shift, and the cast to int8 keeps the low 8 bits.
"""
from __future__ import annotations

import torch

from vittf_tpu_torch import kernels
from vittf_tpu_torch.utils.tensor import ieee_matmul

MODES = ("bf16", "int8+requant", "int8+shift")


def kernel_tile(dim: int) -> int:
    """The kernel's column tile width for ``dim`` (192 where it divides, else
    128), or 0 where the kernel does not take ``dim``: a multiple of 128 whose
    column tiles, one thread block cluster per row block, number 1, 2, 4 or 8."""
    if dim < 128 or dim % 128:
        return 0
    for bn in (192, 128):
        if dim % bn == 0 and dim // bn in (1, 2, 4, 8):
            return bn
    return 0


def wrap_int8(v: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int8 keeping the low 8 bits (two's complement)."""
    return (((v + 128) & 255) - 128).to(torch.int8)


def _check(x: torch.Tensor, w: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"chain_gemm: unknown mode {mode!r}, expected one of {MODES}")
    want = torch.bfloat16 if mode == "bf16" else torch.int8
    if x.dtype != want or w.dtype != want:
        raise ValueError(f"chain_gemm {mode}: takes {want} x and w, got {x.dtype}, {w.dtype}")
    if x.ndim != 2 or w.shape != (x.shape[1], x.shape[1]):
        raise ValueError(f"chain_gemm: x {tuple(x.shape)} needs a square w, got {tuple(w.shape)}")


def chain_gemm_plain(x: torch.Tensor, w: torch.Tensor, chain: int, mode: str) -> torch.Tensor:
    """Plain PyTorch version, rounding where the TPU bodies round.

    bf16: the product of the fp32-widened operands (bf16 products are exact
    in fp32) accumulated in IEEE fp32, cast to bf16 each step. int8: the
    int32 product is taken in floating point where it is exact — fp32 while
    ``128·max|w|·dim < 2^24`` (every partial sum is then an integer below
    2^24), fp64 (exact to 2^53) otherwise — because ``torch.matmul`` has no
    integer kernel on CUDA.
    """
    _check(x, w, mode)
    with ieee_matmul():
        if mode == "bf16":
            wf = w.float()
            for _ in range(chain):
                x = (x.float() @ wf).to(torch.bfloat16)
            return x
        dim = w.shape[0]
        w_max = int(w.abs().max()) if w.numel() else 0
        wide = torch.float32 if 128 * w_max * dim < 2**24 else torch.float64
        wf = w.to(wide)
        for _ in range(chain):
            y = x.to(wide) @ wf  # the exact int32 product
            if mode == "int8+requant":
                yf = y.float()
                m = yf.abs().amax(dim=-1, keepdim=True)
                # a true IEEE division: ``127.0 / tensor`` is reciprocal-then-multiply
                scale = torch.full_like(m, 127.0) / torch.clamp_min(m, 1e-6)
                x = wrap_int8(torch.round(yf * scale).to(torch.int32))
            else:
                x = wrap_int8(y.to(torch.int32) >> 8)
        return x


def chain_gemm(x: torch.Tensor, w: torch.Tensor, chain: int, mode: str) -> torch.Tensor:
    """``chain`` steps of ``x <- f(x @ w)``; the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return chain_gemm_plain(x, w, chain, mode)
    if x.device.type != "cuda":
        raise ValueError(f"chain_gemm: unsupported device {x.device}")
    _check(x, w, mode)
    rows, dim = x.shape
    if w.device != x.device:
        raise ValueError(f"chain_gemm: w on {w.device}, x on {x.device}")
    if not kernel_tile(dim) or rows < 1:
        raise ValueError(
            f"chain_gemm kernel needs rows >= 1 and dim a multiple of 128 that is 1, 2, 4 or 8 "
            f"column tiles of 192 or 128 (128, 256, 384, 512, 768, 1024, 1536), got {rows} x {dim}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"chain_gemm kernel needs contiguous 16-byte aligned {name}")
    if chain < 1:
        return x.clone()
    out, tmp, wt = torch.empty_like(x), torch.empty_like(x), torch.empty_like(w)
    lib = kernels.load_library()
    with torch.cuda.device(x.device):
        code = lib.vittf_chain_gemm(
            x.data_ptr(), w.data_ptr(), wt.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            rows, dim, int(chain), MODES.index(mode),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(code, "vittf_chain_gemm")
    chain_gemm.launches += 1
    return out


chain_gemm.launches = 0
