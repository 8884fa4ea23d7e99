"""The SwiGLU gate of DINOv2's FFN (K10): a hand-written CUDA kernel on the
GPU, plain PyTorch elsewhere.

DINOv2's ``SwiGLUFFNFused`` computes ``w3(silu(x1) · x2)`` where ``[x1 | x2]``
is the ``w12`` projection. The projections are cuBLAS products (their bias
added there); the gate between them is an elementwise pass that reads the
(M, 2H) projection and writes the (M, H) hidden activation, bound by memory:
6·M·H bytes in bf16. On bf16 CUDA tensors ``swiglu`` launches
``csrc/swiglu.cu`` (16-byte loads of both halves and a 16-byte store a
thread, silu and the product in fp32, one rounding to bf16, one launch a
block); elsewhere, and for 'plain', it runs ``swiglu_plain``, which rounds at
the same point. The JAX package has no such kernel: its ViT has no SwiGLU
FFN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from vittf_tpu_torch import kernels

_VEC = 8  # bf16 values in the kernel's 16-byte vector


def swiglu_plain(x12: torch.Tensor) -> torch.Tensor:
    """silu(x1) · x2 of the halves of the last axis, in fp32, cast once to the
    input's dtype."""
    x1, x2 = x12.chunk(2, dim=-1)
    return (F.silu(x1.float()) * x2.float()).to(x12.dtype)


def swiglu(x12: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """The gate over (..., 2H) ``x12``: (..., H). 'auto' launches the kernel
    for a bf16 CUDA tensor and takes ``swiglu_plain`` otherwise (CPU tensors,
    fp32 parity mode); 'plain' always takes the twin."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown swiglu impl: {impl!r}")
    if impl == "plain" or x12.device.type != "cuda" or x12.dtype != torch.bfloat16:
        return swiglu_plain(x12)
    two_h = x12.shape[-1]
    if two_h % (2 * _VEC):
        raise ValueError(f"swiglu kernel needs the hidden width in multiples of {_VEC}, "
                         f"got {two_h // 2}")
    x12 = x12.contiguous()
    if x12.data_ptr() % 16:
        raise ValueError("swiglu kernel needs a 16-byte aligned input")
    rows = x12.numel() // two_h
    out = torch.empty((*x12.shape[:-1], two_h // 2), dtype=x12.dtype, device=x12.device)
    lib = kernels.load_library()
    with torch.cuda.device(x12.device):
        code = lib.vittf_swiglu(x12.data_ptr(), out.data_ptr(), rows, two_h // 2,
                                torch.cuda.current_stream(x12.device).cuda_stream)
    kernels.check(code, "vittf_swiglu")
    swiglu.launches += 1
    return out


swiglu.launches = 0
