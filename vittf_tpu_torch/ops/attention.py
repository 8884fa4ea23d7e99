"""Multi-head self-attention: a hand-written CUDA kernel on the GPU, plain
PyTorch on the CPU.

Port of ``vittf_tpu/ops/attention.py``. The ViT slice batches put ~4k patch
tokens per slice through every attention block, the FLOPs hot spot of
feature extraction. On CUDA tensors ``attention`` launches
``csrc/attention.cu`` (online-softmax forward, the (N x N) score matrix never
reaches device memory: in bf16 both products run on the tensor cores with
the scores held in registers, ``csrc/attention_core.cuh``; fp32 stays IEEE
fp32 on the FP32 cores); on CPU tensors it runs ``attention_plain``, the
``_attention_xla`` math of the JAX package.
"""
from __future__ import annotations

import ctypes
import math

import torch

from vittf_tpu_torch import kernels

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q, k, v):
    """softmax(q·kᵀ/√hd)·v over (B, H, N, hd); ``_attention_xla`` math.

    Scores are taken in the input dtype, the softmax in fp32, and the
    probabilities are cast back to the value dtype before PV. The input
    dtype sets the numerics: fp32 matmuls here are IEEE fp32 (the CPU
    always, CUDA while ``torch.backends.cuda.matmul.allow_tf32`` is off).
    """
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def attention(q, k, v):
    """(B, H, N, hd) attention; the CUDA kernel for CUDA tensors.

    q/k/v may be strided views (e.g. of the fused qkv buffer) as long as the
    head dim is contiguous. Returns a (B, H, N, hd) view of a (B, N, H, hd)
    contiguous buffer, so merging heads afterwards is free.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    B, H, N, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: shapes differ {q.shape} {k.shape} {v.shape}")
    if hd != 64:
        raise ValueError(f"attention kernel supports head dim 64, got {hd}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel takes fp32 or bf16, got {q.dtype}")
    vec = 16 // q.element_size()  # the kernel reads 16-byte vectors
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError("attention: q, k, v on different devices")
        if t.stride(-1) != 1:
            raise ValueError("attention kernel needs a contiguous head dim")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError("attention kernel needs 16-byte aligned rows")
    out = torch.empty((B, N, H, hd), dtype=q.dtype, device=q.device)
    o = out.permute(0, 2, 1, 3)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]
    )
    lib = kernels.load_library()
    with torch.cuda.device(q.device):
        code = lib.vittf_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _KERNEL_DTYPES[q.dtype], B, H, N, hd, ctypes.addressof(strides),
            hd ** -0.5 * math.log2(math.e),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check(code, "vittf_attention_fwd")
    attention.launches += 1
    return o


attention.launches = 0


def multi_head_attention(
    qkv: torch.Tensor,
    num_heads: int,
    impl: str = "auto",
) -> torch.Tensor:
    """Self-attention over a fused qkv projection.

    Args:
        qkv: (B, N, 3D), the qkv linear output (DINO layout: viewed as
            (B, N, 3, heads, hd)).
        impl: 'auto' (the kernel on CUDA, the plain math on CPU) | 'plain'.

    Returns:
        (B, N, D) attention output (pre-proj).
    """
    B, N, threeD = qkv.shape
    D = threeD // 3
    parts = qkv.view(B, N, 3, num_heads, D // num_heads)
    q, k, v = (parts[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    if impl == "auto":
        out = attention(q, k, v)
    elif impl == "plain":
        out = attention_plain(q, k, v)
    else:
        raise ValueError(f"unknown attention impl: {impl}")
    return out.permute(0, 2, 1, 3).reshape(B, N, D)
