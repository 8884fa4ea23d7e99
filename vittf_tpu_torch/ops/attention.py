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

DINOv3 (head dim 128, no position table) rotates the patch rows of q and k
by an axial RoPE in every block (``Rope``). On bf16 CUDA tensors that is
K1's RoPE mode (``csrc/rope_attention.cu``, one launch of a warp-specialised
kernel: a TMA producer rotates the tiles in fp32 in shared memory as they
land, no rotated copy of q and k in device memory), which refuses other
CUDA tensors; on CPU tensors and for ``impl='plain'``, ``rope_plain``
then ``attention_plain``. The JAX package has neither: its ViT has a learned
position table and head dim 64.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from vittf_tpu_torch import kernels

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROPE_HEAD_DIM = 128  # the head dim of K1's RoPE mode


@dataclass(frozen=True)
class Rope:
    """DINOv3's axial RoPE over one token grid: ``table`` (2, h + w, hd/4)
    fp32, cos then sin, its rows the angles of grid row 0..h−1 and then of
    grid column 0..w−1 (``models/vit.py::rope_table``); ``grid`` (h, w);
    ``prefix`` tokens (CLS, registers) ahead of the h·w patches, left as
    they are. Patch p (row ``prefix + p``) sits at grid row p // w, column
    p % w; dims d and d + hd/2 share an angle, of which the first hd/4 are
    its grid row's and the next hd/4 its column's."""
    table: torch.Tensor
    grid: tuple
    prefix: int


def rope_plain(x: torch.Tensor, rope: Rope) -> torch.Tensor:
    """x' = x·cos + rotate_half(x)·sin over the patch rows of (..., N, hd)
    ``x``, rotate_half([x1 | x2]) = [−x2 | x1], in fp32 and cast back to
    x's dtype (dinov3 ``rope_apply`` as ``SelfAttention.apply_rope`` calls
    it); the prefix rows are returned as they are."""
    h, w = rope.grid
    p = torch.arange(x.shape[-2] - rope.prefix, device=x.device)
    t = rope.table.to(x.device)
    cos, sin = (torch.cat([t[i, p // w], t[i, h + p % w]], -1).repeat(1, 2) for i in (0, 1))
    xf = x[..., rope.prefix:, :].float()
    x1, x2 = xf.chunk(2, dim=-1)
    rotated = xf * cos + torch.cat([-x2, x1], dim=-1) * sin
    return torch.cat([x[..., :rope.prefix, :], rotated.to(x.dtype)], dim=-2)


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


def rope_attention_plain(q, k, v, rope: Rope | None):
    """``attention_plain`` of q and k rotated by ``rope`` (none: as they are)."""
    if rope is not None:
        q, k = rope_plain(q, rope), rope_plain(k, rope)
    return attention_plain(q, k, v)


def _checked_strides(q, k, v, out):
    """The kernel's twelve element strides of q, k, v and the (B, H, N, hd)
    view of ``out``; raises where the kernel cannot read the inputs."""
    vec = 16 // q.element_size()  # the kernel reads 16-byte vectors
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError("attention: q, k, v on different devices")
        if t.stride(-1) != 1:
            raise ValueError("attention kernel needs a contiguous head dim")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError("attention kernel needs 16-byte aligned rows")
    o = out.permute(0, 2, 1, 3)
    return o, (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]
    )


def attention(q, k, v, rope: Rope | None = None):
    """(B, H, N, hd) attention; the CUDA kernel for CUDA tensors.

    q/k/v may be strided views (e.g. of the fused qkv buffer) as long as the
    head dim is contiguous. Returns a (B, H, N, hd) view of a (B, N, H, hd)
    contiguous buffer, so merging heads afterwards is free. ``rope``: q's
    and k's patch rows rotated first (K1's RoPE mode, bf16 at head dim 128
    only; the plain twins on CPU tensors).
    """
    if q.device.type == "cpu":
        return rope_attention_plain(q, k, v, rope)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    B, H, N, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: shapes differ {q.shape} {k.shape} {v.shape}")
    if rope is not None:
        return _rope_attention(q, k, v, rope)
    if hd != 64:
        raise ValueError(f"attention kernel supports head dim 64 (128 with RoPE), got {hd}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel takes fp32 or bf16, got {q.dtype}")
    out = torch.empty((B, N, H, hd), dtype=q.dtype, device=q.device)
    o, strides = _checked_strides(q, k, v, out)
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
attention.rope_launches = 0  # of them K1's RoPE mode


def _rope_attention(q, k, v, rope: Rope):
    """``attention`` with RoPE on CUDA tensors: K1's RoPE mode, which takes
    bf16 at head dim 128 and refuses anything else."""
    B, H, N, hd = q.shape
    h, w = rope.grid
    if hd != ROPE_HEAD_DIM:
        raise ValueError(f"the RoPE attention kernel takes head dim {ROPE_HEAD_DIM}, got {hd}")
    if rope.prefix < 0 or rope.prefix + h * w != N:
        raise ValueError(f"RoPE over a {h} x {w} grid after {rope.prefix} prefix tokens "
                         f"does not cover {N} tokens")
    t = rope.table
    if (t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous()
            or tuple(t.shape) != (2, h + w, hd // 4) or t.data_ptr() % 16):
        raise ValueError(f"RoPE table: need contiguous, 16-byte aligned fp32 (2, {h + w}, "
                         f"{hd // 4}) on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise ValueError(f"the RoPE attention kernel takes bf16, got {q.dtype} "
                         f"(impl='plain' runs the plain twins)")
    out = torch.empty((B, N, H, hd), dtype=q.dtype, device=q.device)
    o, strides = _checked_strides(q, k, v, out)
    lib = kernels.load_library()
    with torch.cuda.device(q.device):
        code = lib.vittf_rope_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N,
            ctypes.addressof(strides), hd ** -0.5 * math.log2(math.e), t.data_ptr(),
            rope.prefix, h, w, torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check(code, "vittf_rope_attention_fwd")
    attention.launches += 1
    attention.rope_launches += 1
    return o


def multi_head_attention(
    qkv: torch.Tensor,
    num_heads: int,
    impl: str = "auto",
    rope: Rope | None = None,
) -> torch.Tensor:
    """Self-attention over a fused qkv projection.

    Args:
        qkv: (B, N, 3D), the qkv linear output (DINO layout: viewed as
            (B, N, 3, heads, hd)).
        impl: 'auto' (the kernel on CUDA, the plain math on CPU) | 'plain'.
        rope: the patch rows of q and k rotated first (DINOv3), or None.

    Returns:
        (B, N, D) attention output (pre-proj).
    """
    B, N, threeD = qkv.shape
    D = threeD // 3
    parts = qkv.view(B, N, 3, num_heads, D // num_heads)
    q, k, v = (parts[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    if impl == "auto":
        out = attention(q, k, v, rope)
    elif impl == "plain":
        out = rope_attention_plain(q, k, v, rope)
    else:
        raise ValueError(f"unknown attention impl: {impl}")
    return out.permute(0, 2, 1, 3).reshape(B, N, D)
