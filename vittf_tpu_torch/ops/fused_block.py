"""One pre-LN ViT block (K3): a hand-written CUDA kernel on the GPU, plain
PyTorch on the CPU.

Port of ``vittf_tpu/ops/fused_block.py``. The block is LN1 → qkv →
exp2-domain softmax attention → proj → LayerScale + residual → LN2 → fc1 →
tanh-GELU → fc2 → LayerScale + residual, in bf16 speed-mode numerics. On
CUDA tensors ``fused_block`` launches ``csrc/fused_block.cu`` (five
hand-written launches, every product a warpgroup MMA on the tensor cores:
the linears on ``csrc/gemm_core.cuh`` with each LayerNorm taken once per
128-row block, or at D > 512 as a launch of K11's LN mode
(``csrc/layer_norm.cu``), the attention on K1's body
``csrc/attention_core.cuh``); on CPU tensors it runs ``fused_block_plain``,
per-op torch that rounds where the TPU kernel's body (``_row_block_body``)
rounds:

- q/k/v: fp32 accumulation plus bias, then cast; q carries
  (1/√hd)·log2(e), folded into Wq/bq in fp32 before the cast;
- scores in fp32, then ``exp2(s − m)``, or ``exp2(s)`` when
  ``softmax_max=False``;
- p cast to the compute dtype before PV; the denominator is the fp32 sum of
  that rounded p, held at ≥ 1e-38 (a row whose every p underflowed gives 0);
  output = numerator · (1/denominator), then cast;
- proj, fc1, fc2: fp32 accumulation, cast, then + bias (in the compute
  dtype); residuals add ``branch · gamma`` (ones without LayerScale);
- LayerNorms as ``ops.layer_norm.layer_norm_plain``: statistics in fp32.

The row max runs over the valid keys only (the TPU kernel's zero-score
padded keys would clamp it at ≥ 0; shift-invariance makes the two equal up
to rounding); the CUDA kernel carries it as the running max of an online
softmax, so its p is rounded against the max so far where the twin rounds
against the final one. The JAX package's two grid schedules (its ``impl``)
compute the same values, so this package has one kernel and no ``impl``.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, fields

import torch
import torch.nn.functional as F

from vittf_tpu_torch import kernels
from vittf_tpu_torch.ops.layer_norm import layer_norm_plain

_LOG2E = math.log2(math.e)
MAX_DIM = 2048  # the widest D the kernel takes (csrc/fused_block.cu); K11 rows reach 4096
_KERNEL_HEAD_DIM = 64
ALL_LAUNCHES = 31  # the kernel's five launches as a bit mask, (a) LN1+qkv = 1 .. (e) fc2 = 16


@dataclass(frozen=True)
class FusedBlockWeights:
    """One block's weights as the kernel reads them, in the compute dtype.

    Linear weights keep torch's (out, in) layout. The q third of ``wqkv``
    and ``bqkv`` carries the attention scale and log2(e); ``ls1``/``ls2``
    are ones for a block without LayerScale.
    """

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wproj: torch.Tensor
    bproj: torch.Tensor
    ls1: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    wfc1: torch.Tensor
    bfc1: torch.Tensor
    wfc2: torch.Tensor
    bfc2: torch.Tensor
    ls2: torch.Tensor

    def tensors(self) -> list[torch.Tensor]:
        return [getattr(self, f.name) for f in fields(self)]


def _prepare(blk, num_heads: int, dtype: torch.dtype) -> FusedBlockWeights:
    """``blk``: a ``models.vit.Block`` or its hub-named tensors
    (``norm1.weight``, ``attn.qkv.weight``, ..., ``ls1.gamma``)."""
    t = blk if isinstance(blk, dict) else dict(blk.named_parameters())
    if "mlp.w12.weight" in t:
        raise ValueError("fused_block computes a GELU MLP (fc1, fc2); a SwiGLU block "
                         "(w12, w3) runs per-op: block_impl='xla'")
    D = t["attn.qkv.weight"].shape[1]
    qscale = torch.tensor((D // num_heads) ** -0.5 * _LOG2E, dtype=torch.float32)
    wqkv = t["attn.qkv.weight"].float().clone()
    bqkv = t["attn.qkv.bias"].float().clone()
    wqkv[:D] *= qscale.to(wqkv.device)
    bqkv[:D] *= qscale.to(bqkv.device)
    ones = torch.ones(D, device=wqkv.device)
    cast = lambda a: a.to(dtype).contiguous()  # noqa: E731
    return FusedBlockWeights(
        ln1_w=cast(t["norm1.weight"]), ln1_b=cast(t["norm1.bias"]),
        wqkv=cast(wqkv), bqkv=cast(bqkv),
        wproj=cast(t["attn.proj.weight"]), bproj=cast(t["attn.proj.bias"]),
        ls1=cast(t.get("ls1.gamma", ones)),
        ln2_w=cast(t["norm2.weight"]), ln2_b=cast(t["norm2.bias"]),
        wfc1=cast(t["mlp.fc1.weight"]), bfc1=cast(t["mlp.fc1.bias"]),
        wfc2=cast(t["mlp.fc2.weight"]), bfc2=cast(t["mlp.fc2.bias"]),
        ls2=cast(t.get("ls2.gamma", ones)),
    )


def _block_weights(blk, num_heads: int, dtype: torch.dtype) -> FusedBlockWeights:
    """Prepared weights, made once per block: a module keeps them until its
    parameters move or change; hub-named tensors are prepared per call."""
    if not isinstance(blk, torch.nn.Module):
        return _prepare(blk, num_heads, dtype)
    key = (num_heads, dtype, tuple((p.data_ptr(), p._version) for p in blk.parameters()))
    cached = blk.__dict__.get("_fused_weights")
    if cached is None or cached[0] != key:
        cached = (key, _prepare(blk, num_heads, dtype))
        blk.__dict__["_fused_weights"] = cached
    return cached[1]


def _check_args(x, num_heads, n_valid):
    B, N, D = x.shape
    hd = D // num_heads
    if hd >= 128:
        # the TPU kernel's expanded-V layout gives each head a 128-lane
        # stripe; the guard is kept so both packages refuse the same shapes
        raise ValueError(
            f"fused_block requires head_dim < 128 (got {hd}); use block_impl='xla'"
        )
    nv = N if n_valid is None else n_valid
    if not 0 < nv <= N:
        raise ValueError(f"n_valid={n_valid} outside (0, {N}]")
    return nv


def _mm(a, w):
    """a · wᵀ with fp32 accumulation (products of bf16 values are exact in
    fp32)."""
    return torch.matmul(a.float(), w.float().t())


def fused_block_plain(
    x: torch.Tensor,
    blk,
    num_heads: int,
    n_valid: int | None = None,
    softmax_max: bool = True,
) -> torch.Tensor:
    """The kernel's math in per-op torch, at the kernel's rounding points.
    Keys at or after ``n_valid`` are left out of every softmax."""
    nv = _check_args(x, num_heads, n_valid)
    w = _block_weights(blk, num_heads, x.dtype)
    B, N, D = x.shape
    dt = x.dtype
    qkv = (_mm(layer_norm_plain(x, w.ln1_w, w.ln1_b), w.wqkv) + w.bqkv.float()).to(dt)
    q, k, v = qkv.view(B, N, 3, num_heads, D // num_heads).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float(), k[:, :, :nv].float().transpose(-1, -2))  # exp2 domain
    p = torch.exp2(s - s.amax(-1, keepdim=True) if softmax_max else s).to(dt)
    denom = p.float().sum(-1, keepdim=True).clamp_min(1e-38)
    o = (torch.matmul(p.float(), v[:, :, :nv].float()) * denom.reciprocal()).to(dt)
    a = _mm(o.permute(0, 2, 1, 3).reshape(B, N, D), w.wproj).to(dt) + w.bproj
    x2 = x + a * w.ls1
    mid = _mm(layer_norm_plain(x2, w.ln2_w, w.ln2_b), w.wfc1).to(dt) + w.bfc1
    mid = F.gelu(mid, approximate="tanh")
    return x2 + (_mm(mid, w.wfc2).to(dt) + w.bfc2) * w.ls2


def fused_block(
    x: torch.Tensor,
    blk,
    num_heads: int,
    n_valid: int | None = None,
    softmax_max: bool = True,
) -> torch.Tensor:
    """Apply one transformer block to (B, N, D) tokens; the CUDA kernel for
    CUDA tensors (bf16, head dim 64), ``fused_block_plain`` for CPU ones.

    ``blk`` is a ``models.vit.Block`` or its hub-named tensors. LayerScale
    gammas apply when present.
    """
    nv = _check_args(x, num_heads, n_valid)
    if x.device.type == "cpu":
        return fused_block_plain(x, blk, num_heads, n_valid, softmax_max)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block: unsupported device {x.device}")
    w = _block_weights(blk, num_heads, x.dtype)
    check_kernel_shapes(x.shape[-1], w.wfc1.shape[0], num_heads, x.dtype)
    for t in w.tensors():
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_block: weights must be contiguous, 16-byte aligned bf16 "
                             "on the input's device")
    x = x.contiguous()
    bufs = kernel_buffers(x, w)
    launch_kernel(x, w, bufs, nv, num_heads, softmax_max)
    fused_block.launches += 1
    return bufs[-1]


def check_kernel_shapes(D: int, Hd: int, num_heads: int, dtype: torch.dtype) -> None:
    """Raise on what the CUDA kernel does not take: bf16, head dim 64, D and
    the MLP width ``Hd`` in multiples of 128 (the column tiles are 192 or 128
    wide, a K chunk 64), D at most 2048 (above 512 its LayerNorms are
    launches of ``csrc/layer_norm.cu``)."""
    if D % num_heads or D // num_heads != _KERNEL_HEAD_DIM:
        raise ValueError(f"fused_block kernel supports head dim 64, got {D / num_heads}")
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_block kernel takes bf16, got {dtype}")
    if D % 128 or Hd % 128:
        raise ValueError(f"fused_block kernel needs D and the MLP width in multiples of 128, "
                         f"got {D}, {Hd}")
    if D > MAX_DIM:
        raise ValueError(f"fused_block kernel takes D up to {MAX_DIM}, got {D}")


def kernel_buffers(x: torch.Tensor, w: FusedBlockWeights) -> list[torch.Tensor]:
    """The kernel's scratch and output for tokens ``x``: qkv, attention
    output, x + attention branch, MLP activation, out."""
    B, N, D = x.shape
    wide = lambda n: torch.empty((B, N, n), dtype=x.dtype, device=x.device)  # noqa: E731
    return [wide(3 * D), wide(D), wide(D), wide(w.wfc1.shape[0]), wide(D)]


def launch_kernel(x, w: FusedBlockWeights, bufs, n_valid: int, num_heads: int,
                  softmax_max: bool, launches: int = ALL_LAUNCHES) -> None:
    """The launches of ``csrc/fused_block.cu`` named by the mask ``launches``
    on checked, contiguous arguments. A single launch reads what the launches
    before it left in ``bufs``; timing one alone is what the mask is for."""
    B, N, D = x.shape
    ptrs = [x, *w.tensors(), *bufs]
    arr = (ctypes.c_void_p * len(ptrs))(*(t.data_ptr() for t in ptrs))
    lib = kernels.load_library()
    with torch.cuda.device(x.device):
        code = lib.vittf_fused_block(
            ctypes.addressof(arr), B, N, n_valid, D, num_heads, w.wfc1.shape[0],
            int(softmax_max), launches, torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(code, "vittf_fused_block")


fused_block.launches = 0
