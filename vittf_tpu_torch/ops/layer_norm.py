"""The residual adds and LayerNorms of the per-op ViT block (K11): a
hand-written CUDA kernel on the GPU, plain PyTorch elsewhere.

A per-op block (``models/vit.py::Block``) normalizes its input (LN1), adds
the attention branch (times LayerScale's gamma in DINOv2) and normalizes
again (LN2), then adds the FFN branch. In PyTorch each LayerNorm is about
ten elementwise and reduction launches over the (M, D) residual stream, with
fp32 copies of it, and each residual two more. On bf16 CUDA tensors these
run as three launches of ``csrc/layer_norm.cu``, each reading its rows once
and writing them once: ``layer_norm`` (LN1, and the stop-after-capture and
final LayerNorms), ``residual_layer_norm`` (the attention residual and LN2)
and ``residual`` (the FFN residual). Elsewhere (CPU tensors, the fp32 parity
mode, ``impl='plain'``, which the trainable forward takes: the kernel has no
backward) the plain twins ``layer_norm_plain`` and ``residual_plain`` run. The
kernel rounds where the twins round; its fp32 sums take another order. The
JAX package has no such kernel: XLA fuses these passes there.
``layer_norm_plain`` is the package's one plain LayerNorm: the fused block's
twin (``ops/fused_block.py``) and the tensor- and pipeline-parallel forwards
(``parallel/``) take it too.
"""
from __future__ import annotations

import torch

from vittf_tpu_torch import kernels

_VEC = 8  # bf16 values in the kernel's 16-byte vector
MAX_DIM = 4096  # the widest row a warp holds in registers (16 vectors a lane)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis: the statistics in fp32, the normalized
    value rounded to x's dtype, then the scale and shift in that dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


def residual_plain(x: torch.Tensor, a: torch.Tensor, gamma: torch.Tensor | None = None):
    """x + a·gamma (LayerScale), or x + a without gamma, rounding after each."""
    if gamma is not None:
        a = a * gamma
    return x + a


def _plain(x: torch.Tensor, impl: str) -> bool:
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown layer_norm impl: {impl!r}")
    return impl == "plain" or x.device.type != "cuda" or x.dtype != torch.bfloat16


def layer_norm(x: torch.Tensor, ln, impl: str = "auto") -> torch.Tensor:
    """LayerNorm over the last axis with ``ln``'s weight, bias and eps: the
    kernel for a bf16 CUDA tensor under 'auto', ``layer_norm_plain`` otherwise."""
    if _plain(x, impl):
        return layer_norm_plain(x, ln.weight, ln.bias, ln.eps)
    return _launch(x, None, None, ln)[1]


def residual_layer_norm(x, a, gamma, ln, impl: str = "auto"):
    """(x', LN(x')) with x' = x + a·gamma (x + a where gamma is None)."""
    if _plain(x, impl):
        x = residual_plain(x, a, gamma)
        return x, layer_norm_plain(x, ln.weight, ln.bias, ln.eps)
    return _launch(x, a, gamma, ln)


def residual(x, a, gamma=None, impl: str = "auto") -> torch.Tensor:
    """x + a·gamma (x + a where gamma is None)."""
    if _plain(x, impl):
        return residual_plain(x, a, gamma)
    return _launch(x, a, gamma, None)[0]


def _launch(x, a, gamma, ln):
    """One launch of the kernel: (x' or None, y or None). Raises before any
    launch on a width the kernel does not take, mixed dtypes or devices, or
    tensors that are not contiguous and 16-byte aligned."""
    D = x.shape[-1]
    if D % _VEC or D > MAX_DIM:
        raise ValueError(f"layer_norm kernel needs a width in multiples of {_VEC} up to "
                         f"{MAX_DIM}, got {D}")
    w, b, eps = (ln.weight, ln.bias, ln.eps) if ln is not None else (None, None, 0.0)
    params = [t for t in (gamma, w, b) if t is not None]
    tensors = [x, *([a] if a is not None else []), *params]
    if any(t.dtype != x.dtype or t.device != x.device for t in tensors):
        raise ValueError("layer_norm kernel needs every tensor in one dtype on one device, got "
                         f"{[(t.dtype, str(t.device)) for t in tensors]}")
    if (a is not None and a.shape != x.shape) or any(p.shape != (D,) for p in params):
        raise ValueError(f"layer_norm kernel shapes: x {tuple(x.shape)}, branch "
                         f"{None if a is None else tuple(a.shape)}, "
                         f"parameters {[tuple(p.shape) for p in params]}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("layer_norm kernel needs contiguous, 16-byte aligned tensors")
    x_out = torch.empty_like(x) if a is not None else None
    y = torch.empty_like(x) if ln is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = kernels.load_library()
    with torch.cuda.device(x.device):
        code = lib.vittf_layer_norm(
            ptr(x), ptr(a), ptr(gamma), ptr(w), ptr(b), ptr(x_out), ptr(y), x.numel() // D, D,
            eps, torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(code, "vittf_layer_norm")
    layer_norm.launches += 1
    return x_out, y


layer_norm.launches = 0

