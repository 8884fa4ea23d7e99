"""Fused per-voxel similarity maps: the interactive hot path.

Port of ``vittf_tpu/ops/similarity.py``:

    out[n, c] = Σ_a M[a, c] · g(feat[n, :] · q[a, :])        (mean-last)
    out[n, c] = g(Σ_a M[a, c] · feat[n, :] · q[a, :])        (mean-first)

with ``g(s) = where(s ≥ τ, s, 0) ** exponent`` and ``M`` holding 1/A_c in
class c's annotation rows. On CUDA tensors ``similarity`` launches
``csrc/similarity.cu``, which keeps the (N, ΣA) score matrix out of device
memory and sums without atomics (a launch equals its repeat); on CPU tensors
it runs ``similarity_plain`` (the ``similarity_xla`` math). Both are IEEE
fp32 throughout: no TF32. The kernel takes any N and A and any F that is a
multiple of 4 (it pads its tiles with zeros itself), and up to
``MAX_CLASSES`` classes.
"""
from __future__ import annotations

import numpy as np
import torch

from vittf_tpu_torch import kernels

DEFAULT_THRESHOLD = 0.25  # predict_ntf.py:71
DEFAULT_EXPONENT = 2.5  # predict_ntf.py:71
MAX_CLASSES = 32  # the kernel's accumulator holds at most this many classes


def _g(s, threshold, exponent):
    return torch.where(s >= threshold, s, torch.zeros_like(s)) ** exponent


def class_mean_matrix(counts: list[int], total_padded: int) -> np.ndarray:
    """(ΣA_padded, C) matrix averaging annotation columns per class.

    Classes with zero annotations get an all-zero column (their similarity
    map is zero rather than crashing).
    """
    C = len(counts)
    m = np.zeros((total_padded, C), dtype=np.float32)
    idx = 0
    for c, n in enumerate(counts):
        if n > 0:
            m[idx : idx + n, c] = 1.0 / n
        idx += n
    return m


def similarity_plain(
    feats: torch.Tensor,  # (N, F)
    queries: torch.Tensor,  # (A, F)
    class_mat: torch.Tensor,  # (A, C)
    threshold: float = DEFAULT_THRESHOLD,
    exponent: float = DEFAULT_EXPONENT,
    mean_first: bool = False,
    out_layout: str = "nc",
) -> torch.Tensor:
    """Plain PyTorch similarity; ``similarity_xla`` math."""
    s = feats.float() @ queries.float().T  # (N, A)
    m = class_mat.float()
    if mean_first:
        out = _g(s @ m, threshold, exponent)  # (N, C)
    else:
        out = _g(s, threshold, exponent) @ m
    return out.T if out_layout == "cn" else out


def similarity(
    feats: torch.Tensor,
    queries: torch.Tensor,
    class_mat: torch.Tensor,
    threshold: float = DEFAULT_THRESHOLD,
    exponent: float = DEFAULT_EXPONENT,
    mean_first: bool = False,
    out_layout: str = "nc",
) -> torch.Tensor:
    """Similarity maps, (N, C) or (C, N) fp32; the CUDA kernel for CUDA tensors."""
    if feats.device.type == "cpu":
        return similarity_plain(
            feats, queries, class_mat, threshold, exponent, mean_first, out_layout
        )
    if feats.device.type != "cuda":
        raise ValueError(f"similarity: unsupported device {feats.device}")
    N, F = feats.shape
    A, C = class_mat.shape
    if queries.shape != (A, F):
        raise ValueError(f"similarity: queries {tuple(queries.shape)} != ({A}, {F})")
    if not 1 <= C <= MAX_CLASSES:
        raise ValueError(f"similarity kernel supports 1..{MAX_CLASSES} classes, got {C}")
    if F % 4:
        raise ValueError(f"similarity kernel needs F % 4 == 0, got F={F}")
    for name, t in (("feats", feats), ("queries", queries), ("class_mat", class_mat)):
        if t.dtype != torch.float32:
            raise ValueError(f"similarity kernel takes fp32 {name}, got {t.dtype}")
        if t.device != feats.device:
            raise ValueError(f"similarity: {name} on {t.device}, feats on {feats.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"similarity kernel needs contiguous 16-byte aligned {name}")
    out = torch.empty((C, N), dtype=torch.float32, device=feats.device)
    lib = kernels.load_library()
    with torch.cuda.device(feats.device):
        code = lib.vittf_similarity(
            feats.data_ptr(), queries.data_ptr(), class_mat.data_ptr(),
            out.data_ptr(), N, F, A, C, float(threshold), float(exponent),
            int(bool(mean_first)),
            torch.cuda.current_stream(feats.device).cuda_stream,
        )
    kernels.check(code, "vittf_similarity")
    similarity.launches += 1
    return out.T if out_layout == "nc" else out


similarity.launches = 0


def fused_similarity_m(
    feats_flat: torch.Tensor,
    queries: torch.Tensor,
    class_mat: torch.Tensor,
    threshold: float = DEFAULT_THRESHOLD,
    exponent: float = DEFAULT_EXPONENT,
    mean_first: bool = False,
    impl: str = "auto",
    out_layout: str = "nc",
) -> torch.Tensor:
    """Similarity maps with an explicit (A, C) class-mean matrix.

    ``impl``: 'auto' (the kernel on CUDA, the plain math on CPU) | 'plain'.
    """
    if impl == "auto":
        fn = similarity
    elif impl == "plain":
        fn = similarity_plain
    else:
        raise ValueError(f"unknown similarity impl: {impl}")
    return fn(
        feats_flat, queries, class_mat, threshold, exponent, mean_first,
        out_layout=out_layout,
    )


def fused_similarity(
    feats_flat: torch.Tensor,
    queries: torch.Tensor,
    class_counts: list[int],
    threshold: float = DEFAULT_THRESHOLD,
    exponent: float = DEFAULT_EXPONENT,
    mean_first: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """(N, C) similarity for concatenated per-class queries (classes contiguous)."""
    m = torch.from_numpy(class_mean_matrix(class_counts, queries.shape[0]))
    return fused_similarity_m(
        feats_flat, queries, m.to(feats_flat.device), threshold, exponent,
        mean_first, impl,
    )
