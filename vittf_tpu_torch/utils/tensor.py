"""Dimension-lifting and normalization helpers on torch tensors.

Port of ``vittf_tpu/utils/tensor.py`` (reference infer.py:10-40).
"""
from __future__ import annotations

import contextlib

import torch

# ImageNet normalization constants (reference: infer.py:39-40).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def make_nd(t: torch.Tensor, n: int) -> torch.Tensor:
    """Prepend singleton dimensions to ``t`` until it is ``n``-dimensional.

    Raises if ``t.ndim > n`` (reference infer.py:10-18).
    """
    if n < t.ndim:
        raise ValueError(
            f"make_nd cannot reduce cardinality: ndim={t.ndim} > n={n}"
        )
    return t.reshape((1,) * (n - t.ndim) + tuple(t.shape))


def make_3d(t: torch.Tensor) -> torch.Tensor:
    return make_nd(t, 3)


def make_4d(t: torch.Tensor) -> torch.Tensor:
    return make_nd(t, 4)


def make_5d(t: torch.Tensor) -> torch.Tensor:
    return make_nd(t, 5)


def norm_minmax(t: torch.Tensor) -> torch.Tensor:
    """Scale ``t`` into [0, 1] by its global min/max (infer.py:32-34)."""
    mi = t.min()
    ma = t.max()
    return (t - mi) / (ma - mi)


def norm_mean_std(t: torch.Tensor, mu: float = 0.0, std: float = 1.0) -> torch.Tensor:
    """Standardize to mean ``mu`` / std ``std`` in fp32 (infer.py:36-37), in
    the reference's order ``(x - mean(x)) * std / std(x) + mu`` with the
    sample std (``correction=1``) of the reference's ``Tensor.std``."""
    tf = t.float()
    return (tf - tf.mean()) * std / tf.std(correction=1) + mu


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """Channel-wise ImageNet normalization of ``(..., 3, H, W)`` images."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean.reshape(3, 1, 1)) / std.reshape(3, 1, 1)


def resolve_device(device) -> torch.device:
    """``device``, or the first CUDA device when it is None; never a silent
    fallback to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def place(x, device=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``. With no device given a tensor stays
    where it lies, and host data (a numpy array) goes to the first CUDA
    device or raises, as ``resolve_device`` does."""
    if torch.is_tensor(x) and device is None:
        return x
    return torch.as_tensor(x).to(resolve_device(device))


@contextlib.contextmanager
def ieee_matmul():
    """fp32 matrix products in IEEE fp32 (no TF32) inside the block."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
