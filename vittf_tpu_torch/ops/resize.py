"""Resize / pooling ops with exact PyTorch index-arithmetic parity.

Port of ``vittf_tpu/ops/resize.py``. The weight matrices are the same numpy
constructions (the reference's ``F.interpolate`` / ``AdaptiveAvgPool3d``
index rules); they are applied per axis as fp32 tensordots, each matrix
uploaded once per shape and device and kept (``_axis_weights``). Nearest resize
indexes explicitly (strided slice, repeat or gather), so integer volumes
such as uint8 similarity maps resize exactly on every device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    # torch 'nearest' (not nearest-exact): src = floor(i * in/out), clamped.
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size) * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def _linear_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix for 1D linear resample, align_corners=False.

    torch rule: src = (i + 0.5) * in/out - 0.5, clamped at 0 below;
    neighbors floor(src)/floor(src)+1 clamped into range.
    """
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    src = np.maximum(src, 0.0)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.minimum(i0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = src - np.floor(src)
    w1 = np.where(i1 == i0, 0.0, w1)
    w = np.zeros((out_size, in_size))
    np.add.at(w, (np.arange(out_size), i0), 1.0 - w1)
    np.add.at(w, (np.arange(out_size), i1), w1)
    return w


def _cubic_kernel(t: np.ndarray, A: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel; torch uses A=-0.75 (not Keys' -0.5)."""
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        ((A + 2.0) * t - (A + 3.0)) * t * t + 1.0,
        np.where(t < 2.0, (((t - 5.0) * t + 8.0) * t - 4.0) * A, 0.0),
    )


def _cubic_weight_matrix(
    in_size: int, out_size: int, coord_scale: float | None = None
) -> np.ndarray:
    """(out, in) matrix for 1D bicubic resample, align_corners=False.

    torch rule: src = (i + 0.5) * coord_scale - 0.5, 4 taps at
    floor(src) + {-1, 0, 1, 2}, indices clamped to the border.
    ``coord_scale`` defaults to in/out; DINO's pos-embed path passes the
    reciprocal of its ``scale_factor`` explicitly.
    """
    scale = in_size / out_size if coord_scale is None else coord_scale
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    w = np.zeros((out_size, in_size))
    rows = np.arange(out_size)
    for offset in (-1, 0, 1, 2):
        idx = np.clip(i0 + offset, 0, in_size - 1)
        np.add.at(w, (rows, idx), _cubic_kernel(offset - t))
    return w


def _adaptive_avg_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix for 1D adaptive average pooling.

    torch rule: window [floor(i*in/out), ceil((i+1)*in/out)), uniform weights.
    """
    starts = np.floor(np.arange(out_size) * in_size / out_size).astype(np.int64)
    ends = np.ceil((np.arange(out_size) + 1) * in_size / out_size).astype(np.int64)
    w = np.zeros((out_size, in_size))
    for i, (s, e) in enumerate(zip(starts, ends)):
        w[i, s:e] = 1.0 / (e - s)
    return w


_MATRICES = {
    "linear": _linear_weight_matrix,
    "cubic": _cubic_weight_matrix,
    "adaptive_avg": _adaptive_avg_weight_matrix,
}


@functools.lru_cache(maxsize=64)
def _axis_weights(kind: str, in_size: int, out_size: int, coord_scale: float | None,
                  dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The (out, in) weight matrix of ``kind`` on ``device`` in ``dtype``:
    built by numpy and uploaded once per (kind, sizes, scale, dtype,
    device), a per-shape constant that no caller writes."""
    args = (in_size, out_size) if coord_scale is None else (in_size, out_size, coord_scale)
    return torch.as_tensor(_MATRICES[kind](*args), dtype=dtype, device=device)


def _apply_axis_matrix(x: torch.Tensor, kind: str, out_size: int, axis: int,
                       coord_scale: float | None = None) -> torch.Tensor:
    wdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    wt = _axis_weights(kind, x.shape[axis], out_size, coord_scale, wdt, x.device)
    moved = torch.tensordot(wt, x.to(wdt), dims=([1], [axis]))
    return torch.movedim(moved, 0, axis).to(x.dtype)


def _spatial_axes(ndim: int, n_spatial: int) -> list[int]:
    return list(range(ndim - n_spatial, ndim))


def resize_nearest(x: torch.Tensor, size: tuple[int, ...]) -> torch.Tensor:
    """Nearest resize of the trailing ``len(size)`` axes, torch parity."""
    for axis, out_size in zip(_spatial_axes(x.ndim, len(size)), size):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        if in_size % out_size == 0:
            # integer downsample ratio r: floor(i·r) = i·r, a strided slice
            r = in_size // out_size
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(0, (out_size - 1) * r + 1, r)
            x = x[tuple(sl)]
        elif out_size % in_size == 0:
            # integer upsample ratio k: floor(i·in/out) = i // k, a repeat
            x = torch.repeat_interleave(x, out_size // in_size, dim=axis)
        else:
            idx = torch.from_numpy(_nearest_indices(in_size, out_size))
            x = torch.index_select(x, axis, idx.to(x.device))
    return x


def resize_linear(x: torch.Tensor, size: tuple[int, ...]) -> torch.Tensor:
    """(Bi/tri)linear resize of the trailing axes, align_corners=False, torch
    parity. Integer tensors are resized in fp32 and cast back, as the JAX
    twin does."""
    for axis, out_size in zip(_spatial_axes(x.ndim, len(size)), size):
        if x.shape[axis] != out_size:
            x = _apply_axis_matrix(x, "linear", out_size, axis)
    return x


def resize_cubic(x: torch.Tensor, size: tuple[int, ...]) -> torch.Tensor:
    """Bicubic resize of the trailing axes, align_corners=False, torch parity
    (A=-0.75)."""
    for axis, out_size in zip(_spatial_axes(x.ndim, len(size)), size):
        if x.shape[axis] != out_size:
            x = _apply_axis_matrix(x, "cubic", out_size, axis)
    return x


def resize_cubic_scaled(
    x: torch.Tensor, size: tuple[int, ...], coord_scales: tuple[float, ...]
) -> torch.Tensor:
    """Bicubic resize with explicit coordinate scales (torch ``scale_factor=``
    semantics). DINO pos-embed parity: coord_scale = M / (w0 + 0.1)."""
    for axis, out_size, cs in zip(
        _spatial_axes(x.ndim, len(size)), size, coord_scales
    ):
        x = _apply_axis_matrix(x, "cubic", out_size, axis, cs)
    return x


def adaptive_avg_pool(x: torch.Tensor, size: tuple[int, ...]) -> torch.Tensor:
    """Adaptive average pooling over trailing axes, torch parity."""
    for axis, out_size in zip(_spatial_axes(x.ndim, len(size)), size):
        if x.shape[axis] != out_size:
            x = _apply_axis_matrix(x, "adaptive_avg", out_size, axis)
    return x
