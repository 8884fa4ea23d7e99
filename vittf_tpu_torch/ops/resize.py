"""Resize / pooling ops with exact PyTorch index-arithmetic parity.

Port of ``vittf_tpu/ops/resize.py``. The weight matrices are the same numpy
constructions (the reference's ``F.interpolate`` / ``AdaptiveAvgPool3d``
index rules); they are applied per axis as fp32 tensordots. Nearest resize
indexes explicitly (strided slice, repeat or gather), so integer volumes
such as uint8 similarity maps resize exactly on every device.
"""
from __future__ import annotations

import numpy as np
import torch


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    # torch 'nearest' (not nearest-exact): src = floor(i * in/out), clamped.
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size) * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1)


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


def _apply_axis_matrix(x: torch.Tensor, w: np.ndarray, axis: int) -> torch.Tensor:
    wdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    wt = torch.as_tensor(w, dtype=wdt, device=x.device)
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


def resize_cubic_scaled(
    x: torch.Tensor, size: tuple[int, ...], coord_scales: tuple[float, ...]
) -> torch.Tensor:
    """Bicubic resize with explicit coordinate scales (torch ``scale_factor=``
    semantics). DINO pos-embed parity: coord_scale = M / (w0 + 0.1)."""
    for axis, out_size, cs in zip(
        _spatial_axes(x.ndim, len(size)), size, coord_scales
    ):
        in_size = x.shape[axis]
        x = _apply_axis_matrix(x, _cubic_weight_matrix(in_size, out_size, cs), axis)
    return x


def adaptive_avg_pool(x: torch.Tensor, size: tuple[int, ...]) -> torch.Tensor:
    """Adaptive average pooling over trailing axes, torch parity."""
    for axis, out_size in zip(_spatial_axes(x.ndim, len(size)), size):
        in_size = x.shape[axis]
        if in_size != out_size:
            x = _apply_axis_matrix(
                x, _adaptive_avg_weight_matrix(in_size, out_size), axis
            )
    return x
