"""Binary erosion and small separable filters.

Port of ``vittf_tpu/ops/morphology.py`` without ``binary_fill_holes``:
- binary erosion with scipy-compatible structuring elements, used by the
  surface annotation sampler (reference compare_feat_sampling.py:19-30);
- separable Sobel magnitude / Gaussian blur (bilateral_solver3d.py:169-181),
  the bilateral refinement's confidence map.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vittf_tpu_torch.utils.tensor import make_5d


def _conv1d_axis(x5: torch.Tensor, win: list[float], axis: int) -> torch.Tensor:
    """Depthwise 1D filter along a spatial axis of (N, C, D, H, W), SAME zero
    pad: the reference's padded ``F.conv3d`` with a small separable kernel,
    written as padded shifted multiply-adds in fp32 (the JAX twin's form)."""
    r = len(win) // 2
    pad = [0] * 6
    pad[2 * (4 - axis)] = pad[2 * (4 - axis) + 1] = r  # F.pad lists the last axis first
    xp = F.pad(x5, pad)
    S = x5.shape[axis]
    out = None
    for i, w in enumerate(win):
        if w == 0:
            continue
        term = xp.narrow(axis, i, S) * w
        out = term if out is None else out + term
    return out


def filter_sobel_separated(x: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude via [-0.5, 0, 0.5] central differences per axis
    (reference bilateral_solver3d.py:176-181). Input (N, C, D, H, W)."""
    x5 = make_5d(x)
    win = [-0.5, 0.0, 0.5]
    out = _conv1d_axis(x5, win, 4) ** 2
    out = out + _conv1d_axis(x5, win, 3) ** 2
    out = out + _conv1d_axis(x5, win, 2) ** 2
    return torch.sqrt(out)


def filter_gauss_separated(x: torch.Tensor) -> torch.Tensor:
    """[0.25, 0.5, 0.25] separable blur (reference :169-174)."""
    x5 = make_5d(x)
    win = [0.25, 0.5, 0.25]
    out = _conv1d_axis(x5, win, 4)
    out = _conv1d_axis(out, win, 3)
    return _conv1d_axis(out, win, 2)


def generate_binary_structure(rank: int = 3, connectivity: int = 1) -> np.ndarray:
    """scipy-compatible 3^rank structuring element (sum |offset| ≤ connectivity)."""
    grid = np.indices((3,) * rank) - 1
    return np.abs(grid).sum(axis=0) <= connectivity


def binary_erosion(mask: torch.Tensor, structure: np.ndarray | None = None) -> torch.Tensor:
    """scipy.ndimage.binary_erosion parity (border_value=0).

    A voxel survives iff every 1-cell of the structuring element lies on a
    true voxel; outside the volume counts as false. Counted with one padded
    shifted add per cell (exact integer counts).
    """
    if structure is None:
        structure = generate_binary_structure(mask.ndim, 1)
    structure = np.asarray(structure).astype(bool)
    radii = [s // 2 for s in structure.shape]
    offsets = [
        [int(c) - r for c, r in zip(cell, radii)] for cell in np.argwhere(structure)
    ]
    pad = []
    for r in reversed(radii):  # F.pad lists the last axis first
        pad += [r, r]
    padded = F.pad(mask.to(torch.int32), pad)  # zeros == border_value=0
    counts = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    for off in offsets:
        idx = tuple(slice(r + o, r + o + s) for r, o, s in zip(radii, off, mask.shape))
        counts += padded[idx]
    return counts == len(offsets)
