"""Binary erosion with scipy-compatible structuring elements.

Port of the erosion part of ``vittf_tpu/ops/morphology.py``, used by the
surface annotation sampler (reference compare_feat_sampling.py:19-30).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
