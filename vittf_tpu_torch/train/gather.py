"""Semi-sparse receptive-field gather (reference old/semisparseconv.py).

Port of ``vittf_tpu/train/gather.py``: k³ crops around sampled voxel centers
in one vectorized gather, so only annotated voxels are convolved.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gather_receptive_fields(volume: torch.Tensor, centers: torch.Tensor,
                            ks: int = 3) -> torch.Tensor:
    """(C, Z, Y, X) volume + (N, 3) centers → (N, C, ks, ks, ks) crops.

    Zero padding of ks//2 per side; crop n is centered on ``centers[n]``
    (reference gather_receiptive_fields2 semantics, old/semisparseconv.py:14-22).
    """
    L = ks // 2
    pad = F.pad(volume, (L, L) * 3)
    offs = np.stack(np.meshgrid(*([np.arange(ks)] * 3), indexing="ij"), -1).reshape(-1, 3)
    idx = centers.long()[:, None, :] + torch.from_numpy(offs).to(centers.device)[None]
    vals = pad[:, idx[..., 0], idx[..., 1], idx[..., 2]]  # (C, N, k³)
    return vals.movedim(1, 0).reshape(centers.shape[0], volume.shape[0], ks, ks, ks)


def upscale_indices(indices: torch.Tensor, factor: int) -> torch.Tensor:
    """Map low-res voxel indices to high-res (reference old/utils.py:44-57's
    index upscale for low-res annotation volumes): center of the factor³ cell."""
    return indices * factor + factor // 2
