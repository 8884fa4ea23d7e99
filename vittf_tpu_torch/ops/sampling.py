"""Trilinear feature sampling at annotation coordinates.

Port of the 3D part of ``vittf_tpu/ops/sampling.py`` (reference
infer.py:48-72 ``sample_features3d``): ``F.grid_sample`` with
``align_corners=False`` and zero padding, which the JAX package
re-implements index for index.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from vittf_tpu_torch.utils.tensor import make_4d, make_5d


def sample_features3d(
    feat_vol: torch.Tensor, rel_coords: torch.Tensor, mode: str = "nearest"
) -> torch.Tensor:
    """Sample features at relative coords.

    Args:
        feat_vol:   ([M,] F, W, H, D)
        rel_coords: ([M,] C, A, 3) in [-1, 1], coordinate order (W, H, D),
                    flipped here to torch's (x → last dim) convention.

    Returns:
        (M, C, A, F)
    """
    feat_vol = make_5d(feat_vol)  # (M, F, W, H, D)
    if rel_coords.ndim in (2, 3):
        rel_coords = make_4d(rel_coords)  # (M, C, A, 3)
    if rel_coords.shape[0] != feat_vol.shape[0]:
        rel_coords = rel_coords.expand(feat_vol.shape[0], *rel_coords.shape[1:])
    grid = torch.flip(rel_coords, dims=(-1,))[:, :, :, None, :]  # (M, C, A, 1, 3)
    feats = F.grid_sample(
        feat_vol.float(), grid.float(), mode=mode, padding_mode="zeros",
        align_corners=False,
    )  # (M, F, C, A, 1)
    return feats[..., 0].permute(0, 2, 3, 1).to(feat_vol.dtype)


def rel_coords_from_abs(abs_coords: torch.Tensor, vol_shape) -> torch.Tensor:
    """Voxel indices → [-1, 1] relative coords (predict_ntf.py:56 parity)."""
    extent = torch.tensor(tuple(vol_shape), dtype=torch.float32, device=abs_coords.device)
    return (abs_coords.float() + 0.5) / extent * 2.0 - 1.0
