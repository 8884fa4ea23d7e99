"""Feature sampling at annotation coordinates.

Port of ``vittf_tpu/ops/sampling.py`` (reference infer.py:48-72
``sample_features3d``, old/cluster_dino.py:31-46 ``sample_features2d``):
``F.grid_sample`` with zero padding, which the JAX package re-implements
index for index (``grid_sample_3d`` / ``grid_sample_2d``).
"""
from __future__ import annotations

import functools

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
    feats = grid_sample_3d(feat_vol, grid, mode=mode)  # (M, F, C, A, 1)
    return feats[..., 0].permute(0, 2, 3, 1)


def grid_sample_3d(
    inp: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear", align_corners: bool = False
) -> torch.Tensor:
    """3D grid sample with zero padding.

    inp (N, C, D, H, W); grid (N, *out_dims, 3) with (x→W, y→H, z→D) coords
    in [-1, 1]; mode 'bilinear' (trilinear) or 'nearest'.
    Returns (N, C, *out_dims).
    """
    N, C = inp.shape[:2]
    out_dims = tuple(grid.shape[1:-1])
    points = grid.reshape(N, -1, 1, 1, 3).float()
    sampled = F.grid_sample(
        inp.float(), points, mode=mode, padding_mode="zeros", align_corners=align_corners
    )  # (N, C, P, 1, 1)
    return sampled.reshape(N, C, *out_dims).to(inp.dtype)


def grid_sample_2d(
    inp: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear", align_corners: bool = False
) -> torch.Tensor:
    """2D grid sample with zero padding.

    inp (N, C, H, W); grid (N, *out_dims, 2) with (x→W, y→H) coords.
    Returns (N, C, *out_dims).
    """
    N, C = inp.shape[:2]
    out_dims = tuple(grid.shape[1:-1])
    points = grid.reshape(N, -1, 1, 2).float()
    sampled = F.grid_sample(
        inp.float(), points, mode=mode, padding_mode="zeros", align_corners=align_corners
    )  # (N, C, P, 1)
    return sampled.reshape(N, C, *out_dims).to(inp.dtype)


def sample_features2d(
    feat_vol: torch.Tensor,
    abs_coords: torch.Tensor,
    rel_coords: torch.Tensor,
    mode: str = "nearest",
) -> torch.Tensor:
    """Slice-indexed 2D feature sampling (reference old/cluster_dino.py:31-46).

    The un-reduced axis D is indexed by the absolute z coordinate, then the
    (W, H) plane is grid-sampled at the relative coords.

    Args:
        feat_vol:   (1, F, W, H, D) or (F, W, H, D)
        abs_coords: (C, A, 3) integer voxel coords (z taken from [:, :, 2])
        rel_coords: (C, A, 3) relative coords

    Returns:
        (C, A, F)
    """
    feat_vol = make_5d(feat_vol)[0]  # (F, W, H, D)
    C_cls, A = abs_coords.shape[:2]
    z = abs_coords.reshape(-1, 3)[:, 2].long()
    slices = torch.movedim(feat_vol, -1, 0)[z]  # (C·A, F, W, H)
    # torch sees (N, C, H_in=W, W_in=H): grid x ← rel[1] (H), y ← rel[0] (W)
    grid = rel_coords.reshape(-1, 3)[:, None, None, [1, 0]]
    feats = grid_sample_2d(slices, grid, mode=mode)  # (C·A, F, 1, 1)
    return feats.reshape(C_cls, A, feat_vol.shape[0])


@functools.lru_cache(maxsize=16)
def _extent(vol_shape: tuple, device: torch.device) -> torch.Tensor:
    """``vol_shape`` as an fp32 tensor on ``device``, uploaded once per
    (shape, device); no caller writes it."""
    return torch.tensor(vol_shape, dtype=torch.float32, device=device)


def rel_coords_from_abs(abs_coords: torch.Tensor, vol_shape) -> torch.Tensor:
    """Voxel indices → [-1, 1] relative coords (predict_ntf.py:56 parity)."""
    extent = _extent(tuple(int(s) for s in vol_shape), abs_coords.device)
    return (abs_coords.float() + 0.5) / extent * 2.0 - 1.0
