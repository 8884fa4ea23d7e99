"""Overlapping 3D tiling (reference old/infer_sliding.py:187-209 —
``get_tile_locations``, left unfinished there; completed here).

Port of ``vittf_tpu/pipeline/tiling.py``. Tiles a volume into fixed-size
overlapping boxes whose grid is centered when the extent doesn't divide;
``stitch_tiles`` blends overlapping tile results back with uniform
averaging. Used to push volumes beyond device-memory capacity through the
extraction pipeline.
"""
from __future__ import annotations

import numpy as np
import torch


def get_tile_locations(
    shape: tuple[int, ...],
    tile_sz: tuple[int | None, ...],
    overlap: tuple[int, ...],
    dim: int = 3,
) -> np.ndarray:
    """(T, 2, dim) array of [start, end) boxes.

    Reference semantics: per axis, steps of ``tile - overlap`` from 0; the
    grid is shifted to center the coverage when the extent is not
    divisible; ``None`` tile size means "use the whole axis".
    """
    max_dims = tuple(shape[-dim:])
    axes_idx = []
    for tile, maxd, overl in zip(tile_sz, max_dims, overlap):
        if tile is None:
            idx = [0]
        else:
            end = maxd + 1 - tile if maxd > tile else 0
            step = tile - overl
            idx = list(range(0, end, step)) if end > step else [0]
            if idx and idx[-1] < end - 1:
                shift = (end - idx[-1]) // 2
                idx = [i + shift for i in idx]
        axes_idx.append(np.asarray(idx, np.int64))
    start = np.stack(
        np.meshgrid(*axes_idx, indexing="ij"), axis=-1
    ).reshape(-1, dim)
    start = np.unique(start, axis=0)
    eff_tile = np.asarray(
        [t if t is not None else m for t, m in zip(tile_sz, max_dims)],
        np.int64,
    )
    end = start + eff_tile
    return np.stack([start, end], axis=-2)  # (T, 2, dim)


def extract_tiles(vol: torch.Tensor, locations: np.ndarray) -> list[torch.Tensor]:
    """Cut the (W, H, D) volume into the located tiles."""
    return [
        vol[..., s[0]:e[0], s[1]:e[1], s[2]:e[2]] for s, e in locations
    ]


def stitch_tiles(
    tiles: list[torch.Tensor],
    locations: np.ndarray,
    out_shape: tuple[int, ...],
) -> torch.Tensor:
    """Average overlapping tiles back into a full volume.

    ``tiles[i]`` may have leading channel dims; trailing dims must equal
    the located box size.
    """
    lead = tuple(tiles[0].shape[:-3])
    device = tiles[0].device
    acc = torch.zeros(lead + tuple(out_shape), dtype=torch.float32, device=device)
    cnt = torch.zeros(tuple(out_shape), dtype=torch.float32, device=device)
    for t, (s, e) in zip(tiles, locations):
        acc[..., s[0]:e[0], s[1]:e[1], s[2]:e[2]] += t.float()
        cnt[s[0]:e[0], s[1]:e[1], s[2]:e[2]] += 1.0
    return acc / cnt.clamp_min(1.0)
