"""Polygon annotation rasterization.

The reference's only in-repo interactivity is a Jupyter polygon annotator
(notebooks/annotate.ipynb: draw per-class polygons on a slice, which become
voxel annotations). This is the headless equivalent: rasterize polygon
vertices drawn on an axis-aligned slice into the ``{class: (N, 3)}``
annotation contract.
"""
from __future__ import annotations

import numpy as np


def rasterize_polygon(vertices: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """(V, 2) polygon vertices (row, col) → (H, W) bool mask (even-odd rule)."""
    vertices = np.asarray(vertices, np.float64)
    H, W = shape
    rr, cc = np.mgrid[0:H, 0:W]
    px = rr.reshape(-1) + 0.5
    py = cc.reshape(-1) + 0.5
    inside = np.zeros(px.shape[0], bool)
    n = len(vertices)
    for i in range(n):
        r1, c1 = vertices[i]
        r2, c2 = vertices[(i + 1) % n]
        crosses = (c1 > py) != (c2 > py)
        with np.errstate(divide="ignore", invalid="ignore"):
            x_int = r1 + (py - c1) / (c2 - c1) * (r2 - r1)
        inside ^= crosses & (px < x_int)
    return inside.reshape(H, W)


def polygon_to_annotations(
    polygons: dict[str, list[np.ndarray]],
    slice_index: int,
    axis: int,
    vol_shape: tuple[int, int, int],
) -> dict[str, np.ndarray]:
    """Per-class slice polygons → ``{class: (N, 3) voxel coords}``.

    Args:
        polygons: {class: [(V, 2) vertex arrays in slice coordinates]}
        slice_index: position of the annotated slice along ``axis``
        axis: 0/1/2, the volume axis the slice is perpendicular to
    """
    plane_dims = [d for d in range(3) if d != axis]
    plane_shape = (vol_shape[plane_dims[0]], vol_shape[plane_dims[1]])
    out = {}
    for name, polys in polygons.items():
        mask = np.zeros(plane_shape, bool)
        for poly in polys:
            mask |= rasterize_polygon(poly, plane_shape)
        ij = np.argwhere(mask)
        coords = np.zeros((ij.shape[0], 3), np.int64)
        coords[:, axis] = slice_index
        coords[:, plane_dims[0]] = ij[:, 0]
        coords[:, plane_dims[1]] = ij[:, 1]
        out[name] = coords
    return out
