"""Axis-wise feature-volume merge + comparison tools
(reference old/merge_features.py, old/compare_feat_maps.py).

Port of ``vittf_tpu/pipeline/merge.py``. ``merge_axis_features`` pools
per-axis feature volumes to their common minimum grid with adaptive average
pooling and averages them; the extraction pipeline does this fused
(pipeline.features), but the tool is kept for merging cached artifacts from
separate per-axis runs (sub/infer_and_merge.sh flow).
"""
from __future__ import annotations

import numpy as np
import torch

from vittf_tpu_torch.ops.resize import adaptive_avg_pool
from vittf_tpu_torch.utils.tensor import place


def merge_axis_features(feature_volumes: list, device=None) -> torch.Tensor:
    """Average per-axis (F, W, H, D) feature volumes on the min common grid.

    Tensors are merged where they lie unless ``device`` is given; numpy
    arrays go to ``device``, the first CUDA device when None (pass
    ``device='cpu'`` to run on the CPU)."""
    vols = [place(v, device) for v in feature_volumes]
    min_shape = tuple(min(v.shape[1 + i] for v in vols) for i in range(3))
    pooled = [adaptive_avg_pool(v, min_shape) for v in vols]
    return sum(pooled) / len(pooled)


def cross_axis_cosine(
    feats_a, feats_b, num_bins: int = 50, device=None
) -> tuple[np.ndarray, np.ndarray]:
    """Histogram of voxel-wise cosine similarity between two axis feature
    volumes on their common grid (old/compare_feat_maps.py capability).
    ``device`` as in ``merge_axis_features``."""
    feats_a, feats_b = place(feats_a, device), place(feats_b, device)
    common = tuple(min(feats_a.shape[1 + i], feats_b.shape[1 + i]) for i in range(3))
    a = adaptive_avg_pool(feats_a, common)
    b = adaptive_avg_pool(feats_b, common)
    an = a / torch.linalg.norm(a, dim=0, keepdim=True).clamp_min(1e-12)
    bn = b / torch.linalg.norm(b, dim=0, keepdim=True).clamp_min(1e-12)
    cos = torch.sum(an * bn, dim=0).reshape(-1)
    hist, edges = np.histogram(cos.cpu().numpy(), bins=num_bins, range=(-1, 1))
    return hist, edges
