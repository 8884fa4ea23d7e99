"""Training utilities (reference old/utils.py capability surface).

Port of ``vittf_tpu/train/utils.py``:
- seeding + debug config (the reference's CUDA_LAUNCH_BLOCKING and anomaly
  detection), returning the ``torch.Generator`` that takes the JAX twin's
  key's place
- index helpers ``split_squeeze`` / ``split_squeeze3d``
- ``cluster_kmeans`` / ``project_pca`` feature-space analysis (sklearn, on
  the host)
- ``AverageMeter``
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def setup_seed_and_debug(seed: int = 3407, debug: bool = False) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; in debug mode
    make launches synchronous and turn on autograd's anomaly detection
    (old/utils.py:18-26). Returns a generator seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if debug:
        os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
        torch.autograd.set_detect_anomaly(True)
    return torch.Generator().manual_seed(seed)


def split_squeeze(idx: torch.Tensor, bs: int, f: int):
    """(N, 3) voxel indices → advanced-index tuple into (BS, F, Z, Y, X)
    yielding (BS, F, N) gathers (old/utils.py split_squeeze semantics)."""
    z, y, x = idx[:, 0], idx[:, 1], idx[:, 2]
    b = torch.arange(bs, device=idx.device)[:, None, None]
    c = torch.arange(f, device=idx.device)[None, :, None]
    return (b, c, z[None, None, :], y[None, None, :], x[None, None, :])


def split_squeeze3d(idx: torch.Tensor):
    """(N, 3) → index tuple into a (Z, Y, X) volume."""
    return (idx[:, 0], idx[:, 1], idx[:, 2])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def cluster_kmeans(features, k: int, seed: int = 0) -> np.ndarray:
    """K-means labels over (N, F) features (old/utils.py cluster_kmeans via
    sklearn, on the host)."""
    from sklearn.cluster import KMeans

    return KMeans(n_clusters=k, random_state=seed, n_init=4).fit_predict(_host(features))


def project_pca(features, n_components: int = 3) -> np.ndarray:
    """PCA projection of (N, F) features (old/utils.py project_pca; sklearn,
    on the host)."""
    from sklearn.decomposition import PCA

    return PCA(n_components=n_components).fit_transform(_host(features))


class AverageMeter:
    """Running average (old/utils.py AverageMeter)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
