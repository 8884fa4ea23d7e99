"""Trainer/feature visualizations (reference old/utils.py plotting surface:
similarity/confusion matrix figures, segmentation slice panels, PCA
feature projections — the figures the legacy trainers logged to wandb).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_similarity_matrix(
    features: np.ndarray, labels: list[str], out_path: str | Path
) -> Path:
    """Class-center cosine-similarity matrix heatmap.

    Args:
        features: (C, F) per-class mean feature vectors.
    """
    plt = _plt()
    f = np.asarray(features, np.float64)
    f = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    sim = f @ f.T
    fig, ax = plt.subplots(dpi=150, tight_layout=True)
    im = ax.imshow(sim, vmin=-1, vmax=1, cmap="coolwarm")
    ax.set_xticks(range(len(labels)), labels, rotation=45, ha="right")
    ax.set_yticks(range(len(labels)), labels)
    for i in range(len(labels)):
        for j in range(len(labels)):
            ax.text(j, i, f"{sim[i, j]:.2f}", ha="center", va="center", fontsize=7)
    fig.colorbar(im)
    out_path = Path(out_path)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_segmentation_slices(
    volume: np.ndarray,
    segmentation: np.ndarray,
    out_path: str | Path,
    slice_fracs: tuple[float, ...] = (0.25, 0.5, 0.75),
    axis: int = 0,
) -> Path:
    """Volume slices with segmentation overlays, one row per axis position
    (the wandb mask-image equivalent of old/train*.py validation)."""
    plt = _plt()
    vol = np.asarray(volume)
    seg = np.asarray(segmentation)
    n = len(slice_fracs)
    fig, axes = plt.subplots(2, n, dpi=150, tight_layout=True,
                             figsize=(3 * n, 6))
    for col, frac in enumerate(slice_fracs):
        idx = int(frac * (vol.shape[axis] - 1))
        v = np.take(vol, idx, axis=axis)
        s = np.take(seg, idx, axis=axis)
        axes[0, col].imshow(v, cmap="gray")
        axes[0, col].set_title(f"slice {idx}")
        axes[1, col].imshow(v, cmap="gray")
        axes[1, col].imshow(
            np.ma.masked_where(s == 0, s), cmap="tab10", alpha=0.5,
            vmin=0, vmax=9,
        )
        for a in (axes[0, col], axes[1, col]):
            a.set_xticks([])
            a.set_yticks([])
    out_path = Path(out_path)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_pca_features(
    feat_vol: np.ndarray, out_path: str | Path, axis: int = 0,
    slice_frac: float = 0.5,
) -> Path:
    """PCA(3) projection of a (F, W, H, D) feature volume rendered as an
    RGB slice (old/train.py's PCA visualization)."""
    from vittf_tpu_torch.train.utils import project_pca

    plt = _plt()
    f = np.asarray(feat_vol)
    F_dim = f.shape[0]
    flat = np.moveaxis(f, 0, -1).reshape(-1, F_dim)
    proj = project_pca(flat, 3).reshape(*f.shape[1:], 3)
    lo, hi = proj.min(), proj.max()
    rgb = (proj - lo) / max(hi - lo, 1e-12)
    idx = int(slice_frac * (rgb.shape[axis] - 1))
    img = np.take(rgb, idx, axis=axis)
    fig, ax = plt.subplots(dpi=150, tight_layout=True)
    ax.imshow(img)
    ax.set_xticks([])
    ax.set_yticks([])
    out_path = Path(out_path)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
