"""Query-refinement ops: top-K similarity bootstrapping + prototype thinning.

Port of ``vittf_tpu/ops/query.py`` (the reference's query utilities):
- ``resample_topk`` (infer.py:75-106): re-sample features at the K most
  similar voxels per (class, annotation), recompute similarity, mean over K.
- ``take_most_dissimilar`` (infer.py:108-126): keep the ``num_prototypes``
  features with the largest mean pairwise distance (cosine or euclidean).

Both pick by rank. Among equal values ``jax.lax.top_k`` returns the lowest
index first and ``torch.topk`` promises no order, and quantized or clamped
similarities tie heavily, so the ranks come from a stable descending sort.
The products run in IEEE fp32 (no TF32), as the JAX package asks
``precision='highest'``.
"""
from __future__ import annotations

import torch

from vittf_tpu_torch.ops.sampling import sample_features3d
from vittf_tpu_torch.utils.tensor import ieee_matmul, make_5d


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last axis, descending,
    the lowest index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def resample_topk(
    feat_vol: torch.Tensor,
    sims: torch.Tensor,
    K: int = 8,
    similarity_exponent: float = 2.0,
    feature_sampling_mode: str = "nearest",
) -> torch.Tensor:
    """Bootstrap similarity maps from their own top-K voxels.

    Args:
        feat_vol: ([M,] F, W, H, D) feature volume.
        sims: ([M,] C, A, W, H, D) similarity volumes.

    Returns:
        ([M,] C, A, W, H, D): per-annotation similarity maps averaged over
        the K resampled queries, clamped to [0,1] and sharpened.
    """
    feat_vol = make_5d(feat_vol)
    if sims.ndim == 5:
        sims = sims[None]
    M, C, A = sims.shape[:3]
    spatial = tuple(sims.shape[-3:])

    flat = sims.reshape(M * C * A, -1)
    _, top_idx = top_k_stable(flat, K)  # (MCA, K) descending
    coords = torch.stack(torch.unravel_index(top_idx.reshape(-1), spatial), dim=-1)
    coords = coords.reshape(M, C, A, K, 3)
    extent = torch.tensor(spatial, dtype=torch.float32, device=sims.device)
    rel = (coords.float() + 0.5) / extent * 2.0 - 1.0

    qf2 = sample_features3d(
        feat_vol, rel.reshape(M, C, A * K, 3), mode=feature_sampling_mode
    )  # (M, C, A*K, F)
    qf2 = qf2.reshape(M, C, A, K, qf2.shape[-1])
    with ieee_matmul():
        new_sims = torch.einsum("mfwhd,mcakf->mcakwhd", feat_vol.float(), qf2.float())
    new_sims = new_sims.clamp(0.0, 1.0) ** similarity_exponent
    return new_sims.mean(dim=3).to(sims.dtype)


def take_most_dissimilar(
    features: torch.Tensor, num_prototypes: int = 35, measure: str = "cosine"
) -> torch.Tensor:
    """Keep the ``num_prototypes`` mutually most dissimilar feature rows.

    dist(i) = mean_j (1 − cos(f_i, f_j)) or mean_j ||f_i − f_j||; the rows
    with the largest mean distance are selected (infer.py:117-126).
    """
    N = features.shape[0]
    if N <= num_prototypes:
        return features
    f = features.float()
    with ieee_matmul():
        if measure == "cosine":
            fn = f / torch.linalg.norm(f, dim=-1, keepdim=True).clamp_min(1e-8)
            dist = (1.0 - fn @ fn.T).mean(dim=0)
        elif measure == "euclidean":
            sq = torch.sum(f * f, dim=-1)
            d2 = sq[:, None] + sq[None, :] - 2.0 * (f @ f.T)
            dist = torch.sqrt(d2.clamp_min(0.0)).mean(dim=0)
        else:
            raise ValueError(f"Unknown measure: {measure}")
    _, sel = top_k_stable(dist, num_prototypes)
    return features[sel]
