"""Similarity-map comparison across annotation-sampling strategies
(reference compare_feat_sampling.py:35-84 __main__ flow).

Port of ``vittf_tpu/pipeline/compare_sampling.py``. Normalized features,
per-class GT sampling, *unthresholded* squared-dot similarity averaged over
samples (the reference's chunked running mean for >2¹⁴ queries is
mathematically the same mean — here the fused kernel's blocked accumulation
does it), then 255/quantile(0.9999) clamp-quantization and a
``sim_{class}_{sampler}{n}.npy`` artifact per combination. The similarity
kernel runs here with no threshold (τ = −1e30) on scores of either sign.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from vittf_tpu_torch.ops.sampling import rel_coords_from_abs, sample_features3d
from vittf_tpu_torch.ops.similarity import fused_similarity
from vittf_tpu_torch.pipeline.annotations import SAMPLING_MODES
from vittf_tpu_torch.utils.tensor import place


def normalize_features(feats: torch.Tensor) -> torch.Tensor:
    """F.normalize(feats, dim=0) parity (compare_feat_sampling.py:45)."""
    return feats / torch.linalg.norm(feats, dim=0, keepdim=True).clamp_min(1e-12)


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (linear interpolation) as a 0-d fp32 tensor,
    with its fp32 position arithmetic and XLA's fused interpolation. Sorts instead of calling
    ``torch.quantile``, which refuses inputs above 16 M elements (a 256³
    grid has 16.8 M)."""
    a = x.reshape(-1).float()
    if bool(torch.isnan(a).any()):
        return torch.full((), float("nan"), device=x.device)
    a, _ = torch.sort(a)
    n1 = np.float32(a.numel()) - np.float32(1)
    pos = np.float32(q) * n1
    low, high = np.floor(pos), np.ceil(pos)
    high_w = np.float32(pos - low)
    low_w = np.float32(1) - high_w
    lo, hi = (int(min(max(v, np.float32(0)), n1)) for v in (low, high))
    # XLA contracts the interpolation into low·w_low (rounded) fused into
    # high·w_high + that: the fp64 sum of an exact fp32 product rounds once
    low_term = a[lo] * float(low_w)
    return (a[hi].double() * float(high_w) + low_term.double()).float()


def quantize_quantile_u8(sim: torch.Tensor, q: float = 0.9999) -> torch.Tensor:
    """255/quantile(q) scale + clamp(0, 255) → uint8
    (compare_feat_sampling.py:82)."""
    qv = quantile_linear(sim, q)
    scale = torch.full_like(qv, 255.0) / qv  # a true division, not reciprocal-then-multiply
    return (scale * sim).clamp(0, 255).to(torch.uint8)


def sampling_similarity_map(
    feats_norm: torch.Tensor,
    abs_coords: np.ndarray,
    exponent: float = 2.0,
    impl: str = "auto",
) -> torch.Tensor:
    """Mean over samples of (f·q)^exponent, no threshold
    (compare_feat_sampling.py:71-80)."""
    F_dim = feats_norm.shape[0]
    feat_dims = tuple(feats_norm.shape[-3:])
    coords = torch.as_tensor(np.asarray(abs_coords), dtype=torch.float32, device=feats_norm.device)
    rel = rel_coords_from_abs(coords, feat_dims)
    qf = sample_features3d(feats_norm, rel, mode="bilinear")[0, 0]
    flat = torch.movedim(feats_norm, 0, -1).reshape(-1, F_dim).contiguous()  # voxel-major for K2
    sims = fused_similarity(
        flat, qf.contiguous(), [qf.shape[0]],
        threshold=-1e30, exponent=exponent, impl=impl,
    )[:, 0]
    return sims.reshape(feat_dims)


def compare_sampling_strategies(
    feats,
    labels: np.ndarray,
    num_samples: float,
    out_dir: str | Path,
    samplers: tuple[str, ...] = ("uniform",),
    rng: np.random.Generator | None = None,
    impl: str = "auto",
    device: str | torch.device | None = None,
) -> dict[str, Path]:
    """Per (class, sampler): similarity map artifact + path dict.

    ``labels`` are on the FEATURE grid (the reference samples coords in
    feature-space: rel coords normalized by vol extent equal feature extent
    there since the label volume matches). ``feats`` is a (F, W, H, D)
    array or tensor. A tensor is compared where it lies unless ``device``
    is given; a numpy array goes to ``device``, the first CUDA device when
    None (pass ``device='cpu'`` to run on the CPU).
    """
    rng = rng if rng is not None else np.random.default_rng()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    feats_norm = normalize_features(place(feats, device).float())
    written = {}
    labels = np.asarray(labels)
    for i in range(1, int(labels.max()) + 1):
        mask = labels == i
        if num_samples > 1.0:
            n = min(int(num_samples), int(mask.sum()))
        else:
            n = int(num_samples * mask.sum())
        if n == 0:
            continue
        for name in samplers:
            coords = SAMPLING_MODES[name](torch.from_numpy(mask), n, rng=rng)
            sim = sampling_similarity_map(feats_norm, coords, impl=impl)
            sim_u8 = quantize_quantile_u8(sim)
            p = out_dir / f"sim_{i}_sample_{name}{num_samples}.npy"
            np.save(p, sim_u8.cpu().numpy())
            written[f"{i}_{name}"] = p
    return written
