"""Training losses: InfoNCE, cluster-std, PAWS (snn/sharpen/me-max).

Port of ``vittf_tpu/train/losses.py`` (the reference's legacy trainer losses):
- InfoNCE over sparse voxel crops (old/train_semisparse.py:189-194)
- feature-std cluster compactness (old/utils.py:66-87 via :197-206)
- PAWS soft-nearest-neighbor losses (old/paws.py:4-34)
- PAWS crop augmentation (noise/permute/flip, old/paws.py:36-57), whose
  random draws come from a ``torch.Generator`` or are given explicitly
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def _normalize(x, dim: int = -1, eps: float = 1e-12):
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True), min=eps)


def infonce_loss(pos_feat: torch.Tensor, neg_feat: torch.Tensor) -> torch.Tensor:
    """InfoNCE with the second positive as target and N negatives.

    pos_feat (C, 2, BS, F): two positive views per class; neg_feat
    (C, N, 1, F): negatives per class. logits row = [sim(anchor, positive),
    sim(anchor, neg_1..N)]; label 0 (old/train_semisparse.py:189-193).
    """
    C, _, BS, F_dim = pos_feat.shape
    N = neg_feat.shape[1]
    pos_q = _normalize(pos_feat)
    neg_q = _normalize(neg_feat)
    anchors = pos_q[:, :1]  # (C, 1, BS, F)
    keys = torch.cat([pos_q[:, 1:2], neg_q.expand(C, N, BS, F_dim)], dim=1)  # (C, 1+N, BS, F)
    sim = torch.einsum("cpbf,cnbf->cpbn", anchors, keys).squeeze(1)  # (C, BS, 1+N)
    logprobs = F.log_softmax(sim.reshape(C * BS, N + 1), dim=-1)
    return -logprobs[:, 0].mean()


def feature_std(features: torch.Tensor, reduce_dim=(1, 2), feature_dim: int = -1) -> torch.Tensor:
    """Per-class mean std of features around their cluster center
    (old/utils.py feature_std as used at old/train_semisparse.py:197-206)."""
    return features.float().std(dim=reduce_dim, correction=0).mean(dim=feature_dim)


# ---------------- PAWS ----------------

def sharpen(p: torch.Tensor, T: float) -> torch.Tensor:
    sharp = p ** (1.0 / T)
    return sharp / torch.sum(sharp, dim=1, keepdim=True)


def snn(query, support, labels, tau: float = 0.1):
    """Soft nearest neighbours: softmax(q·sᵀ/τ) @ labels (old/paws.py:8-13)."""
    q = _normalize(query, dim=1)
    s = _normalize(support, dim=1)
    return torch.softmax(q @ s.T / tau, dim=1) @ labels


def paws_loss(anchor_views, anchor_supports, anchor_labels,
              target_views, target_supports, target_labels,
              clas_pred=None, temperature: float = 0.25, tau: float = 0.1):
    """PAWS loss: CE against sharpened positive pseudo-labels + me-max
    (old/paws.py:15-34). Returns (loss, memax[, class_loss]); the targets
    carry no gradient."""
    probs = snn(anchor_views, anchor_supports, anchor_labels, tau=tau)
    targs = sharpen(snn(target_views, target_supports, target_labels, tau=tau),
                    temperature).detach()
    targs = torch.where(targs < 1e-4, 0.0, targs)
    # H(targets, queries): sum(log(probs ** -targs)) = -targs·log(probs)
    loss = torch.mean(torch.sum(-targs * torch.log(torch.clamp(probs, min=1e-30)), dim=1))
    # me-max: Σ p̄·log p̄ (negative entropy)
    avg_probs = torch.mean(sharpen(probs, temperature), dim=0)
    memax = torch.sum(avg_probs * torch.log(torch.clamp(avg_probs, min=1e-30)))
    if clas_pred is not None:
        clas_targ = torch.cat([anchor_labels, sharpen(probs, temperature).detach()], dim=0)
        clas_loss = -(clas_targ * F.log_softmax(clas_pred, dim=-1)).sum(dim=-1).mean()
        return loss, memax, clas_loss
    return loss, memax


def paws_draws(shape, generator: torch.Generator | None = None, device=None) -> dict:
    """The random draws of one ``transform_paws_crops`` call: two unit-normal
    noise tensors of ``shape``, two indices into ``PERMS`` and six flip
    coins (three axes of the anchors, then of the positives)."""
    noise = tuple(torch.randn(shape, generator=generator).to(device) for _ in range(2))
    perm = torch.randint(0, len(PERMS), (2,), generator=generator).tolist()
    flips = (torch.rand(6, generator=generator) < 0.5).tolist()
    return {"noise": noise, "perm": perm, "flips": flips}


def transform_paws_crops(crops: torch.Tensor, draws: dict | None = None,
                         generator: torch.Generator | None = None,
                         noise_std: float = 0.05, flip: bool = True, permute: bool = True):
    """Two augmented views (anchors ‖ positives) of crops (old/paws.py:36-57):
    additive Gaussian noise, a random permutation of the three spatial axes,
    random per-axis flips. ``draws`` (as ``paws_draws`` makes them) fixes
    every random choice; without it they are drawn from ``generator``."""
    if draws is None:
        draws = paws_draws(crops.shape, generator, crops.device)
    if noise_std > 0:
        anchors = crops + draws["noise"][0] * noise_std
        positiv = crops + draws["noise"][1] * noise_std
    else:
        anchors, positiv = crops, crops
    pre = tuple(range(crops.ndim - 3))

    def apply_perm(x, i):
        return x.permute(pre + tuple(d + len(pre) for d in PERMS[i]))

    if permute:
        i0, i1 = draws["perm"]
        anchors = apply_perm(anchors, i0)
        positiv = apply_perm(anchors, i1)  # the reference permutes the anchors twice
    if flip:
        for i in range(3):
            ax = crops.ndim - 3 + i
            if draws["flips"][i]:
                anchors = torch.flip(anchors, dims=(ax,))
            if draws["flips"][3 + i]:
                positiv = torch.flip(positiv, dims=(ax,))
    return torch.cat([anchors, positiv], dim=0)
