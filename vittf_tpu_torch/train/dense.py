"""Dense contrastive trainer (reference old/train.py).

Port of ``vittf_tpu/train/dense.py``. Full-volume forward each step: the
CNN runs over the entire (padded) volume, voxel features are gathered at
class indices sampled on the host (``np.random.default_rng``, in the JAX
twin's call order), and InfoNCE (+ a CE classification head + cluster-std
regularizer) is minimized. Includes the reference's positional-encoding
channels (z, y, x ∈ [-1, 1] scaled by 1.7185, old/train.py:82-88) and
label-percentage dropping (:60-69). Validation computes cluster centers and
L2 / cosine segmentations with per-class IoU (:173-220 capability).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from vittf_tpu_torch.models.cnn3d import (
    FeatureExtractorConfig,
    feature_extractor_forward,
    init_feature_extractor,
)
from vittf_tpu_torch.train import optim
from vittf_tpu_torch.train.contrastive import make_optimizer
from vittf_tpu_torch.utils.tensor import norm_mean_std, resolve_device

POS_ENCODING_SCALE = 1.7185  # old/train.py:87


@dataclass(frozen=True)
class DenseContrastiveConfig:
    model: FeatureExtractorConfig = FeatureExtractorConfig()
    pos_encoding: bool = True
    normalize: bool = True
    samples_per_iteration: int = 8
    neg_count: int = 4096
    # InfoNCE temperature. 1.0 = reference parity (old/train.py:145 uses raw
    # cosine logits), whose per-pair loss floor ln(1 + N·e⁻²) stops
    # separating classes from each other once foreground and background
    # split; τ ≈ 0.07-0.1 restores inter-class separation.
    temperature: float = 1.0
    lambda_std: float = 1.0
    lambda_ce: float = 1.0
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    schedule: str = "onecycle"
    iterations: int = 1000
    label_percentage: float = 1.0
    background_class: str = "background"

    @property
    def rec_field(self) -> int:
        return len(self.model.n_features) * 2 + 1


def add_pos_encoding(vol: torch.Tensor) -> torch.Tensor:
    """(C, Z, Y, X) → (C+3, Z, Y, X) with scaled linspace coords."""
    z, y, x = (torch.linspace(-1.0, 1.0, s, device=vol.device) for s in vol.shape[-3:])
    coords = torch.stack(torch.meshgrid(z, y, x, indexing="ij")) * POS_ENCODING_SCALE
    return torch.cat([vol, coords.to(vol.dtype)], dim=0)


def drop_labels(mask: np.ndarray, label_percentage: float, num_classes: int,
                rng: np.random.Generator, drop_to: int = 0) -> np.ndarray:
    """Simulate sparse annotations: set (1-p) of each class's voxels to
    ``drop_to`` (old/train.py:60-69 / train_semisup_sparse.py:63-71)."""
    if label_percentage >= 1.0:
        return mask
    out = mask.copy()
    for c in range(num_classes):
        idx = np.argwhere(mask == c)
        if idx.shape[0] == 0:
            continue
        n_drop = int((1.0 - label_percentage) * idx.shape[0])
        sel = rng.choice(idx.shape[0], n_drop, replace=False)
        out[tuple(idx[sel].T)] = drop_to
    return out


def _prepare(vol, cfg: DenseContrastiveConfig, device) -> torch.Tensor:
    """(Z, Y, X) → (C, Z, Y, X): normalized and with position channels as
    the config says."""
    v = torch.as_tensor(vol, dtype=torch.float32).to(device)
    if cfg.normalize:
        v = norm_mean_std(v)
    v = v[None]
    if cfg.pos_encoding:
        v = add_pos_encoding(v)
    return v


def _dense_step(params, head_params, opt_state, vol, pos_idx, neg_idx, pos_cls, std_idx,
                cfg: DenseContrastiveConfig, opt, num_classes: int):
    """pos_idx (S, 2, 3) pairs; neg_idx (S, N, 3); pos_cls (S,) class ids;
    std_idx (C, K, 3) per-class voxel samples for the std regularizer.
    ``params`` and ``head_params`` are updated in place; returns (params,
    head_params, opt_state, aux) with aux detached."""
    pad = cfg.rec_field // 2

    def loss_fn(p):
        params_, head_ = p
        feats = feature_extractor_forward(params_, F.pad(vol[None], (pad,) * 6), cfg.model)[0]
        q = feats / torch.clamp(torch.linalg.norm(feats, dim=0, keepdim=True), min=1e-12)

        def gather(idx):  # (..., 3) → (F, ...)
            return q[:, idx[..., 0], idx[..., 1], idx[..., 2]]

        pos = gather(pos_idx)  # (F, S, 2)
        neg = gather(neg_idx)  # (F, S, N)
        anchor = pos[:, :, :1]
        keys = torch.cat([pos[:, :, 1:], neg], dim=-1)  # (F, S, 1+N)
        sim = torch.einsum("fsp,fsn->spn", anchor, keys)[:, 0]  # (S, 1+N)
        logp = F.log_softmax(sim / cfg.temperature, dim=-1)
        infonce = -logp[:, 0].mean() * pos_idx.shape[0]  # summed like the reference

        loss = infonce
        aux = {"infonce": infonce}
        if cfg.lambda_ce > 0:
            # classification head on the normalized positives (old/train.py:147)
            cls_logits = F.linear(pos.permute(1, 2, 0).reshape(-1, pos.shape[0]),
                                  head_["weight"], head_["bias"])
            labels = torch.repeat_interleave(pos_cls, 2)
            ce = -F.log_softmax(cls_logits, dim=-1)[
                torch.arange(labels.shape[0], device=labels.device), labels].mean()
            loss = loss + cfg.lambda_ce * ce
            aux["ce"] = ce
        if cfg.lambda_std > 0:
            # the sum over classes of the std of each class's normalized
            # features (old/train.py:155), over K sampled voxels a class;
            # jnp.std is the population std
            std = gather(std_idx).std(dim=(0, 2), correction=0).sum()  # (F, C, K) → ()
            loss = loss + cfg.lambda_std * std
            aux["std"] = std
        aux["loss"] = loss
        return loss, aux

    opt_state, _, aux = optim.update_step(opt, opt_state, (params, head_params), loss_fn)
    return params, head_params, opt_state, {k: v.detach() for k, v in aux.items()}


class DenseContrastiveTrainer:
    """Host driver for the dense contrastive trainer on ``device`` (the
    first CUDA device when None). ``params`` / ``head_params`` (this
    package's layout) replace the seeded inits."""

    def __init__(self, vol, mask, labels: list[str],
                 cfg: DenseContrastiveConfig = DenseContrastiveConfig(), seed: int = 0,
                 device=None, params=None, head_params=None):
        self.cfg = cfg
        self.labels = labels
        self.rng = np.random.default_rng(seed)
        self.num_classes = len(labels)
        self.device = resolve_device(device)

        mask = drop_labels(np.asarray(mask), cfg.label_percentage, self.num_classes, self.rng)
        self.vol = _prepare(vol, cfg, self.device)
        # replace() keeps every model field
        model_cfg = dataclasses.replace(cfg.model, in_dim=int(self.vol.shape[0]))
        self.model_cfg = model_cfg
        self.cfg = dataclasses.replace(cfg, model=model_cfg)

        self.class_indices = {n: np.argwhere(mask == i) for i, n in enumerate(labels)}
        self.fg_classes = [
            (i, n) for i, n in enumerate(labels)
            if n != cfg.background_class and self.class_indices[n].shape[0] >= 2
        ]
        if len(labels) < 2:
            raise ValueError(
                "dense trainer needs >= 2 label names (mask value i maps to "
                "labels[i]; include the background name as class 0 — the "
                "reference old/train.py data contract)"
            )
        gen = torch.Generator().manual_seed(seed)
        if params is None:
            params = init_feature_extractor(model_cfg, gen, self.device)
        if head_params is None:
            nf = model_cfg.n_linear[-1]
            bound = (1.0 / nf) ** 0.5
            head_params = {k: ((torch.rand(s, generator=gen) * 2.0 - 1.0) * bound)
                           for k, s in (("weight", (self.num_classes, nf)),
                                        ("bias", (self.num_classes,)))}
        self.params = optim.trainable(params, self.device)
        self.head_params = optim.trainable(head_params, self.device)
        self.opt = make_optimizer(self.cfg)
        self.opt_state = self.opt.init(optim.tree_leaves((self.params, self.head_params)))
        self.history: list[dict] = []

    def step(self, std_samples: int = 256) -> dict:
        S = self.cfg.samples_per_iteration
        pos, neg, cls = [], [], []
        for _ in range(S):
            for i, n in self.fg_classes:
                own = self.class_indices[n]
                other = np.concatenate([v for m, v in self.class_indices.items() if m != n])
                pos.append(own[self.rng.choice(own.shape[0], 2, replace=False)])
                neg.append(other[self.rng.choice(other.shape[0], self.cfg.neg_count)])
                cls.append(i)
        std_idx = np.stack([
            idx[self.rng.choice(idx.shape[0], std_samples)] if idx.shape[0]
            else np.zeros((std_samples, 3), np.int64)
            for idx in self.class_indices.values()
        ])
        dev = self.device
        self.params, self.head_params, self.opt_state, aux = _dense_step(
            self.params, self.head_params, self.opt_state, self.vol,
            torch.from_numpy(np.stack(pos)).to(dev), torch.from_numpy(np.stack(neg)).to(dev),
            torch.from_numpy(np.asarray(cls)).to(dev), torch.from_numpy(std_idx).to(dev),
            self.cfg, self.opt, self.num_classes,
        )
        rec = {k: float(v) for k, v in aux.items()}
        self.history.append(rec)
        return rec

    @torch.no_grad()
    def dense_features(self, vol=None, chunk: int | None = None) -> torch.Tensor:
        """Full-resolution feature volume of the training volume, or of
        ``vol`` (preprocessed identically: normalize + pos encoding).

        The train step's backward holds several full-volume activation
        tensors, so callers may train at a small size and evaluate dense
        features at a larger one. Past 128³ (or with ``chunk``) the forward
        runs halo-padded z-slabs: every conv sees rec_field//2 of real
        context, so the conv stack is exact; with norm='group' the
        GroupNorm statistics are per slab (approximate within GN-stat
        sampling noise); norm='none' chunks exactly.
        """
        v = self.vol if vol is None else _prepare(vol, self.cfg, self.device)
        pad = self.cfg.rec_field // 2
        Z = v.shape[1]
        if chunk is None and Z > 128:
            chunk = 64
        padded = F.pad(v[None], (pad,) * 6)
        if not chunk or chunk >= Z:
            return feature_extractor_forward(self.params, padded, self.model_cfg)[0]
        outs = []
        for z0 in range(0, Z, chunk):
            z1 = min(z0 + chunk, Z)
            # output rows [z0, z1) need padded rows [z0, z1 + 2·pad)
            slab = padded[:, :, z0: z1 + 2 * pad]
            outs.append(feature_extractor_forward(self.params, slab, self.model_cfg)[0])
        return torch.cat(outs, dim=1)

    @torch.no_grad()
    def validate(self) -> dict:
        """Cluster centers → L2 / cosine segmentations → per-class IoU
        (old/train.py:173-220 capability)."""
        from vittf_tpu_torch.pipeline.evaluate import confusion_matrix, metrics_from_confusion

        feats = self.dense_features()
        q = feats / torch.clamp(torch.linalg.norm(feats, dim=0, keepdim=True), min=1e-12)
        centers_l2, centers_cos = [], []
        for n in self.labels:
            idx = torch.from_numpy(self.class_indices[n]).to(self.device)
            if idx.shape[0] == 0:
                centers_l2.append(feats.new_zeros(feats.shape[0]))
                centers_cos.append(feats.new_zeros(feats.shape[0]))
                continue
            sel = feats[:, idx[:, 0], idx[:, 1], idx[:, 2]]
            selq = q[:, idx[:, 0], idx[:, 1], idx[:, 2]]
            centers_l2.append(sel.mean(dim=1))
            c = selq.mean(dim=1)
            centers_cos.append(c / torch.clamp(torch.linalg.norm(c), min=1e-12))
        cl2 = torch.stack(centers_l2)
        ccos = torch.stack(centers_cos)

        d_l2 = torch.linalg.norm(feats[None] - cl2[:, :, None, None, None], dim=1)
        seg_l2 = torch.argmin(d_l2, dim=0)
        d_cos = torch.clamp(torch.einsum("fzyx,nf->nzyx", q, ccos), 0, 1)
        seg_cos = torch.argmax(d_cos, dim=0)

        # ground truth from the stored class indices
        gt = np.zeros(tuple(self.vol.shape[-3:]), np.int64)
        for i, n in enumerate(self.labels):
            idx = self.class_indices[n]
            gt[idx[:, 0], idx[:, 1], idx[:, 2]] = i
        gt = torch.from_numpy(gt.reshape(-1)).to(self.device)
        out = {}
        for name, seg in (("l2", seg_l2), ("cosine", seg_cos)):
            m = metrics_from_confusion(confusion_matrix(gt, seg.reshape(-1), self.num_classes))
            out[f"iou_{name}"] = dict(zip(self.labels, m["iou"].cpu().numpy().tolist()))
        return out
