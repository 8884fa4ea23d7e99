"""Sparse-annotation contrastive trainer (reference old/train_semisparse.py).

Port of ``vittf_tpu/train/contrastive.py``. Each step draws 2·BS positive
voxels per class and NEG negatives on the host (``np.random.default_rng``,
in the JAX twin's call order, so both packages draw the same centres),
gathers their k³ receptive fields, runs the 3D CNN and minimizes InfoNCE (+
optional cluster-std compactness). The optimizer is optax's RAdam with the
reference's OneCycle / cosine schedule options, as ``train/optim.py`` writes
them.

Reference mapping:
- voxel sampling             old/train_semisparse.py:161-168 (host, numpy)
- receptive-field gather     old/semisparseconv.py → train/gather.py
- InfoNCE + std loss         :189-206 → train/losses.py
- RAdam + OneCycle/Cosine    :154-156
"""
from __future__ import annotations

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
from vittf_tpu_torch.train.gather import gather_receptive_fields
from vittf_tpu_torch.train.losses import feature_std, infonce_loss
from vittf_tpu_torch.utils.tensor import resolve_device


@dataclass(frozen=True)
class ContrastiveConfig:
    model: FeatureExtractorConfig = FeatureExtractorConfig()
    rec_field: int = 7  # crop size: must reduce to 1³ through the convs
    batch_size: int = 32  # BS positives per class (2·BS drawn)
    neg_count: int = 1024
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    lambda_std: float = 0.0
    std_loss_on: str = "logits"  # 'logits' | 'cosine'
    schedule: str = "onecycle"  # 'onecycle' | 'cosine' | 'const'
    iterations: int = 1000


def make_optimizer(cfg) -> optim.Transform:
    if cfg.iterations < 4:
        # onecycle's piecewise-interpolate boundaries collapse to zero-width
        # intervals below a handful of steps → 0/0 NaN in the schedule, which
        # then NaNs every update: tiny iteration counts get a constant rate
        lr = cfg.learning_rate
    elif cfg.schedule == "onecycle":
        lr = optim.cosine_onecycle_schedule(cfg.iterations, cfg.learning_rate)
    elif cfg.schedule == "cosine":
        lr = optim.cosine_decay_schedule(cfg.learning_rate, cfg.iterations)
    else:
        lr = cfg.learning_rate
    opt = optim.radam(lr)
    if cfg.weight_decay > 0:
        opt = optim.chain(optim.add_decayed_weights(cfg.weight_decay), opt)
    return opt


def contrastive_loss_fn(params, vol4, pos_centers, neg_centers, cfg: ContrastiveConfig):
    """vol4 (C_in, Z, Y, X); pos (C, 2·BS, 3); neg (C, N, 3) voxel centers."""
    C, twoBS, _ = pos_centers.shape
    N = neg_centers.shape[1]
    BS = twoBS // 2
    centers = torch.cat([pos_centers.reshape(-1, 3), neg_centers.reshape(-1, 3)])
    crops = gather_receptive_fields(vol4, centers, ks=cfg.rec_field)
    feats = feature_extractor_forward(params, crops, cfg.model)
    feats = feats.reshape(feats.shape[0], feats.shape[1])  # (·, F)
    NF = feats.shape[-1]
    pos_feat = feats[: C * twoBS].reshape(C, 2, BS, NF)
    neg_feat = feats[C * twoBS:].reshape(C, N, 1, NF)
    loss = infonce_loss(pos_feat, neg_feat)
    aux = {"infonce": loss}
    if cfg.lambda_std > 0:
        f = pos_feat if cfg.std_loss_on == "logits" else (
            pos_feat / torch.clamp(torch.linalg.norm(pos_feat, dim=-1, keepdim=True), min=1e-12)
        )
        std = feature_std(f).sum(0)
        loss = loss + cfg.lambda_std * std
        aux["std"] = std
    aux["loss"] = loss
    return loss, aux


def train_step(params, opt_state, vol4, pos_centers, neg_centers, cfg, opt):
    """One RAdam step on ``params`` (updated in place); returns (params,
    opt_state, aux) with aux detached."""
    opt_state, _, aux = optim.update_step(
        opt, opt_state, params,
        lambda p: contrastive_loss_fn(p, vol4, pos_centers, neg_centers, cfg))
    return params, opt_state, {k: v.detach() for k, v in aux.items()}


class ContrastiveTrainer:
    """Host-side driver: class-index sampling + train steps on ``device``
    (the first CUDA device when None; ``'cpu'`` for the CPU). ``params``
    (this package's layout, e.g. ``models.cnn3d.params_from_jax`` of the
    JAX twin's) replaces the seeded init."""

    def __init__(self, vol, labels, cfg: ContrastiveConfig = ContrastiveConfig(), seed: int = 0,
                 device=None, params=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vol4 = torch.as_tensor(vol, dtype=torch.float32).to(self.device)[None]
        self.rng = np.random.default_rng(seed)
        labels = np.asarray(labels)
        self.class_indices = {
            int(c): np.argwhere(labels == c) for c in np.unique(labels) if c != 0
        }
        if params is None:
            params = init_feature_extractor(cfg.model, torch.Generator().manual_seed(seed),
                                            self.device)
        self.params = optim.trainable(params, self.device)
        self.opt = make_optimizer(cfg)
        self.opt_state = self.opt.init(optim.tree_leaves(self.params))
        self.history: list[dict] = []

    @classmethod
    def from_rle_annotations(cls, vol, annotation: dict[str, np.ndarray],
                             cfg: ContrastiveConfig = ContrastiveConfig(), seed: int = 0,
                             device=None, params=None) -> "ContrastiveTrainer":
        """Build a trainer from an RLE annotation export (the reference's
        ``_old`` trainer input, old/train_semisparse_old.py:14): per-class
        runs → voxel coordinates → class_indices. Class ids are 1..K in the
        annotation dict's order, empty classes skipped;
        ``self.class_names`` maps id → name."""
        from vittf_tpu_torch.core.rle import decode_from_annotation

        coords = decode_from_annotation(annotation, tuple(np.shape(vol)))
        self = cls(vol, np.zeros(np.shape(vol), np.int32), cfg=cfg, seed=seed, device=device,
                   params=params)
        names = [n for n in coords if coords[n].shape[0] > 0]
        self.class_indices = {i + 1: np.asarray(coords[n]) for i, n in enumerate(names)}
        self.class_names = {i + 1: n for i, n in enumerate(names)}
        return self

    def _choice(self, n_avail, n_want):
        # without replacement (torch.multinomial, old/train_semisparse:161-168)
        # unless the class is smaller than the request
        return self.rng.choice(n_avail, size=n_want, replace=n_avail < n_want)

    def _draw(self, n_per_class) -> torch.Tensor:
        out = []
        for c, idxs in sorted(self.class_indices.items()):
            out.append(idxs[self._choice(idxs.shape[0], n_per_class)])
        return torch.from_numpy(np.stack(out)).to(self.device)

    def _draw_negatives(self, n) -> torch.Tensor:
        """Negatives for class c come from all other classes (reference
        different_sample_idxs, old/train_semisparse.py:164-168)."""
        out = []
        classes = sorted(self.class_indices)
        for c in classes:
            other = np.concatenate([self.class_indices[o] for o in classes if o != c])
            out.append(other[self._choice(other.shape[0], n)])
        return torch.from_numpy(np.stack(out)).to(self.device)

    def step(self) -> dict:
        pos = self._draw(2 * self.cfg.batch_size)
        neg = self._draw_negatives(self.cfg.neg_count)
        self.params, self.opt_state, aux = train_step(
            self.params, self.opt_state, self.vol4, pos, neg, self.cfg, self.opt)
        rec = {k: float(v) for k, v in aux.items()}
        self.history.append(rec)
        return rec

    @torch.no_grad()
    def dense_features(self, vol=None) -> torch.Tensor:
        """Full-volume forward for validation (old/train_semisparse.py:229-252),
        padded so the output aligns voxel for voxel with the input volume."""
        v = self.vol4 if vol is None else torch.as_tensor(vol, dtype=torch.float32).to(
            self.device)[None]
        pad = len(self.cfg.model.n_features)
        return feature_extractor_forward(self.params, F.pad(v[None], (pad,) * 6),
                                         self.cfg.model)[0]
