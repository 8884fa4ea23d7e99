"""IntraCLR: within-volume contrastive learning on augmented crop views.

Port of ``vittf_tpu/train/intra_clr.py`` (the completed form of the
reference's unfinished old/intra_clr.py): positives are two augmented views
(noise / flip / permute) of the same voxel crop, negatives are the other
crops of the batch; no labels. The augmentation draws of a step are an
input (``losses.paws_draws``' layout) or come from the trainer's
``torch.Generator``, which takes the place of the twin's ``PRNGKey(seed + 1)``.
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
from vittf_tpu_torch.train.contrastive import make_optimizer
from vittf_tpu_torch.train.gather import gather_receptive_fields
from vittf_tpu_torch.train.losses import paws_draws, transform_paws_crops
from vittf_tpu_torch.utils.tensor import resolve_device


@dataclass(frozen=True)
class IntraCLRConfig:
    model: FeatureExtractorConfig = FeatureExtractorConfig()
    rec_field: int = 7
    batch_size: int = 64
    temperature: float = 0.1
    noise_std: float = 0.05
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    schedule: str = "cosine"
    iterations: int = 1000


def intra_clr_step(params, opt_state, vol4, centers, draws, cfg: IntraCLRConfig, opt):
    """NT-Xent over two augmented views of ``batch_size`` voxel crops;
    ``params`` updated in place. Returns (params, opt_state, loss)."""
    crops = gather_receptive_fields(vol4, centers, ks=cfg.rec_field)
    views = transform_paws_crops(crops, draws, noise_std=cfg.noise_std)  # (2B, ...)
    B = centers.shape[0]
    dev = views.device

    def loss_fn(p):
        f = feature_extractor_forward(p, views, cfg.model)
        f = f.reshape(f.shape[0], f.shape[1])
        f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True), min=1e-12)
        sim = (f @ f.T) / cfg.temperature  # (2B, 2B)
        sim = sim - torch.eye(2 * B, device=dev) * 1e9  # mask self-similarity
        # the positive of i is i ± B
        targets = torch.cat([torch.arange(B, device=dev) + B, torch.arange(B, device=dev)])
        logp = F.log_softmax(sim, dim=-1)
        return -logp[torch.arange(2 * B, device=dev), targets].mean(), None

    opt_state, loss, _ = optim.update_step(opt, opt_state, params, loss_fn)
    return params, opt_state, loss


class IntraCLRTrainer:
    """Host driver on ``device`` (the first CUDA device when None);
    ``params`` replaces the seeded init."""

    def __init__(self, vol, cfg: IntraCLRConfig = IntraCLRConfig(), seed: int = 0, device=None,
                 params=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vol4 = torch.as_tensor(vol, dtype=torch.float32).to(self.device)[None]
        self.rng = np.random.default_rng(seed)
        if params is None:
            params = init_feature_extractor(cfg.model, torch.Generator().manual_seed(seed),
                                            self.device)
        self.params = optim.trainable(params, self.device)
        self.opt = make_optimizer(cfg)
        self.opt_state = self.opt.init(optim.tree_leaves(self.params))
        self.generator = torch.Generator().manual_seed(seed + 1)
        self.history: list[float] = []

    def step(self, draws: dict | None = None) -> float:
        """One step; ``draws`` fixes the augmentation of the step's crops
        (``paws_draws`` of shape (batch, C_in, k, k, k)), else they are drawn
        from ``self.generator``."""
        shape = self.vol4.shape[1:]
        centers = np.stack([self.rng.integers(0, s, self.cfg.batch_size) for s in shape], -1)
        if draws is None:
            k = self.cfg.rec_field
            draws = paws_draws((self.cfg.batch_size, self.vol4.shape[0], k, k, k),
                               self.generator, self.device)
        self.params, self.opt_state, loss = intra_clr_step(
            self.params, self.opt_state, self.vol4, torch.from_numpy(centers).to(self.device),
            draws, self.cfg, self.opt)
        loss = float(loss)
        self.history.append(loss)
        return loss
