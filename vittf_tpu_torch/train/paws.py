"""PAWS semi-supervised trainer (reference old/train_semisup_sparse.py).

Port of ``vittf_tpu/train/paws.py``. Each step gathers M support crops per
labeled class plus BS unlabeled anchor crops (host draws from
``np.random.default_rng``, in the JAX twin's call order); the anchors get
two augmented views (noise / permute / flip; the draws an input or from the
trainer's ``torch.Generator``); PAWSNet produces projection features (snn
targets, detached) and prediction-head features (snn queries); the loss is
PAWS CE + me-max + a detached-encoder classification loss. Optimized with
optax's LARS (trust 0.001) for weights and SGD-momentum for biases and
norm / BN parameters, as ``train/optim.py`` writes them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from vittf_tpu_torch.models.cnn3d import (
    FeatureExtractorConfig,
    PAWSNetConfig,
    _mlp_head,
    feature_extractor_forward,
    init_pawsnet,
    pawsnet_forward,
)
from vittf_tpu_torch.train import optim
from vittf_tpu_torch.train.gather import gather_receptive_fields
from vittf_tpu_torch.train.losses import paws_draws, paws_loss, transform_paws_crops
from vittf_tpu_torch.utils.tensor import resolve_device


@dataclass(frozen=True)
class PAWSConfig:
    model: PAWSNetConfig = PAWSNetConfig(in_dim=1, conv_layers=(8, 16, 32, 64))
    supports_per_class: int = 8  # M
    batch_size: int = 16  # BS unlabeled anchors
    learning_rate: float = 0.1
    weight_decay: float = 1e-6
    trust_coefficient: float = 0.001
    schedule: str = "onecycle"
    iterations: int = 1000
    noise_std: float = 0.05

    @property
    def rec_field(self) -> int:
        return len(self.model.conv_layers) * 2 + 1


def _lars_label_fn(params):
    """'exclude' for biases and norm / BN parameters (reference LARS_exclude
    param group, old/train_semisup_sparse.py:131-137), read from each leaf's
    path: a norm's scale is ``norm.weight`` here, so the leaf name alone
    cannot tell it from a conv weight."""

    def label(path, _leaf):
        if "bias" in path:
            return "exclude"
        if any(k.startswith("bn") or k == "norm" for k in path):
            return "exclude"
        return "lars"

    return optim.tree_map_with_path(label, params)


def make_paws_optimizer(cfg: PAWSConfig, params) -> optim.Transform:
    """Copied as the JAX twin has it, without a small-iteration guard: the
    one-cycle schedule is NaN at every step for ``iterations`` ≤ 3."""
    if cfg.schedule == "onecycle":
        lr = optim.cosine_onecycle_schedule(cfg.iterations, cfg.learning_rate)
    elif cfg.schedule == "cosine":
        lr = optim.cosine_decay_schedule(cfg.learning_rate, cfg.iterations)
    else:
        lr = cfg.learning_rate
    lars = optim.lars(lr, weight_decay=cfg.weight_decay,
                      trust_coefficient=cfg.trust_coefficient, momentum=0.9)
    sgd = optim.sgd(lr, momentum=0.9)
    return optim.multi_transform({"lars": lars, "exclude": sgd},
                                 optim.tree_leaves(_lars_label_fn(params)))


def paws_train_step(params, bn_state, opt_state, vol4, sup_centers, anc_centers, draws,
                    cfg: PAWSConfig, opt, num_classes: int):
    """sup_centers (C·M, 3) class-blocked; anc_centers (BS, 3) unlabeled.
    ``params`` updated in place; returns (params, bn_state, opt_state, aux)
    with aux detached."""
    M = cfg.supports_per_class
    BS = anc_centers.shape[0]
    sup_crops = gather_receptive_fields(vol4, sup_centers, ks=cfg.rec_field)
    anc_crops = gather_receptive_fields(vol4, anc_centers, ks=cfg.rec_field)
    anc_crops = transform_paws_crops(anc_crops, draws, noise_std=cfg.noise_std)
    crops = torch.cat([sup_crops, anc_crops], dim=0)
    # support labels class-BLOCKED to match sup_centers' layout (the
    # reference's class-cycling labels mismatch its crops whenever M > 1;
    # corrected in the JAX twin, kept corrected here)
    label = torch.repeat_interleave(torch.eye(num_classes, dtype=crops.dtype, device=crops.device),
                                    M, dim=0)

    def loss_fn(p):
        (feat, pred, clas), new_bn = pawsnet_forward(p, bn_state, crops, cfg.model, train=True,
                                                     return_class_pred=True)
        nsup = sup_crops.shape[0]
        sup_anc = pred[:nsup]
        anc = pred[nsup:]
        sup_pos = feat[:nsup].detach()
        pos = feat[nsup:].detach()
        pos = torch.cat([pos[BS:], pos[:BS]], dim=0)  # swap the views
        ploss, memax, clas_loss = paws_loss(anc, sup_anc, label, pos, sup_pos, label,
                                            clas_pred=clas)
        loss = ploss + memax + clas_loss
        return loss, ({"paws": ploss, "memax": memax, "clas": clas_loss, "loss": loss}, new_bn)

    opt_state, _, (aux, new_bn) = optim.update_step(opt, opt_state, params, loss_fn)
    return params, new_bn, opt_state, {k: v.detach() for k, v in aux.items()}


class PAWSTrainer:
    """Host driver: class / unlabeled sampling + PAWS steps on ``device``
    (the first CUDA device when None). ``params`` / ``bn_state`` (this
    package's layout) replace the seeded init."""

    def __init__(self, vol, mask, labels: list[str], cfg: PAWSConfig = PAWSConfig(),
                 seed: int = 0, unlabeled_value: int | None = None, device=None, params=None,
                 bn_state=None):
        self.cfg = cfg
        self.labels = labels
        self.num_classes = len(labels)
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.vol4 = torch.as_tensor(vol, dtype=torch.float32).to(self.device)[None]
        mask = np.asarray(mask)
        unl = self.num_classes if unlabeled_value is None else unlabeled_value
        self.class_indices = [np.argwhere(mask == i) for i in range(self.num_classes)]
        self.unlabeled_indices = np.argwhere(mask == unl)
        if self.unlabeled_indices.shape[0] == 0:
            self.unlabeled_indices = np.argwhere(np.ones_like(mask, bool))
        if params is None:
            params, bn_state = init_pawsnet(cfg.model, torch.Generator().manual_seed(seed),
                                            self.device)
        self.params = optim.trainable(params, self.device)
        self.bn_state = optim.tree_map_with_path(lambda _, t: t.to(self.device), bn_state)
        self.opt = make_paws_optimizer(cfg, self.params)
        self.opt_state = self.opt.init(optim.tree_leaves(self.params))
        self.generator = torch.Generator().manual_seed(seed + 1)
        self.history: list[dict] = []

    def step(self, draws: dict | None = None) -> dict:
        """One step; ``draws`` fixes the anchors' augmentation
        (``paws_draws`` of shape (batch, C_in, k, k, k)), else they are drawn
        from ``self.generator``."""
        M = self.cfg.supports_per_class
        sup = np.concatenate([idx[self.rng.choice(idx.shape[0], M)]
                              for idx in self.class_indices])
        anc = self.unlabeled_indices[
            self.rng.choice(self.unlabeled_indices.shape[0], self.cfg.batch_size)]
        if draws is None:
            k = self.cfg.rec_field
            draws = paws_draws((self.cfg.batch_size, self.vol4.shape[0], k, k, k),
                               self.generator, self.device)
        self.params, self.bn_state, self.opt_state, aux = paws_train_step(
            self.params, self.bn_state, self.opt_state, self.vol4,
            torch.from_numpy(sup).to(self.device), torch.from_numpy(anc).to(self.device), draws,
            self.cfg, self.opt, self.num_classes,
        )
        rec = {k: float(v) for k, v in aux.items()}
        self.history.append(rec)
        return rec

    @torch.no_grad()
    def predict_dense(self, vol=None) -> torch.Tensor:
        """Full-volume class prediction via the classification head
        (PAWSNet.forward_fullvol, old/models.py:121-126)."""
        v = self.vol4 if vol is None else torch.as_tensor(vol, dtype=torch.float32).to(
            self.device)[None]
        pad = self.cfg.rec_field // 2
        enc_cfg = FeatureExtractorConfig(self.cfg.model.in_dim, self.cfg.model.conv_layers,
                                         (self.cfg.model.conv_layers[-1],))
        z = feature_extractor_forward(self.params["encoder"], F.pad(v[None], (pad,) * 6),
                                      enc_cfg)[0]  # (NF, Z, Y, X)
        zz = z.movedim(0, -1).reshape(-1, z.shape[0])
        logits, _ = _mlp_head(zz, self.params["predict"], self.bn_state["predict"],
                              ["bn0", "fc1", "bn1", "mish", "fc2"], train=False)
        return logits.reshape(*z.shape[1:], -1).argmax(-1)
