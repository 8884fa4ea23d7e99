"""Linear / MLP probes on frozen DINO features
(reference old/compare_feat_sampling_mlp.py and its ``_wbg`` variant).

Port of ``vittf_tpu/train/probe.py``. A small head is trained on features
sampled at annotation voxels with BCE against one-hot class targets; dense
prediction argmaxes sigmoid scores with an optional background-rejection
threshold (all sigmoids < 0.5 → bg). The twin's ``optax.adamw`` is
``torch.optim.AdamW`` with every argument given (their defaults differ).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from vittf_tpu_torch.utils.tensor import resolve_device


@dataclass(frozen=True)
class ProbeConfig:
    hidden: tuple = ()  # () = linear probe; e.g. (256,) = MLP (_wbg variant)
    learning_rate: float = 5e-4
    weight_decay: float = 1e-2
    epochs: int = 5
    batch_size: int = 32
    bg_threshold: float = 0.5


def init_probe(cfg: ProbeConfig, in_dim: int, num_classes: int,
               generator: torch.Generator | None = None, device=None) -> list[dict]:
    """Layers {weight (out, in), bias (out,)}, uniform in ±1/sqrt(in)."""
    device = resolve_device(device)
    dims = (in_dim,) + tuple(cfg.hidden) + (num_classes,)
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = (1.0 / a) ** 0.5
        w, bias = (((torch.rand(s, generator=generator) * 2.0 - 1.0) * bound).to(device)
                   for s in ((b, a), (b,)))
        params.append({"weight": w, "bias": bias})
    return params


def probe_forward(params, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = F.linear(x, layer["weight"], layer["bias"])
        if i < len(params) - 1:
            x = F.relu(x)
    return x


def bce_loss(params, x: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(probe_forward(params, x), y_onehot)


class ProbeTrainer:
    """Train a probe head on (N, F) sampled features with class ids (N,).

    ``params`` (this layout) replaces the seeded init, e.g. to start from
    the JAX twin's (``models.cnn3d.params_from_jax`` converts them);
    batches follow ``np.random.default_rng(seed)``'s permutations, as in the
    twin.
    """

    def __init__(self, in_dim: int, num_classes: int, cfg: ProbeConfig = ProbeConfig(),
                 seed: int = 0, device=None, params: list[dict] | None = None):
        self.cfg = cfg
        self.num_classes = num_classes
        self.device = resolve_device(device)
        if params is None:
            params = init_probe(cfg, in_dim, num_classes, torch.Generator().manual_seed(seed),
                                self.device)
        self.params = [{k: v.detach().clone().to(self.device).requires_grad_(True)
                        for k, v in layer.items()} for layer in params]
        self.opt = torch.optim.AdamW([p for layer in self.params for p in layer.values()],
                                     lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)
        self.rng = np.random.default_rng(seed)

    def _step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        loss = bce_loss(self.params, x, y)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def fit(self, feats, labels) -> list[float]:
        """``cfg.epochs`` passes over (N, F) features in batches; the loss of
        each step."""
        feats = torch.as_tensor(np.asarray(feats, np.float32)).to(self.device)
        y = torch.eye(self.num_classes, device=self.device)[
            torch.as_tensor(np.asarray(labels, np.int64)).to(self.device)]
        n = feats.shape[0]
        losses = []
        for _ in range(self.cfg.epochs):
            order = torch.from_numpy(self.rng.permutation(n)).to(self.device)
            for i in range(0, n, self.cfg.batch_size):
                sel = order[i:i + self.cfg.batch_size]
                losses.append(self._step(feats[sel], y[sel]))
        return [float(v) for v in losses]

    @torch.no_grad()
    def predict_dense(self, feat_vol: torch.Tensor) -> torch.Tensor:
        """(F, W, H, D) → (W, H, D) labels: argmax+1 over sigmoids, with
        background where every class sigmoid < bg_threshold."""
        feat_vol = torch.as_tensor(feat_vol).to(self.device)
        flat = feat_vol.movedim(0, -1).reshape(-1, feat_vol.shape[0])
        probs = torch.sigmoid(probe_forward(self.params, flat))
        pred = torch.argmax(probs, dim=-1) + 1
        bg = probs.max(dim=-1).values < self.cfg.bg_threshold
        return torch.where(bg, 0, pred).reshape(feat_vol.shape[1:])
