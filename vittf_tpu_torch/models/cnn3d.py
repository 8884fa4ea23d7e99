"""3D CNN feature extractors for the trainer layer (reference old/models.py).

Port of ``vittf_tpu/models/cnn3d.py``, as plain functions on parameter
trees in torch's layout (Conv3d weights (out, in, k, k, k), linear weights
(out, in), norm affines ``weight`` / ``bias``):
- ``FeatureExtractor``: stacks of unpadded 3³ Conv3d + GroupNorm(n/4) +
  Mish, then 1³ "linear" convs, optional center-crop residual concat
  (old/models.py:26-81)
- ``PAWSNet``: encoder + BatchNorm/Linear projection, prediction and
  classification heads (old/models.py:84-129)

BatchNorm in the PAWS heads uses batch statistics in training mode and
running averages at eval, carried in an explicit ``state`` tree
(``mean`` / ``var``). ``params_from_jax`` turns the JAX twin's trees into
these. Inits draw from a ``torch.Generator`` (the bounds of torch's own
Conv3d / Linear init), not the JAX twin's bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from vittf_tpu_torch.utils.tensor import resolve_device


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _conv3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, C, Z, Y, X); weight (out, in, k, k, k); VALID padding."""
    return F.conv3d(x, weight, bias)


def group_norm(x, weight, bias, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """torch GroupNorm on (B, C, Z, Y, X)."""
    return F.group_norm(x, num_groups, weight, bias, eps)


@dataclass(frozen=True)
class FeatureExtractorConfig:
    in_dim: int = 1
    n_features: tuple = (8, 16, 32)
    n_linear: tuple = (32,)
    residual: bool = False
    norm: str = "group"  # 'group' | 'none' (the reference's pluggable Norm)

    @property
    def crop_per_side(self) -> int:
        # CenterCrop(ks=2·len(n_features)) → pad = len(n_features) per side
        return len(self.n_features)


def _uniform(shape, bound: float, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(device)


def _init_conv(gen, k, n_in, n_out, device):
    bound = (1.0 / (n_in * k**3)) ** 0.5  # torch Conv3d default init bounds
    return {"weight": _uniform((n_out, n_in, k, k, k), bound, gen, device),
            "bias": _uniform((n_out,), bound, gen, device)}


def _init_layer(gen, k, n_in, n_out, device):
    return {"conv": _init_conv(gen, k, n_in, n_out, device),
            "norm": {"weight": torch.ones(n_out, device=device),
                     "bias": torch.zeros(n_out, device=device)}}


def init_feature_extractor(cfg: FeatureExtractorConfig, generator: torch.Generator | None = None,
                           device=None) -> dict:
    device = resolve_device(device)
    feats = (cfg.in_dim,) + tuple(cfg.n_features)
    # the reference computes last_in as n_linear[-2] (old/models.py:63-66),
    # which only type-checks when n_linear[-2] == n_linear[-1]; the JAX twin
    # takes the actual lins output, valid everywhere the reference runs
    if cfg.residual:
        lin_in = cfg.n_features[-1] + cfg.in_dim
        last_in = cfg.n_linear[-1] + cfg.in_dim
    else:
        lin_in = cfg.n_features[-1]
        last_in = cfg.n_linear[-1]
    lins = (lin_in,) + tuple(cfg.n_linear)
    return {
        "convs": [_init_layer(generator, 3, a, b, device) for a, b in zip(feats, feats[1:])],
        "lins": [_init_layer(generator, 1, a, b, device) for a, b in zip(lins[:-1], lins[1:])],
        "last": _init_conv(generator, 1, last_in, cfg.n_linear[-1], device),
    }


def feature_extractor_forward(params: dict, x: torch.Tensor,
                              cfg: FeatureExtractorConfig) -> torch.Tensor:
    """(B, C_in, Z, Y, X) → (B, F, Z', Y', X'), spatial shrink 2 a conv layer."""

    def layer(x, p):
        y = _conv3d(x, p["conv"]["weight"], p["conv"]["bias"])
        if cfg.norm == "group":
            n_out = p["conv"]["weight"].shape[0]
            y = group_norm(y, p["norm"]["weight"], p["norm"]["bias"], n_out // 4)
        return mish(y)

    y = x
    for p in params["convs"]:
        y = layer(y, p)
    if cfg.residual:
        i = cfg.crop_per_side
        skip = x[..., i:-i, i:-i, i:-i]
        y = torch.cat([skip, y], dim=1)
        for p in params["lins"]:
            y = layer(y, p)
        y = torch.cat([skip, y], dim=1)
    else:
        for p in params["lins"]:
            y = layer(y, p)
    return _conv3d(y, params["last"]["weight"], params["last"]["bias"])


# ---------------- PAWSNet ----------------

@dataclass(frozen=True)
class PAWSNetConfig:
    in_dim: int = 1
    conv_layers: tuple = (8, 16, 32)
    hidden_sz: int = 128
    out_classes: int = 3
    head_bottleneck: int = 4


def _init_linear(gen, n_in, n_out, device):
    bound = (1.0 / n_in) ** 0.5
    return {"weight": _uniform((n_out, n_in), bound, gen, device),
            "bias": _uniform((n_out,), bound, gen, device)}


def _init_bn(n, device):
    return {"weight": torch.ones(n, device=device), "bias": torch.zeros(n, device=device)}


def _init_bn_state(n, device):
    return {"mean": torch.zeros(n, device=device), "var": torch.ones(n, device=device)}


def init_pawsnet(cfg: PAWSNetConfig, generator: torch.Generator | None = None, device=None):
    """(params, BatchNorm state) of a PAWSNet."""
    device = resolve_device(device)
    NF, NH = cfg.conv_layers[-1], cfg.hidden_sz
    NB = NH // cfg.head_bottleneck
    enc_cfg = FeatureExtractorConfig(cfg.in_dim, cfg.conv_layers, (NF,))
    g = generator
    params = {
        "encoder": init_feature_extractor(enc_cfg, g, device),
        "head": {"bn0": _init_bn(NF, device), "fc1": _init_linear(g, NF, NB, device),
                 "bn1": _init_bn(NB, device), "fc2": _init_linear(g, NB, NF, device)},
        "proj": {"bn0": _init_bn(NF, device), "fc1": _init_linear(g, NF, NH, device),
                 "bn1": _init_bn(NH, device), "fc2": _init_linear(g, NH, NH, device),
                 "bn2": _init_bn(NH, device), "fc3": _init_linear(g, NH, NF, device)},
        "predict": {"bn0": _init_bn(NF, device), "fc1": _init_linear(g, NF, NH, device),
                    "bn1": _init_bn(NH, device),
                    "fc2": _init_linear(g, NH, cfg.out_classes, device)},
    }
    state = {
        "head": {"bn0": _init_bn_state(NF, device), "bn1": _init_bn_state(NB, device)},
        "proj": {"bn0": _init_bn_state(NF, device), "bn1": _init_bn_state(NH, device),
                 "bn2": _init_bn_state(NH, device)},
        "predict": {"bn0": _init_bn_state(NF, device), "bn1": _init_bn_state(NH, device)},
    }
    return params, state


def _batch_norm(x, p, s, train: bool, momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm1d over (B, C) by hand: ``F.batch_norm`` refuses one value
    per channel in training, where the twin takes max(n − 1, 1). Running
    stats follow torch's rule (unbiased variance in the stats, biased in the
    normalization) and carry no gradient."""
    if train:
        mu = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
        n = x.shape[0]
        new_s = {"mean": (1 - momentum) * s["mean"] + momentum * mu.detach(),
                 "var": (1 - momentum) * s["var"] + momentum * var.detach() * n / max(n - 1, 1)}
    else:
        mu, var, new_s = s["mean"], s["var"], s
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * p["weight"] + p["bias"], new_s


def _mlp_head(x, p, s, order, train: bool):
    """Run a bn/fc sequence given its layer order, threading BN state."""
    new_s = dict(s)
    for name in order:
        if name.startswith("bn"):
            x, new_s[name] = _batch_norm(x, p[name], s[name], train)
        elif name.startswith("fc"):
            x = F.linear(x, p[name]["weight"], p[name]["bias"])
        elif name == "mish":
            x = mish(x)
    return x, new_s


def pawsnet_forward(params, state, x, cfg: PAWSNetConfig, train: bool = True,
                    return_class_pred: bool = False):
    """x (B, C, k, k, k) crops sized so the encoder reduces to 1³. Returns
    ((feat, pred[, clas]), new_state); the class head sees the encoder's
    output without its gradient."""
    enc_cfg = FeatureExtractorConfig(cfg.in_dim, cfg.conv_layers, (cfg.conv_layers[-1],))
    z = feature_extractor_forward(params["encoder"], x, enc_cfg)
    z = z.reshape(z.shape[0], z.shape[1])  # (B, NF)
    feat, s_proj = _mlp_head(z, params["proj"], state["proj"],
                             ["bn0", "fc1", "bn1", "mish", "fc2", "bn2", "mish", "fc3"], train)
    pred, s_head = _mlp_head(feat, params["head"], state["head"],
                             ["bn0", "fc1", "bn1", "mish", "fc2"], train)
    new_state = {"proj": s_proj, "head": s_head, "predict": state["predict"]}
    if return_class_pred:
        clas, s_pred = _mlp_head(z.detach(), params["predict"], state["predict"],
                                 ["bn0", "fc1", "bn1", "mish", "fc2"], train)
        new_state["predict"] = s_pred
        return (feat, pred, clas), new_state
    return (feat, pred), new_state


def params_from_jax(tree, device="cpu", dtype=np.float32):
    """A JAX parameter or state tree of the trainer layer (numpy leaves: this
    module's, or ``train.probe``'s layers) → torch's layout in ``dtype``:
    conv kernels (k, k, k, in, out) → (out, in, k, k, k), linear kernels
    (in, out) → (out, in), ``kernel`` / ``scale`` → ``weight``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "kernel":
                w = torch.from_numpy(np.array(v, dtype=dtype))
                w = w.permute(4, 3, 0, 1, 2) if w.ndim == 5 else w.T
                out["weight"] = w.contiguous().to(device)
            else:
                out["weight" if k == "scale" else k] = params_from_jax(v, device, dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=dtype)).to(device)
