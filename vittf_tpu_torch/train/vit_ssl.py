"""Brief token-level self-supervision for the port's ViT on volume slices.

Port of ``vittf_tpu/train/vit_ssl.py``: two noise / intensity-augmented
views of each slice, and a token loss on the last block's k projection (the
tensor extraction harvests): symmetric token InfoNCE ('infonce'), an
EMA-teacher prototype distillation ('dino') or label-supervised token
contrast ('supcon'). The JAX module's docstring has the why of each.

The ViT's parameters are a hub-layout ``state_dict`` (name → tensor), run
through ``VisionTransformer.forward`` (the trainable forward, plain
attention: the attention kernel has no backward) by
``torch.func.functional_call``; the DINO head is a dict of the JAX twin's
matrices in its (in, out) layout. ``optax.adamw`` is ``torch.optim.AdamW``
with every argument given (one group over the whole tree; a leaf the loss
does not reach gets a zero gradient and still decays, as under
``jax.grad``). The random draws of a step are inputs
(``augment_draws``, ``head_draws``), drawn in the training loop from a
``torch.Generator(seed + 1)`` on the host: JAX draws them from threefry
keys, whose bits torch cannot draw. The host draws of ``_slice_batch``
(``np.random.default_rng(seed)``) are the JAX twin's, in its order.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from vittf_tpu_torch.models.vit import ViTConfig, VisionTransformer, split_qkv
from vittf_tpu_torch.pipeline.features import _DTYPES
from vittf_tpu_torch.train.optim import trainable, tree_leaves, tree_map_with_path
from vittf_tpu_torch.utils.tensor import ieee_matmul, resolve_device


@dataclass(frozen=True)
class ViTSelfSupConfig:
    im_sz: int = 64  # token grid = im_sz / patch_size per side
    batch_slices: int = 16
    noise_sigma: float = 0.08
    # intensity view: x ** (1 ± jitter·u); the oracle runs with 0 (the
    # phantom's classes are intensity bands)
    gamma_jitter: float = 0.3
    temperature: float = 0.1
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    steps: int = 400
    feature_key: str = "k"  # which qkv third the loss trains (extraction default)
    compute_dtype: str = "float32"
    # positive pairs: 'aug' = two views of the same slice; 'adjacent' = views
    # of neighbouring slices (same token position)
    pair_mode: str = "aug"
    method: str = "infonce"  # 'infonce' | 'dino' | 'supcon'
    proto_k: int = 64        # prototype count (dino)
    proj_dim: int = 256      # head hidden width (dino)
    bottleneck_dim: int = 64  # l2-normed bottleneck before prototypes
    teacher_temp: float = 0.04
    student_temp: float = 0.1
    ema: float = 0.996       # teacher momentum
    center_ema: float = 0.9  # prototype-logit center momentum


#: The JAX twin's pilot-selected oracle preset (DINO, no gamma jitter,
#: adjacent-slice positives).
VIT_SSL_ORACLE = dict(
    method="dino", gamma_jitter=0.0, pair_mode="adjacent",
    noise_sigma=0.05, steps=1500, learning_rate=1e-3,
)


def augment_draws(gen: torch.Generator, shape, cfg: ViTSelfSupConfig) -> dict:
    """The draws of one ``_augment`` view on the host: ``gamma`` (B, 1, 1, 1)
    uniform in [-1, 1) (None without gamma jitter) and ``noise`` of the
    batch's shape, standard normal (JAX: ``uniform`` / ``normal`` on the
    view key's two halves)."""
    gamma = None
    if cfg.gamma_jitter > 0.0:
        gamma = torch.rand((shape[0], 1, 1, 1), generator=gen) * 2.0 - 1.0
    return {"gamma": gamma, "noise": torch.randn(tuple(shape), generator=gen)}


def head_draws(gen: torch.Generator, dim: int, cfg: ViTSelfSupConfig) -> dict:
    """The DINO head's standard-normal draws: ``w1`` (dim, proj_dim), ``w2``
    (proj_dim, bottleneck_dim), ``protos`` (proto_k, bottleneck_dim)."""
    return {
        "w1": torch.randn((dim, cfg.proj_dim), generator=gen),
        "w2": torch.randn((cfg.proj_dim, cfg.bottleneck_dim), generator=gen),
        "protos": torch.randn((cfg.proto_k, cfg.bottleneck_dim), generator=gen),
    }


def _augment(draws: dict, batch: torch.Tensor, cfg: ViTSelfSupConfig) -> torch.Tensor:
    """One stochastic view: gamma intensity warp + gaussian noise."""
    x = torch.clamp(batch, 0.0, 1.0)
    if cfg.gamma_jitter > 0.0:
        x = x ** (1.0 + cfg.gamma_jitter * draws["gamma"].to(batch.device))
    return x + cfg.noise_sigma * draws["noise"].to(batch.device)


@functools.lru_cache(maxsize=None)
def _skeleton(vit_cfg: ViTConfig) -> VisionTransformer:
    """A parameterless module for ``functional_call`` (its parameters live
    on the meta device; every call supplies them all)."""
    with torch.device("meta"):
        return VisionTransformer(vit_cfg)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _token_features(params: dict, images: torch.Tensor, vit_cfg: ViTConfig,
                    cfg: ViTSelfSupConfig) -> torch.Tensor:
    """(B, 1, H, W) grayscale → (B, hw, D) unit-norm k-token features."""
    dtype = _DTYPES[cfg.compute_dtype]
    rgb = images.repeat_interleave(3, dim=1)
    p = {k: v.to(dtype) for k, v in params.items()}
    _, qkv = torch.func.functional_call(
        _skeleton(vit_cfg), p, (rgb.to(dtype),),
        {"return_qkv_last": True, "capture": "qkv", "stop_after_capture": True},
    )
    idx = {"q": 0, "k": 1, "v": 2}[cfg.feature_key]
    # drop CLS and any registers
    return _l2_normalize(split_qkv(qkv, vit_cfg.num_heads)[idx][:, vit_cfg.prefix_tokens:])


def _init_dino_head(draws: dict, dim: int, cfg: ViTSelfSupConfig) -> dict:
    """DINO projection head: dim → proj_dim (GELU) → bottleneck (l2-norm) →
    K unit-norm prototypes, from ``head_draws``. Discarded after training."""
    s1 = 1.0 / np.sqrt(dim)
    s2 = 1.0 / np.sqrt(cfg.proj_dim)
    return {
        "w1": draws["w1"] * s1,
        "b1": torch.zeros((cfg.proj_dim,), dtype=draws["w1"].dtype),
        "w2": draws["w2"] * s2,
        "b2": torch.zeros((cfg.bottleneck_dim,), dtype=draws["w2"].dtype),
        "protos": _l2_normalize(draws["protos"]),
    }


def _dino_logits(head: dict, feats: torch.Tensor) -> torch.Tensor:
    """(..., D) token features → (..., K) prototype logits (cosine)."""
    # jax.nn.gelu is the tanh approximation by default
    h = F.gelu(feats @ head["w1"] + head["b1"], approximate="tanh")
    z = _l2_normalize(h @ head["w2"] + head["b2"])
    return z @ _l2_normalize(head["protos"]).T


def make_optimizer(params, cfg: ViTSelfSupConfig) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=wd)``: one group over every leaf."""
    return torch.optim.AdamW(tree_leaves(params), lr=cfg.learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.weight_decay)


def _adamw_step(opt: torch.optim.AdamW, params, loss_fn) -> torch.Tensor:
    """``loss_fn(params)``, its gradient for every leaf (zeros where the loss
    does not reach, as ``jax.grad`` gives) and one AdamW update in place."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    for p, g in zip(leaves, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def _supcon_step(params, opt, batch, tok_labels, draws, vit_cfg: ViTConfig,
                 cfg: ViTSelfSupConfig):
    """One supervised-contrastive step on the token grid (method='supcon'):
    every same-class token in the batch is a positive, the rest negatives.
    ``tok_labels`` (B, T) int: the class at each patch centre."""

    def loss_fn(p):
        f = _token_features(p, _augment(draws, batch, cfg), vit_cfg, cfg)
        B, T, D = f.shape
        z = f.reshape(B * T, D)
        y = tok_labels.reshape(-1)
        logits = z @ z.T / cfg.temperature
        eye = torch.eye(B * T, dtype=torch.bool, device=z.device)
        logits = logits.masked_fill(eye, float("-inf"))
        logp = torch.log_softmax(logits, dim=-1)
        pos = (y[:, None] == y[None, :]) & ~eye
        npos = pos.sum(-1)
        # where(pos, logp, 0): the -inf diagonal never reaches the sum or a gradient
        pos_sum = torch.where(pos, logp, torch.zeros_like(logp)).sum(-1)
        per_anchor = torch.where(npos > 0, -pos_sum / torch.clamp(npos, min=1),
                                 torch.zeros_like(pos_sum))
        return per_anchor.sum() / torch.clamp((npos > 0).sum(), min=1)

    loss = _adamw_step(opt, params, loss_fn)
    return params, opt, loss


def _ema_(teacher: dict, student: dict, m: float) -> None:
    """teacher ← m·teacher + (1 − m)·student over every leaf, in place,
    leaves paired by their keys."""
    for k, t in teacher.items():
        if isinstance(t, dict):
            _ema_(t, student[k], m)
        else:
            t.copy_(m * t + (1.0 - m) * student[k])


def _dino_step(student, teacher, opt, center, batch_a, batch_b, draws_a, draws_b,
               vit_cfg: ViTConfig, cfg: ViTSelfSupConfig):
    """One EMA-teacher token-distillation step (method='dino'): the teacher
    (frozen this step) sees the clean views, the student the augmented ones;
    cross-view CE with teacher sharpening and prototype-logit centering.
    Then the teacher's EMA over every leaf, head included, and the centre
    from the updated teacher. ``student`` and ``teacher`` are updated in
    place; returns (student, teacher, opt, center, loss)."""

    def teacher_probs(batch):
        f = _token_features(teacher["vit"], batch, vit_cfg, cfg)
        logits = _dino_logits(teacher["head"], f)
        return torch.softmax((logits - center) / cfg.teacher_temp, dim=-1)

    with torch.no_grad():
        pa_t = teacher_probs(batch_a)
        pb_t = teacher_probs(batch_b)

    def loss_fn(sp):
        la = _dino_logits(sp["head"], _token_features(
            sp["vit"], _augment(draws_a, batch_a, cfg), vit_cfg, cfg))
        lb = _dino_logits(sp["head"], _token_features(
            sp["vit"], _augment(draws_b, batch_b, cfg), vit_cfg, cfg))
        ce_ab = -(pb_t * torch.log_softmax(la / cfg.student_temp, -1)).sum(-1)
        ce_ba = -(pa_t * torch.log_softmax(lb / cfg.student_temp, -1)).sum(-1)
        return 0.5 * (ce_ab.mean() + ce_ba.mean())

    loss = _adamw_step(opt, student, loss_fn)
    with torch.no_grad():
        _ema_(teacher, student, cfg.ema)
        batch_center = torch.cat([
            _dino_logits(teacher["head"], _token_features(teacher["vit"], b, vit_cfg, cfg))
            .reshape(-1, cfg.proto_k) for b in (batch_a, batch_b)
        ]).mean(0)
        center = cfg.center_ema * center + (1.0 - cfg.center_ema) * batch_center
    return student, teacher, opt, center, loss


def _ssl_step(params, opt, batch_a, batch_b, draws_a, draws_b, vit_cfg: ViTConfig,
              cfg: ViTSelfSupConfig):
    """(B, 1, H, W) view pairs in [0, 1] → symmetric InfoNCE over same-token
    pairs; every other token of the batch is a negative."""

    def loss_fn(p):
        fa = _token_features(p, _augment(draws_a, batch_a, cfg), vit_cfg, cfg)
        fb = _token_features(p, _augment(draws_b, batch_b, cfg), vit_cfg, cfg)
        B, T, D = fa.shape
        fa = fa.reshape(B * T, D)
        fb = fb.reshape(B * T, D)
        logits = fa @ fb.T / cfg.temperature  # (BT, BT)
        l1 = -torch.log_softmax(logits, dim=-1).diagonal().mean()
        l2 = -torch.log_softmax(logits.T, dim=-1).diagonal().mean()
        return 0.5 * (l1 + l2)

    loss = _adamw_step(opt, params, loss_fn)
    return params, opt, loss


def _slice_batch(
    vol: np.ndarray,
    cfg: ViTSelfSupConfig,
    rng: np.random.Generator,
    labels: np.ndarray | None = None,
    patch: int = 8,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Two (B, 1, im_sz, im_sz) positive-view batches of random-axis slices
    (+ optional (B, T) per-token labels of view a, for method='supcon').

    pair_mode='aug' returns the same slices twice (views differ only by
    augmentation); 'adjacent' pairs each slice with its axis-neighbor, so
    positives share content but not the exact plane. Token labels are the
    nearest label pixel at each patch center."""
    S = vol.shape
    out_a = np.empty((cfg.batch_slices, 1, cfg.im_sz, cfg.im_sz), np.float32)
    out_b = np.empty_like(out_a)
    tg = cfg.im_sz // patch
    tok = (
        np.empty((cfg.batch_slices, tg * tg), np.int32)
        if labels is not None
        else None
    )
    for b in range(cfg.batch_slices):
        ax = int(rng.integers(0, 3))
        i = int(rng.integers(0, S[ax] - 1))
        j = i + 1 if cfg.pair_mode == "adjacent" else i
        for out, idx in ((out_a, i), (out_b, j)):
            sl = np.take(vol, idx, axis=ax)
            iy = (np.arange(cfg.im_sz) * sl.shape[0]) // cfg.im_sz
            ix = (np.arange(cfg.im_sz) * sl.shape[1]) // cfg.im_sz
            out[b, 0] = sl[np.ix_(iy, ix)]
        if tok is not None:
            lsl = np.take(labels, i, axis=ax)
            # patch-center pixel in im_sz coords → nearest source pixel
            cy = (np.arange(tg) * patch + patch // 2) * lsl.shape[0] // cfg.im_sz
            cx = (np.arange(tg) * patch + patch // 2) * lsl.shape[1] // cfg.im_sz
            tok[b] = lsl[np.ix_(cy, cx)].reshape(-1).astype(np.int32)
    lo = min(out_a.min(), out_b.min())
    hi = max(out_a.max(), out_b.max())
    scale = max(hi - lo, 1e-12)
    return (out_a - lo) / scale, (out_b - lo) / scale, tok


def train_vit_selfsup(
    vol: np.ndarray,
    params: dict,
    vit_cfg: ViTConfig,
    cfg: ViTSelfSupConfig = ViTSelfSupConfig(),
    seed: int = 0,
    log_every: int = 100,
    labels: np.ndarray | None = None,
    device=None,
) -> tuple[dict, list]:
    """Train ``params`` (a hub-layout ``state_dict``) on slices of ``vol`` on
    ``device`` (the first CUDA device when None); returns (state_dict, loss
    history). The returned ``state_dict`` (detached, on ``device``) plugs
    straight into ``pipeline.features.extract_features``. ``labels`` is
    required for (and only used by) method='supcon'; method='dino' returns
    the teacher's backbone."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    vol = np.asarray(vol, np.float32)
    history = []

    def put(a):
        return torch.from_numpy(a).to(device)

    def logged(step, loss):
        if step % log_every == 0 or step == cfg.steps - 1:
            history.append({"step": step, "loss": float(loss)})

    def frozen(tree):
        return {k: v.detach() for k, v in tree.items()}

    with ieee_matmul():
        if cfg.method == "supcon":
            if labels is None:
                raise ValueError("method='supcon' needs the labels volume")
            labels = np.asarray(labels)
            params = trainable(params, device)
            opt = make_optimizer(params, cfg)
            for step in range(cfg.steps):
                ba, _, tok = _slice_batch(vol, cfg, rng, labels=labels,
                                          patch=vit_cfg.patch_size)
                draws = augment_draws(gen, ba.shape, cfg)
                params, opt, loss = _supcon_step(params, opt, put(ba), put(tok), draws,
                                                 vit_cfg, cfg)
                logged(step, loss)
            return frozen(params), history

        if cfg.method == "dino":
            head = _init_dino_head(head_draws(gen, vit_cfg.embed_dim, cfg), vit_cfg.embed_dim,
                                   cfg)
            student = trainable({"vit": params, "head": head}, device)
            teacher = tree_map_with_path(lambda _, t: t.detach().clone(), student)
            center = torch.zeros((cfg.proto_k,), dtype=head["protos"].dtype, device=device)
            opt = make_optimizer(student, cfg)
            for step in range(cfg.steps):
                ba, bb, _ = _slice_batch(vol, cfg, rng)
                da, db = augment_draws(gen, ba.shape, cfg), augment_draws(gen, bb.shape, cfg)
                student, teacher, opt, center, loss = _dino_step(
                    student, teacher, opt, center, put(ba), put(bb), da, db, vit_cfg, cfg)
                logged(step, loss)
            # the teacher backbone is the oracle (the DINO convention)
            return frozen(teacher["vit"]), history

        params = trainable(params, device)
        opt = make_optimizer(params, cfg)
        for step in range(cfg.steps):
            ba, bb, _ = _slice_batch(vol, cfg, rng)
            da, db = augment_draws(gen, ba.shape, cfg), augment_draws(gen, bb.shape, cfg)
            params, opt, loss = _ssl_step(params, opt, put(ba), put(bb), da, db, vit_cfg, cfg)
            logged(step, loss)
        return frozen(params), history
