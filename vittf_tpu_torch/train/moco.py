"""MoCo for volumes: momentum key encoder + negative queue
(reference old/moco.py, the DDP-era module rewritten functionally).

Port of ``vittf_tpu/train/moco.py``. State = {params_q, params_k, queue
(F, K), queue_ptr}; ``moco_loss_and_new_state`` computes the InfoNCE loss
against the queue, updates the key encoder by EMA and enqueues the new keys.
Parameter trees are nested dicts / lists of tensors; the queue pointer is a
Python int.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from vittf_tpu_torch.utils.tensor import resolve_device


@dataclass(frozen=True)
class MoCoConfig:
    dim: int = 128
    K: int = 65536
    m: float = 0.999
    T: float = 0.07


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts / lists of the same structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def init_moco_state(params_q, cfg: MoCoConfig, generator: torch.Generator | None = None,
                    queue: torch.Tensor | None = None, device=None) -> dict:
    """The key encoder a copy of ``params_q``; the queue ``queue`` (F, K) or
    unit normals from ``generator``, each column scaled to unit length."""
    device = resolve_device(device)
    if queue is None:
        queue = torch.randn((cfg.dim, cfg.K), generator=generator)
    queue = torch.as_tensor(queue, dtype=torch.float32).to(device)
    return {
        "params_q": params_q,
        "params_k": tree_map(lambda p: p.detach().clone(), params_q),
        "queue": queue / torch.linalg.norm(queue, dim=0, keepdim=True),
        "queue_ptr": 0,
    }


@torch.no_grad()
def momentum_update(params_q, params_k, m: float):
    """EMA key-encoder update (old/moco.py:52-58)."""
    return tree_map(lambda k, q: k * m + q * (1.0 - m), params_k, params_q)


def dequeue_and_enqueue(queue: torch.Tensor, ptr: int, keys: torch.Tensor):
    """A copy of ``queue`` with columns from ``ptr`` replaced by the keys (F, B)
    (old/moco.py:60-75); K is meant to be a multiple of B (the reference's
    assertion). Like the twin's ``dynamic_update_slice`` the start is
    clamped so that the keys fit. Returns (queue, (ptr + B) % K)."""
    B, K = keys.shape[1], queue.shape[1]
    start = min(max(int(ptr), 0), K - B)
    out = queue.clone()
    out[:, start:start + B] = keys
    return out, (int(ptr) + B) % K


def moco_logits(q_feats: torch.Tensor, k_feats: torch.Tensor, queue: torch.Tensor, T: float):
    """InfoNCE logits: positives from the key encoder, negatives from the queue.

    q_feats / k_feats: (B, F, S) normalized per-sample features. Returns
    logits (B·S, 1+K) with label 0 (old/moco.py:105-125).
    """
    l_pos = torch.einsum("bfs,bfs->bs", q_feats, k_feats)[..., None]
    l_neg = torch.einsum("bfs,fk->bsk", q_feats, queue)
    logits = torch.cat([l_pos, l_neg], dim=-1)
    return logits.reshape(-1, 1 + queue.shape[1]) / T


def moco_loss_and_new_state(state: dict, q_feats: torch.Tensor, k_feats: torch.Tensor,
                            cfg: MoCoConfig):
    """Loss + updated queue and key encoder. ``k_feats`` come from the key
    encoder and carry no gradient (the caller runs both encoders)."""
    k_feats = k_feats.detach()
    logits = moco_logits(q_feats, k_feats, state["queue"], cfg.T)
    loss = -F.log_softmax(logits, dim=-1)[:, 0].mean()
    to_enq = k_feats.movedim(1, 0).reshape(k_feats.shape[1], -1)
    new_queue, new_ptr = dequeue_and_enqueue(state["queue"], state["queue_ptr"], to_enq)
    new_state = {
        **state,
        "params_k": momentum_update(state["params_q"], state["params_k"], cfg.m),
        "queue": new_queue,
        "queue_ptr": new_ptr,
    }
    return loss, new_state
