"""Plain PyTorch feature extraction with a DINOv3 ViT: axial RoPE on q and k,
no position table, storage tokens, SwiGLU FFN, LayerScale.

The reference for ``extract_features`` on a DINOv3 configuration, written
from the published model (facebookresearch/dinov3 ``models/
vision_transformer.py`` ``DinoVisionTransformer``, ``layers/
rope_position_encoding.py`` ``RopePositionEmbedding``, ``layers/attention.py``
``SelfAttention`` with ``rope_apply`` and ``rope_rotate_half``, ``layers/
ffn_layers.py`` ``SwiGLUFFN``, ``layers/block.py`` ``SelfAttentionBlock``,
``layers/layer_scale.py``), not from the program, with the published
``state_dict`` names (``storage_tokens``, ``mlp.w1`` / ``w2`` / ``w3``):

- ``prepare_tokens_with_masks``: stride-P patch conv, then [CLS, storage
  tokens, patches in row-major (h, w)], no position table;
- ``RopePositionEmbedding`` in eval mode, ``normalize_coords='separate'``:
  periods base^(2j / (hd/2)) for j < hd/4, coordinates
  2·(arange(0.5, h)/h) − 1 per axis, angles 2π·c / periods as [h-angles,
  w-angles] tiled twice to hd, cos and sin in fp32;
- each block: x + ls1 ⊙ proj(attn(norm1(x))), then x + ls2 ⊙ w3(silu(w1·y)
  · w2·y) with y = norm2(x), LayerNorm eps ``norm_eps``; in the attention q
  and k of the patch rows become x·cos + rotate_half(x)·sin in fp32,
  rotate_half([x1 | x2]) = [−x2 | x1]; the qkv projection has no bias;
- the last block's k projection of norm1, before RoPE (a forward hook on
  ``attn.qkv`` sees it), CLS and storage tokens dropped.

The slices, their normalization, the sweep over three axes and the pooled
sum are the v1 reference's (``reference/vit.py``'s helpers, in the sweep
``reference/dinov2.py`` runs), and its products, attention and precisions
are used as they are: 'fp32' (IEEE fp32, TF32 off), 'bf16', 'fp8' (the control).
RoPE stays fp32 under each, as the published code casts q and k to fp32 for
it. The slices run in batches of the cell's batch size, so the fp32 model
needs only a batch's activations beside the weights.

Departures from the published code: the patch conv is the same sum written
as a product over each patch's pixels; the last block stops after its k
projection; no mask token, no training-time coordinate jitter, shift or
rescale (eval mode); one RoPE table for every block (the published model
builds the same table in each); explicit softmax products for
``scaled_dot_product_attention``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.vit import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    SWEEP_AXES,
    attention,
    image_size,
    linear,
    matmul,
    pool_windows,
)


def rope_sin_cos(h: int, w: int, head_dim: int, base: float, device) -> tuple:
    """``RopePositionEmbedding.forward(H=h, W=w)`` in eval mode: (sin, cos),
    each (h·w, head_dim) fp32."""
    dd = {"device": device, "dtype": torch.float32}
    periods = base ** (2 * torch.arange(head_dim // 4, **dd) / (head_dim // 2))
    coords_h = torch.arange(0.5, h, **dd) / h
    coords_w = torch.arange(0.5, w, **dd) / w
    coords = torch.stack(torch.meshgrid(coords_h, coords_w, indexing="ij"), dim=-1)
    coords = coords.flatten(0, 1)
    coords = 2.0 * coords - 1.0
    angles = 2 * math.pi * coords[:, :, None] / periods[None, None, :]
    angles = angles.flatten(1, 2)
    angles = angles.tile(2)
    return torch.sin(angles), torch.cos(angles)


def rope_rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_apply(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    return (x * cos) + (rope_rotate_half(x) * sin)


def apply_rope(q: torch.Tensor, k: torch.Tensor, rope: tuple) -> tuple:
    """``SelfAttention.apply_rope``: the last h·w rows of (B, heads, N, hd)
    q and k rotated in fp32, the prefix rows kept."""
    sin, cos = rope
    prefix = q.shape[-2] - sin.shape[-2]
    q, k = q.float(), k.float()
    q = torch.cat([q[:, :, :prefix], rope_apply(q[:, :, prefix:], sin, cos)], dim=-2)
    k = torch.cat([k[:, :, :prefix], rope_apply(k[:, :, prefix:], sin, cos)], dim=-2)
    return q, k


def layer_norm(x, w, b, eps: float):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps=eps)


def keys(images: torch.Tensor, p: dict, model: dict, precision: str) -> torch.Tensor:
    """(B, 1, H, W) normalized slices → (B, h·w, D) k features of the last
    block (CLS and storage tokens dropped), fp32."""
    B = images.shape[0]
    mean = torch.tensor(IMAGENET_MEAN, device=images.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=images.device).view(1, 3, 1, 1)
    x3 = (images.float().expand(B, 3, -1, -1) - mean) / std
    P, D, heads = model["patch_size"], model["embed_dim"], model["num_heads"]
    h, w = x3.shape[2] // P, x3.shape[3] // P
    patches = x3.reshape(B, 3, h, P, w, P).permute(0, 2, 4, 1, 3, 5).reshape(B, h * w, 3 * P * P)
    x = linear(patches, p["patch_embed.proj.weight"].reshape(D, -1),
               p["patch_embed.proj.bias"], precision)
    S = model["n_storage_tokens"]
    x = torch.cat([p["cls_token"].float().expand(B, 1, D),
                   p["storage_tokens"].float().expand(B, S, D), x], dim=1)
    N, hd, eps = x.shape[1], D // heads, model["norm_eps"]
    rope = rope_sin_cos(h, w, hd, model["rope_base"], images.device)
    for i in range(model["depth"]):
        b = f"blocks.{i}."
        y = layer_norm(x, p[b + "norm1.weight"], p[b + "norm1.bias"], eps)
        wqkv = p[b + "attn.qkv.weight"]  # no bias
        if i == model["depth"] - 1:
            return matmul(y, wqkv[D:2 * D].t(), precision)[:, 1 + S:]
        qkv = matmul(y, wqkv.t(), precision)
        q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k = apply_rope(q, k, rope)
        a = attention(q, k, v, precision).permute(0, 2, 1, 3).reshape(B, N, D)
        a = linear(a, p[b + "attn.proj.weight"], p[b + "attn.proj.bias"], precision)
        x = x + a * p[b + "ls1.gamma"].float()
        y = layer_norm(x, p[b + "norm2.weight"], p[b + "norm2.bias"], eps)
        x1 = linear(y, p[b + "mlp.w1.weight"], p[b + "mlp.w1.bias"], precision)
        x2 = linear(y, p[b + "mlp.w2.weight"], p[b + "mlp.w2.bias"], precision)
        y = linear(F.silu(x1) * x2, p[b + "mlp.w3.weight"], p[b + "mlp.w3.bias"], precision)
        x = x + y * p[b + "ls2.gamma"].float()
    raise ValueError("a ViT of depth 0 has no k projection")


def extract(vol: torch.Tensor, params: dict, model: dict, extract_cfg: dict,
            precision: str = "fp32", slots=None) -> torch.Tensor:
    """fp32 k features of a (W, H, D) scalar volume swept along all three
    axes, (D, o0, o1, o2), or with ``slots`` (three sorted index lists) only
    the voxels of that lattice, from the slices their pool windows cover:
    ``reference/dinov2.py``'s ``extract`` with this module's ViT."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _extract(vol.float(), params, model, extract_cfg, precision, slots)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


@torch.no_grad()
def _extract(vol, params, model, extract_cfg, precision, slots):
    im, n_slots = image_size(tuple(vol.shape), extract_cfg["feature_output_size"],
                             model["patch_size"])
    if slots is None:
        slots = [list(range(n)) for n in n_slots]
    lo, hi = vol.min(), vol.max()
    B, D = extract_cfg["batch_size"], model["embed_dim"]
    total = None
    for axis in SWEEP_AXES:
        stack = vol.movedim(axis, 0)  # (S, a, b): the other two axes in order
        d0, d1 = [d for d in range(3) if d != axis]
        windows = [pool_windows(stack.shape[0], n_slots[axis])[j] for j in slots[axis]]
        need = sorted({s for a, b in windows for s in range(a, b)})
        rows = torch.as_tensor(slots[d0], device=vol.device)
        cols = torch.as_tensor(slots[d1], device=vol.device)
        per_slice = {}
        for i in range(0, len(need), B):
            idx = need[i:i + B]
            img = F.interpolate(stack[idx][:, None], size=(im[d0], im[d1]), mode="nearest")
            k = keys((img - lo) / (hi - lo), params, model, precision)
            k = k.reshape(len(idx), n_slots[d0], n_slots[d1], D)[:, rows][:, :, cols]
            per_slice.update(zip(idx, k))
        feat = torch.stack([sum(per_slice[s] for s in range(a, b)) / (b - a) for a, b in windows])
        feat = feat.permute(3, 0, 1, 2).movedim(1, 1 + axis)  # (D, slot, rows, cols) → axis order
        total = feat if total is None else total + feat
    return total.contiguous()
