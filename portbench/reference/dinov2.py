"""Plain PyTorch feature extraction with a DINOv2 ViT: SwiGLU FFN, LayerScale,
register tokens.

The reference for ``extract_features`` on a DINOv2 configuration, written
from the published model (facebookresearch/dinov2 ``models/
vision_transformer.py`` ``DinoVisionTransformer``, ``layers/swiglu_ffn.py``
``SwiGLUFFNFused``, ``layers/layer_scale.py``, ``layers/block.py``), not
from the program:

- ``prepare_tokens_with_masks``: stride-P patch conv, CLS, the position
  grid resized by ``interpolate_pos_encoding`` (bicubic in fp32, to the size
  (h, w) when ``interpolate_offset`` is 0, else at the scale
  (h + offset) / M; antialiased when ``interpolate_antialias``), then the
  register tokens inserted after CLS, without a position embedding;
- each block: x + ls1 ⊙ attn(norm1(x)), then x + ls2 ⊙ ffn(norm2(x)),
  LayerNorm eps 1e-6; ffn = w3(silu(x1) · x2) with [x1 | x2] = w12(x);
- the last block's k projection of norm1, CLS and registers dropped.

The slices, their normalization, the sweep over three axes and the pooled
sum are the v1 reference's (``reference/vit.py``), and its products,
attention, LayerNorm and precisions are used as they are: 'fp32' (IEEE
fp32, TF32 off, explicit softmax attention), 'bf16', 'fp8' (the control).

Departures from the published code: the patch conv is the same sum written
as a product over each patch's pixels (``reference/vit.py``); the last
block stops after its k projection, the only output the pipeline reads;
no mask token (extraction masks nothing); no xFormers memory-efficient
attention (explicit softmax products); the whole batch at once, no chunked
blocks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.vit import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    SWEEP_AXES,
    attention,
    image_size,
    layer_norm,
    linear,
    pool_windows,
)


def interpolate_pos_embed(pos_embed: torch.Tensor, h: int, w: int, offset: float,
                          antialias: bool) -> torch.Tensor:
    """DINOv2's ``interpolate_pos_encoding`` for an (h, w) token grid."""
    M = int(round((pos_embed.shape[1] - 1) ** 0.5))
    if (h, w) == (M, M):
        return pos_embed.float()
    patch = pos_embed[:, 1:].float().reshape(1, M, M, -1).permute(0, 3, 1, 2)
    if offset:
        kwargs = {"scale_factor": ((h + offset) / M, (w + offset) / M)}
    else:
        kwargs = {"size": (h, w)}
    patch = F.interpolate(patch, mode="bicubic", antialias=antialias, **kwargs)
    if patch.shape[-2:] != (h, w):
        raise ValueError(f"position grid resized to {tuple(patch.shape[-2:])}, not {(h, w)}")
    patch = patch.permute(0, 2, 3, 1).reshape(1, h * w, -1)
    return torch.cat([pos_embed[:, :1].float(), patch], dim=1)


def keys(images: torch.Tensor, p: dict, model: dict, precision: str) -> torch.Tensor:
    """(B, 1, H, W) normalized slices → (B, h·w, D) k features of the last
    block (CLS and registers dropped), fp32."""
    B = images.shape[0]
    mean = torch.tensor(IMAGENET_MEAN, device=images.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=images.device).view(1, 3, 1, 1)
    x3 = (images.float().expand(B, 3, -1, -1) - mean) / std
    P, D, heads = model["patch_size"], model["embed_dim"], model["num_heads"]
    h, w = x3.shape[2] // P, x3.shape[3] // P
    patches = x3.reshape(B, 3, h, P, w, P).permute(0, 2, 4, 1, 3, 5).reshape(B, h * w, 3 * P * P)
    x = linear(patches, p["patch_embed.proj.weight"].reshape(D, -1),
               p["patch_embed.proj.bias"], precision)
    x = torch.cat([p["cls_token"].float().expand(B, 1, D), x], dim=1)
    x = x + interpolate_pos_embed(p["pos_embed"], h, w, model["interpolate_offset"],
                                  model["interpolate_antialias"])
    R = model["num_register_tokens"]
    if R:
        x = torch.cat([x[:, :1], p["register_tokens"].float().expand(B, R, D), x[:, 1:]], dim=1)
    N, hd, H = x.shape[1], D // heads, model["hidden_dim"]
    for i in range(model["depth"]):
        b = f"blocks.{i}."
        y = layer_norm(x, p[b + "norm1.weight"], p[b + "norm1.bias"])
        if i == model["depth"] - 1:
            k = linear(y, p[b + "attn.qkv.weight"][D:2 * D], p[b + "attn.qkv.bias"][D:2 * D],
                       precision)
            return k[:, 1 + R:]
        qkv = linear(y, p[b + "attn.qkv.weight"], p[b + "attn.qkv.bias"], precision)
        q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        a = attention(q, k, v, precision).permute(0, 2, 1, 3).reshape(B, N, D)
        a = linear(a, p[b + "attn.proj.weight"], p[b + "attn.proj.bias"], precision)
        x = x + a * p[b + "ls1.gamma"].float()
        y = layer_norm(x, p[b + "norm2.weight"], p[b + "norm2.bias"])
        x12 = linear(y, p[b + "mlp.w12.weight"], p[b + "mlp.w12.bias"], precision)
        hidden = F.silu(x12[..., :H]) * x12[..., H:]
        y = linear(hidden, p[b + "mlp.w3.weight"], p[b + "mlp.w3.bias"], precision)
        x = x + y * p[b + "ls2.gamma"].float()
    raise ValueError("a ViT of depth 0 has no k projection")


def extract(vol: torch.Tensor, params: dict, model: dict, extract_cfg: dict,
            precision: str = "fp32", slots=None) -> torch.Tensor:
    """fp32 k features of a (W, H, D) scalar volume swept along all three
    axes, (D, o0, o1, o2), or with ``slots`` (three sorted index lists) only
    the voxels of that lattice, from the slices their pool windows cover:
    ``reference/vit.py``'s ``extract`` with this module's ViT."""
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
