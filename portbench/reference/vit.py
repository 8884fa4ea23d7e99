"""Plain PyTorch feature extraction: a DINO ViT over the slices of three axes.

The reference for ``extract_features``, written from the published model
(facebookresearch/dino ``vision_transformer.py``) and the reference
pipeline's extraction (infer.py:130-210, 317-333), not from the program:

- per axis, each slice is nearest-resized to the image size, min-max
  normalized by the volume's global range, replicated to three channels
  and ImageNet-normalized;
- the ViT: stride-P patch conv, CLS token, the position grid resized
  bicubically with DINO's ``scale_factor`` of (w0 + 0.1) / grid, pre-LN
  blocks (LayerNorm eps 1e-6, exact GELU); the last block's k projection
  of LN1, CLS dropped;
- the slice axis pooled adaptively to the output size; the three axes summed
  as (z + y) + x.

``precision``: 'fp32' (the reference: IEEE fp32 products, TF32 off, attention
as explicit softmax products); 'bf16' (bf16 products with fp32 accumulation,
the library's attention: how the edit cells make the features both sides
take); 'fp8' (every product's operands rounded to float8 e4m3 with a
power-of-two scale per tensor, fp32 accumulation: the control).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0  # float8 e4m3fn
ATTN_CHUNK_ELEMS = 2**30  # score elements computed at once in the explicit attention

# (slice axis of the (W, H, D) volume) in sweep order z, y, x
SWEEP_AXES = (2, 1, 0)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a power-of-two scale that maps its
    largest magnitude into range, returned in fp32."""
    amax = x.abs().amax().float().clamp(min=1e-30)
    scale = torch.exp2(torch.floor(torch.log2(FP8_MAX / amax)))
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x.float()
    if precision == "bf16":
        return x.bfloat16()
    if precision == "fp8":
        return fp8_round(x)
    raise ValueError(f"unknown precision {precision!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in ``precision`` (see the module), fp32 out."""
    return torch.matmul(_operand(a, precision), _operand(b, precision)).float()


def linear(x, w, b, precision):
    return matmul(x, w.t(), precision) + b.float()


def attention(q, k, v, precision):
    """Softmax attention of (B, H, N, hd) heads, fp32 out."""
    if precision == "bf16":
        return F.scaled_dot_product_attention(q.bfloat16(), k.bfloat16(), v.bfloat16()).float()
    B, H, N, hd = q.shape
    out = torch.empty((B, H, N, hd), dtype=torch.float32, device=q.device)
    per = max(1, ATTN_CHUNK_ELEMS // (N * N))
    qf, kf, vf = q.reshape(B * H, N, hd), k.reshape(B * H, N, hd), v.reshape(B * H, N, hd)
    of = out.view(B * H, N, hd)
    for i in range(0, B * H, per):
        s = matmul(qf[i:i + per], kf[i:i + per].transpose(1, 2), precision) * hd ** -0.5
        p = torch.softmax(s, dim=-1)
        of[i:i + per] = matmul(p, vf[i:i + per], precision)
    return out


def interpolate_pos_embed(pos_embed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """DINO's ``interpolate_pos_encoding`` for an (h, w) token grid."""
    g = int(math.sqrt(pos_embed.shape[1] - 1))
    if (h, w) == (g, g):
        return pos_embed
    patch = pos_embed[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2).float()
    patch = F.interpolate(patch, scale_factor=((h + 0.1) / g, (w + 0.1) / g), mode="bicubic")
    if patch.shape[-2:] != (h, w):
        raise ValueError(f"position grid resized to {tuple(patch.shape[-2:])}, not {(h, w)}")
    patch = patch.permute(0, 2, 3, 1).reshape(1, h * w, -1)
    return torch.cat([pos_embed[:, :1].float(), patch], dim=1)


def layer_norm(x, w, b):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps=1e-6)


def keys(images: torch.Tensor, p: dict, model: dict, precision: str) -> torch.Tensor:
    """(B, 1, H, W) normalized slices → (B, h·w, D) k features of the last
    block (CLS dropped), fp32."""
    B = images.shape[0]
    mean = torch.tensor(IMAGENET_MEAN, device=images.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=images.device).view(1, 3, 1, 1)
    x3 = (images.float().expand(B, 3, -1, -1) - mean) / std
    P, D, heads = model["patch_size"], model["embed_dim"], model["num_heads"]
    # the stride-P conv as a product over each patch's (c, i, j) pixels
    h, w = x3.shape[2] // P, x3.shape[3] // P
    patches = x3.reshape(B, 3, h, P, w, P).permute(0, 2, 4, 1, 3, 5).reshape(B, h * w, 3 * P * P)
    x = linear(patches, p["patch_embed.proj.weight"].reshape(D, -1),
               p["patch_embed.proj.bias"], precision)
    x = torch.cat([p["cls_token"].float().expand(B, 1, D), x], dim=1)
    x = x + interpolate_pos_embed(p["pos_embed"], h, w)
    N, hd = x.shape[1], D // heads
    for i in range(model["depth"]):
        b = f"blocks.{i}."
        y = layer_norm(x, p[b + "norm1.weight"], p[b + "norm1.bias"])
        if i == model["depth"] - 1:
            k = linear(y, p[b + "attn.qkv.weight"][D:2 * D], p[b + "attn.qkv.bias"][D:2 * D],
                       precision)
            return k[:, 1:]
        qkv = linear(y, p[b + "attn.qkv.weight"], p[b + "attn.qkv.bias"], precision)
        q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        a = attention(q, k, v, precision).permute(0, 2, 1, 3).reshape(B, N, D)
        x = x + linear(a, p[b + "attn.proj.weight"], p[b + "attn.proj.bias"], precision)
        y = layer_norm(x, p[b + "norm2.weight"], p[b + "norm2.bias"])
        y = F.gelu(linear(y, p[b + "mlp.fc1.weight"], p[b + "mlp.fc1.bias"], precision))
        x = x + linear(y, p[b + "mlp.fc2.weight"], p[b + "mlp.fc2.bias"], precision)
    raise ValueError("a ViT of depth 0 has no k projection")


def image_size(vol_shape, feature_output_size: int, patch_size: int):
    """(image side per volume axis, pooled slots per axis), infer.py:317-319."""
    ref_fact = sorted(vol_shape)[1] / feature_output_size
    im = tuple(int(patch_size * (d // ref_fact)) for d in vol_shape)
    return im, tuple(d // patch_size for d in im)


def pool_windows(S: int, out: int) -> list[tuple[int, int]]:
    """Adaptive average pool: slot i averages slices [⌊i·S/out⌋, ⌈(i+1)·S/out⌉)."""
    return [((i * S) // out, -((-(i + 1) * S) // out)) for i in range(out)]


def extract(vol: torch.Tensor, params: dict, model: dict, extract_cfg: dict,
            precision: str = "fp32", slots=None) -> torch.Tensor:
    """fp32 k features of a (W, H, D) scalar volume swept along all three
    axes (``slice_along='all'``, one return key 'k'): (D, o0, o1, o2), or with
    ``slots`` (three sorted index lists, one per volume axis) only the voxels
    of that lattice, (D, len(slots[0]), len(slots[1]), len(slots[2])),
    computed from the slices their pool windows cover."""
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
