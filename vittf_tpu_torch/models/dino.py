"""DINO / DINOv2 architecture registry and weight loading.

Port of ``vittf_tpu/models/dino.py``. The port keeps weights in the hub
``state_dict`` layout, so a DINO ``.pth`` loads as it is; ``params_from_jax``
turns the JAX package's parameter pytree (the inverse of its
``convert_torch_state_dict``) into that layout, and ``params_to_jax`` back.
A flat-key ``.npz`` of JAX params: ``params_from_jax(models.serialization.
load_params_npz(path))``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from vittf_tpu_torch.models.vit import ViTConfig

# DINO v1 (facebookresearch/dino): patch 8/16, img_size 224.
# DINOv2 (facebookresearch/dinov2 hubconf): patch 14, img_size 518, LayerScale;
# ViT-g/14 (``vit_giant2``) has a SwiGLU FFN of width 4096
# (``ffn_layer='swiglufused'``); the ``_reg`` models add 4 register tokens and
# resize the position grid to a size with antialiasing (offset 0).
DINO_ARCHS = {
    "vits16": ViTConfig(16, 384, 12, 6, name="vits16"),
    "vits8": ViTConfig(8, 384, 12, 6, name="vits8"),
    "vitb16": ViTConfig(16, 768, 12, 12, name="vitb16"),
    "vitb8": ViTConfig(8, 768, 12, 12, name="vitb8"),
}
DINOV2_ARCHS = {
    "vits14": ViTConfig(14, 384, 12, 6, img_size=518, layerscale=True, name="vits14"),
    "vitb14": ViTConfig(14, 768, 12, 12, img_size=518, layerscale=True, name="vitb14"),
    "vitl14": ViTConfig(14, 1024, 24, 16, img_size=518, layerscale=True, name="vitl14"),
    "vitg14": ViTConfig(14, 1536, 40, 24, img_size=518, layerscale=True, name="vitg14",
                        ffn="swiglu"),
    "vitg14_reg": ViTConfig(14, 1536, 40, 24, img_size=518, layerscale=True,
                            name="vitg14_reg", ffn="swiglu", num_register_tokens=4,
                            interpolate_antialias=True, interpolate_offset=0.0),
}
ALL_ARCHS = {**DINO_ARCHS, **DINOV2_ARCHS}


def resolve_model(
    dino_model: str | None = None, dino2_model: str | None = None
) -> ViTConfig:
    """Name → config, with the reference's default (vits8) (infer.py:239-264)."""
    if dino_model and dino2_model:
        raise ValueError("Set only one of dino_model / dino2_model")
    if dino2_model:
        if dino2_model not in DINOV2_ARCHS:
            raise ValueError(f"Unknown DINOv2 arch: {dino2_model}")
        return DINOV2_ARCHS[dino2_model]
    name = dino_model or "vits8"
    if name not in DINO_ARCHS:
        raise ValueError(f"Unknown DINO arch: {name}")
    return DINO_ARCHS[name]


def _backbone_keys(cfg: ViTConfig) -> list[str]:
    keys = ["cls_token", "pos_embed", "patch_embed.proj.weight",
            "patch_embed.proj.bias", "norm.weight", "norm.bias"]
    if cfg.num_register_tokens:
        keys.append("register_tokens")
    ffn = ("mlp.w12", "mlp.w3") if cfg.ffn == "swiglu" else ("mlp.fc1", "mlp.fc2")
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        for name in ("norm1", "norm2", "attn.qkv", "attn.proj", *ffn):
            keys += [f"{b}.{name}.weight", f"{b}.{name}.bias"]
        if cfg.layerscale:
            keys += [f"{b}.ls1.gamma", f"{b}.ls2.gamma"]
    return keys


def backbone_state_dict(sd: dict, cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """The backbone's tensors of a hub-layout ``state_dict``, in fp32; keys
    outside the backbone are dropped, a missing one raises ``KeyError``.
    Register tokens the config does not hold raise ``ValueError``: without
    them the model would run and give other features."""
    regs = sd.get("register_tokens")
    if regs is not None and tuple(regs.shape[:2]) != (1, cfg.num_register_tokens):
        raise ValueError(f"the checkpoint holds register tokens {tuple(regs.shape)}; "
                         f"{cfg.name} has {cfg.num_register_tokens}")
    return {k: torch.as_tensor(sd[k]).detach().float() for k in _backbone_keys(cfg)}


def load_dino_checkpoint(path: str | Path, cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """Load a DINO ``.pth`` checkpoint as a backbone ``state_dict`` (fp32).

    Keys outside the backbone (head, mask_token) are dropped; register
    tokens are kept for a config that has them and refused otherwise.
    """
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "teacher" in sd:
        sd = {k.replace("backbone.", ""): v for k, v in sd["teacher"].items()}
    return backbone_state_dict(sd, cfg)


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy leaves) → hub-layout ``state_dict``.

    Inverse of the JAX package's ``convert_torch_state_dict``: the HWIO
    patch-embed kernel (P, P, C, D) becomes OIHW (D, C, P, P), linear
    kernels (din, dout) become (dout, din), LayerNorm scale becomes weight.
    The JAX package's ViT has a GELU MLP and no register tokens: a tree with
    a SwiGLU FFN or registers raises ``ValueError``.
    """
    if "register_tokens" in params or any("w12" in blk for blk in params["blocks"]):
        raise ValueError("the JAX package's ViT holds no SwiGLU FFN and no register tokens")

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {
        "cls_token": t(params["cls_token"]),
        "pos_embed": t(params["pos_embed"]),
        "patch_embed.proj.weight": t(params["patch_embed"]["kernel"]).permute(3, 2, 0, 1).contiguous(),
        "patch_embed.proj.bias": t(params["patch_embed"]["bias"]),
        "norm.weight": t(params["norm"]["scale"]),
        "norm.bias": t(params["norm"]["bias"]),
    }
    names = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i, blk in enumerate(params["blocks"]):
        b = f"blocks.{i}"
        for ln in ("norm1", "norm2"):
            sd[f"{b}.{ln}.weight"] = t(blk[ln]["scale"])
            sd[f"{b}.{ln}.bias"] = t(blk[ln]["bias"])
        for jname, tname in names.items():
            sd[f"{b}.{tname}.weight"] = t(blk[jname]["kernel"]).T.contiguous()
            sd[f"{b}.{tname}.bias"] = t(blk[jname]["bias"])
        if "ls1" in blk:
            sd[f"{b}.ls1.gamma"] = t(blk["ls1"])
            sd[f"{b}.ls2.gamma"] = t(blk["ls2"])
    return sd


def params_to_jax(sd: dict[str, torch.Tensor]) -> dict:
    """Hub-layout ``state_dict`` → the JAX package's parameter tree (numpy
    leaves), as its ``convert_torch_state_dict`` makes it: the inverse of
    ``params_from_jax``; ``models.serialization.save_params_npz`` writes it
    in the JAX package's ``.npz`` layout. A SwiGLU FFN (``mlp.w12``) or
    register tokens raise ``ValueError``: the JAX package cannot hold them."""
    if "register_tokens" in sd or any(k.endswith("mlp.w12.weight") for k in sd):
        raise ValueError("the JAX package's ViT holds no SwiGLU FFN and no register tokens "
                         "(DINOv2 ViT-g/14 runs in vittf_tpu_torch only)")

    def n(key):
        return sd[key].detach().float().cpu().numpy()

    def linear(prefix):
        return {"kernel": np.ascontiguousarray(n(f"{prefix}.weight").T), "bias": n(f"{prefix}.bias")}

    def ln(prefix):
        return {"scale": n(f"{prefix}.weight"), "bias": n(f"{prefix}.bias")}

    params = {
        "patch_embed": {
            "kernel": np.ascontiguousarray(n("patch_embed.proj.weight").transpose(2, 3, 1, 0)),
            "bias": n("patch_embed.proj.bias"),
        },
        "cls_token": n("cls_token"),
        "pos_embed": n("pos_embed"),
        "blocks": [],
        "norm": ln("norm"),
    }
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    for i in range(depth):
        b = f"blocks.{i}"
        blk = {"norm1": ln(f"{b}.norm1"), "norm2": ln(f"{b}.norm2"),
               "qkv": linear(f"{b}.attn.qkv"), "proj": linear(f"{b}.attn.proj"),
               "fc1": linear(f"{b}.mlp.fc1"), "fc2": linear(f"{b}.mlp.fc2")}
        if f"{b}.ls1.gamma" in sd:
            blk["ls1"] = n(f"{b}.ls1.gamma")
            blk["ls2"] = n(f"{b}.ls2.gamma")
        params["blocks"].append(blk)
    return params
