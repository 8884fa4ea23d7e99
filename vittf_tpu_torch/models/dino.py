"""DINO / DINOv2 architecture registry and weight loading.

Port of ``vittf_tpu/models/dino.py``. The port keeps weights in the hub
``state_dict`` layout, so a DINO ``.pth`` loads as it is; ``params_from_jax``
turns the JAX package's parameter pytree (the inverse of its
``convert_torch_state_dict``) into that layout.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from vittf_tpu_torch.models.vit import ViTConfig

# DINO v1 (facebookresearch/dino): patch 8/16, img_size 224.
# DINOv2 (facebookresearch/dinov2): patch 14, img_size 518, LayerScale.
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
    "vitg14": ViTConfig(14, 1536, 40, 24, img_size=518, layerscale=True, name="vitg14"),
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
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        for name in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            keys += [f"{b}.{name}.weight", f"{b}.{name}.bias"]
        if cfg.layerscale:
            keys += [f"{b}.ls1.gamma", f"{b}.ls2.gamma"]
    return keys


def backbone_state_dict(sd: dict, cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """The backbone's tensors of a hub-layout ``state_dict``, in fp32; keys
    outside the backbone are dropped, a missing one raises ``KeyError``."""
    return {k: torch.as_tensor(sd[k]).detach().float() for k in _backbone_keys(cfg)}


def load_dino_checkpoint(path: str | Path, cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """Load a DINO ``.pth`` checkpoint as a backbone ``state_dict`` (fp32).

    Keys outside the backbone (head, mask_token, register tokens) are dropped.
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
    """
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


def load_params_npz(path: str | Path) -> dict[str, torch.Tensor]:
    """JAX flat-npz params (``blocks.3.qkv.kernel`` → array) → ``state_dict``."""
    root: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            parts = key.split(".")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    blocks = root.get("blocks", {})
    root["blocks"] = [blocks[str(i)] for i in range(len(blocks))]
    return params_from_jax(root)
