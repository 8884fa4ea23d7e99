"""CLIP / BLIP / MedCLIP visual-encoder variants (reference infer_clip.py).

The reference's experimental CLIP path reuses the same slice machinery but
hooks the last block's MLP output of a LAVIS (BLIP/CLIP) or MedCLIP visual
encoder (SURVEY.md C5). Here the equivalent is:

- the extraction pipeline's ``feature_source='mlp'`` option (the captured
  MLP output is split in thirds exactly like the reference's post-hook
  reshape does to whatever tensor it receives)
- converters from timm-style visual-encoder ``state_dict``s (the BLIP/CLIP
  ViT layout, ``visual_encoder.*`` prefix; MedCLIP's SwinT is not a ViT
  and is out of scope — the reference's MedCLIP path exits before use,
  infer_clip.py:151)

LAVIS/MedCLIP themselves are optional: loading *from those packages* is
gated; loading from a saved ``state_dict`` file needs only torch.

Port of ``vittf_tpu/models/clip.py``. The port's ViT takes the hub
(timm-style) ``state_dict`` layout as it is, so "converting" a visual
encoder is stripping the prefix and keeping the backbone's tensors in fp32.
"""
from __future__ import annotations

from pathlib import Path

from vittf_tpu_torch.models.dino import backbone_state_dict
from vittf_tpu_torch.models.vit import ViTConfig

# BLIP/CLIP visual encoders used by LAVIS are ViT-B/16 or ViT-L/16-style.
CLIP_ARCHS = {
    "blip_vitb16": ViTConfig(16, 768, 12, 12, img_size=224, name="blip_vitb16"),
    "clip_vitl14": ViTConfig(14, 1024, 24, 16, img_size=224, name="clip_vitl14"),
}


def strip_prefix(state_dict: dict, prefix: str = "visual_encoder.") -> dict:
    """Keep and strip ``prefix`` keys (LAVIS wraps the ViT as
    ``visual_encoder``)."""
    out = {
        k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)
    }
    return out or dict(state_dict)


def convert_visual_encoder(state_dict: dict, cfg: ViTConfig):
    """timm-style visual-encoder state_dict → the port's backbone
    ``state_dict``.

    BLIP/CLIP ViTs share the DINO/timm parameter layout (patch_embed.proj,
    blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}, norm), so the
    DINO checkpoint filter applies after prefix stripping.
    """
    return backbone_state_dict(strip_prefix(state_dict), cfg)


def load_lavis_model(name: str = "blip_feature_extractor", model_type: str = "base"):
    """Load a LAVIS model's visual encoder params (requires ``lavis``)."""
    try:
        from lavis.models import load_model_and_preprocess
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "lavis is required for load_lavis_model; install salesforce-lavis "
            "or convert a saved state_dict with convert_visual_encoder()"
        ) from e
    model, _, _ = load_model_and_preprocess(
        name=name, model_type=model_type, is_eval=True
    )
    cfg = CLIP_ARCHS["blip_vitb16"]
    return convert_visual_encoder(model.state_dict(), cfg), cfg


def load_visual_checkpoint(path: str | Path, cfg: ViTConfig):
    """Convert a saved visual-encoder checkpoint file (torch)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    return convert_visual_encoder(sd, cfg)
