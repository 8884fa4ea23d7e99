"""models layer of the PyTorch/CUDA port (see vittf_tpu/models).

The JAX package's ``vit_forward`` / ``vit_forward_raw`` are methods of the
port's ``VisionTransformer`` here (``forward_raw`` for inference, ``forward``
for training), and ``convert_torch_state_dict`` has no
twin: the port keeps the hub layout (``models.dino.params_from_jax`` and
``params_to_jax`` convert)."""
from vittf_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "vit": ("ViTConfig", "init_vit_params", "split_qkv"),
    "dino": ("ALL_ARCHS", "DINO_ARCHS", "DINOV2_ARCHS", "load_dino_checkpoint", "resolve_model"),
    "cnn3d": ("FeatureExtractorConfig", "PAWSNetConfig", "feature_extractor_forward",
              "init_feature_extractor", "init_pawsnet", "pawsnet_forward"),
})
