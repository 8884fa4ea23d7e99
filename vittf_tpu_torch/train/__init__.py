"""The trainer layer of the port (see vittf_tpu/train). ``optim`` holds the
optax pieces the trainers use, written to optax's arithmetic."""
from vittf_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "contrastive": ("ContrastiveConfig", "ContrastiveTrainer"),
    "dense": ("DenseContrastiveConfig", "DenseContrastiveTrainer"),
    "paws": ("PAWSConfig", "PAWSTrainer"),
    "intra_clr": ("IntraCLRConfig", "IntraCLRTrainer"),
    "probe": ("ProbeConfig", "ProbeTrainer"),
    "gather": ("gather_receptive_fields",),
    "losses": ("feature_std", "infonce_loss", "paws_loss", "sharpen", "snn",
               "transform_paws_crops"),
})
