"""core layer of the PyTorch/CUDA port (see vittf_tpu/core)."""
from vittf_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "io": ("load_volume", "load_features", "load_annotations", "save_array", "save_features",
           "save_similarities", "ArtifactDir"),
    "synthetic": ("make_synthetic_volumes",),
})
