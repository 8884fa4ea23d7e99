"""utils layer of the PyTorch/CUDA port (see vittf_tpu/utils)."""
from vittf_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "tensor": ("make_nd", "make_3d", "make_4d", "make_5d", "norm_minmax", "norm_mean_std",
               "IMAGENET_MEAN", "IMAGENET_STD"),
})
