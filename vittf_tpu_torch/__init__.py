"""vittf_tpu_torch — the PyTorch/CUDA port of vittf_tpu for NVIDIA Hopper.

Same module layout and public names as ``vittf_tpu`` (the JAX reference,
which stays beside it); the ``__init__`` files resolve their names lazily
(``_lazy.py``). Plain tensor code is PyTorch; the Pallas TPU kernels on the
extraction, similarity and refinement paths are hand-written CUDA kernels in
``csrc/``, built at first use by ``vittf_tpu_torch.kernels``. This package
never imports JAX.
"""
from vittf_tpu_torch._lazy import lazy_exports

__version__ = "0.1.0"

__getattr__, __all__ = lazy_exports(__name__, {
    "utils.tensor": ("make_nd", "make_3d", "make_4d", "make_5d", "norm_minmax", "norm_mean_std"),
})
