"""vittf_tpu_torch — the PyTorch/CUDA port of vittf_tpu for NVIDIA Hopper.

Same module layout and public names as ``vittf_tpu`` (the JAX reference,
which stays beside it). Plain tensor code is PyTorch; the Pallas TPU kernels
on the extraction, similarity and refinement paths are hand-written CUDA
kernels in ``csrc/``, built at first use by ``vittf_tpu_torch.kernels``. This
package never imports JAX.
"""

__version__ = "0.1.0"
