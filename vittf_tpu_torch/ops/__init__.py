"""ops layer of the PyTorch/CUDA port (see vittf_tpu/ops)."""
