"""Measurement scripts of the port (``python -m vittf_tpu_torch.scripts.<name>``)."""
