"""The benchmark of vittf_tpu_torch (see run.py and PERF.md)."""
