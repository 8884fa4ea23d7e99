"""The card's clock and memory, and the same calls as no-ops on the CPU, where
the tests drive a whole run at a tiny size."""
from __future__ import annotations

import sys

import torch


def log(msg: str) -> None:
    """A line of diagnostics on standard error, before the checks that end it."""
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def memory_peak(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
