"""Observability: metric logging backends + profiler traces.

The reference logs with prints/icecream and wandb in the legacy trainers
(SURVEY.md §5). Here a small ``MetricLogger`` fans metrics out to pluggable
backends — stdout, JSONL file, and wandb when installed — and
``profile_trace`` wraps ``torch.profiler`` for device timeline captures.
``span`` names what the host is doing inside the served paths (an edit,
an extraction sweep), so that such a trace says which layer left the card
idle.

Port of ``vittf_tpu/utils/logging.py``; ``span`` is the port's own.
"""
from __future__ import annotations

import json
import tempfile
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "vittf."
_NO_SPAN = nullcontext()


class MetricLogger:
    """Step-indexed metric logging with stdout / JSONL / wandb backends."""

    def __init__(
        self,
        jsonl_path: str | Path | None = None,
        use_wandb: bool = False,
        wandb_kwargs: dict | None = None,
        stdout_every: int = 0,
    ):
        self.step = 0
        self.stdout_every = stdout_every
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except ImportError:
                print("wandb requested but not installed; skipping")

    def log(self, metrics: dict, step: int | None = None):
        self.step = self.step + 1 if step is None else step
        rec = {"step": self.step, "time": time.time(), **metrics}
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._wandb:
            self._wandb.log(metrics, step=self.step)
        if self.stdout_every and self.step % self.stdout_every == 0:
            printable = {
                k: (round(v, 5) if isinstance(v, float) else v)
                for k, v in metrics.items()
            }
            print(f"[{self.step}] {printable}")

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._wandb:
            self._wandb.finish()


@contextmanager
def profile_trace(logdir: str | Path | None = None):
    """Capture a torch.profiler trace of the block (host activity, and the
    card's when one is visible) as a Chrome trace, ``logdir/trace.json``
    (view in chrome://tracing or Perfetto). ``logdir`` defaults to
    ``vittf_trace`` under the system's temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir) if logdir is not None else Path(tempfile.gettempdir()) / "vittf_trace"
    logdir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(str(logdir / "trace.json"))


def span(name: str, *values):
    """A host span ``vittf.<name>`` in a running ``torch.profiler`` trace,
    nested under the span or operator that encloses it on this thread;
    ``values`` (ints, floats, strings) are recorded as its inputs where the
    profiler records them (``record_shapes=True``), so that one request's
    spans can share an identifier. Without a running profiler it does
    nothing and costs an attribute read.

    The record is a plain CPU operator, not a ``record_function``
    annotation: the profiler mirrors annotations onto the device timeline,
    where a host span would read as device work. Keep spans out of bodies a
    CUDA graph captures (their Python runs only while capturing) and out of
    kernel wrappers (their ``launches`` counters already count them)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    record = torch._C._profiler._RecordFunctionFast
    # inputs are given only when there are some: None aborts the process
    return record(SPAN_PREFIX + name, values) if values else record(SPAN_PREFIX + name)


@contextmanager
def debug_mode(nans: bool = True):
    """The reference's debug switches (CUDA_LAUNCH_BLOCKING +
    detect_anomaly, old/utils.py:23-26): autograd anomaly detection, which
    raises where a backward pass produces NaN. Eager PyTorch has no jit to
    disable, so the JAX package's ``disable_jit`` argument has no
    counterpart here."""
    with torch.autograd.set_detect_anomaly(nans):
        yield
