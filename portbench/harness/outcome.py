"""What one run of a cell hands back to ``run.py`` and the per-layer readers."""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from portbench.harness.trace import Trace


@dataclass
class Check:
    """One number of the correctness comparison beside its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    end_to_end: dict  # metric name → value
    attempted: int
    failed: int
    checks: list  # of Check
    memory_peak_bytes: int
    window_s: float
    trace: Trace | None = None
    work: dict = field(default_factory=dict)  # what the window computed, for the readers
    counters: dict = field(default_factory=dict)  # program counters' deltas over the window

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0


def limit_checks(values: dict, limits: dict) -> list:
    """A ``Check`` for every limit of the cell; a number the run could not
    compute reads as infinite, so it fails."""
    return [Check(name, float(values.get(name, math.inf)), float(lim))
            for name, lim in limits.items()]
