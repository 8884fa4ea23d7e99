"""Per-stage wall-clock timing recorded into artifact metadata.

The reference only has ad-hoc ``time.time()`` spans (infer.py:324-336,
predict_ntf.py:179-192) persisted as ``fit_time``/``predict_time`` in metrics
JSONs. Here timings are first-class: every pipeline stage records into a
``StageTimings`` that is serialized alongside artifacts.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Timer:
    """Simple wall-clock timer; ``elapsed`` is valid after ``stop()``."""

    start_time: float = field(default_factory=time.perf_counter)
    elapsed: float = 0.0

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self.start_time
        return self.elapsed


@dataclass
class StageTimings:
    """Accumulates named stage timings, serializable to JSON metadata."""

    timings: dict = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str):
        t = Timer()
        try:
            yield t
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + t.stop()

    def to_json(self) -> str:
        return json.dumps(self.timings)

    def __getitem__(self, name: str) -> float:
        return self.timings[name]
