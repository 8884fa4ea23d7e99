"""Reading a torch.profiler trace of the measured window.

- busy time: the union of the card's activity intervals (kernels, copies,
  memsets); the idle share is one minus busy over the window's host wall;
- kernel time by name, for the roofline readers;
- the breakdown the result line carries: the device operations that took
  most time, and the idle gaps summed by what the host was doing in them
  (the innermost host event that spans the gap's midpoint).
"""
from __future__ import annotations

import contextlib
import re
import time
from dataclasses import dataclass, field

import numpy as np

from portbench.harness.device import log

TOP = 10
SPAN_PREFIX = "portbench."
GAPS_KEPT = 4000  # the longest idle gaps given a host name


@dataclass
class Trace:
    """The window's device and host events, times in microseconds. The
    reductions run on arrays, once each: a traced window of edits holds
    millions of events."""
    window_s: float
    device: list = field(default_factory=list)  # (name, start, end)
    host: list = field(default_factory=list)  # (name, start, end)
    _cache: dict = field(default_factory=dict, repr=False)

    def _union(self) -> tuple:
        """The device events' intervals merged into disjoint (starts, ends),
        in time order."""
        if "union" not in self._cache:
            a = np.array([(s, e) for _, s, e in self.device], dtype=np.float64).reshape(-1, 2)
            a = a[np.argsort(a[:, 0], kind="stable")]
            s, e = a[:, 0], a[:, 1]
            if len(s):
                reach = np.maximum.accumulate(e)
                first = np.flatnonzero(np.r_[True, s[1:] > reach[:-1]])
                s, e = s[first], reach[np.r_[first[1:] - 1, len(reach) - 1]]
            self._cache["union"] = (s, e)
        return self._cache["union"]

    def _per_name(self) -> dict:
        """Device name → [microseconds, count]."""
        if "names" not in self._cache:
            per: dict = {}
            for name, s, e in self.device:
                t = per.setdefault(name, [0.0, 0])
                t[0] += e - s
                t[1] += 1
            self._cache["names"] = per
        return self._cache["names"]

    def busy_s(self) -> float:
        s, e = self._union()
        return float((e - s).sum()) / 1e6

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """Seconds and count of the device events whose name matches."""
        rx = re.compile(pattern)
        hits = [v for name, v in self._per_name().items() if rx.search(name)]
        return sum(t for t, _ in hits) / 1e6, sum(n for _, n in hits)

    def device_ops(self) -> list:
        top = sorted(self._per_name().items(), key=lambda kv: -kv[1][0])[:TOP]
        return [[n, t / 1e6] for n, (t, _) in top]

    def idle_gaps(self) -> list:
        s, e = self._union()
        g0, g1 = e[:-1], s[1:]
        longest = np.argsort(g0 - g1, kind="stable")[:GAPS_KEPT]
        hs = np.array([h[1] for h in self.host], dtype=np.float64)
        order = np.argsort(hs, kind="stable")
        hs = hs[order]
        he = np.array([h[2] for h in self.host], dtype=np.float64)[order]
        block_ends = _block_max(he)
        per: dict[str, float] = {}
        for k in longest.tolist():
            mid = 0.5 * (g0[k] + g1[k])
            i = _latest_spanning(hs, he, block_ends, mid)
            name = self.host[order[i]][0] if i >= 0 else "host outside any traced op"
            per[name] = per.get(name, 0.0) + float(g1[k] - g0[k])
        return [[n, t / 1e6] for n, t in sorted(per.items(), key=lambda kv: -kv[1])[:TOP]]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}


BLOCK = 1024


def _block_max(ends: np.ndarray) -> np.ndarray:
    """The latest end in each block of ``BLOCK`` events."""
    pad = np.full(-(-len(ends) // BLOCK) * BLOCK, -np.inf)
    pad[:len(ends)] = ends
    return pad.reshape(-1, BLOCK).max(axis=1)


def _latest_spanning(starts: np.ndarray, ends: np.ndarray, block_ends: np.ndarray,
                     t: float) -> int:
    """The index of the latest-starting event (events sorted by start) that
    spans ``t``, the innermost where they nest; -1 when none does. Blocks whose
    latest end is before ``t`` are skipped whole."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    if i < 0:
        return -1
    b = i // BLOCK
    hit = np.flatnonzero(ends[b * BLOCK:i + 1] >= t)
    if not len(hit):
        earlier = np.flatnonzero(block_ends[:b] >= t)
        if not len(earlier):
            return -1
        b = int(earlier[-1])
        hit = np.flatnonzero(ends[b * BLOCK:(b + 1) * BLOCK] >= t)
    return b * BLOCK + int(hit[-1])


def _events(prof):
    """(name, is_device, start_us, end_us) of every event of the trace."""
    import torch

    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for ev in raw:
            start = ev.start_ns() / 1e3
            yield ev.name(), ev.device_type() == torch.autograd.DeviceType.CUDA, \
                start, start + ev.duration_ns() / 1e3
        return
    for ev in prof.events():
        yield ev.name, ev.device_type == torch.autograd.DeviceType.CUDA, \
            ev.time_range.start, ev.time_range.end


class Window:
    """``with Window(trace=...) as w:`` around the measured window: host wall
    time, and with ``trace`` a torch.profiler trace of it (``w.trace``)."""

    def __init__(self, trace: bool):
        self.tracing = trace
        self.trace: Trace | None = None
        self._prof = None

    def __enter__(self):
        if self.tracing:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def close(self) -> float:
        """End the window (the caller has synchronized); returns its seconds."""
        self.seconds = time.perf_counter() - self.t0
        return self.seconds

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        t0 = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            t1 = time.perf_counter()
            tr = Trace(window_s=self.seconds)
            for name, on_device, s, e in _events(self._prof):
                if on_device and name.startswith(SPAN_PREFIX):
                    continue  # a span's mirror on the device timeline is no device work
                (tr.device if on_device else tr.host).append((name, s, e))
            self.trace = tr
            log(f"trace: profiler stopped in {t1 - t0:.1f} s, {len(tr.device)} device and "
                f"{len(tr.host)} host events read in {time.perf_counter() - t1:.1f} s")
        self._prof = None
        return False


@contextlib.contextmanager
def span(name: str):
    """A named host span in the trace around a call into one layer."""
    import torch

    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield
