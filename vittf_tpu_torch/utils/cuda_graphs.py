"""Captured CUDA graphs by key: the port's counterpart of ``jax.jit``'s cache,
for bodies whose sequence of launches depends on their key alone (shapes,
form and static arguments), never on the values of their inputs.

``graphed(key, args, body, wrappers)`` answers ``body(*args)``:

- on a key's first sighting it runs ``body`` eagerly on the current stream
  and returns that answer, the witness itself; the key goes into a bounded
  LRU of sightings;
- on its second sighting it copies ``args`` into static buffers, captures
  ``body`` on them with ``capture_begin`` / ``capture_end`` on the device's
  capture stream (one long-lived stream per device, ordered against the
  current stream both ways), then replays. The first sighting has run the
  body in the process, so every kernel it launches is loaded and has its
  attributes set before the capture (a first use inside a capture would
  fail it); nothing it uses is specific to a stream, so the capture stream
  needs no run of its own (PERF.md §6: a capture on a stream that never
  ran the body replays equal to it). An eager run on another stream
  would miss the current stream's cached blocks and pay ``cudaMalloc``
  (70 ms against 34 at the whole grid's chunk on an H100);
- later it copies the inputs in, replays and returns a copy of the output.

It does not use ``torch.cuda.graph``, whose entry synchronizes and empties
the caching allocator and the host cache, after which every eager
allocation goes back to ``cudaMalloc``. ``GRAPHS`` keeps at most
``GRAPH_BOUND`` graphs and at most ``GRAPH_BUDGET_SHARE`` of the card's
memory in them (each entry's private memory pool, read as the change of
memory reserved around its capture, plus its input buffers), evicting the
one used least recently. A key whose one capture exceeds the budget is
replayed once, dropped, and runs eager from then on. A capture or replay
error raises: there is no eager fallback and no switch.

Launch counters: a wrapper counts its launches where it launches. A capture
launches nothing, so ``uncounted`` sets the counters back and keeps the
deltas, which each replay adds once. Under a running profiler each call is
one span of its branch, ``vittf.graph.eager``, ``.capture`` or ``.replay``
(``utils/logging.py::span``), so a trace shows what a capture costs where
it happens.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import torch

from vittf_tpu_torch.utils.logging import span

GRAPH_BOUND = 8  # captured graphs kept per process
GRAPH_BUDGET_SHARE = 0.25  # of the card's memory, held by the kept graphs' pools and buffers
SIGHTING_BOUND = 64  # keys remembered as seen once (or as too large to keep)
_SEEN, _EAGER_ONLY = "seen", "eager only"


def uncounted(run, wrappers):
    """``run()`` → (its result, {wrapper: launches it counted}), the
    counters of ``wrappers`` set back as they were: a capture records
    launches and makes none."""
    before = [fn.launches for fn in wrappers]
    try:
        out = run()
    finally:
        counted = {fn: fn.launches - n for fn, n in zip(wrappers, before) if fn.launches != n}
        for fn, n in zip(wrappers, before):
            fn.launches = n
    return out, counted


@dataclasses.dataclass
class Graph:
    """One captured body: the graph, the buffers it reads and writes, the
    launches one replay makes and the bytes it holds."""
    graph: object  # torch.cuda.CUDAGraph
    inputs: tuple
    output: torch.Tensor
    launches: dict
    nbytes: int

    def __call__(self, *args) -> torch.Tensor:
        """Copy the inputs in, replay, count the replay's launches and
        return a copy of the output, which the next replay overwrites."""
        for buf, x in zip(self.inputs, args):
            buf.copy_(x)
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        return self.output.clone()


class GraphCache:
    """Captured graphs by key under the sighting policy, within ``bound``
    entries and ``budget`` bytes (None: ``GRAPH_BUDGET_SHARE`` of the
    device's memory). ``hits`` counts replays of a kept graph, ``misses``
    captures, ``eager`` first sightings run eager; ``lock`` orders callers
    from several threads."""

    def __init__(self, bound: int = GRAPH_BOUND, budget: int | None = None,
                 sighting_bound: int = SIGHTING_BOUND):
        self.bound, self.budget, self.sighting_bound = bound, budget, sighting_bound
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.sightings: collections.OrderedDict = collections.OrderedDict()
        self.hits = self.misses = self.eager = 0
        self.lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        return sum(entry.nbytes for entry in self.entries.values())

    def budget_bytes(self, device: torch.device) -> int:
        if self.budget is not None:
            return self.budget
        return int(GRAPH_BUDGET_SHARE * torch.cuda.get_device_properties(device).total_memory)

    def _sight(self, key, what: str) -> None:
        self.sightings[key] = what
        while len(self.sightings) > self.sighting_bound:
            self.sightings.popitem(last=False)

    def _evict(self, count: int, nbytes: int) -> None:
        """Drop the entries used least recently until at most ``count`` and
        ``nbytes`` are kept, and give their memory pools back to the card."""
        evicted = False
        while self.entries and (len(self.entries) > count or self.nbytes > nbytes):
            self.entries.popitem(last=False)
            evicted = True
        if evicted:
            _release()

    def call(self, key, args, eager, make, budget: int):
        """The answer of ``key`` for ``args``: the kept graph's replay;
        ``eager(*args)`` on a first sighting (and for a key too large to
        keep); on a second sighting the graph ``make(*args)`` captures,
        replayed, and kept if it fits in ``budget`` bytes."""
        entry = self.entries.get(key)
        if entry is not None:
            self.hits += 1
            self.entries.move_to_end(key)
            with span("graph.replay"):
                return entry(*args)
        seen = self.sightings.pop(key, None)
        if seen is None or seen == _EAGER_ONLY:
            self._sight(key, seen or _SEEN)
            self.eager += 1
            with span("graph.eager"):
                return eager(*args)
        self.misses += 1
        with span("graph.capture"):
            self._evict(self.bound - 1, budget)  # room first, for the capture's own pool
            entry = make(*args)
            if entry.nbytes > budget:
                self._sight(key, _EAGER_ONLY)
                out = entry(*args)  # its one replay
                del entry
                _release()
                return out
            self.entries[key] = entry
            self._evict(self.bound, budget)
            return entry(*args)

    def clear(self) -> None:
        self.entries.clear()
        self.sightings.clear()


GRAPHS = GraphCache()
_CAPTURE_STREAMS: dict = {}


def _release() -> None:
    """Give the memory pools of dropped graphs back to the card. A dropped
    graph's pool stays reserved until the caching allocator is emptied (no
    later capture or eager call reuses it), so this empties it: a cost of a
    few ms on the next eager calls, paid only when a graph is dropped. A
    no-op while CUDA is not initialized."""
    torch.cuda.empty_cache()


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The device's one capture stream, made on first use."""
    stream = _CAPTURE_STREAMS.get(device.index)
    if stream is None:
        stream = _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    return stream


def capture(body, args, wrappers) -> Graph:
    """Capture ``body`` on static copies of ``args`` on the capture stream,
    ordered after the current stream's work so far and before its work to
    come, without emptying any cache; the capture's launches are not
    counted."""
    device = args[0].device
    inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x) for x in args)
    graph = torch.cuda.CUDAGraph()
    stream, current = capture_stream(device), torch.cuda.current_stream(device)
    reserved = torch.cuda.memory_reserved(device)

    def run():
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                return body(*inputs)
            finally:
                graph.capture_end()

    output, launches = uncounted(run, wrappers)
    current.wait_stream(stream)
    pool = max(torch.cuda.memory_reserved(device) - reserved, output.nbytes)
    return Graph(graph, inputs, output, launches, pool + sum(buf.nbytes for buf in inputs))


def graphed(key, args, body, wrappers, cache: GraphCache = GRAPHS) -> torch.Tensor:
    """``body(*args)`` for CUDA tensors ``args`` under ``cache``'s policy
    (module docstring); ``wrappers`` are the kernel wrappers whose launch
    counters ``body`` moves."""
    device = args[0].device
    with cache.lock:  # a replay's buffers serve one call at a time
        return cache.call(key, args, body, lambda *a: capture(body, a, wrappers),
                          cache.budget_bytes(device))
