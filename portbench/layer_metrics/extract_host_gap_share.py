"""Share of the traced extraction window in which the card ran nothing
while the host was inside ``extract_features`` (the program's
``vittf.features.extract`` spans): the idle the program's own host work
leaves, the harness's synchronize between calls left out. The helpers
here are shared with the other readers of the program's spans."""
import numpy as np

PREFIX = "vittf."


def program_spans(trace) -> dict:
    """Span name without the prefix → [(start, end)] of the program's host
    spans, gathered in one pass over the trace's host events and kept."""
    got = trace._cache.get("program spans")
    if got is None:
        got = {}
        for n, s, e in trace.host:
            if n.startswith(PREFIX):
                got.setdefault(n[len(PREFIX):], []).append((s, e))
        trace._cache["program spans"] = got
    return got


def spans(trace, *names) -> np.ndarray:
    """(n, 2) start and end, in microseconds and start order, of the
    program's spans named ``names``."""
    by_name = program_spans(trace)
    a = np.array([se for n in names for se in by_name.get(n, ())], dtype=np.float64)
    a = a.reshape(-1, 2)
    return a[np.argsort(a[:, 0], kind="stable")]


def merged(a: np.ndarray) -> np.ndarray:
    """Sorted intervals ``a`` merged into disjoint ones."""
    if not len(a):
        return a
    reach = np.maximum.accumulate(a[:, 1])
    first = np.flatnonzero(np.r_[True, a[1:, 0] > reach[:-1]])
    return np.stack([a[first, 0], reach[np.r_[first[1:] - 1, len(a) - 1]]], axis=1)


def idle_seconds(trace, a: np.ndarray) -> float:
    """Seconds inside the sorted intervals ``a`` in which the card ran
    nothing: their length less the device busy union's part of them."""
    a = merged(a)
    bs, be = trace._union()
    length = float((a[:, 1] - a[:, 0]).sum())
    if not len(bs):
        return length / 1e6
    done = np.r_[0.0, np.cumsum(be - bs)]  # busy time of the first k intervals

    def busy_until(t):
        k = np.searchsorted(bs, t, side="right")  # busy intervals started by t
        j = np.maximum(k - 1, 0)
        return np.where(k > 0, done[j] + np.clip(t - bs[j], 0.0, be[j] - bs[j]), 0.0)

    busy = float((busy_until(a[:, 1]) - busy_until(a[:, 0])).sum())
    return (length - busy) / 1e6


def read(ctx):
    if ctx.trace is None:
        return None
    a = spans(ctx.trace, "features.extract")
    if not len(a):
        return None
    return 100.0 * idle_seconds(ctx.trace, a) / ctx.window_s
