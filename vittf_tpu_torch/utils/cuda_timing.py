"""The card's time of a call, read between CUDA events.

``one_call_ms`` times one call between two events: the host's launch path of
the call lies between them, which matters for launches of tens of µs.
``ten_call_ms`` queues its events behind fp32 matrix products, so that the
host has enqueued every call before the card reaches the first: it reads
device time only. ``copy_floor`` makes a device-to-device copy of a given
size, the floor timed beside a kernel that has no library counterpart. All
need a CUDA card.
"""
from __future__ import annotations

import statistics

import torch

from vittf_tpu_torch.utils.tensor import ieee_matmul

L2_SCRUB_BYTES = 128 << 20  # more than twice the H100's 50 MB L2
MAX_QUEUED_PRODUCTS = 64  # fp32 3072³ products, ~0.9 ms each on an H100


def one_call_ms(fn, reps: int = 7) -> float:
    """Median time of one call between two CUDA events, after one warm-up
    call: the host's launch path of the call lies between the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _event_pairs(fn, calls: int, scrub) -> list:
    """Enqueue ``calls`` calls of ``fn`` with their events: one pair around
    all of them, or, given ``scrub``, one pair around each call with
    ``scrub`` read before it. The read evicts the L2 and leaves it clean: a
    write would leave dirty lines that the call then has to write back."""
    def event():
        return torch.cuda.Event(enable_timing=True)

    if scrub is None:
        pair = (event(), event())
        pair[0].record()
        for _ in range(calls):
            fn()
        pair[1].record()
        return [pair]
    pairs = []
    for _ in range(calls):
        scrub.sum()
        pair = (event(), event())
        pair[0].record()
        fn()
        pair[1].record()
        pairs.append(pair)
    return pairs


def ten_call_ms(fn, calls: int = 10, reps: int = 7, cold_l2: bool = False) -> float:
    """Median device time of one call of ``fn`` in ms: ``calls`` calls timed
    between CUDA events, divided by ``calls``. The events are queued behind
    IEEE fp32 3072³ products (whatever the TF32 setting), so that the card
    reaches the first call only after the host has enqueued the last: the
    host's launch path stays off the card's clock. If the card got there
    first, the reading is taken again behind twice the products.

    ``cold_l2``: read a 128 MB buffer before each call and time each call
    between its own events, for callers that find the L2 cold."""
    busy = torch.ones((3072, 3072), device="cuda")
    scrub = torch.zeros(L2_SCRUB_BYTES // 4, device="cuda") if cold_l2 else None
    fn()
    torch.cuda.synchronize()
    times, queued = [], 1
    while len(times) < reps:
        with ieee_matmul():
            for _ in range(queued):
                torch.mm(busy, busy)
        pairs = _event_pairs(fn, calls, scrub)
        ran_dry = pairs[0][0].query()  # the card reached the first call already
        torch.cuda.synchronize()
        if not ran_dry:
            times.append(sum(s.elapsed_time(e) for s, e in pairs) / calls)
        elif queued < MAX_QUEUED_PRODUCTS:
            queued *= 2
        else:
            raise RuntimeError(f"the card caught up with the host behind {queued} products")
    return statistics.median(times)


def copy_floor(n_words: int):
    """A call that copies ``n_words`` fp32 words on the card (``dst.copy_(src)``):
    the least time any kernel that reads and writes as many bytes once can
    take. A floor to time beside a kernel, not a library call for its
    function."""
    src = torch.randn(n_words, device="cuda")
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)
