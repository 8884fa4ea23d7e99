"""The trace reader's arithmetic on a hand-made trace, and the per-layer
readers on it."""
from types import SimpleNamespace

import pytest

from portbench.harness import flops, spec
from portbench.harness.trace import Trace


def hand_trace():
    # device: [0, 10) and [5, 20) overlap, then [30, 40); host: a span over all,
    # a copy inside the first gap
    return Trace(window_s=50e-6,
                 device=[("k2 similarity_kernel(Args)", 0.0, 10.0), ("copy", 5.0, 20.0),
                         ("similarity_kernel", 30.0, 40.0)],
                 host=[("portbench.update", 0.0, 45.0), ("aten::copy_", 21.0, 29.0)])


def test_busy_is_the_union_of_intervals():
    assert hand_trace().busy_s() == pytest.approx(30e-6)


def test_kernel_time_by_name_and_breakdown():
    tr = hand_trace()
    assert tr.kernel_seconds(r"similarity_kernel") == (pytest.approx(20e-6), 2)
    ops = tr.device_ops()
    assert ops[0][0] in ("copy", "k2 similarity_kernel(Args)") and len(ops) == 3
    assert tr.idle_gaps() == [["aten::copy_", pytest.approx(10e-6)]]


def test_readers_on_a_hand_trace():
    tr = hand_trace()
    ctx = SimpleNamespace(trace=tr, window_s=tr.window_s, counters={"graph_hits": 3,
                          "graph_misses": 1, "graph_eager": 0},
                          work={"similarity": [(2, 67e12 * 5e-6, 1.0)],
                                "similarity_flops": 2 * 67e12 * 5e-6})
    assert spec.layer_reader("similarity_roofline")(ctx) == pytest.approx(50.0)
    assert spec.layer_reader("edit_mfu")(ctx) == pytest.approx(20.0)
    assert spec.layer_reader("edit_idle_share")(ctx) == pytest.approx(40.0)
    assert spec.layer_reader("graph_replay_share")(ctx) == pytest.approx(75.0)
    # nothing to read: no value, never 0
    assert spec.layer_reader("fused_block_roofline")(ctx) is None
    assert spec.layer_reader("extract_mfu")(ctx) is None
    ctx.counters = {}
    assert spec.layer_reader("graph_replay_share")(ctx) is None


def test_roofline_takes_the_larger_bound():
    assert flops.bound_seconds(989e12, 0.0, flops.PEAK_BF16_FLOPS) == pytest.approx(1.0)
    assert flops.bound_seconds(0.0, 3.35e12, flops.PEAK_BF16_FLOPS) == pytest.approx(1.0)
