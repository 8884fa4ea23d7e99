"""The readers of the program's spans (``vittf.<name>``): on a hand-made
trace, on a traced tiny run on the CPU, and, on a card, each edit's
``vittf.sync.*`` spans against the synchronizing calls CUDA's sync debug
mode reports."""
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.harness import edit, spec
from portbench.harness.trace import Trace, Window
from portbench.tests import tiny

SEED = 2**33 + 17

# the program's spans (vittf_tpu_torch.utils.logging.span) in the hand trace:
# one edit, update [1, 28) and predict [28, 35), two syncs inside it and one
# outside; an extraction call [38, 50) whose model build is [41, 44)
PROGRAM_SPANS = [("vittf.session.update", 1.0, 28.0), ("vittf.sync.upload", 2.0, 4.0),
                 ("vittf.sync.boxes", 22.0, 24.0), ("vittf.session.predict", 28.0, 35.0),
                 ("vittf.features.extract", 38.0, 50.0),
                 ("vittf.features.build_model", 41.0, 44.0), ("vittf.sync.pool", 46.0, 48.0)]
PROGRAM_READERS = ("edit_host_gap_ms", "edit_syncs", "extract_build_share",
                   "extract_host_gap_share")


def hand_trace(program_spans=True):
    # device: [0, 10) and [5, 20) overlap, then [30, 40); host: a span over all,
    # a copy inside the first gap, and the program's spans
    return Trace(window_s=50e-6,
                 device=[("k2 similarity_kernel(Args)", 0.0, 10.0), ("copy", 5.0, 20.0),
                         ("similarity_kernel", 30.0, 40.0)],
                 host=[("portbench.update", 0.0, 45.0), ("aten::copy_", 21.0, 29.0)]
                 + (PROGRAM_SPANS if program_spans else []))


def test_readers_of_the_programs_spans_on_a_hand_trace():
    tr = hand_trace()
    ctx = SimpleNamespace(trace=tr, window_s=tr.window_s, counters={}, work={})
    # idle inside [1, 35): [20, 30) → 10 µs over one update
    assert spec.layer_reader("edit_host_gap_ms")(ctx) == pytest.approx(0.01)
    assert spec.layer_reader("edit_syncs")(ctx) == pytest.approx(2.0)  # sync.pool is outside
    assert spec.layer_reader("extract_build_share")(ctx) == pytest.approx(6.0)
    # idle inside [38, 50): [40, 50) → 10 of 50 µs
    assert spec.layer_reader("extract_host_gap_share")(ctx) == pytest.approx(20.0)


def test_readers_of_the_programs_spans_read_nothing_without_them():
    """A program without the spans (the parent of the change that added
    them) reads no value, never 0."""
    for trace in (hand_trace(program_spans=False), None):
        ctx = SimpleNamespace(trace=trace, window_s=50e-6, counters={}, work={})
        assert all(spec.layer_reader(m)(ctx) is None for m in PROGRAM_READERS)


def test_idle_inside_spans_merges_them_and_cuts_busy_intervals():
    from portbench.layer_metrics.extract_host_gap_share import idle_seconds, merged

    tr = Trace(window_s=1.0, device=[("k", 10.0, 20.0), ("k", 30.0, 40.0)])
    a = np.array([[0.0, 15.0], [5.0, 12.0], [18.0, 35.0], [50.0, 60.0]])
    assert merged(a).tolist() == [[0.0, 15.0], [18.0, 35.0], [50.0, 60.0]]
    # [0, 15) idle 10; [18, 35) idle 10; [50, 60) idle 10
    assert idle_seconds(tr, a) == pytest.approx(30e-6)
    assert idle_seconds(Trace(window_s=1.0), a) == pytest.approx(42e-6)


@pytest.mark.parametrize("refined,syncs", [(True, 3), (False, 1)])
def test_a_traced_tiny_edit_run_reads_the_programs_spans(refined, syncs):
    """A ``--trace 1`` edit run on the CPU (no device events): each edit's
    syncs, and the window's host time inside the session's spans."""
    out = edit.run(tiny.edit_cell(refined), SEED, 0.5, True, time.perf_counter(), device="cpu")
    assert out.correct and out.trace is not None
    assert spec.layer_reader("edit_syncs")(out) == pytest.approx(syncs)
    assert spec.layer_reader("edit_host_gap_ms")(out) > 0
    assert spec.layer_reader("extract_build_share")(out) is None


SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.mark.card
@pytest.mark.parametrize("refined", [True, False], ids=["refined", "plain"])
def test_every_sync_of_an_edit_has_its_span(card, refined):
    """Edits on the card (after warm rounds, so that the refine core
    replays) under CUDA's sync debug mode: as many synchronizing calls as
    ``vittf.sync.*`` spans, and no span mirrored onto the device."""
    import torch

    from vittf_tpu_torch.pipeline.session import InteractiveSession

    cell = tiny.edit_cell(refined)
    vol, feats, painter = edit.make_inputs(cell, SEED, card)
    session = InteractiveSession(vol.cpu().numpy(), feats, bilateral_solver=refined,
                                 bls_shape_bucket=cell.traffic["bls_shape_bucket"],
                                 dirty_tracking=True, device=card)
    for _ in range(3 * len(painter.names) + 1):
        painter.edit()
        session.update_annotations(painter.state)
        session.predict()
    torch.cuda.synchronize(card)
    edits = 2 * len(painter.names)
    with Window(trace=True) as w:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _ in range(edits):
                    painter.edit()
                    session.update_annotations(painter.state)
                    session.predict()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize(card)
        w.close()
    warned = sum(SYNC_WARNING in str(c.message) for c in caught)
    spans = sum(name.startswith("vittf.sync.") for name, _, _ in w.trace.host)
    assert warned == spans == edits * (3 if refined else 1)
    assert not [name for name, _, _ in w.trace.device if name.startswith("vittf.")]
