"""``edit_layout_copies``, the feature-volume copies an edit makes into the
similarity kernel's rows (``vittf.ntf.layout`` spans over
``vittf.session.update`` spans): on hand traces, and, on a card, a session's
voxel-major features serving the maps of the feature-major volume with no
copy of the volume."""
import math
from types import SimpleNamespace

import pytest

from portbench.harness import edit, spec
from portbench.harness.trace import Trace
from portbench.tests import tiny

SEED = 2**33 + 29
EDITS = [("vittf.session.update", 1.0, 20.0), ("vittf.session.predict", 20.0, 25.0),
         ("vittf.session.update", 30.0, 50.0), ("vittf.session.predict", 50.0, 55.0)]
LAYOUTS = [("vittf.ntf.layout", 5.0, 8.0), ("vittf.ntf.layout", 35.0, 38.0)]


def read(host, trace=True):
    tr = Trace(window_s=60e-6, device=[("similarity_kernel", 0.0, 10.0)], host=host)
    ctx = SimpleNamespace(trace=tr if trace else None, window_s=60e-6, counters={}, work={})
    return spec.layer_reader("edit_layout_copies")(ctx)


def test_edit_layout_copies_on_hand_traces():
    assert read(EDITS + LAYOUTS) == pytest.approx(1.0)
    assert read(EDITS + LAYOUTS[:1]) == pytest.approx(0.5)
    assert read(EDITS) == 0.0
    # no update to count by (an extraction) or no trace: no value
    assert read(LAYOUTS + [("vittf.features.extract", 0.0, 10.0)]) is None
    assert read(EDITS + LAYOUTS, trace=False) is None


def _volume_copies(prof, numel: int, inside: str) -> list:
    """The copy operators of the profile, inside the span named ``inside``,
    over a tensor of ``numel`` elements."""
    def within(ev):
        p = ev.cpu_parent
        while p is not None and p.name != inside:
            p = p.cpu_parent
        return p is not None

    return [e.name for e in prof.events()
            if e.name in ("aten::copy_", "aten::clone", "aten::contiguous")
            and any(s and math.prod(s) == numel for s in e.input_shapes) and within(e)]


@pytest.mark.card
@pytest.mark.parametrize("refined", [True, False], ids=["refined", "plain"])
def test_a_voxel_major_session_copies_no_volume_and_serves_the_same_maps(card, refined):
    """K2's maps from the session's voxel-major features equal, bit for bit,
    those of requests on the contiguous feature-major volume, through the
    refine core's eager run, capture and replays; a profiled edit copies no
    tensor of the volume's size under ``vittf.session.update``, where a
    feature-major request copies it once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vittf_tpu_torch.pipeline.ntf import compute_similarities
    from vittf_tpu_torch.pipeline.session import InteractiveSession

    cell = tiny.edit_cell(refined)
    vol, feats, painter = edit.make_inputs(cell, SEED, card)
    vol_np = vol.cpu().numpy()
    fm = feats.contiguous()
    kw = dict(bilateral_solver=refined, bls_shape_bucket=cell.traffic["bls_shape_bucket"])
    session = InteractiveSession(vol_np, feats, dirty_tracking=False, device=card, **kw)
    assert torch.movedim(session.features, 0, -1).is_contiguous()
    assert torch.equal(session.features, fm)
    for _ in range(4):
        painter.edit()
        got = session.update_annotations(painter.state)
        want = compute_similarities(vol_np, fm, painter.state, **kw)
        assert list(got) == list(want)
        assert all(torch.equal(got[n], want[n]) for n in want)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    painter.edit()
    with profile(activities=acts, record_shapes=True) as prof:
        session.update_annotations(painter.state)
        torch.cuda.synchronize(card)
    assert _volume_copies(prof, fm.numel(), "vittf.session.update") == []
    with profile(activities=acts, record_shapes=True) as prof:
        compute_similarities(vol_np, fm, painter.state, **kw)
        torch.cuda.synchronize(card)
    assert len(_volume_copies(prof, fm.numel(), "vittf.ntf.layout")) >= 1
