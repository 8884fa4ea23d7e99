"""The port's profiler spans (``vittf_tpu_torch.utils.logging.span``): free
without a profiler, plain CPU operators (never annotations the profiler
mirrors onto the device timeline) nested by the thread, and the span tree
of an edit, an extraction and the graph cache's three branches."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vittf_tpu_torch.models.vit import ViTConfig, VisionTransformer
from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features
from vittf_tpu_torch.pipeline.session import InteractiveSession
from vittf_tpu_torch.utils import logging as tlog
from vittf_tpu_torch.utils.cuda_graphs import GraphCache

TINY = ViTConfig(patch_size=4, embed_dim=32, depth=2, num_heads=4, img_size=16, name="tiny")


def _parent(ev):
    """The name of the nearest enclosing span, without its prefix."""
    p = ev.cpu_parent
    while p is not None and not p.name.startswith(tlog.SPAN_PREFIX):
        p = p.cpu_parent
    return p.name[len(tlog.SPAN_PREFIX):] if p is not None else None


def traced(block, record_shapes=False):
    """``block()`` under a CPU profiler → [(span, parent span, inputs)] in
    start order, names without the prefix."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=record_shapes) as prof:
        block()
    evs = sorted((e for e in prof.events() if e.name.startswith(tlog.SPAN_PREFIX)),
                 key=lambda e: e.time_range.start)
    return [(e.name[len(tlog.SPAN_PREFIX):], _parent(e), e.concrete_inputs) for e in evs]


def tree(block):
    return [(name, parent) for name, parent, _ in traced(block)]


def test_span_without_a_profiler_makes_no_record(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record was made with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    with tlog.span("outer", 3):
        with tlog.span("inner"):
            pass
    session, edits = _session(bilateral_solver=False)
    session.update_annotations(edits[0])
    session.predict()


def test_spans_nest_and_are_plain_cpu_operators():
    """Each span is a ``cpu_op``: the profiler makes no device mirror of it,
    which a ``record_function`` annotation would get and a trace would read
    as device work."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tlog.span("outer", 7):
            torch.ones(4).sum()
            with tlog.span("inner"):
                torch.ones(4).sum()
    mine = [ev for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith(tlog.SPAN_PREFIX)]
    assert sorted(ev.name() for ev in mine) == ["vittf.inner", "vittf.outer"]
    assert not any(ev.is_user_annotation() for ev in mine)
    assert all(ev.device_type() == torch.autograd.DeviceType.CPU for ev in mine)
    by_name = {e.name: e for e in prof.events() if e.name.startswith(tlog.SPAN_PREFIX)}
    assert _parent(by_name["vittf.inner"]) == "outer" and _parent(by_name["vittf.outer"]) is None


def _session(bilateral_solver, **kw):
    rng = np.random.default_rng(0)
    vol = rng.random((16, 16, 16)).astype(np.float32)
    feats = (rng.standard_normal((8, 8, 8, 8)) * 0.4).astype(np.float32)
    first = {n: rng.integers(0, 16, (9, 3)) for n in ("a", "b", "c")}
    edited = dict(first, b=rng.integers(0, 16, (9, 3)))
    session = InteractiveSession(vol, feats, bilateral_solver=bilateral_solver, device="cpu",
                                 **kw)
    return session, [first, edited]


EDIT_HEAD = [("session.update", None), ("session.dirty", "session.update"),
             ("ntf.pack", "session.update"), ("sync.upload", "ntf.pack"),
             ("ntf.sample", "session.update"), ("ntf.k2", "session.update")]
EDIT_TAIL = [("session.predict", None), ("ntf.fuse", "session.predict")]
EDIT_TREES = {
    "plain": (dict(bilateral_solver=False),
              EDIT_HEAD + [("ntf.quantize", "session.update")] + EDIT_TAIL),
    "refined": (dict(bilateral_solver=True, bls_shape_bucket=4),
                EDIT_HEAD + [("refine.boxes", "session.update"), ("sync.boxes", "refine.boxes"),
                             ("sync.nonempty", "refine.boxes"), ("refine.plan", "session.update")]
                + EDIT_TAIL),
}


@pytest.mark.parametrize("path", sorted(EDIT_TREES))
def test_an_edit_gives_the_span_tree(path):
    kw, want = EDIT_TREES[path]
    session, (first, edited) = _session(**kw)
    session.update_annotations(first)
    session.predict()

    def edit():
        session.update_annotations(edited)
        session.predict()

    got = tree(edit)
    assert got == want
    assert sum(name.startswith("sync.") for name, _ in got) == {"plain": 1, "refined": 3}[path]


def test_an_updates_spans_carry_its_identifier():
    """With ``record_shapes`` the update counter is the input of the
    update's and the following predict's spans."""
    session, (first, edited) = _session(bilateral_solver=False)
    session.update_annotations(first)

    def edit():
        session.update_annotations(edited)
        session.predict()

    got = {name: inputs for name, _, inputs in traced(edit, record_shapes=True)}
    assert session.updates == 2
    assert got["session.update"] == [2] and got["session.predict"] == [2]


def test_export_spans_its_fetch_only_when_a_map_changed(tmp_path):
    session, (first, edited) = _session(bilateral_solver=False)
    session.update_annotations(first)
    assert tree(lambda: session.export(tmp_path)) == [("session.export", None),
                                                      ("sync.export", "session.export")]
    assert tree(lambda: session.export(tmp_path)) == [("session.export", None)]


def test_an_extraction_gives_the_span_tree():
    params = VisionTransformer(TINY, in_chans=1).state_dict()
    vol = np.random.default_rng(1).random((16, 16, 16)).astype(np.float32)
    cfg = ExtractConfig(feature_output_size=4, slice_along="all", batch_size=3)
    got = tree(lambda: extract_features(vol, params, TINY, cfg, device="cpu"))
    per_axis = [("features.axis", "features.extract"), ("sync.pool", "features.axis")] \
        + [("features.batch", "features.axis")] * 6 + [("features.merge", "features.extract")]
    assert got == [("features.extract", None), ("sync.volume", "features.extract"),
                   ("features.build_model", "features.extract")] + per_axis * 3


class _FakeGraph:
    nbytes = 0

    def __call__(self, *args):
        return "replayed"


def test_graph_cache_spans_each_branch():
    cache = GraphCache(budget=1 << 20)

    def three_calls():
        return [cache.call("key", (), lambda: "eager", lambda: _FakeGraph(), 1 << 20)
                for _ in range(3)]

    got = []
    assert tree(lambda: got.extend(three_calls())) == [
        ("graph.eager", None), ("graph.capture", None), ("graph.replay", None)]
    assert got == ["eager", "replayed", "replayed"]
    assert (cache.eager, cache.misses, cache.hits) == (1, 1, 1)


def test_profile_trace_shows_the_spans(tmp_path):
    """The operator's Chrome trace holds the spans as CPU operators."""
    session, (first, _) = _session(bilateral_solver=False)
    with tlog.profile_trace(tmp_path) as logdir:
        session.update_annotations(first)
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    mine = [e for e in events if e.get("name", "").startswith(tlog.SPAN_PREFIX)]
    assert {e["name"] for e in mine} >= {"vittf.session.update", "vittf.ntf.k2"}
    assert all(e["cat"] == "cpu_op" for e in mine)
