"""The memory order of the session's resident features: an
``InteractiveSession`` holds them voxel-major ((W', H', D', F) in memory under
the (F, W', H', D') shape), so that its requests read the similarity kernel's
(V, F) rows in place, with no ``ntf.layout`` copy, and serve the maps that
feature-major features give, bit for bit."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vittf_tpu_torch.ops.sampling import grid_sample_3d
from vittf_tpu_torch.pipeline.ntf import compute_similarities
from vittf_tpu_torch.pipeline.session import InteractiveSession

REFINED = dict(bilateral_solver=True, bls_shape_bucket=4)


def _case(seed=0):
    rng = np.random.default_rng(seed)
    vol = rng.random((16, 16, 16)).astype(np.float32)
    feats = (rng.standard_normal((8, 8, 8, 8)) * 0.4).astype(np.float32)
    first = {n: rng.integers(0, 16, (9, 3)) for n in ("a", "b", "c")}
    edited = dict(first, b=rng.integers(0, 16, (9, 3)))
    return vol, feats, first, edited


def _layout_spans(block) -> int:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        block()
    return sum(e.name == "vittf.ntf.layout" for e in prof.events())


def test_the_session_holds_its_features_voxel_major():
    vol, feats, _, _ = _case()
    for given in (feats, torch.from_numpy(feats)):
        session = InteractiveSession(vol, given, device="cpu")
        assert session.features.shape == feats.shape
        assert session.features.dtype == torch.float32
        assert torch.movedim(session.features, 0, -1).is_contiguous()
        assert torch.equal(session.features, torch.from_numpy(feats))


@pytest.mark.parametrize("path", ["plain", "refined"])
def test_session_maps_equal_feature_major_requests_bit_for_bit(path):
    """A dirty-tracked session (voxel-major) against ``compute_similarities``
    on the feature-major volume, for the first update and then for an edit
    of one class, recomputed alone as the session does."""
    kw = REFINED if path == "refined" else {}
    vol, feats, first, edited = _case()
    session = InteractiveSession(vol, feats, device="cpu", dirty_tracking=True, **kw)
    fm = torch.from_numpy(feats)
    assert fm.is_contiguous()

    got = session.update_annotations(first)
    want = compute_similarities(vol, fm, first, **kw)
    assert list(got) == list(want)
    assert all(torch.equal(got[n], want[n]) for n in want)

    got = session.update_annotations(edited)
    want = dict(want, **compute_similarities(vol, fm, {"b": edited["b"]}, mean_first=False,
                                             **kw))
    assert all(torch.equal(got[n], want[n]) for n in want)
    assert not torch.equal(got["b"], compute_similarities(vol, fm, first, **kw)["b"])


def test_only_feature_major_requests_copy_the_layout():
    """Under a profiler a session's edit opens no ``ntf.layout`` span; one
    request on feature-major features opens exactly one."""
    vol, feats, first, edited = _case()
    session = InteractiveSession(vol, feats, device="cpu")
    session.update_annotations(first)
    assert _layout_spans(lambda: session.update_annotations(edited)) == 0
    fm = torch.from_numpy(feats)
    assert _layout_spans(lambda: compute_similarities(vol, fm, edited)) == 1


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_3d_reads_a_strided_volume_bit_for_bit(mode):
    rng = np.random.default_rng(1)
    fm = torch.from_numpy(rng.standard_normal((1, 16, 6, 7, 5)).astype(np.float32))
    vm = fm.movedim(1, -1).contiguous().movedim(-1, 1)  # the session's layout
    assert not vm.is_contiguous() and torch.equal(vm, fm)
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (1, 37, 1, 1, 3)).astype(np.float32))
    assert torch.equal(grid_sample_3d(vm, grid, mode=mode), grid_sample_3d(fm, grid, mode=mode))
