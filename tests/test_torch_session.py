"""Port parity: vittf_tpu_torch.pipeline.session and cli.serve vs vittf_tpu on
CPU, on the same volume, features and annotation sequence. Without the
bilateral solver the uint8 maps and label volumes agree bit for bit; with it
they follow the refinement slice's contract (tests/test_torch_refine.py).
"""
import shutil
import threading

import numpy as np
import pytest
import torch

from vittf_tpu.pipeline import session as js
from vittf_tpu_torch.pipeline import ntf as tn
from vittf_tpu_torch.pipeline import session as ts


def _assert_u8_close(got, want):
    """tests/test_torch_refine.py's contract for refined uint8 maps: they
    differ by at most 1 (255 and 0 are neighbours across the wraparound), and
    the voxels that differ hold one value in each map."""
    got, want = np.asarray(got), np.asarray(want)
    d = (got.astype(np.int32) - want.astype(np.int32)) % 256
    d = np.minimum(d, 256 - d)
    assert d.max() <= 1, d.max()
    diff = d > 0
    assert len(np.unique(got[diff])) <= 1 and len(np.unique(want[diff])) <= 1


def _case(seed=0, vol_size=16, feat_size=8, channels=8):
    rng = np.random.default_rng(seed)
    vol = rng.random((vol_size,) * 3).astype(np.float32)
    feats = (rng.standard_normal((channels,) + (feat_size,) * 3) * 0.4).astype(np.float32)
    return rng, vol, feats


def _frames(rng, size=16):
    """An editing session: three classes; one edited; one added and one left
    empty; one removed; all cleared; annotated again."""
    def pts(n):
        return rng.integers(0, size, (n, 3))

    a, b, c = pts(9), pts(7), pts(5)
    b2 = pts(11)
    return [
        {"a": a, "b": b, "c": c},
        {"a": a, "b": b2, "c": c},
        {"a": a, "b": b2, "c": c, "d": pts(6), "e": np.zeros((0, 3), np.int64)},
        {"a": a, "d": pts(6)},
        {},
        {"z": pts(4)},
    ]


def _pair(vol, feats, **kw):
    return (js.InteractiveSession(vol, feats, impl="xla", **kw),
            ts.InteractiveSession(vol, feats, device="cpu", **kw))


@pytest.mark.parametrize("dirty_tracking", [True, False])
def test_session_updates_match_jax_bit_for_bit(dirty_tracking):
    rng, vol, feats = _case()
    jsess, tsess = _pair(vol, feats, dirty_tracking=dirty_tracking)
    for frame in _frames(rng):
        want = jsess.update_annotations({k: v.copy() for k, v in frame.items()})
        got = tsess.update_annotations({k: v.copy() for k, v in frame.items()})
        assert list(got) == list(want) == list(frame)
        for k in frame:
            assert got[k].dtype == torch.uint8 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        if frame:
            np.testing.assert_array_equal(tsess.predict().numpy(), np.asarray(jsess.predict()))
            np.testing.assert_array_equal(tsess.predict([0.1] * len(frame)).numpy(),
                                          np.asarray(jsess.predict([0.1] * len(frame))))
        else:
            with pytest.raises(RuntimeError, match="No similarities"):
                tsess.predict()


def test_dirty_update_equals_full_recompute():
    """Clean classes keep their tensor objects; the recomputed ones equal a
    full recompute. The second edit leaves one dirty class of more than 1024
    annotations beside a clean one: alone it would take the mean-first path,
    and only the decision pinned to the full class set keeps it identical."""
    rng, vol, feats = _case(1)
    dirty = ts.InteractiveSession(vol, feats, device="cpu")
    full = ts.InteractiveSession(vol, feats, device="cpu", dirty_tracking=False)
    ann = {"a": rng.integers(0, 16, (9, 3)), "b": rng.integers(0, 16, (7, 3)),
           "c": rng.integers(0, 16, (5, 3))}
    first = dirty.update_annotations(ann)
    full.update_annotations(ann)
    for edit in ({"b": rng.integers(0, 16, (11, 3))}, {"a": rng.integers(0, 16, (1100, 3))}):
        ann = {**ann, **edit}
        out_d, out_f = dirty.update_annotations(ann), full.update_annotations(ann)
        assert out_d["c"] is first["c"] and out_f["c"] is not first["c"]
        for k in ann:
            assert torch.equal(out_d[k], out_f[k]), k
    unpinned = tn.compute_similarities(vol, torch.from_numpy(feats), {"a": ann["a"]})
    assert not torch.equal(unpinned["a"], out_d["a"])  # the case does exercise the pin
    jfull = js.InteractiveSession(vol, feats, impl="xla", dirty_tracking=False)
    want = jfull.update_annotations(ann)
    for k in ann:
        np.testing.assert_array_equal(out_d[k].numpy(), np.asarray(want[k]))


def test_single_class_mean_first_matches_jax():
    """One class of more than 1024 annotations: the session passes
    mean_first=True, as the request path decides on its own."""
    rng, vol, feats = _case(2)
    ann = {"only": rng.integers(0, 16, (1100, 3))}
    jsess, tsess = _pair(vol, feats)
    np.testing.assert_array_equal(tsess.update_annotations(ann)["only"].numpy(),
                                  np.asarray(jsess.update_annotations(ann)["only"]))
    for mean_first in (True, False, None):
        got = tn.compute_similarities(vol, torch.from_numpy(feats), ann, mean_first=mean_first)
        want = js.compute_similarities(vol, feats, ann, impl="xla", mean_first=mean_first)
        np.testing.assert_array_equal(got["only"].numpy(), np.asarray(want["only"]))


@pytest.mark.parametrize("largest_island", [False, True])
def test_refined_session_matches_jax(largest_island):
    """bilateral_solver=True (batched crops, bucket 8): full updates and a
    one-class edit, at the refinement's uint8 contract; the island filter on
    top keeps one island per map."""
    rng = np.random.default_rng(12)
    vol = np.kron(rng.random((4, 4, 4)), np.ones((6, 6, 6))).astype(np.float32)
    feats = (rng.standard_normal((16, 12, 12, 12)) * 0.4).astype(np.float32)
    jsess, tsess = _pair(vol, feats, bilateral_solver=True, largest_island=largest_island,
                         island_threshold=40)
    np.testing.assert_array_equal(tsess._bls_ref_u8.numpy(), np.asarray(jsess._bls_ref_u8))
    a, b = rng.integers(0, 24, (12, 3)), rng.integers(0, 24, (5, 3))
    for frame in ({"a": a, "b": b, "empty": np.zeros((0, 3), np.int64)},
                  {"a": a, "b": rng.integers(0, 24, (6, 3)), "empty": np.zeros((0, 3), np.int64)}):
        want = jsess.update_annotations(frame)
        got = tsess.update_annotations(frame)
        for k in frame:
            assert got[k].dtype == torch.uint8 and got[k].shape == (12, 12, 12)
            if not largest_island:
                _assert_u8_close(got[k].numpy(), np.asarray(want[k]))
        assert not got["empty"].any() and got["a"].any()
    if largest_island:
        from scipy import ndimage

        for k in ("a", "b"):
            assert ndimage.label(got[k].numpy() > 40)[1] <= 1
            assert (got[k].numpy() > 40).sum() == (np.asarray(want[k]) > 40).sum()


def test_prewarm_leaves_state_clean_and_device_is_explicit(monkeypatch):
    rng, vol, feats = _case(3)
    sess = ts.InteractiveSession(vol, feats, device="cpu", bilateral_solver=True)
    assert sess.prewarm() > 0
    assert sess.similarities == {} and sess._export_cache == {}
    assert set(sess.update_annotations({"a": rng.integers(0, 16, (8, 3))})) == {"a"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.InteractiveSession(vol, feats)


def _load(dirpath):
    sims = np.load(dirpath / "similarities.npy", allow_pickle=True)[()]
    return sims, np.load(dirpath / "predictions.npy")


def test_export_matches_jax_and_fetches_only_changed_maps(tmp_path):
    rng, vol, feats = _case(4)
    jsess, tsess = _pair(vol, feats)
    fetched = []
    real_stack = torch.stack

    def counting_stack(tensors, *a, **kw):
        fetched.append(len(tensors))
        return real_stack(tensors, *a, **kw)

    for i, frame in enumerate(_frames(rng)):
        jdir, tdir = tmp_path / f"j{i}", tmp_path / f"t{i}"
        jdir.mkdir(), tdir.mkdir()
        jsess.update_annotations(frame)
        jsess.export(jdir)
        tsess.update_annotations(frame)
        before = {k: v[1] for k, v in tsess._export_cache.items()}
        fetched.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ts.torch, "stack", counting_stack)
            tsess.export(tdir)
        (jsims, jpred), (tsims, tpred) = _load(jdir), _load(tdir)
        assert list(tsims) == list(jsims) == list(frame)
        for k in frame:
            assert tsims[k].dtype == np.uint8
            np.testing.assert_array_equal(tsims[k], jsims[k])
        assert tpred.dtype == np.uint8
        np.testing.assert_array_equal(tpred, jpred)
        assert set(tsess._export_cache) == set(frame)  # removed classes are evicted
        # one stacked copy of exactly the maps whose tensors changed
        changed = [k for k in frame if k not in before or tsess._export_cache[k][1] is not before[k]]
        assert fetched == ([len(changed)] if changed else [])
        if i == 1:
            assert changed == ["b"]
        if i == 2:
            assert changed == ["d", "e"]


def _watch_with_writer(tmp_path, session, frames, max_updates, pause=0.4, **kw):
    """Write ``frames`` one after the other from a thread, each after the
    previous one was answered (or, for a frame that must not be answered,
    after ``pause`` seconds)."""
    answered = threading.Semaphore(0)

    def writer():
        last = None
        for frame in frames:
            np.save(tmp_path / "annotations.npy", frame, allow_pickle=True)
            same = last is not None and list(frame) == list(last) and all(
                np.array_equal(frame[k], last[k]) for k in frame)
            answered.acquire(timeout=pause if same else 120)
            last = frame

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    served = ts.watch_directory(tmp_path, session, poll_interval=0.05, max_updates=max_updates,
                                on_update=lambda n, dt: answered.release(), verbose=False, **kw)
    t.join(timeout=120)
    return served


@pytest.mark.parametrize("use_inotify", [True, False])
def test_watch_directory_skips_an_identical_rewrite(tmp_path, use_inotify):
    """Three writes, the second identical to the first: two updates are
    served, and the second answer is the third write's."""
    rng, vol, feats = _case(5)
    sess = ts.InteractiveSession(vol, feats, device="cpu")
    ann_a = {"first": rng.integers(0, 16, (5, 3))}
    ann_b = {"second": rng.integers(0, 16, (6, 3))}
    served = _watch_with_writer(tmp_path, sess, [ann_a, ann_a, ann_b], 2,
                                use_inotify=use_inotify)
    assert served == 2
    sims, pred = _load(tmp_path)
    assert set(sims) == {"second"}
    want = tn.compute_similarities(vol, torch.from_numpy(feats), ann_b)
    np.testing.assert_array_equal(sims["second"], want["second"].numpy())
    np.testing.assert_array_equal(pred, tn.fuse_predictions(want).numpy())


def test_watch_directory_retries_a_partial_file(tmp_path):
    rng, vol, feats = _case(6)
    sess = ts.InteractiveSession(vol, feats, device="cpu")
    (tmp_path / "annotations.npy").write_bytes(b"\x93NUMPY\x01\x00 not a whole file")
    served = _watch_with_writer(tmp_path, sess, [{"a": rng.integers(0, 16, (4, 3))}], 1)
    assert served == 1 and set(_load(tmp_path)[0]) == {"a"}


def test_watch_directory_refined_class_changes(tmp_path):
    rng, vol, feats = _case(7)
    sess = ts.InteractiveSession(vol, feats, device="cpu", bilateral_solver=True,
                                 bls_shape_bucket=4)
    frames = [{"a": rng.integers(0, 16, (6, 3))},
              {"a": rng.integers(0, 16, (7, 3)), "b": rng.integers(0, 16, (5, 3))},
              {"b": rng.integers(0, 16, (4, 3))}, {}]
    assert _watch_with_writer(tmp_path, sess, frames, len(frames)) == len(frames)
    sims, pred = _load(tmp_path)
    assert sims == {} and pred.shape == (8, 8, 8) and not pred.any()


def _write_artifacts(d, seed=8):
    rng = np.random.default_rng(seed)
    np.save(d / "volume.npy", rng.random((12, 12, 12)).astype(np.float32))
    np.save(d / "x_features8.npy",
            np.asarray({"k": rng.standard_normal((4, 6, 6, 6)).astype(np.float16)}, dtype=object))
    np.save(d / "annotations.npy", {"liver": rng.integers(0, 12, (6, 3)),
                                    "bone": rng.integers(0, 12, (4, 3))}, allow_pickle=True)


@pytest.mark.parametrize("flags", [[], ["--bilateral-solver"]])
def test_serve_cli_writes_the_jax_cli_artifacts(tmp_path, monkeypatch, capsys, flags):
    """``serve --cpu --no-prewarm --max-updates 1`` on a directory that holds
    annotations answers them once and exits, with the artifacts of
    ``python -m vittf_tpu.cli.serve`` on a copy of the directory."""
    from vittf_tpu.cli import serve as jax_serve
    from vittf_tpu_torch.cli import serve

    monkeypatch.setenv("VITTF_NO_COMPILE_CACHE", "1")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    _write_artifacts(jdir)
    shutil.copytree(jdir, tdir)
    common = ["--no-prewarm", "--max-updates", "1", "--poll-interval", "0.05", *flags]
    assert jax_serve.main(["--data", str(jdir), "--impl", "xla", *common]) == 0
    assert serve.main(["--data", str(tdir), "--cpu", *common]) == 0
    assert "on cpu" in capsys.readouterr().out
    (jsims, jpred), (tsims, tpred) = _load(jdir), _load(tdir)
    assert list(tsims) == list(jsims) == ["liver", "bone"]
    for k in jsims:
        assert tsims[k].shape == (6, 6, 6) and tsims[k].dtype == np.uint8
        if flags:
            _assert_u8_close(tsims[k], jsims[k])
        else:
            np.testing.assert_array_equal(tsims[k], jsims[k])
    if not flags:
        np.testing.assert_array_equal(tpred, jpred)
    np.testing.assert_array_equal(
        tpred, tn.fuse_predictions_host(tsims, tn.CT_ORG_THRESHOLDS[:2]))


def test_serve_cli_prewarms_and_from_artifacts(tmp_path, capsys):
    from vittf_tpu_torch.cli import serve

    _write_artifacts(tmp_path)
    sess = ts.InteractiveSession.from_artifacts(tmp_path, device="cpu")
    assert sess.features.shape == (4, 6, 6, 6) and sess.features.dtype == torch.float32
    assert serve.main(["--data", str(tmp_path), "--cpu", "--max-updates", "1",
                       "--poll-interval", "0.05"]) == 0
    assert "Warmed up" in capsys.readouterr().out
    assert set(_load(tmp_path)[0]) == {"liver", "bone"}


def test_session_extract_matches_jax():
    """``InteractiveSession.extract``: features from the TINY model on the
    given device (rtol 1e-5, the extraction tolerance), then one update."""
    from tests.test_torch_vit import as_numpy_tree, port_cfg
    from tests.test_vit import TINY, _make_pair
    from vittf_tpu.pipeline import features as jf
    from vittf_tpu_torch.models.dino import params_from_jax
    from vittf_tpu_torch.pipeline import features as tf

    _, params = _make_pair(TINY, seed=1)
    rng = np.random.default_rng(9)
    vol = rng.random((16, 16, 16)).astype(np.float32)
    kw = dict(feature_output_size=4, slice_along="all", batch_size=3, precision="highest")
    jsess = js.InteractiveSession.extract(vol, params, TINY,
                                          jf.ExtractConfig(attn_impl="xla", **kw), impl="xla")
    tsess = ts.InteractiveSession.extract(vol, params_from_jax(as_numpy_tree(params)),
                                          port_cfg(TINY), tf.ExtractConfig(**kw), device="cpu")
    assert tsess.features.device.type == "cpu" and tsess.volume is not None
    np.testing.assert_allclose(tsess.features.numpy(), np.asarray(jsess.features),
                               rtol=1e-5, atol=1e-6)
    ann = {"a": rng.integers(0, 16, (6, 3))}
    got, want = tsess.update_annotations(ann), jsess.update_annotations(ann)
    d = np.abs(got["a"].numpy().astype(int) - np.asarray(want["a"]).astype(int))
    assert d.max() <= 1  # features 1e-5 apart may cross one quantization boundary
