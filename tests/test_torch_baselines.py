"""Port parity: the SVM / Random-Forest baselines of vittf_tpu_torch
(``pipeline/baselines.py``, ``cli/predict_svm_rf.py``) vs vittf_tpu on CPU.

The same seeded numpy volumes and annotations go through both packages.
``compose_features`` is held at 1e-5 (fp32 sums in another order); the
device SVM prediction must give ``clf.predict``'s labels and the JAX
function's on a real fitted ``SVC``; the CLI's artifacts equal the JAX
CLI's for the same seed (the random forest is seeded through numpy's global
state, which both CLIs leave to sklearn).
"""
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.cli import predict_svm_rf as jcli
from vittf_tpu.pipeline import baselines as jb
from vittf_tpu_torch.cli import predict_svm_rf as tcli
from vittf_tpu_torch.pipeline import baselines as tb


def _phantom(seed, shape=(12, 14, 10)):
    rng = np.random.default_rng(seed)
    lab = np.zeros(shape, np.uint8)
    lab[2:6, 2:7, 1:5] = 1
    lab[7:11, 6:12, 5:9] = 2
    vol = (lab == 1) * 0.9 + (lab == 2) * 0.4 + rng.random(shape) * 0.05
    return vol.astype(np.float32), lab, rng


def _annotations(lab, rng, n=24):
    out = {}
    for name, cls in (("ntf2", 2), ("ntf1", 1), ("background", 0)):
        coords = np.argwhere(lab == cls)
        out[name] = coords[rng.choice(len(coords), n, replace=False)]
    return out


@pytest.mark.parametrize("shape", [(8, 9, 10), (12, 14, 10), (5, 5, 5)])
def test_compose_features_matches_jax(shape):
    vol = np.random.default_rng(0).random(shape).astype(np.float32) + 0.1
    want = np.asarray(jb.compose_features(jnp.asarray(vol)))
    got = tb.compose_features(torch.from_numpy(vol)).numpy()
    assert got.shape == want.shape == (11,) + shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_get_neighbors6_order_and_padding():
    v = np.random.default_rng(1).random((1, 4, 5, 6)).astype(np.float32)
    want = np.asarray(jb.get_neighbors6(jnp.asarray(v)))
    got = tb.get_neighbors6(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, -1], v[0, -1])  # +w at the edge replicates
    np.testing.assert_array_equal(got[5, :, :, 0], v[0, :, :, 0])  # −d at the edge


def test_sample_train_data_matches_jax():
    vol, lab, rng = _phantom(2)
    ann = _annotations(lab, rng)
    feats = np.asarray(jb.compose_features(jnp.asarray(vol)))
    wx, wy = jb.sample_train_data(jnp.asarray(feats), ann)
    gx, gy = tb.sample_train_data(torch.from_numpy(feats), ann)
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    assert gy.dtype == np.uint8 and list(np.unique(gy)) == [0, 1, 2]


def test_sample_background_border_matches_jax():
    np.testing.assert_array_equal(tb.sample_background_border((12, 11, 10)),
                                  jb.sample_background_border((12, 11, 10)))


@pytest.fixture(scope="module")
def fitted():
    from sklearn.svm import SVC

    vol, lab, rng = _phantom(3)
    ann = _annotations(lab, rng)
    feats = np.asarray(jb.compose_features(jnp.asarray(vol)))
    X, y = jb.sample_train_data(jnp.asarray(feats), ann)
    flat = np.ascontiguousarray(np.moveaxis(feats, 0, -1).reshape(-1, 11))
    return {k: SVC(kernel=k).fit(X, y) for k in ("rbf", "linear")}, flat


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_svm_predict_device_matches_sklearn_and_jax(fitted, kernel, route):
    clfs, flat = fitted
    clf = clfs[kernel]
    want = clf.predict(flat)
    x = torch.from_numpy(flat) if route == "resident" else flat
    got = tb.svm_predict_device(clf, x, chunk=1024, device="cpu")
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jb.svm_predict_device(clf, flat))


def test_svm_predict_device_ragged_last_chunk(fitted):
    clfs, flat = fitted
    part = flat[:1500]  # 1024 + 476
    np.testing.assert_array_equal(
        tb.svm_predict_device(clfs["rbf"], part, chunk=1024, device="cpu"),
        clfs["rbf"].predict(part))


def test_ovo_weights_and_gamma_match_jax(fitted):
    clf = fitted[0]["rbf"]
    for a, b in zip(tb._build_ovo_weights(clf), jb._build_ovo_weights(clf)):
        np.testing.assert_array_equal(a, b)
    assert tb._resolve_gamma(clf) == jb._resolve_gamma(clf) == clf._gamma
    fake = types.SimpleNamespace(gamma="auto", n_features_in_=4)
    assert tb._resolve_gamma(fake) == 0.25
    with pytest.raises(AttributeError, match="cannot resolve"):
        tb._resolve_gamma(types.SimpleNamespace(gamma="scale"))
    with pytest.raises(ValueError, match="rbf/linear"):
        tb.svm_predict_device(types.SimpleNamespace(kernel="poly"), np.zeros((1, 11)))


def test_svm_predict_device_needs_a_device_for_host_input(fitted, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.svm_predict_device(fitted[0]["rbf"], fitted[1][:8])


@pytest.mark.parametrize("device_predict", [False, True])
@pytest.mark.parametrize("exclude_bg", [False, True])
def test_run_svm_rf_matches_jax(device_predict, exclude_bg):
    vol, lab, rng = _phantom(4)
    ann = _annotations(lab, rng)
    if exclude_bg:
        ann.pop("background")
    kw = dict(labels=lab, rf_estimators=8, exclude_bg=exclude_bg, device_predict=device_predict)
    np.random.seed(0)
    want = jb.run_svm_rf(vol, ann, **kw)
    np.random.seed(0)
    got = tb.run_svm_rf(vol, ann, device="cpu", **kw)
    assert set(got) == set(want) == {"svm", "rf"}
    for name in got:
        np.testing.assert_array_equal(got[name]["pred"], want[name]["pred"])
        gm, wm = got[name]["metrics"], want[name]["metrics"]
        assert gm["confusion_matrix"] == wm["confusion_matrix"]
        assert gm["mIoU"] == pytest.approx(wm["mIoU"], rel=1e-6)
        assert {"fit_time", "predict_time"} <= set(gm)
    if exclude_bg:
        assert (got["svm"]["pred"][lab == 0] == 0).all()


def test_run_svm_rf_exclude_bg_needs_labels():
    vol, lab, rng = _phantom(5)
    with pytest.raises(ValueError, match="requires labels"):
        tb.run_svm_rf(vol, _annotations(lab, rng), exclude_bg=True, device="cpu")


@pytest.mark.parametrize("flags", [[], ["--device-predict"], ["--use-intensity-only"],
                                   ["--exclude-bg", "--device-predict"]],
                         ids=["composed", "device_predict", "intensity", "nobg_device"])
def test_predict_svm_rf_cli_matches_jax(tmp_path, flags):
    vol, lab, _ = _phantom(6)
    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        np.save(d / "volume.npy", vol)
        np.save(d / "labels.npy", lab)
        dirs.append(d)
    args = ["--num-samples", "20", "--sampling-mode", "uniform", "--rf-estimators", "8",
            "--seed", "3"] + flags
    np.random.seed(1)
    assert jcli.main(["--data", str(dirs[0])] + args) == 0
    np.random.seed(1)
    assert tcli.main(["--data", str(dirs[1]), "--cpu"] + args) == 0
    names = sorted(p.name for p in dirs[0].iterdir())
    assert names == sorted(p.name for p in dirs[1].iterdir())
    assert any(n.startswith("svm_pred") for n in names) and any(n.endswith(".png") for n in names)
    for n in names:
        if n.endswith(".npy") and "_pred" in n:
            np.testing.assert_array_equal(np.load(dirs[1] / n), np.load(dirs[0] / n))
        elif n.endswith(".json"):
            g, w = (json.loads((d / n).read_text()) for d in (dirs[1], dirs[0]))
            assert g["confusion_matrix"] == w["confusion_matrix"]
    # idempotent: existing metrics short-circuit
    assert tcli.main(["--data", str(dirs[1]), "--cpu"] + args) == 0


def test_predict_svm_rf_cli_requires_cuda_without_cpu_flag(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol, lab, _ = _phantom(7)
    np.save(tmp_path / "volume.npy", vol)
    np.save(tmp_path / "labels.npy", lab)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--data", str(tmp_path), "--num-samples", "8"])
    assert not list(tmp_path.glob("*_pred*"))
