"""Port parity: the similarity/prediction slice and both CLIs.

``vittf_tpu_torch.pipeline`` (ntf, annotations, evaluate) and
``vittf_tpu_torch.cli`` (infer, predict_ntf) against their ``vittf_tpu``
twins on CPU, with the same numpy inputs and generator seeds.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.pipeline import annotations as ja
from vittf_tpu.pipeline import evaluate as je
from vittf_tpu.pipeline import ntf as jn
from vittf_tpu_torch.pipeline import annotations as ta
from vittf_tpu_torch.pipeline import evaluate as te
from vittf_tpu_torch.pipeline import ntf as tn

GOLDEN = "tests/golden/tiny_pipeline.npz"


def test_golden_similarities_and_prediction_bit_exact():
    """The uint8 maps are bit-defined; from the golden features the port
    reproduces them exactly (no reassociation flip occurs at this input)."""
    g = np.load(GOLDEN)
    ann = {"a": g["annotations_a"], "b": g["annotations_b"]}
    sims = tn.compute_similarities((16, 16, 16), torch.from_numpy(g["features"]), ann)
    np.testing.assert_array_equal(sims["a"].numpy(), g["sim_a"])
    np.testing.assert_array_equal(sims["b"].numpy(), g["sim_b"])
    np.testing.assert_array_equal(tn.fuse_predictions(sims, [0.2, 0.2]).numpy(), g["pred"])


def test_compute_similarities_matches_jax(rng):
    volume = rng.random((12, 14, 16)).astype(np.float32)
    features = (rng.standard_normal((8, 6, 7, 8)) * 0.4).astype(np.float32)
    ann = {
        "liver": rng.integers(0, 12, (9, 3)).astype(np.int64),
        "bone": rng.integers(0, 12, (4, 3)).astype(np.int64),
        "empty": np.zeros((0, 3), np.int64),
    }
    want = jn.compute_similarities(jnp.asarray(volume), jnp.asarray(features), ann, impl="xla")
    got = tn.compute_similarities(volume.shape, torch.from_numpy(features), ann)
    for name in ann:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    one = {"solo": rng.integers(0, 12, (1100, 3)).astype(np.int64)}  # mean-first path
    want = jn.compute_similarities(jnp.asarray(volume), jnp.asarray(features), one, impl="xla")
    got = tn.compute_similarities(volume, torch.from_numpy(features), one, impl="plain")
    # one voxel may differ by 1 where fp32 reassociation of the 1100-term
    # mean moves a value across an integer quantization boundary
    d = np.abs(got["solo"].numpy().astype(int) - np.asarray(want["solo"]).astype(int))
    assert d.max() <= 1 and np.count_nonzero(d) <= 1
    # with refinement (per-class crops; tests/test_torch_refine.py has both modes)
    want = jn.compute_similarities(jnp.asarray(volume), jnp.asarray(features), ann,
                                   impl="xla", bilateral_solver=True)
    got = tn.compute_similarities(volume, torch.from_numpy(features), ann,
                                  bilateral_solver=True)
    for name in ann:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_quantize_uint8_wraps_mod_256():
    vals = np.array([0.0, 0.9, 1.2, 254.9, 255.1, 257.6, 511.9, 767.0, 1000.5], np.float32)
    got = tn.quantize_uint8_torch(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jn.quantize_uint8_torch(jnp.asarray(vals))))
    np.testing.assert_array_equal(got, (np.trunc(vals) % 256).astype(np.uint8))
    assert got.dtype == np.uint8 and got[5] == 1 and got[8] == 232


def test_fuse_predictions_match_jax(rng):
    for n_cls in (2, 5, 7):
        sims = {f"c{i}": rng.integers(0, 256, (6, 6, 6), dtype=np.uint8) for i in range(n_cls)}
        sims["c1"][:2] = sims["c0"][:2]  # exact ties: the first class wins
        want = np.asarray(jn.fuse_predictions({k: jnp.asarray(v) for k, v in sims.items()}))
        got = tn.fuse_predictions({k: torch.from_numpy(v) for k, v in sims.items()})
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tn.fuse_predictions_host(sims), want)
    pred = torch.from_numpy(rng.integers(0, 4, (4, 5, 6), dtype=np.uint8))
    np.testing.assert_array_equal(
        tn.upscale_prediction(pred, (8, 10, 12)).numpy(),
        np.asarray(jn.upscale_prediction(jnp.asarray(pred.numpy()), (8, 10, 12))),
    )


@pytest.mark.parametrize("mode", ["uniform", "surface", "both"])
def test_annotations_from_labels_same_coordinates(mode):
    lab = np.zeros((20, 20, 20), np.uint8)
    lab[2:14, 3:15, 4:16] = 1
    lab[10:19, 10:19, 1:9] = 2
    lab[0:4, 15:20, 12:20] = 3
    for n in (25, 0.05):
        want = ja.annotations_from_labels(lab, n, mode, rng=np.random.default_rng(3))
        got = ta.annotations_from_labels(lab, n, mode, rng=np.random.default_rng(3))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("mode", ["uniform", "surface", "both"])
def test_host_samplers_equal_the_device_ones(mode):
    """``impl='host'`` (argwhere + ``rng.choice`` on the host) equals the
    device path and both JAX paths bit for bit, for a tensor mask and a
    numpy one, and through ``annotations_from_labels``."""
    lab = np.zeros((20, 20, 20), np.uint8)
    lab[2:14, 3:15, 4:16] = 1
    lab[10:19, 10:19, 1:9] = 2
    mask = lab == 1
    fn, kw = ta.SAMPLING_MODES[mode], ({"dist_from_surface": 2} if mode != "uniform" else {})
    jfn = ja.SAMPLING_MODES[mode]
    dev = fn(torch.from_numpy(mask), 30, rng=np.random.default_rng(7), **kw)
    for m in (torch.from_numpy(mask), mask):
        host = fn(m, 30, rng=np.random.default_rng(7), impl="host", **kw)
        assert host.dtype == dev.dtype == np.int64
        np.testing.assert_array_equal(host, dev)
    for impl in ("host", "device"):
        np.testing.assert_array_equal(
            jfn(mask, 30, rng=np.random.default_rng(7), impl=impl, **kw), dev)
    for n in (25, 0.05):
        want = ja.annotations_from_labels(lab, n, mode, rng=np.random.default_rng(3), impl="host")
        got = ta.annotations_from_labels(lab, n, mode, rng=np.random.default_rng(3), impl="host")
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="impl"):
        fn(mask, 3, impl="pallas")


def test_host_sampler_thinning_equals_device(monkeypatch):
    """The >THIN_LIMIT stride-2 thinning on the host path, at a lowered limit."""
    monkeypatch.setattr(ta, "THIN_LIMIT", 50)
    mask = np.random.default_rng(1).random((9, 9, 9)) > 0.4
    host = ta.sample_uniform(mask, 20, True, rng=np.random.default_rng(11), impl="host")
    dev = ta.sample_uniform(torch.from_numpy(mask), 20, True, rng=np.random.default_rng(11))
    np.testing.assert_array_equal(host, dev)
    assert (host[:, 0] * 81 + host[:, 1] * 9 + host[:, 2]).max() < mask.size


def test_surface_shell_matches_jax(rng):
    mask = rng.random((12, 13, 14)) > 0.3
    want = ja.surface_shell(mask, 2)
    got = ta.surface_shell(torch.from_numpy(mask), 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segmentation_metrics_match_jax(rng):
    names = ["background", "a", "b", "c"]
    y_true = rng.integers(0, 4, (10, 10, 10)).astype(np.uint8)
    y_pred = rng.integers(0, 3, (10, 10, 10)).astype(np.uint8)  # class c never predicted
    want = je.segmentation_metrics(y_true, y_pred, names, extra={"fit_time": 1.0})
    got = te.segmentation_metrics(torch.from_numpy(y_true), y_pred, names,
                                  extra={"fit_time": 1.0})
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    np.testing.assert_array_equal(
        te.confusion_matrix(torch.from_numpy(y_true), torch.from_numpy(y_pred), 4).numpy(),
        np.asarray(je.confusion_matrix(jnp.asarray(y_true), jnp.asarray(y_pred), 4)),
    )


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    """The same 16³ labeled volume through the JAX CLIs and the port CLIs:
    vits8 (random weights from PRNGKey(0) in both), fos 4 (17 tokens per
    slice), fp32 parity mode, 32 sampled annotations per class; predict_ntf
    runs without and with ``--bilateral-solver --largest-island``."""
    from vittf_tpu.cli import infer as j_infer
    from vittf_tpu.cli import predict_ntf as j_predict
    from vittf_tpu.cli import synth as j_synth
    from vittf_tpu_torch.cli import infer as t_infer
    from vittf_tpu_torch.cli import predict_ntf as t_predict

    src = tmp_path_factory.mktemp("synth")
    assert j_synth.main([str(src), "--size", "16"]) == 0
    vol = np.load(src / "sphere_filled.npy").astype(np.float32)
    labels = np.load(src / "sphere_filled_label.npy")
    dirs = {}
    for name, infer, predict, extra in (
        ("jax", j_infer, j_predict, ["--impl", "xla"]),
        ("torch", t_infer, t_predict, ["--cpu"]),
    ):
        d = tmp_path_factory.mktemp(name)
        np.save(d / "volume.npy", vol)
        np.save(d / "labels.npy", labels)
        infer_args = ["--data-path", str(d / "volume.npy"), "--feature-output-size", "4",
                      "--precision", "highest"]
        assert infer.main(infer_args + (["--cpu"] if name == "torch" else [])) == 0
        assert predict.main(["--data", str(d), "--num-samples", "32"] + extra) == 0
        assert predict.main(["--data", str(d), "--num-samples", "32", "--bilateral-solver",
                             "--largest-island"] + extra) == 0
        dirs[name] = d
    return dirs


def test_infer_cli_artifact_matches_jax(cli_dirs):
    name = "volume_vits8_all_features4.npy"
    want = np.load(cli_dirs["jax"] / name, allow_pickle=True)[()]["k"]
    got = np.load(cli_dirs["torch"] / name, allow_pickle=True)[()]["k"]
    assert got.dtype == np.float16 and got.shape == want.shape == (384, 4, 4, 4)
    # both CLIs store fp16; fp32 sums that differ in the last bits may round
    # to neighbouring fp16 values
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               rtol=1e-3, atol=1e-5)


def _assert_predict_artifacts_match(cli_dirs, suffix):
    want = np.load(cli_dirs["jax"] / f"ntf_pred{suffix}.npy")
    got = np.load(cli_dirs["torch"] / f"ntf_pred{suffix}.npy")
    assert got.dtype == np.uint8 and got.shape == (8, 8, 8)
    np.testing.assert_array_equal(got, want)
    wm = json.loads((cli_dirs["jax"] / f"ntf_metrics{suffix}.json").read_text())
    gm = json.loads((cli_dirs["torch"] / f"ntf_metrics{suffix}.json").read_text())
    for key in ("fit_time", "predict_time"):
        wm.pop(key), gm.pop(key)
    assert gm == wm


def test_predict_cli_artifacts_match_jax(cli_dirs):
    _assert_predict_artifacts_match(cli_dirs, "32.0both")


def test_predict_cli_bls_island_artifacts_match_jax(cli_dirs):
    """``--bilateral-solver --largest-island``: per-class tight-crop
    refinement, then the native largest-island filter, as the JAX CLI."""
    _assert_predict_artifacts_match(cli_dirs, "32.0bothblsisl")
    plain = np.load(cli_dirs["torch"] / "ntf_pred32.0both.npy")
    refined = np.load(cli_dirs["torch"] / "ntf_pred32.0bothblsisl.npy")
    assert refined.any() and (refined != plain).any()


def test_quantize_features_u8_tensor_branch_matches_numpy(rng):
    """The device-tensor branch (quantize before the fetch) gives the same
    codes, scales and offsets as the numpy branch both packages share."""
    from vittf_tpu.core.io import quantize_features_u8 as jq
    from vittf_tpu_torch.core.io import quantize_features_u8 as tq

    feats = (rng.standard_normal((6, 5, 4, 3)) * 3).astype(np.float32)
    feats[2] = 1.5  # constant channel: scale clamps at 1e-12
    got = tq(torch.from_numpy(feats))
    for g, w in zip(got, jq(feats)):
        np.testing.assert_array_equal(g, w)
