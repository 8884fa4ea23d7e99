"""Port parity: the tools slice of vittf_tpu_torch vs vittf_tpu on CPU —
sampling-strategy comparison, merge, tiling, the sparse RGB bilateral solver,
logging, conversion, the CLIP/BLIP feature source, the user-study evaluator
and the batch CLI — on the same seeded numpy inputs.
"""
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vit import as_numpy_tree, port_cfg
from tests.test_vit import TorchDinoViT
from vittf_tpu.convert import volumes as jcv
from vittf_tpu.models.vit import ViTConfig as JViTConfig
from vittf_tpu.models.vit import init_vit_params
from vittf_tpu.ops import bilateral_sparse as jsp
from vittf_tpu.pipeline import compare_sampling as jcs
from vittf_tpu.pipeline import evaluate as jev
from vittf_tpu.pipeline import features as jf
from vittf_tpu.pipeline import merge as jmerge
from vittf_tpu.pipeline import tiling as jtile
from vittf_tpu_torch.cli import batch as tbatch
from vittf_tpu_torch.cli import convert as tconvert
from vittf_tpu_torch.cli import evaluate as tevaluate
from vittf_tpu_torch.convert import volumes as tcv
from vittf_tpu_torch.models import clip as tclip
from vittf_tpu_torch.models.dino import params_from_jax
from vittf_tpu_torch.native import bilateral_grid_build
from vittf_tpu_torch.ops import bilateral_sparse as tsp
from vittf_tpu_torch.pipeline import compare_sampling as tcs
from vittf_tpu_torch.pipeline import evaluate as tev
from vittf_tpu_torch.pipeline import features as tf
from vittf_tpu_torch.pipeline import merge as tmerge
from vittf_tpu_torch.pipeline import tiling as ttile
from vittf_tpu_torch.pipeline import visualize as tviz
from vittf_tpu_torch.utils import logging as tlog


# ---------- compare_sampling ----------

def _feats_labels(seed, shape=(6, 7, 8), F=16):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((F,) + shape).astype(np.float32)
    lab = np.zeros(shape, np.uint8)
    lab[1:4, 1:5, 1:4] = 1
    lab[4:, 3:, 4:] = 2
    return feats, lab, rng


def test_normalize_features_matches_jax():
    feats, _, _ = _feats_labels(0)
    feats[:, 0, 0, 0] = 0  # a zero vector: the 1e-12 floor
    want = np.asarray(jcs.normalize_features(jnp.asarray(feats)))
    got = tcs.normalize_features(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("exponent", [2.0, 3.0])
def test_sampling_similarity_map_matches_jax(exponent):
    """No threshold and scores of either sign: with exponent 3 negative
    scores stay negative."""
    feats, lab, rng = _feats_labels(1)
    fn = np.asarray(jcs.normalize_features(jnp.asarray(feats)))
    coords = np.argwhere(lab == 1)[rng.choice(int((lab == 1).sum()), 9, replace=False)]
    want = np.asarray(jcs.sampling_similarity_map(jnp.asarray(fn), coords, exponent, impl="xla"))
    got = tcs.sampling_similarity_map(torch.from_numpy(fn), coords, exponent).numpy()
    assert got.shape == want.shape == lab.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if exponent == 3.0:
        assert (got < 0).any()


@pytest.mark.parametrize("n,q", [(1000, 0.9999), (4097, 0.5), (7, 0.9999), (2**24 + 3, 0.9999)],
                         ids=["1000", "4097_median", "7", "above_16M"])
def test_quantize_quantile_u8_bit_equal(n, q):
    """``jnp.quantile``'s linear interpolation with its fp32 position
    arithmetic, also above ``torch.quantile``'s 16 M element limit."""
    sim = np.random.default_rng(n).random(n, dtype=np.float32) ** 2
    want = np.asarray(jcs.quantize_quantile_u8(jnp.asarray(sim), q))
    got = tcs.quantize_quantile_u8(torch.from_numpy(sim), q).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    qv = float(tcs.quantile_linear(torch.from_numpy(sim), q))
    assert qv == float(jnp.quantile(jnp.asarray(sim), q))


def test_quantile_linear_nan():
    x = torch.tensor([0.5, float("nan"), 1.0])
    assert torch.isnan(tcs.quantile_linear(x, 0.5))


@pytest.mark.parametrize("num_samples", [6, 0.25])
def test_compare_sampling_strategies_matches_jax(tmp_path, num_samples):
    feats, lab, _ = _feats_labels(2)
    kw = dict(samplers=("uniform", "surface"))
    want = jcs.compare_sampling_strategies(jnp.asarray(feats), lab, num_samples, tmp_path / "jax",
                                           rng=np.random.default_rng(5), impl="xla", **kw)
    got = tcs.compare_sampling_strategies(feats, lab, num_samples, tmp_path / "port",
                                          rng=np.random.default_rng(5), device="cpu", **kw)
    assert list(got) == list(want) and len(got) == 4
    for key in got:
        assert got[key].name == want[key].name
        g, w = np.load(got[key]).astype(int), np.load(want[key]).astype(int)
        assert g.shape == lab.shape
        # uint8 maps may differ by 1 where fp32 reassociation crosses an integer boundary
        assert np.abs(g - w).max() <= 1 and (g != w).mean() <= 0.01


def test_compare_sampling_places_host_input_on_the_card(tmp_path, monkeypatch):
    """A numpy volume goes to the first CUDA device and raises without one; a
    tensor is compared where it lies."""
    feats, lab, _ = _feats_labels(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcs.compare_sampling_strategies(feats, lab, 4, tmp_path / "a", rng=np.random.default_rng(0))
    got = tcs.compare_sampling_strategies(torch.from_numpy(feats), lab, 4, tmp_path / "b",
                                          rng=np.random.default_rng(0))
    assert len(got) == 2 and all(p.exists() for p in got.values())


# ---------- merge, tiling ----------

def test_merge_axis_features_matches_jax():
    rng = np.random.default_rng(0)
    vols = [rng.standard_normal((4,) + s).astype(np.float32) for s in ((8, 6, 6), (6, 8, 6), (6, 6, 9))]
    want = np.asarray(jmerge.merge_axis_features([jnp.asarray(v) for v in vols]))
    got = tmerge.merge_axis_features(vols, device="cpu").numpy()
    assert got.shape == want.shape == (4, 6, 6, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cross_axis_cosine_matches_jax():
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((5,) + s).astype(np.float32) for s in ((8, 6, 6), (6, 8, 6)))
    wh, we = jmerge.cross_axis_cosine(jnp.asarray(a), jnp.asarray(b), 20)
    gh, ge = tmerge.cross_axis_cosine(a, b, 20, device="cpu")
    np.testing.assert_array_equal(ge, we)
    assert gh.sum() == wh.sum() == 6 * 6 * 6 and np.abs(gh - wh).sum() <= 2


def test_merge_tools_place_host_input_on_the_card(monkeypatch):
    """numpy volumes go to the first CUDA device and raise without one;
    tensors are merged where they lie."""
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((3,) + s).astype(np.float32) for s in ((6, 4, 4), (4, 6, 4)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmerge.merge_axis_features([a, b])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmerge.cross_axis_cosine(a, b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert tuple(tmerge.merge_axis_features([ta, tb]).shape) == (3, 4, 4, 4)
    assert tmerge.cross_axis_cosine(ta, tb)[0].sum() == 64


@pytest.mark.parametrize("shape,tile,overlap", [
    ((20, 17, 33), (8, 8, 8), (2, 2, 2)),
    ((16, 16, 16), (8, None, 8), (0, 0, 4)),
    ((5, 9, 30), (8, 8, 8), (3, 3, 3)),
    ((3, 64, 64, 64), (32, 32, 32), (8, 8, 8)),
])
def test_tile_locations_exact(shape, tile, overlap):
    want = jtile.get_tile_locations(shape, tile, overlap)
    got = ttile.get_tile_locations(shape, tile, overlap)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_tile_roundtrip_matches_jax():
    rng = np.random.default_rng(2)
    vol = rng.random((2, 20, 17, 33)).astype(np.float32)
    loc = ttile.get_tile_locations(vol.shape, (8, 8, 8), (2, 2, 2))
    tiles = ttile.extract_tiles(torch.from_numpy(vol), loc)
    jtiles = jtile.extract_tiles(jnp.asarray(vol), loc)
    assert len(tiles) == len(jtiles) == len(loc)
    for t, j in zip(tiles, jtiles):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    got = ttile.stitch_tiles([t * 2 for t in tiles], loc, vol.shape[-3:]).numpy()
    want = np.asarray(jtile.stitch_tiles([t * 2 for t in jtiles], loc, vol.shape[-3:]))
    np.testing.assert_array_equal(got, want)


# ---------- sparse RGB bilateral solver ----------

def _rgb_case(seed, shape=(12, 10, 14)):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 256, (3,) + shape).astype(np.uint8)
    r[:, :6] //= 4  # two regions of different colour statistics
    t = (rng.random(shape) * 0.3 + 0.6 * (np.arange(shape[0])[:, None, None] < 6)).astype(np.float32)
    return t, r


def test_rgb2yuv_and_build_grid_match_jax():
    t, r = _rgb_case(0)
    rgb = np.moveaxis(r, 0, -1)
    np.testing.assert_array_equal(tsp.rgb2yuv(rgb.astype(np.float64)), jsp.rgb2yuv(rgb.astype(np.float64)))
    gv, gn, gk = tsp.build_grid(rgb, 4, 32, 32)
    wv, wn, wk = jsp.build_grid(rgb, 4, 32, 32)
    assert gk == wk
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gn, wn)


def test_bilateral_grid_build_range_and_capacity():
    with pytest.raises(ValueError, match=r"\[0, 1024\)"):
        bilateral_grid_build(np.array([[0, 1024]], np.int32))
    coords = np.array([[0, 0], [0, 1], [5, 5], [0, 0]], np.int32)
    vop, nb, n = bilateral_grid_build(coords)
    assert n == 3 and vop[0] == vop[3] and nb.shape == (3, 2, 2)
    assert nb[vop[0], 1, 1] == vop[1] and nb[vop[2]].max() == -1
    with pytest.raises(ValueError, match="max_vertices too small"):
        bilateral_grid_build(coords, max_vertices=2)


@pytest.mark.parametrize("with_conf", [False, True])
def test_apply_bilateral_solver3d_rgb_matches_jax(with_conf):
    """CG in fp32 in another summation order: 2e-4, the dense solve's bound."""
    t, r = _rgb_case(1)
    gp = {"sigma_spatial": 4, "sigma_luma": 32, "sigma_chroma": 32}
    c = (0.5 + 0.5 * np.random.default_rng(3).random(t.shape)).astype(np.float32) if with_conf else None
    want = np.asarray(jsp.apply_bilateral_solver3d_rgb(
        jnp.asarray(t)[None], r, None if c is None else jnp.asarray(c), grid_params=gp))
    got = tsp.apply_bilateral_solver3d_rgb(
        torch.from_numpy(t)[None], r, None if c is None else torch.from_numpy(c),
        grid_params=gp).numpy()
    assert got.shape == want.shape == t.shape and want.std() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


# ---------- logging ----------

def test_metric_logger_jsonl(tmp_path, capsys):
    lg = tlog.MetricLogger(jsonl_path=tmp_path / "m.jsonl", stdout_every=2)
    lg.log({"loss": 1.0})
    lg.log({"loss": 0.5})
    lg.log({"loss": 0.25}, step=10)
    lg.close()
    recs = [json.loads(ln) for ln in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 10] and recs[1]["loss"] == 0.5
    out = capsys.readouterr().out
    assert "[2]" in out and "[10]" in out and "[1]" not in out


def test_profile_trace_writes_chrome_trace(tmp_path):
    with tlog.profile_trace(tmp_path / "trace") as logdir:
        torch.ones(8, 8) @ torch.ones(8, 8)
    trace = json.loads((logdir / "trace.json").read_text())
    assert trace["traceEvents"]


def test_debug_mode_restores():
    assert not torch.is_anomaly_enabled()
    with tlog.debug_mode():
        assert torch.is_anomaly_enabled()
        with tlog.debug_mode(nans=False):
            assert not torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()
    with pytest.raises(TypeError):
        tlog.debug_mode(disable_jit=True).__enter__()


# ---------- convert ----------

def test_resize_volume_and_downsample_z_match_jax(tmp_path):
    vol = np.random.default_rng(0).random((8, 6, 16)).astype(np.float32)
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        np.save(tmp_path / name / "v.npy", vol)
    want = jcv.resize_volume(tmp_path / "jax" / "v.npy", (0.5, 5, 0.75))
    got = tcv.resize_volume(tmp_path / "port" / "v.npy", (0.5, 5, 0.75), device="cpu")
    assert got.shape == want.shape == (4, 5, 12)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "v_resized.npy"), got)
    for factor, tag in ((2, "_halfZ"), (4, "_quaterZ"), (3, "_z3")):
        w = jcv.downsample_z(tmp_path / "jax" / "v.npy", factor)
        g = tcv.downsample_z(tmp_path / "port" / "v.npy", factor, device="cpu")
        np.testing.assert_array_equal(g, w)
        assert (tmp_path / "port" / f"v{tag}.npy").exists()


def test_raw_to_npy_matches_jax(tmp_path):
    arr = np.random.default_rng(1).integers(0, 255, (3, 4, 5, 6), dtype=np.uint8)
    arr.tofile(tmp_path / "v.raw")
    (tmp_path / "v.dat").write_text("Resolution: 4 5 6")
    want = jcv.raw_to_npy(tmp_path / "v.raw", (3, 4, 5, 6), out_path=tmp_path / "j.npy",
                          channels_last=False)
    got = tcv.raw_to_npy(tmp_path / "v.raw", (3, 4, 5, 6), out_path=tmp_path / "p.npy",
                         channels_last=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy"))


@pytest.mark.parametrize("fn,mod", [("dcm_to_npy", "pydicom"), ("tiff_to_npy", "tifffile"),
                                    ("nifti_to_npy", "nibabel")])
def test_optional_readers_raise_naming_the_package(tmp_path, monkeypatch, fn, mod):
    monkeypatch.setitem(sys.modules, mod, None)  # import fails even where it is installed
    args = (tmp_path, tmp_path / "o.npy") if fn != "nifti_to_npy" else (tmp_path / "v.nii.gz",)
    with pytest.raises(ImportError, match=f"{mod} is required"):
        getattr(tcv, fn)(*args)


def test_convert_cli(tmp_path, monkeypatch):
    vol = np.random.default_rng(2).random((8, 8, 16)).astype(np.float32)
    np.save(tmp_path / "v.npy", vol)
    assert tconvert.main(["--cpu", "resize", "--data", str(tmp_path / "v.npy"),
                          "--resolution", "0.5", "0.5", "0.5"]) == 0
    assert np.load(tmp_path / "v_resized.npy").shape == (4, 4, 8)
    assert tconvert.main(["--cpu", "halfz", "--data", str(tmp_path / "v.npy")]) == 0
    assert np.load(tmp_path / "v_halfZ.npy").shape == (8, 8, 8)
    vol.astype(np.uint8).tofile(tmp_path / "r.raw")
    assert tconvert.main(["raw", "--data", str(tmp_path / "r.raw"), "--shape", "8", "8", "16"]) == 0
    assert np.load(tmp_path / "r.npy").shape == (8, 8, 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconvert.main(["quaterz", "--data", str(tmp_path / "v.npy")])


# ---------- CLIP/BLIP feature source ----------

# the thirds-split needs embed_dim % 3 == 0 (BLIP's 768 satisfies it)
CFG36 = JViTConfig(4, 36, 2, 4, img_size=16)


@pytest.fixture(scope="module")
def tiny_params():
    import jax

    return init_vit_params(CFG36, jax.random.PRNGKey(0))


@pytest.mark.parametrize("kw", [
    dict(slice_along="all", return_keys=("k",)),
    dict(slice_along="z", return_keys=("q", "v")),
], ids=["all_k", "z_qv"])
def test_extract_features_mlp_source_matches_jax(tiny_params, kw):
    vol = np.random.default_rng(3).random((16, 16, 16)).astype(np.float32)
    common = dict(feature_output_size=4, batch_size=4, precision="highest", feature_source="mlp", **kw)
    want = jf.extract_features(jnp.asarray(vol), tiny_params, CFG36,
                               jf.ExtractConfig(attn_impl="xla", **common))
    got = tf.extract_features(vol, params_from_jax(as_numpy_tree(tiny_params)), port_cfg(CFG36),
                              tf.ExtractConfig(**common))
    assert set(got) == set(kw["return_keys"])
    for k in got:
        assert got[k].shape[0] == CFG36.embed_dim // 3
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)


def test_unknown_feature_source_is_refused(tiny_params):
    with pytest.raises(ValueError, match="feature_source"):
        tf.extract_features(np.zeros((8, 8, 8), np.float32),
                            params_from_jax(as_numpy_tree(tiny_params)), port_cfg(CFG36),
                            tf.ExtractConfig(feature_source="cls"))


def test_clip_conversion_path(tmp_path):
    """``convert_visual_encoder`` strips the ``visual_encoder.`` prefix and
    keeps the backbone; the loaded model runs the ``mlp`` source."""
    cfg = port_cfg(CFG36)
    sd = TorchDinoViT(CFG36).state_dict()
    wrapped = {f"visual_encoder.{k}": v for k, v in sd.items()}
    wrapped["text_encoder.embeddings.weight"] = torch.zeros(3)
    params = tclip.convert_visual_encoder(wrapped, cfg)
    assert set(params) <= set(sd) and "blocks.1.mlp.fc2.weight" in params
    for k, v in params.items():
        assert torch.equal(v, sd[k].float())
    assert tclip.strip_prefix({"a": 1}) == {"a": 1}
    torch.save({"model": wrapped}, tmp_path / "ckpt.pth")
    loaded = tclip.load_visual_checkpoint(tmp_path / "ckpt.pth", cfg)
    assert all(torch.equal(loaded[k], params[k]) for k in params)
    assert tclip.CLIP_ARCHS["blip_vitb16"].embed_dim == 768
    assert tclip.CLIP_ARCHS["clip_vitl14"].patch_size == 14
    out = tf.extract_features(np.random.default_rng(0).random((8, 8, 8)).astype(np.float32), loaded,
                              cfg, tf.ExtractConfig(feature_output_size=2, feature_source="mlp",
                                                    precision="highest"))
    assert out["k"].shape == (CFG36.embed_dim // 3, 2, 2, 2)


def test_load_lavis_model_raises_without_lavis(monkeypatch):
    monkeypatch.setitem(sys.modules, "lavis", None)
    monkeypatch.setitem(sys.modules, "lavis.models", None)
    with pytest.raises(ImportError, match="lavis is required"):
        tclip.load_lavis_model()


def test_plot_pca_features_names_the_missing_trainers(tmp_path):
    """The trainers' ``project_pca`` is ported, so the PCA plot runs in the
    port: the counterpart of ``tests/test_visualize.py::
    test_pca_features_plot``, the same image as the JAX package's."""
    from vittf_tpu.pipeline import visualize as jviz

    fv = np.random.default_rng(0).standard_normal((8, 6, 10, 10)).astype(np.float32)
    out = tviz.plot_pca_features(fv, tmp_path / "p.png")
    assert out.exists() and out.stat().st_size > 1000
    want = jviz.plot_pca_features(fv, tmp_path / "j.png")
    import matplotlib.image as mpimg

    np.testing.assert_allclose(mpimg.imread(out), mpimg.imread(want), atol=1 / 255)


# ---------- user-study evaluator, batch ----------

def test_evaluate_user_study_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    lab = rng.integers(0, 6, (12, 10, 8)).astype(np.uint8)
    preds = {"cls0": (lab == 3).astype(np.uint8)[::2, ::2, ::2],
             "cls1": (rng.random((12, 10, 8)) > 0.5).astype(np.uint8)}
    meta = {"cls0": {"time": 42.0, "num_annotations": 7}, "cls1": {"time": 1.5, "num_annotations": 2}}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        np.save(d / "predictions.npy", preds)
        (d / "metadata.json").write_text(json.dumps(meta))
    np.save(tmp_path / "labels.npy", lab)
    want = jev.evaluate_user_study(tmp_path / "jax", tmp_path / "labels.npy", ["lung", "liver"])
    got = tev.evaluate_user_study(tmp_path / "port", tmp_path / "labels.npy", ["lung", "liver"],
                                  device="cpu")
    assert list(got) == list(want) == ["lung", "liver"]
    for ln in got:
        assert got[ln]["confusion_matrix"] == want[ln]["confusion_matrix"]
        assert got[ln]["annotation_time"] == want[ln]["annotation_time"]
        for k in ("accuracy", "precision", "recall", "f1", "iou"):
            np.testing.assert_allclose(got[ln][k], want[ln][k], rtol=1e-6)
    assert json.loads((tmp_path / "port" / "metrics.json").read_text()) == got
    assert tev.LABEL2IDX == jev.LABEL2IDX and tev.IDX2LABEL == jev.IDX2LABEL


def test_evaluate_cli(tmp_path, capsys, monkeypatch):
    lab = np.zeros((8, 8, 8), np.uint8)
    lab[2:6, 2:6, 2:6] = 3
    np.save(tmp_path / "labels.npy", lab)
    np.save(tmp_path / "predictions.npy", {"a": (lab == 3).astype(np.uint8)})
    (tmp_path / "metadata.json").write_text(json.dumps({"a": {"time": 1.0, "num_annotations": 3}}))
    args = ["--data", str(tmp_path), "--label", str(tmp_path / "labels.npy"), "--labels", "lung"]
    assert tevaluate.main(args + ["--cpu"]) == 0
    assert "'accuracy': 1.0" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tevaluate.main(args)


def _volume_dirs(root, rng, names=("v1", "v2", "v3")):
    for name in names:
        d = root / name
        d.mkdir()
        np.save(d / "volume.npy", rng.random((12, 12, 12)).astype(np.float32))
        lab = np.zeros((12, 12, 12), np.uint8)
        lab[3:9, 3:9, 3:9] = 1
        np.save(d / "labels.npy", lab)
        np.save(d / "x_features8.npy",
                np.asarray({"k": rng.standard_normal((6, 6, 6, 6)).astype(np.float16)}, dtype=object))


def test_batch_predict_all_and_shard(tmp_path):
    _volume_dirs(tmp_path, np.random.default_rng(0))
    assert tbatch.main(["predict-all", "--root", str(tmp_path), "--num-samples", "16", "8",
                        "--cpu", "--shard", "1/2"]) == 0
    assert [len(list((tmp_path / n).glob("ntf_pred*.npy"))) for n in ("v1", "v2", "v3")] == [0, 2, 0]
    assert [d.name for d in tbatch._volume_dirs(tmp_path, "0/2")] == ["v1", "v3"]
    assert tbatch._volume_dirs(tmp_path / "v1", None) == [tmp_path / "v1"]


def test_batch_svm_rf_sweep(tmp_path):
    _volume_dirs(tmp_path, np.random.default_rng(1), names=("v1",))
    assert tbatch.main(["svm-rf-sweep", "--root", str(tmp_path), "--num-samples", "8",
                        "--sampling-mode", "uniform", "--cpu"]) == 0
    assert list((tmp_path / "v1").glob("svm_metrics8.0uniform.json"))


def test_batch_infer_all_is_idempotent_and_reports_failures(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    for name in ("v1", "v2"):
        (tmp_path / name).mkdir()
        np.save(tmp_path / name / "volume.npy", rng.random((12, 12, 12)).astype(np.float32))
    args = ["infer-all", "--root", str(tmp_path), "--feature-output-size", "6"]
    assert tbatch.main(args + ["--cpu"]) == 0
    for name in ("v1", "v2"):
        assert len(list((tmp_path / name).glob("*features*"))) == 1
    assert tbatch.main(args + ["--cpu"]) == 0  # the cache guard exits per volume
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbatch.main(args) == 1  # no card and no --cpu: every volume fails, reported
