"""Port parity: vittf_tpu_torch.pipeline.quality against
vittf_tpu.pipeline.quality, on the CPU.

The six cases of ``tests/test_quality.py`` at its sizes (a 2-block random
ViT with patch 4, width 32, on a 32³ phantom, 8³ feature grid), each on the
port, and held against the JAX function on the same weights
(``params_from_jax``), phantoms (bit-equal, ROADMAP §C 10) and annotations:
``ntf_predict``'s prediction equal to JAX's but on at most 1e-3 of the
voxels (the knife-edge share of the request contract), the experiments'
tables within 1e-6 in every IoU. The structured A/B starts its CNN oracle
from the JAX trainer's initial weights, and the refinement A/B is held on
features both packages are given; their oracles' own training runs on the
port alone, as the JAX test runs it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from vittf_tpu.models.vit import ViTConfig as JViTConfig
from vittf_tpu.models.vit import init_vit_params
from vittf_tpu.pipeline import features as jf
from vittf_tpu.pipeline import quality as jq
from vittf_tpu_torch.core.synthetic import make_multiclass_volume
from vittf_tpu_torch.models.dino import params_from_jax
from vittf_tpu_torch.models.vit import ViTConfig
from vittf_tpu_torch.pipeline import features as tf
from vittf_tpu_torch.pipeline import quality as tq

JCFG = JViTConfig(patch_size=4, embed_dim=32, depth=2, num_heads=4, img_size=32)
TCFG = ViTConfig(**dataclasses.asdict(JCFG))
JEX = jf.ExtractConfig(feature_output_size=8, slice_along="all", batch_size=8, attn_impl="xla")
TEX = tf.ExtractConfig(feature_output_size=8, slice_along="all", batch_size=8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vit_pair():
    params = init_vit_params(JCFG, jax.random.PRNGKey(0))
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def assert_tables_close(got: dict, want: dict, cells, atol=1e-6):
    for cell in cells:
        assert got[cell]["iou"].keys() == want[cell]["iou"].keys(), cell
        for k, v in want[cell]["iou"].items():
            assert got[cell]["iou"][k] == pytest.approx(v, abs=atol), (cell, k)
        assert got[cell]["mIoU_fg"] == pytest.approx(want[cell]["mIoU_fg"], abs=atol), cell
        assert got[cell]["accuracy"] == pytest.approx(want[cell]["accuracy"], abs=atol), cell


def assert_ceiling_close(got: dict, want: dict):
    assert got["mIoU_fg"] == pytest.approx(want["mIoU_fg"], abs=1e-6)
    assert got["iou"] == pytest.approx(want["iou"], abs=1e-6)


def test_multiclass_volume_has_three_disjoint_classes():
    vol, labels = make_multiclass_volume(48, noise=0.05, device="cpu")
    vol, labels = vol.numpy(), labels.numpy()
    assert vol.shape == labels.shape == (48, 48, 48)
    assert set(np.unique(labels).tolist()) == {0, 1, 2, 3}
    # intensity bands are ordered: class1 > class2 > class3 > background
    means = [float(vol[labels == c].mean()) for c in (1, 2, 3, 0)]
    assert means[0] > means[1] > means[2] > means[3]


def test_fastmode_experiment_runs_and_reports(vit_pair):
    jparams, sd = vit_pair
    r = tq.fastmode_quality_experiment(32, sd, TCFG, TEX, n_annotations=32, seed=0, device="cpu")
    for mode in ("full", "fast"):
        assert 0.0 <= r[mode]["mIoU_fg"] <= 1.0
        assert set(r[mode]["iou"]) == set(r["classes"])
        assert r[mode]["extract_s"] > 0
    assert r["full"]["iou"]["ntf1"] > 0.15
    assert r["fast"]["iou"]["ntf1"] > 0.15
    assert abs(r["iou_delta"]) < 0.2
    want = jq.fastmode_quality_experiment(32, jparams, JCFG, JEX, n_annotations=32, seed=0)
    assert r["classes"] == want["classes"]
    assert_tables_close(r, want, ("full", "fast"))
    assert r["iou_delta"] == pytest.approx(want["iou_delta"], abs=1e-6)


def test_ntf_predict_pred_at_volume_resolution(vit_pair):
    from vittf_tpu.core.synthetic import make_multiclass_volume as jax_volume
    from vittf_tpu.pipeline.annotations import annotations_from_labels

    jparams, sd = vit_pair
    vol, labels = jax_volume(32)
    ann = annotations_from_labels(labels, 16, "uniform", rng=np.random.default_rng(0))
    pred, times = tq.ntf_predict(vol, sd, TCFG, TEX, ann, device="cpu")
    assert torch.is_tensor(pred) and pred.shape == vol.shape
    assert int(pred.max()) <= len(ann)
    assert set(times) == {"extract_s", "similarity_s"} and min(times.values()) > 0
    want, _ = jq.ntf_predict(vol, jparams, JCFG, JEX, ann)
    differ = float((pred.numpy() != np.asarray(want)).mean())
    assert differ <= 1e-3, differ


def test_refinement_experiment_runs_and_reports():
    """The JAX test's smoke (the CNN oracle trained 30 iterations), on the
    port: four cells, each a valid IoU table on identical features +
    annotations."""
    r = tq.refinement_quality_experiment(
        32, fos=16, phantom="easy", seed=0, n_annotations=32, train_iterations=30,
        oracle_kw={"model_features": (4, 8), "model_linear": (8,), "train_size": 32},
        device="cpu",
    )
    for cell in ("base", "bls", "island", "bls_island"):
        assert 0.0 <= r[cell]["mIoU_fg"] <= 1.0
        assert set(r[cell]["iou"]) == {"c1", "c2", "c3"}
    for k in ("bls_uplift", "island_uplift", "stack_uplift"):
        assert -1.0 <= r[k] <= 1.0
    assert r["phantom"] == "easy" and np.isfinite(r["final_train_loss"])


def test_refinement_experiment_matches_jax_on_given_features(vit_pair):
    """The four cells (similarity, bilateral solve, island filter, fuse,
    metrics) on the JAX package's ViT features of the phantom, given to
    both."""
    from vittf_tpu.core.synthetic import make_multiclass_volume as jax_volume

    jparams, _ = vit_pair
    vol, _ = jax_volume(32)
    ex = dataclasses.replace(JEX, feature_output_size=16)
    feats = np.asarray(jf.extract_features(vol, jparams, JCFG, ex)["k"])
    kw = dict(fos=16, phantom="easy", seed=0, n_annotations=32, feature_source="vit")
    want = jq.refinement_quality_experiment(32, features=feats, **kw)
    got = tq.refinement_quality_experiment(32, features=torch.from_numpy(feats), device="cpu", **kw)
    assert_tables_close(got, want, ("base", "bls", "island", "bls_island"))
    assert_ceiling_close(got["grid_ceiling"], want["grid_ceiling"])


def test_structured_experiment_matches_jax(monkeypatch):
    """The structured A/B with both oracles started from the JAX trainer's
    initial weights (the port's ``DenseContrastiveTrainer`` takes them as
    ``params`` / ``head_params``), trained 3 iterations on the same host
    draws."""
    from vittf_tpu.train import dense as jd
    from vittf_tpu_torch.models.cnn3d import params_from_jax as cnn_from_jax
    from vittf_tpu_torch.train import dense as td

    inits = []
    real_j, real_t = jd.DenseContrastiveTrainer, td.DenseContrastiveTrainer

    def jax_trainer(*a, **kw):
        tr = real_j(*a, **kw)
        inits.append((tr.params, tr.head_params))
        return tr

    def port_trainer(*a, **kw):
        p, h = inits.pop(0)
        return real_t(*a, params=cnn_from_jax(jax.tree.map(np.asarray, p)),
                      head_params=cnn_from_jax(jax.tree.map(np.asarray, h)), **kw)

    monkeypatch.setattr(jd, "DenseContrastiveTrainer", jax_trainer)
    monkeypatch.setattr(td, "DenseContrastiveTrainer", port_trainer)
    kw = dict(fos=8, train_iterations=3, n_annotations=32, seed=0, model_features=(4, 8),
              model_linear=(8,))
    want = jq.structured_quality_experiment(24, **kw)
    got = tq.structured_quality_experiment(24, device="cpu", **kw)
    assert not inits
    assert got["final_train_loss"] == pytest.approx(want["final_train_loss"], rel=1e-4)
    assert got["oracle"] == want["oracle"] and got["classes"] == want["classes"]
    assert_tables_close(got, want, ("full", "fast"))
    assert_ceiling_close(got["grid_ceiling"], want["grid_ceiling"])


def test_hard_phantom_through_quality_harness(vit_pair):
    jparams, sd = vit_pair
    r = tq.fastmode_quality_experiment(32, sd, TCFG, TEX, n_annotations=24, seed=0,
                                       phantom="hard", device="cpu")
    assert r["phantom"] == "hard"
    assert len(r["classes"]) == 5  # body/liver/kidney/bone/lesion
    for mode in ("full", "fast"):
        assert 0.0 <= r[mode]["mIoU_fg"] <= 1.0
    want = jq.fastmode_quality_experiment(32, jparams, JCFG, JEX, n_annotations=24, seed=0,
                                          phantom="hard")
    assert_tables_close(r, want, ("full", "fast"))


def test_seed_budget_sweep_matches_jax(vit_pair):
    jparams, sd = vit_pair
    kw = dict(budgets=(16,), seeds=(0, 1))
    got = tq.fastmode_seed_budget_sweep(24, sd, TCFG, TEX, device="cpu", **kw)
    want = jq.fastmode_seed_budget_sweep(24, jparams, JCFG, JEX, **kw)
    assert [(c["budget"], c["seed"]) for c in got["cells"]] == [(16, 0), (16, 1)]
    for g, w in zip(got["cells"], want["cells"]):
        for k in ("full_mIoU", "fast_mIoU", "iou_delta"):
            assert g[k] == pytest.approx(w[k], abs=1e-6), k
    for k in ("delta_mean", "delta_min", "delta_max"):
        assert got[k] == pytest.approx(want[k], abs=1e-6)


def test_grid_ceiling_non_divisible_size():
    """size % fos != 0 pools the covered corner instead of crashing."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, (50, 50, 50)).astype(np.uint8)
    out = tq.grid_ceiling_miou(labels, 16, device="cpu")  # 50 % 16 != 0
    assert 0.0 <= out["mIoU_fg"] <= 1.0
    assert_ceiling_close(out, jq.grid_ceiling_miou(labels, 16))
    # fos larger than the volume clamps to one cell per voxel
    out2 = tq.grid_ceiling_miou(torch.from_numpy(labels[:4, :4, :4]), 16, device="cpu")
    assert out2["mIoU_fg"] == 1.0  # identity grid is a perfect predictor
