"""Port parity: vittf_tpu_torch.train.dense against its vittf_tpu twin, on
the CPU, held as ``test_torch_train_contrastive`` holds the crop trainers:
the same seed, the JAX twin's initial parameters and head, host draws in
step; records at every step, parameters and RAdam's moments after 1, 3 and
10 steps, within 1e-5 through step 3 and 1e-4 after. The pieces (position
encoding, label dropping, the normalized input), the chunked features on
another volume, validation, and the short run of the JAX test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_contrastive import (
    EARLY,
    LATE,
    _tol,
    assert_records_close,
    assert_trees_close,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    radam_state_by_path,
    to_port,
)
from vittf_tpu.models.cnn3d import FeatureExtractorConfig as JFC
from vittf_tpu.train import dense as jd
from vittf_tpu_torch.models.cnn3d import FeatureExtractorConfig as TFC
from vittf_tpu_torch.train import dense as td

LABELS = ["background", "a", "b"]


def toy_data(rng, size=12):
    mask = np.zeros((size,) * 3, np.uint8)
    mask[2:6, 2:6, 2:6] = 1
    mask[7:11, 7:11, 7:11] = 2
    vol = ((mask == 1) * 0.9 + (mask == 2) * 0.2 + rng.random(mask.shape) * 0.03)
    return vol.astype(np.float32), mask


# ---------------- dense ----------------

def test_add_pos_encoding_and_drop_labels_match_jax(rng):
    v = rng.standard_normal((2, 4, 5, 6)).astype(np.float32)
    got = td.add_pos_encoding(torch.from_numpy(v))
    want = np.asarray(jd.add_pos_encoding(jnp.asarray(v)))
    assert got.shape == want.shape == (5, 4, 5, 6)
    # torch.linspace and jnp.linspace round a few points a ulp apart
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.5e-7)
    np.testing.assert_array_equal(got[:2].numpy(), v)
    _, mask = toy_data(rng)
    for p in (1.0, 0.5, 0.1):
        np.testing.assert_array_equal(
            td.drop_labels(mask, p, 3, np.random.default_rng(4)),
            jd.drop_labels(mask, p, 3, np.random.default_rng(4)))


@pytest.mark.parametrize("variant", [
    dict(schedule="onecycle", label_percentage=0.8),
    dict(schedule="cosine", temperature=0.1, weight_decay=1e-3, lambda_ce=0.0),
])
def test_dense_trainer_matches_jax(rng, variant):
    vol, mask = toy_data(rng)
    common = dict(samples_per_iteration=3, neg_count=16, learning_rate=3e-3, iterations=10,
                  lambda_std=0.1, **variant)
    tj = jd.DenseContrastiveTrainer(
        vol, mask, LABELS, jd.DenseContrastiveConfig(JFC(1, (8,), (8,)), **common), seed=0)
    tt = td.DenseContrastiveTrainer(
        vol, mask, LABELS, td.DenseContrastiveConfig(TFC(1, (8,), (8,)), **common), seed=0,
        device="cpu", params=to_port(tj.params), head_params=to_port(tj.head_params))
    np.testing.assert_allclose(tt.vol.numpy(), np.asarray(tj.vol), **EARLY)
    assert tt.model_cfg.in_dim == tj.model_cfg.in_dim == 4
    assert [n for _, n in tt.fg_classes] == [n for _, n in tj.fg_classes] == ["a", "b"]
    for n in LABELS:
        np.testing.assert_array_equal(tt.class_indices[n], tj.class_indices[n])
    for step in range(1, 11):
        want, got = tj.step(std_samples=16), tt.step(std_samples=16)
        assert tt.rng.bit_generator.state == tj.rng.bit_generator.state
        assert_records_close(got, want, _tol(step))
        if step in (1, 3, 10):
            assert_trees_close([tt.params, tt.head_params],
                               to_port((tj.params, tj.head_params)), _tol(step))
    got, want, n_j, n_t = radam_state_by_path([tt.params, tt.head_params], tt.opt_state,
                                              tj.opt_state)
    assert n_j == n_t == 10
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=str(k), **LATE)
    np.testing.assert_allclose(tt.dense_features().numpy(), np.asarray(tj.dense_features()),
                               **LATE)
    val_t, val_j = tt.validate(), tj.validate()
    assert val_t.keys() == val_j.keys() == {"iou_l2", "iou_cosine"}
    for k in val_j:
        assert val_t[k].keys() == set(LABELS)
        np.testing.assert_allclose([val_t[k][n] for n in LABELS],
                                   [val_j[k][n] for n in LABELS], rtol=0, atol=1e-6)


def test_dense_features_chunked_and_cross_volume(rng):
    """Another volume through the training preprocessing, chunked slabs
    equal to the monolithic forward for norm='none', and both equal to the
    JAX twin's."""
    vol = rng.random((16, 16, 16)).astype(np.float32)
    labels = (rng.random((16, 16, 16)) > 0.7).astype(np.uint8)
    other = rng.random((20, 20, 20)).astype(np.float32)
    for norm in ("none", "group"):
        common = dict(iterations=1, samples_per_iteration=2, neg_count=16)
        tj = jd.DenseContrastiveTrainer(
            vol, labels, ["background", "fg"],
            jd.DenseContrastiveConfig(JFC(n_features=(4, 8), n_linear=(8,), norm=norm), **common),
            seed=0)
        tt = td.DenseContrastiveTrainer(
            vol, labels, ["background", "fg"],
            td.DenseContrastiveConfig(TFC(n_features=(4, 8), n_linear=(8,), norm=norm), **common),
            seed=0, device="cpu", params=to_port(tj.params), head_params=to_port(tj.head_params))
        assert tt.model_cfg.norm == norm
        mono, chunked = tt.dense_features(other), tt.dense_features(other, chunk=8)
        assert mono.shape == chunked.shape == (8, 20, 20, 20)
        np.testing.assert_allclose(mono.numpy(), np.asarray(tj.dense_features(other)), **EARLY)
        np.testing.assert_allclose(chunked.numpy(), np.asarray(tj.dense_features(other, chunk=8)),
                                   **EARLY)
        if norm == "none":
            np.testing.assert_allclose(chunked.numpy(), mono.numpy(), rtol=1e-5, atol=1e-5)


def test_dense_trainer_learns(rng):
    vol, mask = toy_data(rng)
    cfg = td.DenseContrastiveConfig(model=TFC(1, (8,), (8,)), samples_per_iteration=4,
                                    neg_count=64, learning_rate=3e-3, schedule="const",
                                    iterations=40, lambda_std=0.1, lambda_ce=1.0)
    tr = td.DenseContrastiveTrainer(vol, mask, LABELS, cfg, seed=0, device="cpu")
    first = tr.step()["loss"]
    for _ in range(39):
        last = tr.step()["loss"]
    assert last < first, (first, last)
    val = tr.validate()
    assert set(val) == {"iou_l2", "iou_cosine"} and set(val["iou_l2"]) == set(LABELS)
    with pytest.raises(ValueError, match=">= 2 label names"):
        td.DenseContrastiveTrainer(vol, mask, ["background"], cfg, device="cpu")
