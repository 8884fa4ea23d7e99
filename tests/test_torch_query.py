"""Port parity: vittf_tpu_torch.ops.query and the 2-D sampling ops vs
vittf_tpu on CPU, on the same seeded numpy inputs.

``jax.lax.top_k`` returns the lowest index first among equal values; the
port's stable descending sort must do the same, so the tie-heavy cases
(quantized, clamped similarities) pick the same voxels and rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.ops import query as jq
from vittf_tpu.ops import sampling as js
from vittf_tpu_torch.ops import query as tq
from vittf_tpu_torch.ops import sampling as ts


def _feat_sims(seed, quantize):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((8, 6, 5, 7)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=0, keepdims=True)
    sims = rng.random((2, 3, 6, 5, 7)).astype(np.float32)
    if quantize:
        sims = np.round(sims * 4) / 4  # five distinct values: heavy ties
        sims = np.clip(sims, 0.25, 0.75)
    return feats, sims


@pytest.mark.parametrize("quantize", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("K", [1, 4, 8])
def test_resample_topk_matches_jax(K, quantize):
    feats, sims = _feat_sims(K, quantize)
    want = np.asarray(jq.resample_topk(jnp.asarray(feats), jnp.asarray(sims), K=K))
    got = tq.resample_topk(torch.from_numpy(feats), torch.from_numpy(sims), K=K).numpy()
    assert got.shape == want.shape == (1, 2, 3, 6, 5, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_resample_topk_bilinear_and_batched():
    feats, sims = _feat_sims(3, False)
    fb, sb = np.stack([feats, feats[::-1].copy()]), np.stack([sims, sims[:, ::-1].copy()])
    kw = dict(K=3, similarity_exponent=1.5, feature_sampling_mode="bilinear")
    want = np.asarray(jq.resample_topk(jnp.asarray(fb), jnp.asarray(sb), **kw))
    got = tq.resample_topk(torch.from_numpy(fb), torch.from_numpy(sb), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(7,), (3, 50)])
def test_top_k_stable_matches_lax_top_k_on_ties(shape):
    import jax

    x = np.random.default_rng(0).integers(0, 3, shape).astype(np.float32)
    k = min(5, shape[-1])
    wv, wi = jax.lax.top_k(jnp.asarray(x), k)
    gv, gi = tq.top_k_stable(torch.from_numpy(x), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("measure", ["cosine", "euclidean"])
@pytest.mark.parametrize("ties", [False, True])
def test_take_most_dissimilar_matches_jax(measure, ties):
    rng = np.random.default_rng(5)
    f = rng.standard_normal((40, 6)).astype(np.float32)
    if ties:
        f[20:] = f[:20]  # every row twice: equal mean distances in pairs
    want = np.asarray(jq.take_most_dissimilar(jnp.asarray(f), 11, measure))
    got = tq.take_most_dissimilar(torch.from_numpy(f), 11, measure).numpy()
    np.testing.assert_array_equal(got, want)
    small = torch.from_numpy(f[:5])
    assert tq.take_most_dissimilar(small, 11, measure) is small
    with pytest.raises(ValueError, match="Unknown measure"):
        tq.take_most_dissimilar(torch.from_numpy(f), 3, "manhattan")


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_2d_matches_jax(mode, align_corners):
    rng = np.random.default_rng(1)
    inp = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 4, 6, 2)).astype(np.float32)  # some points outside
    want = np.asarray(js.grid_sample_2d(jnp.asarray(inp), jnp.asarray(grid), mode, align_corners))
    got = ts.grid_sample_2d(torch.from_numpy(inp), torch.from_numpy(grid), mode,
                            align_corners).numpy()
    assert got.shape == (2, 3, 4, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_sample_features2d_matches_jax(mode):
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((4, 6, 5, 9)).astype(np.float32)
    ab = np.stack([rng.integers(0, s, (2, 7)) for s in (6, 5, 9)], axis=-1)
    rel = ((ab + 0.5) / np.array([6, 5, 9]) * 2 - 1).astype(np.float32)
    want = np.asarray(js.sample_features2d(jnp.asarray(feats), jnp.asarray(ab), jnp.asarray(rel), mode))
    got = ts.sample_features2d(torch.from_numpy(feats), torch.from_numpy(ab),
                               torch.from_numpy(rel), mode).numpy()
    assert got.shape == (2, 7, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
