"""Port parity: vittf_tpu_torch.ops.similarity vs vittf_tpu on CPU.

On CPU tensors the port's wrapper runs its plain twin; the CUDA kernel is
held against the same twin on the card by ``chip_smoke.py`` (phase 3).
Tolerance rtol 1e-4 / atol 1e-5, as tests/test_similarity.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.ops import similarity as js
from vittf_tpu_torch.ops import similarity as ts


def _inputs(N, F, counts, seed=0, q_scale=0.3):
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((N, F)) * 0.3).astype(np.float32)
    qf = (rng.standard_normal((sum(counts), F)) * q_scale).astype(np.float32)
    return feats, qf, js.class_mean_matrix(counts, sum(counts))


@pytest.mark.parametrize("mean_first", [False, True])
@pytest.mark.parametrize("layout", ["nc", "cn"])
def test_plain_matches_xla(mean_first, layout):
    counts = [7] if mean_first else [7, 5, 3]
    feats, qf, m = _inputs(200, 16, counts)
    want = np.asarray(js.similarity_xla(
        jnp.asarray(feats), jnp.asarray(qf), jnp.asarray(m),
        mean_first=mean_first, out_layout=layout,
    ))
    got = ts.similarity_plain(
        torch.from_numpy(feats), torch.from_numpy(qf), torch.from_numpy(m),
        mean_first=mean_first, out_layout=layout,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mean_first", [False, True])
@pytest.mark.parametrize("layout", ["nc", "cn"])
def test_plain_matches_pallas_interpret(mean_first, layout):
    from jax.experimental.pallas import tpu as pltpu

    counts = [1500] if mean_first else [9, 4]
    feats, qf, m = _inputs(300, 24, counts, seed=1, q_scale=0.1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(js.similarity_pallas(
            jnp.asarray(feats), jnp.asarray(qf), jnp.asarray(m),
            mean_first=mean_first, out_layout=layout,
        ))
    got = ts.similarity_plain(
        torch.from_numpy(feats), torch.from_numpy(qf), torch.from_numpy(m),
        mean_first=mean_first, out_layout=layout,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_zero_padded_queries_contribute_nothing():
    """Padding the annotation axis with zero rows (and zero M rows) is exact."""
    feats, qf, m = _inputs(64, 8, [5, 3], seed=2)
    pad_q = np.concatenate([qf, np.zeros((8, 8), np.float32)])
    pad_m = np.concatenate([m, np.zeros((8, 2), np.float32)])
    a = ts.similarity_plain(*map(torch.from_numpy, (feats, qf, m)))
    b = ts.similarity_plain(*map(torch.from_numpy, (feats, pad_q, pad_m)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_class_mean_matrix_and_fused_similarity_match_jax():
    counts = [3, 0, 2]
    np.testing.assert_array_equal(ts.class_mean_matrix(counts, 8), js.class_mean_matrix(counts, 8))
    feats, qf, _ = _inputs(50, 12, counts, seed=3)
    want = np.asarray(js.fused_similarity(jnp.asarray(feats), jnp.asarray(qf), counts, impl="xla"))
    got = ts.fused_similarity(torch.from_numpy(feats), torch.from_numpy(qf), counts).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert (got[:, 1] == 0).all()  # empty class: all-zero map


def test_cpu_wrapper_is_plain_and_not_counted():
    feats, qf, m = (torch.from_numpy(a) for a in _inputs(40, 8, [4, 4], seed=4))
    before = ts.similarity.launches
    torch.testing.assert_close(
        ts.similarity(feats, qf, m, out_layout="cn"),
        ts.similarity_plain(feats, qf, m, out_layout="cn"), rtol=0, atol=0,
    )
    assert ts.similarity.launches == before
    with pytest.raises(ValueError, match="unknown similarity impl"):
        ts.fused_similarity_m(feats, qf, m, impl="pallas")


# The edges of the card kernel's tiling (128-voxel blocks, 256-annotation
# chunks, 32-feature slabs): annotations short of a chunk, voxels short of a
# block, features short of a slab, one class and the 32 the kernel allows.
EDGE_CASES = [
    (129, 16, [70]),            # A = 70, C = 1
    (200, 36, [33, 37]),        # F not a multiple of 32
    (65, 24, [3] * 32),         # C = 32
    (300, 16, [130, 129]),      # A = 259: one annotation past a chunk
]


@pytest.mark.parametrize("mean_first", [False, True])
@pytest.mark.parametrize("N,F,counts", EDGE_CASES)
def test_plain_matches_xla_at_tile_edges(N, F, counts, mean_first):
    feats, qf, m = _inputs(N, F, counts, seed=5 + len(counts), q_scale=0.5)
    # a low threshold, so that the class means of random scores pass it too
    want = np.asarray(js.similarity_xla(
        jnp.asarray(feats), jnp.asarray(qf), jnp.asarray(m), threshold=0.01,
        mean_first=mean_first))
    got = ts.similarity_plain(
        torch.from_numpy(feats), torch.from_numpy(qf), torch.from_numpy(m), threshold=0.01,
        mean_first=mean_first).numpy()
    assert got.shape == (N, len(counts)) and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("N,F,counts", EDGE_CASES[:3])
def test_plain_matches_pallas_interpret_at_tile_edges(N, F, counts):
    from jax.experimental.pallas import tpu as pltpu

    feats, qf, m = _inputs(N, F, counts, seed=9 + len(counts), q_scale=0.5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(js.similarity_pallas(
            jnp.asarray(feats), jnp.asarray(qf), jnp.asarray(m)))
    got = ts.similarity_plain(*map(torch.from_numpy, (feats, qf, m))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("exponent", [2.0, 2.5, 3.0])
def test_g_below_the_threshold_is_pow_of_zero(exponent):
    """g(s) = where(s >= t, s, 0) ** e: a score below the threshold gives
    0 ** e, the value the card's kernel takes once per launch."""
    s = torch.tensor([[0.2, 0.25, 0.3, -1.0]])
    got = ts._g(s, 0.25, exponent)
    want = torch.tensor([[0.0, 0.25 ** exponent, 0.3 ** exponent, 0.0]])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
