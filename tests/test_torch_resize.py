"""Port parity: vittf_tpu_torch.ops.resize vs vittf_tpu.ops.resize on CPU.

Same numpy inputs through both; the weight matrices are identical numpy
constructions, so fp32 results agree to 1e-6 (summation order only) and
nearest resizes agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.ops import resize as jr
from vittf_tpu_torch.ops import resize as tr


@pytest.mark.parametrize(
    "shape,size",
    [
        ((2, 3, 16, 12), (8, 4)),     # integer downsample
        ((2, 3, 4, 6), (8, 18)),      # integer upsample
        ((1, 2, 7, 9), (5, 13)),      # general gather
        ((3, 10, 6, 8), (5, 12, 3)),  # 3D, mixed
    ],
)
def test_resize_nearest_matches_jax(shape, size):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jr.resize_nearest(jnp.asarray(x), size))
    got = tr.resize_nearest(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(got, want)


def test_resize_nearest_uint8_exact():
    x = np.random.default_rng(1).integers(0, 256, (2, 6, 5, 7), dtype=np.uint8)
    for size in ((12, 10, 14), (3, 5, 4), (9, 7, 3)):
        want = np.asarray(jr.resize_nearest(jnp.asarray(x), size))
        got = tr.resize_nearest(torch.from_numpy(x), size)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("g,hw", [(4, (6, 5)), (14, (37, 37)), (8, (4, 4))])
def test_resize_cubic_scaled_matches_jax(g, hw):
    x = np.random.default_rng(2).standard_normal((1, 16, g, g)).astype(np.float32)
    scales = (g / (hw[0] + 0.1), g / (hw[1] + 0.1))
    want = np.asarray(jr.resize_cubic_scaled(jnp.asarray(x), hw, scales))
    got = tr.resize_cubic_scaled(torch.from_numpy(x), hw, scales).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,size", [((1, 3, 7, 9), (13, 5)), ((2, 4, 6), (11,)),
                                        ((1, 2, 5, 8, 4), (7, 3, 4)), ((1, 1, 12, 12), (12, 6))])
def test_resize_cubic_matches_jax(shape, size):
    """At the tolerance of ``resize_cubic_scaled`` above: the same weight
    matrices, fp32 sums in another order."""
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want = np.asarray(jr.resize_cubic(jnp.asarray(x), size))
    got = tr.resize_cubic(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "shape,size", [((4, 12, 16, 20), (3, 4, 5)), ((2, 7, 9, 5), (4, 4, 4)), ((3, 8, 8, 8), (8, 8, 8))]
)
def test_adaptive_avg_pool_matches_jax(shape, size):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(jr.adaptive_avg_pool(jnp.asarray(x), size))
    got = tr.adaptive_avg_pool(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_adaptive_weight_matrix_identical():
    for n_in, n_out in ((12, 3), (7, 4), (5, 8), (64, 64)):
        np.testing.assert_array_equal(
            tr._adaptive_avg_weight_matrix(n_in, n_out),
            jr._adaptive_avg_weight_matrix(n_in, n_out),
        )
