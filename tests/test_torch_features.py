"""Port parity: vittf_tpu_torch.pipeline.features vs vittf_tpu on CPU.

The same TINY-model weights and the same numpy volumes go through the JAX
``extract_features`` (parity mode, XLA attention) and the port's. The port
runs z, y, x in turn where the JAX package fuses cubic sweeps into one jit;
the sums are the same up to fp32 reassociation, held to rtol 1e-5 (the
golden-file tolerance of tests/test_golden.py).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vit import as_numpy_tree, port_cfg
from tests.test_vit import TINY, _make_pair
from vittf_tpu.pipeline import features as jf
from vittf_tpu_torch.models.dino import params_from_jax
from vittf_tpu_torch.pipeline import features as tf

GOLDEN = "tests/golden/tiny_pipeline.npz"


@pytest.fixture(scope="module")
def params():
    _, p = _make_pair(TINY, seed=1)
    return p


def _both(params, vol, **kw):
    jcfg = jf.ExtractConfig(precision="highest", attn_impl="xla", **kw)
    tcfg = tf.ExtractConfig(precision="highest", **kw)
    want = jf.extract_features(jnp.asarray(vol), params, TINY, jcfg)["k"]
    got = tf.extract_features(vol, params_from_jax(as_numpy_tree(params)), port_cfg(TINY), tcfg,
                              device="cpu")["k"]
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize(
    "shape,kw",
    [
        ((16, 16, 16), dict(feature_output_size=4, slice_along="all", batch_size=3)),
        ((12, 16, 20), dict(feature_output_size=4, slice_along="all", batch_size=3)),
        ((12, 16, 20), dict(feature_output_size=4, slice_along="y", batch_size=4)),
        ((32, 32, 32), dict(feature_output_size=4, slice_along="all", batch_size=4,
                            slice_subsample=True)),
        ((12, 16, 20), dict(feature_output_size=4, slice_along="all", batch_size=2,
                            slice_subsample=True)),
    ],
    ids=["cubic_all", "noncubic_all", "single_axis_unpooled", "fast_predecimated",
         "fast_noncubic"],
)
def test_extract_features_matches_jax(params, shape, kw):
    vol = np.random.default_rng(42).random(shape).astype(np.float32)
    got, want = _both(params, vol, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_uint8_volume_matches_jax(params):
    vol = np.random.default_rng(7).integers(0, 256, (16, 16, 16), dtype=np.uint8)
    got, want = _both(params, vol, feature_output_size=4, batch_size=4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_golden_features():
    from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features

    golden = np.load(GOLDEN)
    tmodel, _ = _make_pair(TINY, seed=11)
    vol = np.random.default_rng(123).random((16, 16, 16)).astype(np.float32)
    got = extract_features(
        vol, tmodel.state_dict(), port_cfg(TINY),
        ExtractConfig(feature_output_size=4, slice_along="all", batch_size=4,
                      precision="highest"),
        device="cpu",
    )["k"]
    np.testing.assert_allclose(got.numpy(), golden["features"], rtol=1e-5, atol=1e-6)


def test_fold_grayscale_patch_embed_matches_jax(params):
    want = jf.fold_grayscale_patch_embed(params)["patch_embed"]
    got = tf.fold_grayscale_patch_embed(params_from_jax(as_numpy_tree(params)))
    np.testing.assert_allclose(
        got["patch_embed.proj.weight"].permute(2, 3, 1, 0).numpy(),
        np.asarray(want["kernel"]), rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_allclose(
        got["patch_embed.proj.bias"].numpy(), np.asarray(want["bias"]), rtol=1e-6, atol=1e-6
    )


def test_helpers_match_jax():
    for shape, fos, patch in (((12, 16, 20), 4, 4), ((100, 100, 100), 64, 8), ((64, 80, 48), 8, 14)):
        assert tf.compute_im_sizes(shape, fos, patch) == jf.compute_im_sizes(shape, fos, patch)
    for S, target in ((128, 64), (100, 64), (37, 5)):
        np.testing.assert_array_equal(
            tf._subsample_slice_indices(S, target), jf._subsample_slice_indices(S, target)
        )
    vol = np.random.default_rng(0).random((32, 32, 32)).astype(np.float32)
    im, fo = tf.compute_im_sizes(vol.shape, 4, 4)
    got = tf._predecimate_fast_input(torch.from_numpy(vol), im, fo)
    want = jf._predecimate_fast_input(jnp.asarray(vol), im, fo)
    assert got.shape == (16, 16, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fused_both(params, monkeypatch, block_impl):
    """bf16 extraction through the fused block on both sides; the JAX block
    runs in interpret mode (its TPU kernel does not lower on the CPU)."""
    from vittf_tpu.ops import fused_block as jfb

    monkeypatch.setattr(jfb, "fused_block", functools.partial(jfb.fused_block, interpret=True))
    vol = np.random.default_rng(3).random((16, 16, 16)).astype(np.float32)
    kw = dict(feature_output_size=4, batch_size=4, compute_dtype="bfloat16", block_impl=block_impl)
    want = jf.extract_features(jnp.asarray(vol), params, TINY,
                               jf.ExtractConfig(attn_impl="xla", **kw))["k"]
    got = tf.extract_features(vol, params_from_jax(as_numpy_tree(params)), port_cfg(TINY),
                              tf.ExtractConfig(**kw), device="cpu")["k"]
    want = np.asarray(want)
    assert got.shape == want.shape
    # the bf16 block-stack contract (tests_tpu/test_kernels_tpu.py)
    assert np.abs(got.numpy() - want).max() <= 0.02 * np.abs(want).max()
    return got


def test_fused_block_impl_not_ported(params, monkeypatch):
    """block_impl='fused', the path the port refused before the fused block
    was ported, matches the JAX package's extraction."""
    got = _fused_both(params, monkeypatch, "fused")
    xla = tf.extract_features(
        np.random.default_rng(3).random((16, 16, 16)).astype(np.float32),
        params_from_jax(as_numpy_tree(params)), port_cfg(TINY),
        tf.ExtractConfig(feature_output_size=4, batch_size=4, compute_dtype="bfloat16"),
        device="cpu",
    )["k"]
    assert not torch.equal(got, xla)  # the blocks really ran fused


@pytest.mark.parametrize("block_impl", ["fused_max", "fused_rows"])
def test_fused_block_impls_match_jax(params, monkeypatch, block_impl):
    _fused_both(params, monkeypatch, block_impl)


def test_unknown_block_impl_raises(params):
    cfg = tf.ExtractConfig(feature_output_size=4, block_impl="fused_nomax")
    with pytest.raises(ValueError, match="block_impl"):
        tf.extract_features(np.zeros((8, 8, 8), np.float32), {}, port_cfg(TINY), cfg,
                            device="cpu")
