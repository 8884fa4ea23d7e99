"""Port parity: vittf_tpu_torch.pipeline.streamed vs vittf_tpu on CPU.

The mirror of tests/test_streamed.py: host-streamed extraction with the
TINY model in parity mode, held to rtol 1e-5 against the JAX package's
``extract_features_streamed`` and against the port's resident
``extract_features`` (the chunked accumulation keeps the batch-ordered
fp32 sum).
"""
import numpy as np
import pytest
import torch

from tests.test_torch_vit import as_numpy_tree, port_cfg
from tests.test_vit import TINY, _make_pair
from vittf_tpu.pipeline import features as jf
from vittf_tpu.pipeline.streamed import extract_features_streamed as jax_streamed
from vittf_tpu_torch.models.dino import params_from_jax
from vittf_tpu_torch.pipeline import features as tf
from vittf_tpu_torch.pipeline.streamed import extract_features_streamed


@pytest.fixture(scope="module")
def params():
    _, p = _make_pair(TINY, seed=9)
    return p, params_from_jax(as_numpy_tree(p))


def _kw(**kw):
    return dict(dict(feature_output_size=4, slice_along="all", batch_size=2), **kw)


def _check(params, vol, chunk_batches=8, **kw):
    jparams, sd = params
    want = jax_streamed(vol, jparams, TINY,
                        jf.ExtractConfig(precision="highest", attn_impl="xla", **_kw(**kw)),
                        chunk_batches=chunk_batches)["k"]
    tcfg = tf.ExtractConfig(precision="highest", **_kw(**kw))
    got = extract_features_streamed(vol, sd, port_cfg(TINY), tcfg, chunk_batches=chunk_batches,
                                    device="cpu")["k"]
    resident = tf.extract_features(vol, sd, port_cfg(TINY), tcfg, device="cpu")["k"]
    assert got.shape == tuple(want.shape) == resident.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), resident.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk_batches", [1, 2, 3])
def test_streamed_matches_full(params, chunk_batches):
    vol = np.random.default_rng(0).random((12, 16, 20)).astype(np.float32)
    _check(params, vol, chunk_batches)


def test_streamed_matches_fast(params):
    vol = np.random.default_rng(1).random((16, 16, 16)).astype(np.float32)
    _check(params, vol, 2, slice_subsample=True)


def test_streamed_single_axis_no_pool(params):
    vol = np.random.default_rng(2).random((12, 16, 12)).astype(np.float32)
    _check(params, vol, 3, slice_along="y")


def test_streamed_uint8_compact(params):
    vol = (np.random.default_rng(3).random((12, 12, 12)) * 255).astype(np.uint8)
    _check(params, vol)


def test_streamed_fused_equals_resident(params):
    """bf16 with the fused block: streamed and resident run the same batches
    through the same kernels in the same order, so they agree bit for bit."""
    _, sd = params
    vol = np.random.default_rng(4).random((12, 16, 20)).astype(np.float32)
    cfg = tf.ExtractConfig(compute_dtype="bfloat16", block_impl="fused", **_kw())
    got = extract_features_streamed(vol, sd, port_cfg(TINY), cfg, chunk_batches=2,
                                    device="cpu")["k"]
    want = tf.extract_features(vol, sd, port_cfg(TINY), cfg, device="cpu")["k"]
    assert torch.equal(got, want)


def test_streamed_refuses_bad_input(params):
    _, sd = params
    with pytest.raises(ValueError, match="scalar"):
        extract_features_streamed(np.zeros((3, 8, 8, 8), np.float32), sd, port_cfg(TINY),
                                  device="cpu")
    with pytest.raises(ValueError, match="chunk_batches"):
        extract_features_streamed(np.zeros((8, 8, 8), np.float32), sd, port_cfg(TINY),
                                  chunk_batches=0, device="cpu")
