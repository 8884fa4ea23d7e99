"""Port parity: the attention op of vittf_tpu_torch vs vittf_tpu on CPU.

On CPU tensors the port's wrapper runs its plain twin; the CUDA kernel is
held against the same twin on the card by ``chip_smoke.py`` (phase 2).
Here the twin is held against the JAX package's XLA math and its Pallas
kernel in interpret mode. Tolerances: fp32 2e-5 (as tests/test_attention.py);
bf16 0.05 of the reference scale (scores and probabilities round to bf16 at
other places in the two frameworks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.ops.attention import _attention_pallas, _attention_xla
from vittf_tpu.ops.attention import multi_head_attention as jax_mha
from vittf_tpu_torch.ops.attention import (
    attention,
    attention_plain,
    multi_head_attention,
)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("B,H,N,hd", [(2, 4, 65, 16), (1, 2, 257, 64), (2, 6, 17, 64)])
def test_plain_matches_xla_fp32(B, H, N, hd):
    q, k, v = _qkv((B, H, N, hd))
    want = np.asarray(_attention_xla(*map(jnp.asarray, (q, k, v)), "highest"))
    got = attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,H,N,hd", [(1, 2, 129, 64), (2, 3, 33, 32)])
def test_plain_matches_pallas_interpret_fp32(B, H, N, hd):
    q, k, v = _qkv((B, H, N, hd), seed=1)
    want = np.asarray(_attention_pallas(*map(jnp.asarray, (q, k, v)), H, interpret=True))
    got = attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_matches_jax_bf16():
    q, k, v = _qkv((2, 3, 129, 64), seed=2)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention_plain(tq, tk, tv).float().numpy()
    for want in (
        np.asarray(_attention_xla(jq, jk, jv, "default")).astype(np.float32),
        np.asarray(_attention_pallas(jq, jk, jv, 3, interpret=True)).astype(np.float32),
    ):
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_multi_head_attention_matches_jax(impl):
    B, N, D, heads = 2, 17, 128, 2
    qkv = np.random.default_rng(3).standard_normal((B, N, 3 * D)).astype(np.float32)
    want = np.asarray(jax_mha(jnp.asarray(qkv), heads, "highest", impl="xla"))
    got = multi_head_attention(torch.from_numpy(qkv), heads, impl=impl).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_cpu_wrapper_is_plain_and_not_counted():
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 9, 64), seed=4))
    before = attention.launches
    torch.testing.assert_close(attention(q, k, v), attention_plain(q, k, v), rtol=0, atol=0)
    assert attention.launches == before


def test_wrapper_rejects_other_devices():
    q = torch.empty((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention(q, q, q)


# The shapes that stress the card kernel's tiling (64-key tiles, 128-query
# blocks): one partial tile, exact tiles, one key past a tile, one query past
# a block. The twin must agree with the JAX package at each of them, since
# the card's kernel is held to the twin at the same shapes.
EDGE_KEYS = [17, 64, 65, 129]


@pytest.mark.parametrize("N", EDGE_KEYS)
def test_plain_matches_xla_fp32_at_tile_edges(N):
    q, k, v = _qkv((2, 6, N, 64), seed=10 + N)
    want = np.asarray(_attention_xla(*map(jnp.asarray, (q, k, v)), "highest"))
    got = attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N", EDGE_KEYS)
def test_plain_matches_pallas_interpret_fp32_at_tile_edges(N):
    q, k, v = _qkv((1, 6, N, 64), seed=20 + N)
    want = np.asarray(_attention_pallas(*map(jnp.asarray, (q, k, v)), 6, interpret=True))
    got = attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_scale", [1.0, 8.0])
@pytest.mark.parametrize("N", EDGE_KEYS)
def test_plain_matches_xla_bf16_at_tile_edges(N, q_scale):
    """bf16 at 0.02·max|ref|; with q scaled by 8 the softmax is peaked (a
    row's mass on a few keys), where a wrong max or rescale would show.
    There both frameworks round the scores to bf16, so the reference is the
    JAX math in fp32 on the same bf16 values and the limit 0.05·max|ref|."""
    q, k, v = _qkv((2, 6, N, 64), seed=30 + N)
    q = q * np.float32(q_scale)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention_plain(tq, tk, tv).float().numpy()
    if q_scale == 1.0:
        want = np.asarray(_attention_xla(jq, jk, jv, "default")).astype(np.float32)
        limit = 0.02
    else:
        want = np.asarray(_attention_xla(*(a.astype(jnp.float32) for a in (jq, jk, jv)), "highest"))
        limit = 0.05
    assert np.abs(got - want).max() <= limit * np.abs(want).max()


def test_plain_is_shift_invariant_on_all_negative_rows():
    """No clamp of the row max at 0: with every score far below zero the
    softmax equals that of the scores shifted up by a constant per row (the
    card's kernel masks padded keys with -inf instead of clamping, and is
    held to this twin)."""
    rng = np.random.default_rng(40)
    q = np.abs(rng.standard_normal((1, 2, 65, 64))).astype(np.float32)
    k = -np.abs(rng.standard_normal((1, 2, 65, 64))).astype(np.float32)  # q·k < 0 everywhere
    v = rng.standard_normal((1, 2, 65, 64)).astype(np.float32)
    got = attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    s = np.einsum("bhnd,bhmd->bhnm", q, k).astype(np.float64) / 8.0
    assert s.max() < -1.0
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    want = np.einsum("bhnm,bhmd->bhnd", p / p.sum(axis=-1, keepdims=True), v.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    jax_got = np.asarray(_attention_xla(*map(jnp.asarray, (q, k, v)), "highest"))
    np.testing.assert_allclose(got, jax_got, rtol=2e-5, atol=2e-5)
