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
