"""Port parity: vittf_tpu_torch.ops.fused_block (K3) vs vittf_tpu on CPU.

On CPU tensors ``fused_block`` runs ``fused_block_plain``. The same numpy
inputs and block weights (JAX params, biases and LayerNorm parameters
perturbed so that every term counts, carried across by ``params_from_jax``)
go through the JAX ``fused_block`` in interpret mode and through the JAX
per-op block ``_block(..., 'highest')``. Tolerances: fp32 2e-4, those of
tests/test_fused_block.py; bf16 0.02·max|ref| (0.05 with bf16 scores), the
on-chip contract of tests_tpu/test_kernels_tpu.py. The plain twin takes the
softmax row max over valid keys only, where the TPU kernel's zero-score
padded keys clamp it at >= 0: the softmax is shift-invariant, so the two
agree within these tolerances.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vit import as_numpy_tree, port_cfg, port_model
from vittf_tpu.models.vit import ViTConfig, _block, init_vit_params, vit_forward_raw
from vittf_tpu.ops import fused_block as jfb
from vittf_tpu_torch.models.dino import params_from_jax
from vittf_tpu_torch.ops import fused_block as tfb

MINI = ViTConfig(patch_size=8, embed_dim=128, depth=2, num_heads=2, img_size=32)
MINI_LS = ViTConfig(patch_size=8, embed_dim=128, depth=1, num_heads=2, img_size=32,
                    layerscale=True)


def _perturbed_params(cfg, seed):
    """JAX params with the biases and LayerNorm parameters moved off their
    init (0 and 1), so that each term reaches the output."""
    params = init_vit_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params["blocks"] = [
        jax.tree_util.tree_map_with_path(
            lambda path, a: a if path[-1].key == "kernel"
            else a + jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype), b)
        for b in params["blocks"]
    ]
    return params


def _hub_block(params, i=0, dtype=torch.float32):
    """Block i of JAX params as the port's hub-named tensors."""
    sd = params_from_jax(as_numpy_tree(params))
    pre = f"blocks.{i}."
    return {k[len(pre):]: v.to(dtype) for k, v in sd.items() if k.startswith(pre)}


@pytest.fixture(scope="module")
def mini():
    params = _perturbed_params(MINI, 0)
    return params, _hub_block(params)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("n_tokens", [64, 384, 401, 785])
def test_plain_matches_jax(mini, n_tokens):
    params, blk = mini
    x = _x((2, n_tokens, MINI.embed_dim))
    got = tfb.fused_block(torch.from_numpy(x), blk, MINI.num_heads).numpy()
    want_kernel = jfb.fused_block(jnp.asarray(x), params["blocks"][0], MINI.num_heads,
                                  interpret=True)
    want_block, _ = _block(jnp.asarray(x), params["blocks"][0], MINI, "highest", "xla")
    _close(got, np.asarray(want_kernel), 2e-4)
    _close(got, np.asarray(want_block), 2e-4)


@pytest.mark.parametrize("impl,softmax_max", [("loop", False), ("rows", True), ("rows", False)])
def test_impl_and_softmax_max_match_jax_interpret(mini, impl, softmax_max):
    params, blk = mini
    x = _x((2, 401, MINI.embed_dim), seed=1)
    got = tfb.fused_block(torch.from_numpy(x), blk, MINI.num_heads, impl=impl,
                          softmax_max=softmax_max).numpy()
    want = jfb.fused_block(jnp.asarray(x), params["blocks"][0], MINI.num_heads, interpret=True,
                           impl=impl, softmax_max=softmax_max)
    _close(got, np.asarray(want), 2e-4)


def test_layerscale_gammas_reach_both_residuals():
    params = _perturbed_params(MINI_LS, 3)
    rng = np.random.default_rng(3)
    for g in ("ls1", "ls2"):  # gammas of O(0.1), not the 1e-5 init
        params["blocks"][0][g] = jnp.asarray(0.1 * rng.standard_normal(128), jnp.float32)
    blk = _hub_block(params)
    assert "ls1.gamma" in blk and "ls2.gamma" in blk
    x = _x((2, 65, 128), seed=3)
    got = tfb.fused_block(torch.from_numpy(x), blk, MINI_LS.num_heads).numpy()
    want_kernel = jfb.fused_block(jnp.asarray(x), params["blocks"][0], 2, interpret=True)
    want_block, _ = _block(jnp.asarray(x), params["blocks"][0], MINI_LS, "highest", "xla")
    _close(got, np.asarray(want_kernel), 2e-4)
    _close(got, np.asarray(want_block), 2e-4)
    # without its gammas the block is a different function
    no_ls = {k: v for k, v in blk.items() if not k.startswith("ls")}
    assert np.abs(tfb.fused_block(torch.from_numpy(x), no_ls, 2).numpy() - got).max() > 1e-2


@pytest.mark.parametrize("softmax_max", [True, False])
def test_n_valid_masks_padded_keys(mini, softmax_max):
    params, blk = mini
    x = _x((2, 437, MINI.embed_dim), seed=2)
    got = tfb.fused_block(torch.from_numpy(x), blk, MINI.num_heads, n_valid=401,
                          softmax_max=softmax_max).numpy()
    want = jfb.fused_block(jnp.asarray(x), params["blocks"][0], MINI.num_heads, n_valid=401,
                           interpret=True, softmax_max=softmax_max)
    _close(got, np.asarray(want), 2e-4)
    # the valid rows are those of the unpadded tokens
    short = tfb.fused_block(torch.from_numpy(x[:, :401]), blk, MINI.num_heads,
                            softmax_max=softmax_max).numpy()
    _close(got[:, :401], short, 1e-5)


def test_head_dim_guard():
    cfg = ViTConfig(patch_size=8, embed_dim=256, depth=1, num_heads=2, img_size=32)  # hd 128
    blk = _hub_block(init_vit_params(cfg, jax.random.PRNGKey(6)))
    x = torch.zeros((1, 64, 256))
    for fn in (tfb.fused_block, tfb.fused_block_plain):
        with pytest.raises(ValueError, match="head_dim"):
            fn(x, blk, cfg.num_heads)


@pytest.mark.parametrize(
    "softmax_max,score_dtype", [(True, "fp32"), (False, "fp32"), (False, "bf16"), (True, "bf16")]
)
def test_bf16_matches_jax_interpret(mini, softmax_max, score_dtype):
    """Speed mode: both sides start from the same bf16 weights and tokens."""
    params, blk = mini
    jblk = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params["blocks"][0])
    x = jnp.asarray(_x((2, 401, MINI.embed_dim), seed=4) * 0.5, jnp.bfloat16)
    want = np.asarray(jfb.fused_block(x, jblk, MINI.num_heads, interpret=True,
                                      softmax_max=softmax_max, score_dtype=score_dtype),
                      np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    got = tfb.fused_block(xt, {k: v.bfloat16() for k, v in blk.items()}, MINI.num_heads,
                          softmax_max=softmax_max, score_dtype=score_dtype)
    assert got.dtype == torch.bfloat16
    lim = (0.05 if score_dtype == "bf16" else 0.02) * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= lim


def test_cpu_wrapper_is_the_plain_twin(mini):
    _, blk = mini
    x = torch.from_numpy(_x((1, 70, MINI.embed_dim), seed=5))
    before = tfb.fused_block.launches
    got = tfb.fused_block(x, blk, MINI.num_heads, softmax_max=False)
    assert torch.equal(got, tfb.fused_block_plain(x, blk, MINI.num_heads, softmax_max=False))
    assert tfb.fused_block.launches == before


def test_weights_prepared_once_per_block(mini):
    params, _ = mini
    model = port_model(params, MINI)
    blk = model.blocks[0]
    x = torch.from_numpy(_x((1, 17, MINI.embed_dim), seed=6))
    first = tfb.fused_block(x, blk, MINI.num_heads)
    prepared = blk.__dict__["_fused_weights"][1]
    tfb.fused_block(x, blk, MINI.num_heads)
    assert blk.__dict__["_fused_weights"][1] is prepared
    with torch.no_grad():
        blk.mlp.fc2.bias.add_(1.0)  # an in-place update is seen
    assert not torch.equal(tfb.fused_block(x, blk, MINI.num_heads), first)
    assert blk.__dict__["_fused_weights"][1] is not prepared
    # the folded q third: (1/√hd)·log2(e) on Wq and bq only
    w = blk.__dict__["_fused_weights"][1]
    scale = (128 // 2) ** -0.5 * np.log2(np.e)
    torch.testing.assert_close(w.wqkv[:128], blk.attn.qkv.weight[:128] * scale)
    torch.testing.assert_close(w.wqkv[128:], blk.attn.qkv.weight[128:], rtol=0, atol=0)


def test_forward_raw_fp32_keeps_per_op_blocks(mini):
    """block_impl='fused' in fp32 is the per-op forward bit for bit, as in
    the JAX package (tests/test_fused_block.py)."""
    params, _ = mini
    model = port_model(params, MINI)
    imgs = torch.from_numpy(_x((1, 3, 32, 32), seed=7))
    ref = model.forward_raw(imgs, precision="highest")
    got = model.forward_raw(imgs, precision="highest", block_impl="fused")
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="block_impl"):
        model.forward_raw(imgs, block_impl="fused_fast")


@pytest.mark.parametrize("block_impl", ["fused", "fused_rows_nomax"])
def test_forward_raw_bf16_matches_jax(mini, monkeypatch, block_impl):
    params, _ = mini
    monkeypatch.setattr(jfb, "fused_block", functools.partial(jfb.fused_block, interpret=True))
    imgs = _x((2, 3, 32, 40), seed=8)
    want_tok, want_qkv = vit_forward_raw(params, jnp.asarray(imgs), MINI,
                                         compute_dtype=jnp.bfloat16, block_impl=block_impl)
    model = port_model(params, MINI, torch.bfloat16)
    got_tok, got_qkv = model.forward_raw(torch.from_numpy(imgs), block_impl=block_impl)
    for got, want in ((got_tok, want_tok), (got_qkv, want_qkv)):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 0.02 * np.abs(want).max()
    assert port_cfg(MINI).head_dim == 64
