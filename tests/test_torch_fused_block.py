"""Port parity: vittf_tpu_torch.ops.fused_block (K3) vs vittf_tpu on CPU.

On CPU tensors ``fused_block`` runs ``fused_block_plain``. The same numpy
inputs and block weights (JAX params, biases and LayerNorm parameters
perturbed so that every term counts, carried across by ``params_from_jax``)
go through the JAX ``fused_block`` in interpret mode and through the JAX
per-op block ``_block(..., 'highest')``. Tolerances: fp32 2e-4, those of
tests/test_fused_block.py; bf16 0.02·max|ref|, the on-chip contract of
tests_tpu/test_kernels_tpu.py. The plain twin takes the
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
from vittf_tpu_torch.models import vit as port_vit
from vittf_tpu_torch.models.dino import params_from_jax
from vittf_tpu_torch.ops import fused_block as tfb
from vittf_tpu_torch.ops.layer_norm import layer_norm_plain
from vittf_tpu_torch.pipeline import features as tf

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
    """Each of the JAX kernel's grid schedules (``impl``) computes what the
    port's one kernel, which has no ``impl``, computes."""
    params, blk = mini
    x = _x((2, 401, MINI.embed_dim), seed=1)
    got = tfb.fused_block(torch.from_numpy(x), blk, MINI.num_heads,
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


@pytest.mark.parametrize("softmax_max", [True, False])
def test_bf16_matches_jax_interpret(mini, softmax_max):
    """Speed mode: both sides start from the same bf16 weights and tokens."""
    params, blk = mini
    jblk = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params["blocks"][0])
    x = jnp.asarray(_x((2, 401, MINI.embed_dim), seed=4) * 0.5, jnp.bfloat16)
    want = np.asarray(jfb.fused_block(x, jblk, MINI.num_heads, interpret=True,
                                      softmax_max=softmax_max), np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    got = tfb.fused_block(xt, {k: v.bfloat16() for k, v in blk.items()}, MINI.num_heads,
                          softmax_max=softmax_max)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 0.02 * np.abs(want).max()


@pytest.mark.parametrize("fn", [tfb.fused_block, tfb.fused_block_plain])
def test_score_dtype_is_gone(mini, fn):
    """No caller of either package ever set it; the port dropped the knob."""
    _, blk = mini
    with pytest.raises(TypeError, match="score_dtype"):
        fn(torch.zeros((1, 8, MINI.embed_dim)), blk, MINI.num_heads, score_dtype="fp32")


# (the JAX forward's name, the port's name for the same numerics): the JAX
# model's 'fused[_rows][_nomax]' grammar against the port's one table
@pytest.mark.parametrize("jax_name,port_name", [
    ("fused", "fused_max"), ("fused_rows", "fused_rows"),
    ("fused_nomax", "fused"), ("fused_rows_nomax", "fused"),
])
def test_fused_names_resolve_as_jax(mini, monkeypatch, jax_name, port_name):
    """The port's name reaches fused_block with the softmax_max that the JAX
    forward passes for its name."""
    params, _ = mini
    seen = {}

    def spy(side, real):
        def call(x, blk, num_heads, **kw):
            seen.setdefault(side, []).append(kw["softmax_max"])
            return real(x, blk, num_heads, **kw)
        return call

    monkeypatch.setattr(jfb, "fused_block",
                        spy("jax", functools.partial(jfb.fused_block, interpret=True)))
    monkeypatch.setattr(port_vit, "fused_block", spy("port", tfb.fused_block))
    imgs = _x((1, 3, 32, 32), seed=9)
    vit_forward_raw(params, jnp.asarray(imgs), MINI, compute_dtype=jnp.bfloat16,
                    block_impl=jax_name)
    port_model(params, MINI, torch.bfloat16).forward_raw(torch.from_numpy(imgs),
                                                         block_impl=port_name)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == MINI.depth - 1
    assert seen["port"][0] == ("_nomax" not in jax_name)


@pytest.mark.parametrize("path", ["forward_raw", "extract_features"])
@pytest.mark.parametrize("block_impl,softmax_max",
                         [("fused", False), ("fused_max", True), ("fused_rows", True)])
def test_block_impl_reaches_fused_block_with_its_softmax_max(mini, monkeypatch, path,
                                                             block_impl, softmax_max):
    """One name means one softmax_max in the model and at the extraction
    layer, which passes ``ExtractConfig.block_impl`` through unchanged."""
    params, _ = mini
    seen = []

    def spy(x, blk, num_heads, **kw):
        seen.append(kw["softmax_max"])
        return tfb.fused_block(x, blk, num_heads, **kw)

    monkeypatch.setattr(port_vit, "fused_block", spy)
    if path == "forward_raw":
        port_model(params, MINI, torch.bfloat16).forward_raw(
            torch.from_numpy(_x((1, 3, 32, 32), seed=10)), block_impl=block_impl)
    else:
        cfg = tf.ExtractConfig(feature_output_size=4, batch_size=8, compute_dtype="bfloat16",
                               block_impl=block_impl)
        tf.extract_features(np.random.default_rng(10).random((16, 16, 16)).astype(np.float32),
                            params_from_jax(as_numpy_tree(params)), port_cfg(MINI), cfg,
                            device="cpu")
    assert seen and set(seen) == {softmax_max}


@pytest.mark.parametrize("D,Hd,heads,dtype", [
    (192, 768, 3, torch.bfloat16),     # not a multiple of 128
    (320, 1280, 5, torch.bfloat16),
    (384, 1600, 6, torch.bfloat16),    # the MLP width
    (384, 1536, 3, torch.bfloat16),    # head dim 128
    (384, 1536, 6, torch.float32),
    (2176, 8704, 34, torch.bfloat16),  # wider than K11's LayerNorm row
    (4096, 16384, 64, torch.bfloat16),
])
def test_kernel_shape_refusals(D, Hd, heads, dtype):
    with pytest.raises(ValueError, match="fused_block kernel"):
        tfb.check_kernel_shapes(D, Hd, heads, dtype)


@pytest.mark.parametrize("D,Hd", [(128, 512), (256, 1024), (384, 1536), (512, 2048),
                                  (768, 3072), (1024, 4096)])
def test_kernel_shapes_taken(D, Hd):
    tfb.check_kernel_shapes(D, Hd, D // 64, torch.bfloat16)


# ---------------------------------------------------------------------------
# numpy models of the CUDA kernel's structure (csrc/fused_block.cu on
# csrc/gemm_core.cuh and csrc/attention_core.cuh), held against the plain twin
# ---------------------------------------------------------------------------

def _bf16(a):
    """fp32 -> bf16 -> fp32, round to nearest even, as numpy."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _swz(row, chunk):
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _resident_linear_model(a, w, ln=None, bn=192):
    """out = LN(a) · wᵀ in fp32 as a thread block of the kernel takes it: per
    128-row block, a half warp (16 lanes) per row, lane l holding the 8-value
    vectors l, l + 16, ..; the statistics from per-lane partial sums joined by
    a butterfly; the normalised vectors (zeros for rows past M) written into
    the swizzled chunk tile of their K chunk; then every column tile of ``bn``
    columns as a sum over the K chunks read back through the swizzle."""
    M, K = a.shape
    N, n_k, n_vec = w.shape[0], K // 64, K // 128
    out = np.zeros((M, N), np.float32)
    for m0 in range(0, M, 128):
        smem = np.zeros((n_k, 128 * 128), np.uint8)
        for r in range(128):
            m = m0 + r
            vecs = {c: (a[m, 8 * c:8 * c + 8] if m < M else np.zeros(8, np.float32))
                    for c in range(K // 8)}
            if ln is not None and m < M:
                lane_sum = np.array([sum(np.float32(vecs[l + 16 * i].sum(dtype=np.float32))
                                         for i in range(n_vec)) for l in range(16)], np.float32)
                mu = np.float32(_butterfly(lane_sum) / np.float32(K))
                lane_sq = np.array([sum(np.float32(((vecs[l + 16 * i] - mu) ** 2).sum(dtype=np.float32))
                                        for i in range(n_vec)) for l in range(16)], np.float32)
                rs = np.float32(1) / np.sqrt(np.float32(_butterfly(lane_sq) / np.float32(K))
                                             + np.float32(1e-6))
                g, b = ln
                vecs = {c: _bf16(_bf16(_bf16((v - mu) * rs) * g[8 * c:8 * c + 8]) + b[8 * c:8 * c + 8])
                        for c, v in vecs.items()}
            for c, v in vecs.items():
                raw = torch.from_numpy(np.ascontiguousarray(v, np.float32)).bfloat16().view(torch.uint8)
                at = _swz(r, c & 7)
                smem[c >> 3, at:at + 16] = raw.numpy()
        # the A operand as the descriptors name it: chunk (c ^ (r & 7)) of row r
        blk = np.zeros((128, K), np.float32)
        for kc in range(n_k):
            for r in range(128):
                for c in range(8):
                    raw = torch.from_numpy(smem[kc, _swz(r, c):_swz(r, c) + 16].copy())
                    blk[r, kc * 64 + 8 * c:kc * 64 + 8 * c + 8] = raw.view(torch.bfloat16).float().numpy()
        rows = min(128, M - m0)
        for n0 in range(0, N, bn):
            acc = np.zeros((128, bn), np.float32)
            for kc in range(n_k):
                acc += blk[:, kc * 64:kc * 64 + 64] @ w[n0:n0 + bn, kc * 64:kc * 64 + 64].T
            out[m0:m0 + rows, n0:n0 + bn] = acc[:rows]
    return out


def _butterfly(v):
    """The xor-shuffle sum over 16 lanes (offsets 8, 4, 2, 1), lane 0's value."""
    v = v.astype(np.float32)
    for off in (8, 4, 2, 1):
        v = (v + v[np.arange(16) ^ off]).astype(np.float32)
    return v[0]


@pytest.mark.parametrize("K,N,bn", [(128, 384, 192), (128, 256, 128), (384, 384, 192)])
def test_resident_linear_model_bit_equal_to_plain(K, N, bn):
    """Operands on which every fp32 sum is exact, so that any order gives the
    same bits: integer tokens whose row mean is an integer (a row is pairs
    ±v plus an offset), unit LayerNorm gain and integer shift kept out of the
    product's way by taking the product on integer-valued rows. 150 rows: a
    full row block and a ragged one of 22. The model must equal the twin's
    ``layer_norm_plain`` bit for bit on the LayerNorm alone, and the twin's product
    on the staged rows."""
    rng = np.random.default_rng(K + N)
    M = 150
    half = rng.integers(-8, 9, (M, K // 2)).astype(np.float32)
    a = np.concatenate([half, -half], 1) * 2.0 ** rng.integers(-2, 3, (M, 1))
    a = rng.permuted(a, axis=1) + rng.integers(-3, 4, (M, 1)).astype(np.float32)
    g = _bf16(1 + 0.5 * rng.standard_normal(K))
    b = _bf16(0.5 * rng.standard_normal(K))
    eye = np.eye(K, dtype=np.float32)
    want_ln = layer_norm_plain(torch.from_numpy(a).bfloat16(), torch.from_numpy(g).bfloat16(),
                               torch.from_numpy(b).bfloat16()).float().numpy()
    got_ln = _resident_linear_model(_bf16(a), eye, ln=(g, b), bn=K if K == 128 else 192)
    np.testing.assert_array_equal(got_ln, want_ln)
    # the product, no LayerNorm (the proj form), on integer rows and weights
    w = rng.integers(-4, 5, (N, K)).astype(np.float32)
    rows = rng.integers(-8, 9, (M, K)).astype(np.float32)
    want = tfb._mm(torch.from_numpy(rows).bfloat16(), torch.from_numpy(w).bfloat16()).numpy()
    np.testing.assert_array_equal(_resident_linear_model(rows, w, bn=bn), want)


@pytest.mark.parametrize("K", [128, 384])
def test_resident_linear_model_matches_plain_ln_product(K):
    """LayerNorm and product together on normal draws. The sums are no longer
    exact: an fp32 order difference may flip a bf16 rounding of a normalised
    value (one part in 2^8 of one of K terms), so 1e-3·max|ref|."""
    rng = np.random.default_rng(K)
    a = _bf16(rng.standard_normal((140, K)))
    g, b = _bf16(1 + 0.5 * rng.standard_normal(K)), _bf16(0.5 * rng.standard_normal(K))
    w = _bf16(rng.standard_normal((256, K)) / np.sqrt(K))
    tb = lambda v: torch.from_numpy(v).bfloat16()  # noqa: E731
    want = tfb._mm(layer_norm_plain(tb(a), tb(g), tb(b)), tb(w)).numpy()
    got = _resident_linear_model(a, w, ln=(g, b), bn=128)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def _online_attention_model(q, k, v, n_valid, softmax_max, tile=64):
    """softmax(q·kᵀ)·v of one head in the exp2 domain as attention_core takes
    it: 64-key tiles, p = bf16(exp2(s − running max)), the output and the row
    sum of the rounded p rescaled in fp32 when the max moves, out =
    bf16(acc · 1/max(l, 1e-38))."""
    n = q.shape[0]
    m = np.full((n, 1), -np.inf, np.float32)
    acc, l = np.zeros((n, v.shape[1]), np.float32), np.zeros((n, 1), np.float32)
    for k0 in range(0, n_valid, tile):
        s = (q @ k[k0:min(k0 + tile, n_valid)].T).astype(np.float32)
        if softmax_max:
            m_new = np.maximum(m, s.max(-1, keepdims=True))
            alpha = np.exp2(m - m_new).astype(np.float32)
            acc, l, m = acc * alpha, l * alpha, m_new
            s = s - m
        p = _bf16(np.exp2(s))
        acc = (acc + p @ v[k0:min(k0 + tile, n_valid)]).astype(np.float32)
        l = (l + p.sum(-1, keepdims=True)).astype(np.float32)
    return _bf16(acc * (np.float32(1) / np.maximum(l, np.float32(1e-38))))


def _loud_block(rng, D, Hd, k_shift=1.0):
    """Hub-named bf16 tensors of a block where every term counts (as
    chip_smoke.random_block); ``k_shift`` scales the k bias."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()  # noqa: E731
    blk = {"attn.qkv.weight": t(rng.standard_normal((3 * D, D)) * 2 * D**-0.5),
           "attn.qkv.bias": t(0.5 * rng.standard_normal(3 * D)),
           "attn.proj.weight": t(rng.standard_normal((D, D)) * D**-0.5),
           "attn.proj.bias": t(0.5 * rng.standard_normal(D)),
           "mlp.fc1.weight": t(rng.standard_normal((Hd, D)) * D**-0.5),
           "mlp.fc1.bias": t(0.5 * rng.standard_normal(Hd)),
           "mlp.fc2.weight": t(rng.standard_normal((D, Hd)) * Hd**-0.5),
           "mlp.fc2.bias": t(0.5 * rng.standard_normal(D))}
    for n in ("norm1", "norm2"):
        blk[n + ".weight"], blk[n + ".bias"] = (t(1 + 0.5 * rng.standard_normal(D)),
                                                  t(0.5 * rng.standard_normal(D)))
    for n in ("ls1.gamma", "ls2.gamma"):
        blk[n] = t(rng.uniform(0.35, 1.05, D))
    blk["attn.qkv.bias"][D:2 * D] *= k_shift
    return blk


def _block_with_attention(x, blk, num_heads, attend):
    """fused_block_plain with its attention replaced by ``attend(q, k, v)``
    per (slice, head) on fp32 numpy views of the bf16 q, k, v."""
    w = tfb._block_weights(blk, num_heads, x.dtype)
    B, N, D = x.shape
    dt = x.dtype
    qkv = (tfb._mm(layer_norm_plain(x, w.ln1_w, w.ln1_b), w.wqkv) + w.bqkv.float()).to(dt)
    q, k, v = qkv.view(B, N, 3, num_heads, D // num_heads).permute(2, 0, 3, 1, 4).float().numpy()
    o = np.stack([np.stack([attend(q[b, h], k[b, h], v[b, h]) for h in range(num_heads)])
                  for b in range(B)])
    o = torch.from_numpy(o).to(dt)
    a = tfb._mm(o.permute(0, 2, 1, 3).reshape(B, N, D), w.wproj).to(dt) + w.bproj
    x2 = x + a * w.ls1
    mid = tfb._mm(layer_norm_plain(x2, w.ln2_w, w.ln2_b), w.wfc1).to(dt) + w.bfc1
    mid = torch.nn.functional.gelu(mid, approximate="tanh")
    return x2 + (tfb._mm(mid, w.wfc2).to(dt) + w.bfc2) * w.ls2


@pytest.mark.parametrize("n_tokens,n_valid", [(129, 129), (200, 150)])
def test_online_max_attention_inside_the_two_pass_limit(n_tokens, n_valid):
    """The kernel rounds p against the running max, the twin against the
    final one. On a block whose k bias shifts every row's scores by up to
    hundreds (only the row max keeps exp2 finite) the branch (out − x) of the
    online model stays inside 0.02·max|branch| of the twin's: the measured
    share of that limit is asserted below 1."""
    rng = np.random.default_rng(n_tokens)
    blk = _loud_block(rng, 128, 512, k_shift=80.0)
    x = torch.from_numpy(0.1 * rng.standard_normal((2, n_tokens, 128)).astype(np.float32)).bfloat16()
    assert not torch.isfinite(tfb.fused_block_plain(x, blk, 2, n_valid, softmax_max=False)).all()
    want = tfb.fused_block_plain(x, blk, 2, n_valid, softmax_max=True).float()
    got = _block_with_attention(
        x, blk, 2, lambda q, k, v: _online_attention_model(q, k, v, n_valid, True)).float()
    # the decomposition itself is the twin: with the twin's two-pass softmax it is bit-equal
    def two_pass(q, k, v):
        s = torch.from_numpy(q) @ torch.from_numpy(k[:n_valid]).T
        p = torch.exp2(s - s.amax(-1, keepdim=True)).bfloat16().float()
        o = (p @ torch.from_numpy(v[:n_valid])) * p.sum(-1, keepdim=True).clamp_min(1e-38).reciprocal()
        return o.bfloat16().float().numpy()
    assert torch.equal(_block_with_attention(x, blk, 2, two_pass).float(), want)
    share = ((got - want).abs().max() / (0.02 * (want - x.float()).abs().max())).item()
    assert 0 < share < 1, share


@pytest.mark.parametrize("softmax_max", [False, True])
def test_underflowed_row_sum_gives_zero_not_nan(softmax_max):
    """q = −8, k = 8 for every token: each score is −739 in the exp2 domain,
    every p is 0 without the row max, and the row sum's floor of 1e-38 makes
    the attention output 0 (not 0 · inf), in the twin and in the model of the
    kernel's body alike; with the row max the same block is a plain mean."""
    rng = np.random.default_rng(11)
    blk = _loud_block(rng, 128, 512)
    blk["attn.qkv.weight"][:256] = 0
    blk["attn.qkv.bias"][:128], blk["attn.qkv.bias"][128:256] = -8.0, 8.0
    x = torch.from_numpy(0.1 * rng.standard_normal((1, 70, 128)).astype(np.float32)).bfloat16()
    want = tfb.fused_block_plain(x, blk, 2, softmax_max=softmax_max)
    assert torch.isfinite(want).all()
    got = _block_with_attention(
        x, blk, 2, lambda q, k, v: _online_attention_model(q, k, v, 70, softmax_max))
    assert torch.isfinite(got).all()
    ref = (want.float() - x.float()).abs().max()
    assert (got.float() - want.float()).abs().max() <= 0.02 * ref
    if not softmax_max:  # the attention output is exactly 0: the branch is proj's bias alone
        assert torch.equal(got, want)


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


@pytest.mark.parametrize("block_impl", ["fused_nomax", "fused_rows_nomax"])
def test_forward_raw_refuses_the_jax_model_grammar(mini, block_impl):
    """The JAX model's '_nomax' names are not the port's: one table, one
    meaning of 'fused' in every layer."""
    params, _ = mini
    model = port_model(params, MINI, torch.bfloat16)
    with pytest.raises(ValueError, match="unknown block_impl"):
        model.forward_raw(torch.from_numpy(_x((1, 3, 32, 32), seed=7)), block_impl=block_impl)


@pytest.mark.parametrize("jax_name,port_name", [("fused", "fused_max"),
                                                ("fused_rows_nomax", "fused")])
def test_forward_raw_bf16_matches_jax(mini, monkeypatch, jax_name, port_name):
    params, _ = mini
    monkeypatch.setattr(jfb, "fused_block", functools.partial(jfb.fused_block, interpret=True))
    imgs = _x((2, 3, 32, 40), seed=8)
    want_tok, want_qkv = vit_forward_raw(params, jnp.asarray(imgs), MINI,
                                         compute_dtype=jnp.bfloat16, block_impl=jax_name)
    model = port_model(params, MINI, torch.bfloat16)
    got_tok, got_qkv = model.forward_raw(torch.from_numpy(imgs), block_impl=port_name)
    for got, want in ((got_tok, want_tok), (got_qkv, want_qkv)):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 0.02 * np.abs(want).max()
    assert port_cfg(MINI).head_dim == 64
