"""DINOv3 in the port: axial RoPE on q and k in every block and no position
table, head dim 128, storage tokens, SwiGLU aligned to 64, no qkv bias,
LayerNorm eps 1e-5, against the plain reference ``portbench/reference/
dinov3.py``, which reads the published ``state_dict`` names.

A tiny DINOv3 (D 256, 2 heads of 128, 2 blocks, 4 storage tokens, 64²
images at patch 16, LayerScale gammas away from 1, every weight at
1/√fan-in so each branch reaches the output) on seeded random weights.
Parity mode (fp32) is held to the reference at 1e-4 of the features' norm:
both compute in IEEE fp32 and differ only in the order of their sums (about
1e-6 here), so the tolerance leaves two decades to that, and each planted
fault (RoPE dropped, RoPE on the prefix rows too, neighbouring pairs for
halves, sin negated, the storage tokens left out) moves the features by
1e-2 or more. The JAX package holds no such model, so nothing here is
compared with it. The ``card`` tests run K1's RoPE mode and K11 at D 4096
at the ViT-7B/16 cell's shapes, and one call of the cell, on a CUDA card
(``python -m pytest --noconftest -m card tests/test_torch_dinov3.py``).
"""
import dataclasses
import hashlib
import math

import numpy as np
import pytest
import torch

from portbench.harness.extract_dinov3 import published as published_names
from portbench.reference import dinov3 as reference
from vittf_tpu_torch.models import dino
from vittf_tpu_torch.models import vit as vit_module
from vittf_tpu_torch.models.vit import (
    ViTConfig,
    VisionTransformer,
    check_block_impl,
    init_vit_params,
    rope_table,
)
from vittf_tpu_torch.ops import attention as attention_module
from vittf_tpu_torch.ops.attention import Rope, rope_attention_plain, rope_plain
from vittf_tpu_torch.pipeline import features
from vittf_tpu_torch.pipeline.streamed import extract_features_streamed
from vittf_tpu_torch.utils.tensor import imagenet_normalize

TINY = ViTConfig(16, 256, 2, 2, mlp_ratio=3.0, img_size=64, layerscale=True, name="tiny_v3",
                 ffn="swiglu", num_register_tokens=4, position="rope",
                 qkv_bias=False, norm_eps=1e-5)
D, H = TINY.embed_dim, TINY.hidden_dim
TOL = 1e-4  # fp32 against fp32: sums in another order (see the module)
PARITY = features.ExtractConfig(feature_output_size=4, batch_size=8, precision="highest")
EX = {"feature_output_size": 4, "batch_size": 8}


def reference_model(cfg: ViTConfig = TINY) -> dict:
    return {"patch_size": cfg.patch_size, "embed_dim": cfg.embed_dim, "depth": cfg.depth,
            "num_heads": cfg.num_heads, "n_storage_tokens": cfg.num_register_tokens,
            "norm_eps": cfg.norm_eps, "rope_base": vit_module.ROPE_BASE}


def tiny_params(cfg: ViTConfig = TINY, seed: int = 0) -> dict:
    """The port's layout: weights N(0, 1/fan-in), biases and shifts
    N(0, 0.05), LayerNorm gains 1 + N(0, 0.1), gammas U[0.25, 1.25], CLS
    and the storage tokens N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in init_vit_params(cfg).items():
        shape = tuple(t.shape)
        if name.endswith(".gamma"):
            v = rng.uniform(0.25, 1.25, shape)
        elif name.endswith(("norm1.weight", "norm2.weight")) or name == "norm.weight":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name in ("register_tokens", "cls_token"):
            v = 0.5 * rng.standard_normal(shape)
        elif name.endswith(".weight"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            v = 0.05 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


def published(p: dict) -> dict:
    """The port's layout under the published names the reference reads."""
    return published_names(p, {"hidden_dim": TINY.hidden_dim})


@pytest.fixture(scope="module")
def params():
    return tiny_params()


def rel_err(got, want):
    return float((got.float() - want).norm() / want.norm())


def gray_images(hw=(64, 64), seed=1):
    return torch.from_numpy(np.random.default_rng(seed).random((2, 1, *hw), np.float32))


def port_keys(cfg, p, gray):
    """The port's parity-mode k capture of grayscale images, prefix dropped."""
    model = VisionTransformer.from_state_dict(cfg, p)
    rgb = imagenet_normalize(gray.expand(-1, 3, -1, -1))
    _, k = model.forward_raw(rgb, precision="highest", stop_after_capture=True,
                             capture_thirds=(1,))
    return k[:, cfg.prefix_tokens:]


def volume(n=16, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).random((n, n, n), np.float32))


# ---- planted faults: each patches one name of the port for one call


def _table_with(fn):
    """``rope_table`` with ``fn`` applied to the (cos, sin) table it returns."""
    def table(grid_hw, head_dim, device=None):
        return fn(rope_table(grid_hw, head_dim, device))
    return table


def _prefix_rotated(x, rope):
    """The prefix rows rotated at patch 0's angles, the patches as they are."""
    patch0 = Rope(rope.table, rope.grid, 0)
    prefix = [rope_plain(x[..., i:i + 1, :], patch0) for i in range(rope.prefix)]
    return torch.cat([*prefix, rope_plain(x, rope)[..., rope.prefix:, :]], dim=-2)


def _interleaved(x, rope):
    """RoPE on neighbouring pairs (2i, 2i + 1) at angle i, not on halves."""
    hd = x.shape[-1]
    order = torch.cat([torch.arange(0, hd, 2), torch.arange(1, hd, 2)])
    return rope_plain(x[..., order], rope)[..., torch.argsort(order)]


# fault → (module, name, replacement) patched in the port; None: the
# storage tokens left out of the config and the weights
FAULTS = {
    "RoPE dropped": (vit_module, "rope_table", _table_with(
        lambda t: torch.stack([torch.ones_like(t[0]), torch.zeros_like(t[1])]))),
    "sin negated": (vit_module, "rope_table", _table_with(lambda t: torch.stack([t[0], -t[1]]))),
    "RoPE on the prefix rows": (attention_module, "rope_plain", _prefix_rotated),
    "interleaved pairs for halves": (attention_module, "rope_plain", _interleaved),
    "storage tokens omitted": None,
}


@pytest.fixture
def planted(monkeypatch, params):
    """``planted(kind)`` → (config, weights) for the port, with the fault's
    patch applied; the reference keeps TINY and the sound weights."""
    def plant(kind):
        if FAULTS[kind] is None:
            return (dataclasses.replace(TINY, num_register_tokens=0),
                    {k: v for k, v in params.items() if k != "register_tokens"})
        monkeypatch.setattr(*FAULTS[kind])
        return TINY, params
    return plant


# ---- the port against the reference


@pytest.mark.parametrize("hw", [(64, 64), (64, 48), (32, 80)])
def test_forward_raw_k_matches_the_reference(params, hw):
    gray = gray_images(hw)
    want = reference.keys(gray, published(params), reference_model(), "fp32")
    got = port_keys(TINY, params, gray)
    assert got.shape == want.shape == (2, hw[0] * hw[1] // 256, D)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("kind", list(FAULTS))
def test_forward_raw_fault_fails_the_tolerance(params, planted, kind):
    gray = gray_images((64, 48))
    want = reference.keys(gray, published(params), reference_model(), "fp32")
    cfg, p = planted(kind)
    assert rel_err(port_keys(cfg, p, gray), want) > 100 * TOL


def test_extract_features_matches_the_reference(params):
    vol = volume()
    want = reference.extract(vol, published(params), reference_model(), EX, "fp32")
    got = features.extract_features(vol, params, TINY, PARITY, device="cpu")["k"]
    assert got.shape == want.shape == (D, 4, 4, 4)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("kind", list(FAULTS))
def test_extract_features_fault_fails_the_tolerance(params, planted, kind):
    vol = volume()
    want = reference.extract(vol, published(params), reference_model(), EX, "fp32")
    cfg, p = planted(kind)
    got = features.extract_features(vol, p, cfg, PARITY, device="cpu")["k"]
    assert rel_err(got, want) > 100 * TOL


def test_speed_mode_is_near_the_reference(params):
    """bf16 activations and products, the plain twins: the bf16 rounding of
    two blocks, about 1e-2 here, held at 0.03."""
    vol = volume()
    want = reference.extract(vol, published(params), reference_model(), EX, "fp32")
    ex = features.ExtractConfig(feature_output_size=4, batch_size=8, compute_dtype="bfloat16")
    got = features.extract_features(vol, params, TINY, ex, device="cpu")["k"]
    assert rel_err(got, want) <= 0.03


def test_every_extraction_path_drops_cls_and_the_storage_tokens(params):
    vol = volume()
    resident = features.extract_features(vol, params, TINY, PARITY, device="cpu")["k"]
    streamed = extract_features_streamed(vol.numpy(), params, TINY, PARITY, chunk_batches=1,
                                         device="cpu")["k"]
    torch.testing.assert_close(streamed, resident, rtol=1e-5, atol=1e-6)
    model = VisionTransformer.from_state_dict(TINY, features.fold_grayscale_patch_embed(params))
    batch, mima = vol[:3, None], (vol.min(), vol.max())
    got = features._slice_batch_features(model, batch, (64, 64), (4, 4), (1,), "highest",
                                         "auto", "xla", mima)
    imgs = (features.resize_nearest(batch, (64, 64)) - mima[0]) / (mima[1] - mima[0])
    _, cap = model.forward_raw(imgs, precision="highest", stop_after_capture=True,
                               capture_thirds=(1,))
    assert cap.shape == (3, 5 + 16, D)
    torch.testing.assert_close(got[0], cap[:, 5:], rtol=0, atol=0)


def test_the_capture_is_k_before_rope(params):
    """The stop-after-capture k (a qkv without bias) is the last block's
    LN1 times the k rows, before any rotation: the qkv a forward hook sees."""
    model = VisionTransformer.from_state_dict(TINY, params)
    x = imagenet_normalize(gray_images().expand(-1, 3, -1, -1))
    _, qkv = model.forward_raw(x, precision="highest", capture="qkv")
    _, k = model.forward_raw(x, precision="highest", stop_after_capture=True,
                             capture_thirds=(1,))
    assert model.blocks[-1].attn.qkv.bias is None
    torch.testing.assert_close(k, qkv[..., D:2 * D], rtol=1e-6, atol=1e-6)


# ---- the RoPE table and rotation


@pytest.mark.parametrize("grid", [(4, 4), (3, 5), (32, 32)])
def test_rope_table_follows_the_equations(grid):
    """periods_j = 100^(2j/(hd/2)), c = 2(i + 0.5)/n − 1, angle = 2π·c/period,
    written out by hand in float64; the fp32 table within 4 ulps of 2π."""
    hd, h, w = 128, *grid
    got = rope_table(grid, hd)
    assert got.shape == (2, h + w, hd // 4) and got.dtype == torch.float32
    want = np.empty((2, h + w, hd // 4))
    for row, (i, n) in enumerate([(i, h) for i in range(h)] + [(j, w) for j in range(w)]):
        c = 2.0 * (i + 0.5) / n - 1.0
        for j in range(hd // 4):
            angle = 2.0 * math.pi * c / 100.0 ** (2.0 * j / (hd // 2))
            want[:, row, j] = math.cos(angle), math.sin(angle)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0, atol=4e-6)


@pytest.mark.parametrize("grid,prefix", [((4, 4), 5), ((3, 5), 0), ((32, 32), 5)])
def test_the_table_expands_to_the_published_one(grid, prefix):
    """Each patch's [row angles | column angles] tiled twice is the
    published (h·w, hd) table, bit for bit; the rotation is the published
    ``apply_rope`` bit for bit in fp32 and in bf16."""
    table = rope_table(grid, 128)
    sin, cos = reference.rope_sin_cos(*grid, 128, 100.0, "cpu")
    p = torch.arange(grid[0] * grid[1])
    for i, want in ((0, cos), (1, sin)):
        got = torch.cat([table[i, p // grid[1]], table[i, grid[0] + p % grid[1]]], -1)
        assert torch.equal(got.repeat(1, 2), want)
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 3, prefix + grid[0] * grid[1], 128, generator=gen).to(dtype)
        q, _ = reference.apply_rope(x, x, (sin, cos))
        assert torch.equal(rope_plain(x, Rope(table, grid, prefix)), q.to(dtype))


def test_plain_attention_with_rope_is_attention_of_the_rotated():
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 21, 128, generator=gen) for _ in range(3))
    rope = Rope(rope_table((4, 4), 128), (4, 4), 5)
    got = rope_attention_plain(q, k, v, rope)
    want = attention_module.attention_plain(rope_plain(q, rope), rope_plain(k, rope), v)
    assert torch.equal(got, want)
    assert torch.equal(attention_module.attention(q, k, v, rope), got)  # CPU: the twins


@pytest.mark.parametrize("case", ["head dim 64", "grid short of the tokens", "table of another "
                                  "shape", "fp16 inputs", "fp32 inputs"])
def test_the_rope_kernel_wrapper_refuses_before_a_launch(case):
    """Refused, not handed to the plain twins: the kernel takes bf16 alone."""
    hd = 64 if case == "head dim 64" else 128
    dtype = {"fp16 inputs": torch.float16, "fp32 inputs": torch.float32}.get(case, torch.bfloat16)
    q = torch.zeros(1, 2, 21, hd, dtype=dtype)
    grid = (4, 3) if case == "grid short of the tokens" else (4, 4)
    table = rope_table(grid, hd)
    if case == "table of another shape":
        table = table[:, :-1].contiguous()
    before = attention_module.attention.rope_launches
    with pytest.raises(ValueError):
        attention_module._rope_attention(q, q, q, Rope(table, grid, 5))
    assert attention_module.attention.rope_launches == before


# ---- the configuration, the registry, the refusals


def test_registry_and_cli_hold_vit7b16():
    cfg = dino.resolve_model(dino3_model="vit7b16")
    assert (cfg.patch_size, cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.head_dim) == \
        (16, 4096, 40, 32, 128)
    assert (cfg.ffn, cfg.hidden_dim, cfg.num_register_tokens, cfg.prefix_tokens,
            cfg.layerscale) == ("swiglu", 8192, 4, 5, True)
    assert cfg.hidden_dim % 64 == 0  # the published swiglu64
    assert (cfg.position, cfg.qkv_bias, cfg.norm_eps) == ("rope", False, 1e-5)
    assert vit_module.ROPE_BASE == 100.0
    with pytest.raises(ValueError, match="only one"):
        dino.resolve_model(dino2_model="vitg14_reg", dino3_model="vit7b16")
    with pytest.raises(ValueError, match="DINOv3"):
        dino.resolve_model(dino3_model="vitl16")
    from vittf_tpu_torch.cli.infer import build_parser

    args = build_parser().parse_args(["--data-path", "v.npy", "--dino3-model", "vit7b16"])
    assert (args.dino3_model, args.dino2_model, args.dino_model) == ("vit7b16", None, None)


def test_vit7b16_parameter_count():
    """6,716,030,976 parameters in the RGB layout the port holds: 40 blocks
    of qkv 3D² (no bias), proj D² + D, w12 2HD + 2H, w3 HD + D, two
    LayerNorms and two LayerScales; the patch embed, CLS, 4 storage tokens
    and the final LayerNorm; no position table."""
    cfg = dino.resolve_model(dino3_model="vit7b16")
    with torch.device("meta"):
        model = VisionTransformer(cfg)
    Dm, Hm = 4096, 8192
    block = 3 * Dm * Dm + Dm * Dm + Dm + 2 * Hm * Dm + 2 * Hm + Hm * Dm + Dm + 4 * Dm + 2 * Dm
    by_hand = 40 * block + 3 * 16 * 16 * Dm + Dm + Dm + 4 * Dm + 2 * Dm
    assert sum(p.numel() for p in model.parameters()) == by_hand == 6_716_030_976
    assert set(model.state_dict()) == set(dino._backbone_keys(cfg))
    assert "pos_embed" not in model.state_dict()
    assert "blocks.0.attn.qkv.bias" not in model.state_dict()


def test_a_rope_model_is_refused_where_no_rope_runs(params):
    from vittf_tpu_torch.parallel.mesh import tp_vit_forward
    from vittf_tpu_torch.parallel.pipeline_parallel import pp_vit_forward

    for impl in ("fused", "fused_max", "fused_rows"):
        with pytest.raises(ValueError, match="RoPE"):
            check_block_impl(dataclasses.replace(TINY, ffn="mlp"), impl)
        with pytest.raises(ValueError):
            features.extract_features(volume(8), params, TINY,
                                      features.ExtractConfig(compute_dtype="bfloat16",
                                                             block_impl=impl), device="cpu")
    with pytest.raises(ValueError, match="rope positions"):
        tp_vit_forward({}, torch.zeros(1, 3, 16, 16), dataclasses.replace(TINY, ffn="mlp"), None)
    with pytest.raises(ValueError, match="rope positions"):
        pp_vit_forward({}, torch.zeros(1, 3, 16, 16), TINY, None)
    with pytest.raises(ValueError, match="position"):
        ViTConfig(position="sinusoidal")


def test_a_rope_model_draws_no_table_and_no_qkv_bias():
    sd = init_vit_params(TINY)
    assert "pos_embed" not in sd and "blocks.0.attn.qkv.bias" not in sd
    assert TINY.hidden_dim == 512  # int(768 · 2/3) = 512, a multiple of 64
    VisionTransformer(TINY).load_state_dict(sd)


def _digest(cfg, key=(0, 0)) -> str:
    sd = init_vit_params(cfg, key)
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].numpy().tobytes())
    return h.hexdigest()[:16]


V1 = ViTConfig(patch_size=4, embed_dim=32, depth=2, num_heads=2, img_size=16, name="v1")
V2 = ViTConfig(patch_size=2, embed_dim=48, depth=2, num_heads=2, img_size=74, layerscale=True,
               ffn="swiglu", num_register_tokens=4, interpolate_antialias=True,
               interpolate_offset=0.0, name="v2")


@pytest.mark.parametrize("cfg,key,digest", [
    (V1, (0, 0), "f2a745a7ab30068e"), (V2, (0, 0), "11d8b1d10b287046"),
    (V2, (3, 1), "20b4e53defbb8a4f"),
    (dataclasses.replace(dino.ALL_ARCHS["vits8"], depth=1), (0, 0), "413dae31eb736ce8"),
    (dataclasses.replace(dino.ALL_ARCHS["vitb8"], depth=1), (0, 0), "df453ee116923020"),
    (dataclasses.replace(dino.ALL_ARCHS["vitg14_reg"], depth=1), (0, 0), "cbd2e3c6ea3ecde3"),
], ids=["v1", "v2", "v2-key31", "vits8", "vitb8", "vitg14_reg"])
def test_no_existing_config_draws_differently(cfg, key, digest):
    """Every tensor of these draws, and their names, as they were before
    the DINOv3 fields (the digests of the draws then)."""
    assert _digest(cfg, key) == digest


def test_the_new_fields_default_to_the_existing_models():
    for cfg in [*dino.DINO_ARCHS.values(), *dino.DINOV2_ARCHS.values()]:
        assert (cfg.position, cfg.qkv_bias, cfg.norm_eps) == ("learned", True, 1e-6)
    blk = vit_module.Block(dataclasses.replace(V2, norm_eps=1e-5))
    assert blk.norm1.eps == blk.norm2.eps == 1e-5 and blk.attn.qkv.bias is not None


def test_flops_count_the_prefix_tokens_at_d4096():
    from vittf_tpu_torch.utils.flops import extraction_flops, vit_slice_flops

    N, Dm, Hm = 1029, 4096, 8192
    cfg = dino.resolve_model(dino3_model="vit7b16")
    block = 8 * N * Dm * Dm + 6 * N * Dm * Hm + 4 * N * N * Dm
    assert block == pytest.approx(362.6e9, rel=1e-3)
    assert vit_slice_flops(N, cfg) == 2 * (N - 5) * Dm * 16 * 16 + 39 * block + 2 * N * Dm * Dm
    ex = features.ExtractConfig(feature_output_size=32, batch_size=32)
    assert extraction_flops((256,) * 3, cfg, ex) == pytest.approx(10.89e15, rel=1e-3)


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_the_rope_kernel_against_the_twin_at_the_cells_shape(card, q_scale):
    from chip_smoke import ROPE_GRID, ROPE_SHAPE, check_rel, rope_case

    q, k, v, rope = rope_case(ROPE_SHAPE, ROPE_GRID,
                              torch.Generator().manual_seed(int(q_scale)), q_scale)
    before = attention_module.attention.rope_launches
    got = attention_module.attention(q, k, v, rope)
    torch.cuda.synchronize()
    assert attention_module.attention.rope_launches == before + 1
    exact = attention_module.attention_plain(rope_plain(q, rope).float(),
                                             rope_plain(k, rope).float(), v.float())
    check_rel("rope attention vs the fp32 twin", got, exact, 0.02)
    assert torch.equal(attention_module.attention(q, k, v, rope), got)


@pytest.mark.card
def test_fp32_cuda_tensors_with_rope_are_refused(card):
    """The fp32 parity mode has no RoPE kernel: refused, not run plain."""
    q = torch.zeros(1, 2, 21, 128, device=card)
    rope = Rope(rope_table((4, 4), 128, card), (4, 4), 5)
    before = attention_module.attention.rope_launches
    with pytest.raises(ValueError, match="bf16"):
        attention_module.attention(q, q, q, rope)
    assert attention_module.attention.rope_launches == before


@pytest.mark.card
@pytest.mark.parametrize("mode", ["ln", "residual_ln", "residual", "residual_ln_no_gamma"])
def test_the_layer_norm_kernel_at_d4096(card, mode):
    from chip_smoke import LN_WIDE_SHAPE, hold_ln, ln_inputs
    from vittf_tpu_torch.ops.layer_norm import layer_norm, residual, residual_layer_norm

    x, a, gamma, ln = ln_inputs(LN_WIDE_SHAPE, torch.Generator().manual_seed(4096))
    gamma = None if mode.endswith("no_gamma") else gamma
    if mode == "ln":
        hold_ln(mode, layer_norm(x, ln), x, ln)
    elif mode == "residual":
        assert torch.equal(residual(x, a, gamma), residual(x, a, gamma, impl="plain"))
    else:
        got_x, got_y = residual_layer_norm(x, a, gamma, ln)
        want_x = residual(x, a, gamma, impl="plain")
        assert torch.equal(got_x, want_x)
        hold_ln(mode, got_y, want_x, ln)


@pytest.mark.card
def test_the_launches_of_one_cell_call(card):
    """One call of ``vit7b16-extract-256``: K1's RoPE mode and K10 once per
    whole block per batch (39 × 24), K11 (39 × 3 + 1) × 24, and finite
    features of (4096, 32, 32, 32)."""
    from portbench.harness import extract_dinov3, spec
    from vittf_tpu_torch.ops.layer_norm import layer_norm
    from vittf_tpu_torch.ops.swiglu import swiglu

    cell = spec.load_cell("vit7b16-extract-256")
    *_, vit_cfg, ecfg, p, vol = extract_dinov3.make_inputs(cell, 2**31 + 24, card)
    before = (attention_module.attention.rope_launches, swiglu.launches, layer_norm.launches)
    feats = features.extract_features(vol, p, vit_cfg, ecfg, device=card)["k"]
    torch.cuda.synchronize()
    after = (attention_module.attention.rope_launches, swiglu.launches, layer_norm.launches)
    assert tuple(n - b for n, b in zip(after, before)) == (936, 936, 2832)
    assert feats.shape == (4096, 32, 32, 32) and bool(torch.isfinite(feats).all())
