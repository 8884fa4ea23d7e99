"""DINOv2 with registers in the port: SwiGLU FFN, register tokens, DINOv2's
position resize, against the plain reference ``portbench/reference/dinov2.py``.

A tiny DINOv2-style model (SwiGLU, 4 registers, LayerScale gammas away from
1, a 37² position grid resized down by the antialiased size rule, every
weight drawn at 1/√fan-in so each branch reaches the output) on seeded
random weights. Parity mode (fp32) is held to the reference at 1e-4 of the
features' norm: both compute in IEEE fp32 and differ only in the order of
their sums (below 1e-6 here), so the tolerance leaves two decades to that
and each planted fault (the SwiGLU halves swapped, the registers left out,
DINO v1's position rule, one block's LayerScale dropped) moves the features
by 1e-2 or more. The JAX package holds no such model, so nothing here is
compared with it.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.reference import dinov2 as reference
from vittf_tpu_torch.models import dino
from vittf_tpu_torch.models.vit import (
    ViTConfig,
    VisionTransformer,
    init_vit_params,
    interpolate_pos_embed,
)
from vittf_tpu_torch.ops.fused_block import fused_block
from vittf_tpu_torch.ops.swiglu import swiglu, swiglu_plain
from vittf_tpu_torch.pipeline import features
from vittf_tpu_torch.pipeline.streamed import extract_features_streamed
from vittf_tpu_torch.utils.tensor import imagenet_normalize

TINY = ViTConfig(patch_size=2, embed_dim=48, depth=3, num_heads=2, img_size=74, layerscale=True,
                 name="tiny_reg", ffn="swiglu", num_register_tokens=4,
                 interpolate_antialias=True, interpolate_offset=0.0)
D = TINY.embed_dim
TOL = 1e-4  # fp32 against fp32: sums in another order (see the module)
PARITY = features.ExtractConfig(feature_output_size=6, batch_size=8, precision="highest")


def reference_model(cfg: ViTConfig) -> dict:
    return {"patch_size": cfg.patch_size, "embed_dim": cfg.embed_dim, "depth": cfg.depth,
            "num_heads": cfg.num_heads, "hidden_dim": cfg.hidden_dim,
            "num_register_tokens": cfg.num_register_tokens,
            "interpolate_antialias": cfg.interpolate_antialias,
            "interpolate_offset": cfg.interpolate_offset}


def tiny_params(cfg: ViTConfig = TINY, seed: int = 0) -> dict:
    """A hub-layout state_dict: weights N(0, 1/fan-in), biases and shifts
    N(0, 0.05), LayerNorm gains 1 + N(0, 0.1), gammas U[0.25, 1.25], the
    position grid and the registers N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in init_vit_params(cfg).items():
        shape = tuple(t.shape)
        if name.endswith(".gamma"):
            v = rng.uniform(0.25, 1.25, shape)
        elif name.endswith("norm1.weight") or name.endswith("norm2.weight") or name == "norm.weight":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name in ("pos_embed", "register_tokens", "cls_token"):
            v = 0.5 * rng.standard_normal(shape)
        elif name.endswith(".weight"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            v = 0.05 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def params():
    return tiny_params()


def rel_err(got, want):
    return float((got.float() - want).norm() / want.norm())


def port_keys(cfg, p, gray):
    """The port's parity-mode k capture of grayscale images, prefix dropped."""
    model = VisionTransformer.from_state_dict(cfg, p)
    rgb = imagenet_normalize(gray.expand(-1, 3, -1, -1))
    _, k = model.forward_raw(rgb, precision="highest", stop_after_capture=True,
                             capture_thirds=(1,))
    return k[:, cfg.prefix_tokens:]


def volume(n=24, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).random((n, n, n), np.float32))


def swap_halves(p, cfg):
    out = dict(p)
    H = cfg.hidden_dim
    for i in range(cfg.depth):
        for part in ("weight", "bias"):
            w = p[f"blocks.{i}.mlp.w12.{part}"]
            out[f"blocks.{i}.mlp.w12.{part}"] = torch.cat([w[H:], w[:H]])
    return out


def fault(kind, p):
    """(config, weights) given to the port; the reference keeps TINY and p."""
    if kind == "swiglu halves swapped":
        return TINY, swap_halves(p, TINY)
    if kind == "registers omitted":
        return (dataclasses.replace(TINY, num_register_tokens=0),
                {k: v for k, v in p.items() if k != "register_tokens"})
    if kind == "DINO v1 position rule":
        return dataclasses.replace(TINY, interpolate_antialias=False, interpolate_offset=0.1), p
    return TINY, {**p, "blocks.1.ls1.gamma": torch.ones(D), "blocks.1.ls2.gamma": torch.ones(D)}


FAULTS = ["swiglu halves swapped", "registers omitted", "DINO v1 position rule",
          "LayerScale dropped"]


def test_forward_raw_k_matches_the_reference(params):
    gray = torch.from_numpy(np.random.default_rng(1).random((2, 1, 24, 20), np.float32))
    want = reference.keys(gray, params, reference_model(TINY), "fp32")
    got = port_keys(TINY, params, gray)
    assert got.shape == want.shape == (2, 12 * 10, D)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("kind", FAULTS)
def test_forward_raw_fault_fails_the_tolerance(params, kind):
    gray = torch.from_numpy(np.random.default_rng(1).random((2, 1, 24, 20), np.float32))
    want = reference.keys(gray, params, reference_model(TINY), "fp32")
    cfg, p = fault(kind, params)
    assert rel_err(port_keys(cfg, p, gray), want) > 100 * TOL


def test_extract_features_matches_the_reference(params):
    vol = volume()
    ex = {"feature_output_size": 6, "batch_size": 8}
    want = reference.extract(vol, params, reference_model(TINY), ex, "fp32")
    got = features.extract_features(vol, params, TINY, PARITY, device="cpu")["k"]
    assert got.shape == want.shape == (D, 6, 6, 6)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("kind", FAULTS)
def test_extract_features_fault_fails_the_tolerance(params, kind):
    vol = volume()
    want = reference.extract(vol, params, reference_model(TINY),
                             {"feature_output_size": 6, "batch_size": 8}, "fp32")
    cfg, p = fault(kind, params)
    got = features.extract_features(vol, p, cfg, PARITY, device="cpu")["k"]
    assert rel_err(got, want) > 100 * TOL


def test_speed_mode_is_near_the_reference(params):
    """bf16 activations and products, the gate's plain twin: the bf16
    rounding of three blocks, about 1e-2 here, held at 0.03."""
    vol = volume()
    want = reference.extract(vol, params, reference_model(TINY),
                             {"feature_output_size": 6, "batch_size": 8}, "fp32")
    ex = features.ExtractConfig(feature_output_size=6, batch_size=8, compute_dtype="bfloat16")
    got = features.extract_features(vol, params, TINY, ex, device="cpu")["k"]
    assert rel_err(got, want) <= 0.03


@pytest.mark.parametrize("hw", [(12, 10), (6, 6), (37, 37), (40, 44)])
def test_position_resize_is_torch_antialiased_bicubic_to_a_size(hw):
    pos = torch.randn(1, 1 + 37 * 37, 16, generator=torch.Generator().manual_seed(0))
    got = interpolate_pos_embed(pos, hw, offset=0.0, antialias=True)
    grid = pos[:, 1:].reshape(1, 37, 37, 16).permute(0, 3, 1, 2)
    want = F.interpolate(grid, size=hw, mode="bicubic", antialias=True)
    want = torch.cat([pos[:, :1], want.permute(0, 2, 3, 1).reshape(1, hw[0] * hw[1], 16)], 1)
    assert torch.equal(got, want if hw != (37, 37) else pos)


def test_registers_follow_cls_without_a_position_embedding(params):
    model = VisionTransformer.from_state_dict(TINY, params)
    x = model._embed(torch.randn(1, 3, 8, 8))
    assert x.shape == (1, 1 + 4 + 16, D)
    torch.testing.assert_close(x[0, 1:5], params["register_tokens"][0], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_twin_is_silu_of_the_first_half_times_the_second(dtype):
    x = (3 * torch.randn(5, 7, 48, generator=torch.Generator().manual_seed(1))).to(dtype)
    x1, x2 = x.float()[..., :24], x.float()[..., 24:]
    want = (F.silu(x1) * x2).to(dtype)
    assert torch.equal(swiglu_plain(x), want)
    assert torch.equal(swiglu(x), want)  # CPU tensors take the twin
    assert torch.equal(swiglu(x, "plain"), want)
    with pytest.raises(ValueError):
        swiglu(x, "fast")


def test_fused_blocks_are_refused_for_swiglu(params):
    model = VisionTransformer.from_state_dict(TINY, params).to(torch.bfloat16)
    with pytest.raises(ValueError, match="GELU"):
        model.forward_raw(torch.randn(1, 3, 8, 8).bfloat16(), block_impl="fused")
    for impl in ("fused", "fused_max", "fused_rows"):
        with pytest.raises(ValueError, match="GELU"):
            features.extract_features(volume(8), params, TINY,
                                      features.ExtractConfig(compute_dtype="bfloat16",
                                                             block_impl=impl), device="cpu")
    with pytest.raises(ValueError, match="SwiGLU"):
        fused_block(torch.randn(1, 9, D).bfloat16(), model.blocks[0], 2)


def test_every_extraction_path_drops_cls_and_registers(params):
    vol = volume(16)
    ex = features.ExtractConfig(feature_output_size=4, batch_size=8, precision="highest")
    resident = features.extract_features(vol, params, TINY, ex, device="cpu")["k"]
    streamed = extract_features_streamed(vol.numpy(), params, TINY, ex, chunk_batches=1,
                                         device="cpu")["k"]
    torch.testing.assert_close(streamed, resident, rtol=1e-5, atol=1e-6)
    fast = features.extract_features(vol, params, TINY, dataclasses.replace(ex, slice_subsample=True),
                                     device="cpu")["k"]
    assert fast.shape == resident.shape == (D, 4, 4, 4)
    # one slice batch, the qkv and mlp sources, against the capture sliced by hand
    model = VisionTransformer.from_state_dict(TINY, features.fold_grayscale_patch_embed(params))
    batch = vol[:3, None]
    mima = (vol.min(), vol.max())
    for source, idx in (("qkv", (1,)), ("mlp", (0, 1, 2))):
        got = features._slice_batch_features(model, batch, (8, 8), (4, 4), idx, "highest",
                                             "auto", "xla", mima, source)
        imgs = (features.resize_nearest(batch, (8, 8)) - mima[0]) / (mima[1] - mima[0])
        _, cap = model.forward_raw(imgs, precision="highest", capture=source,
                                   stop_after_capture=source == "qkv",
                                   capture_thirds=idx if source == "qkv" else None)
        want = cap[:, 5:].reshape(3, 16, len(idx) if source == "qkv" else 3, -1)
        for i, g in enumerate(got):
            torch.testing.assert_close(g, want[:, :, i], rtol=0, atol=0)


def hub_state_dict(cfg=TINY, seed=0) -> dict:
    """``dinov2_vitg14_reg``'s hub layout at a tiny size: the backbone with
    its registers, plus the keys a hub checkpoint carries beside it."""
    return {**tiny_params(cfg, seed), "mask_token": torch.zeros(1, D)}


def test_loader_keeps_swiglu_registers_and_layerscale(tmp_path):
    sd = hub_state_dict()
    path = tmp_path / "dinov2_tiny_reg.pth"
    torch.save({"teacher": {f"backbone.{k}": v for k, v in sd.items()}}, path)
    got = dino.load_dino_checkpoint(path, TINY)
    want = {k: v for k, v in sd.items() if k != "mask_token"}
    assert set(got) == set(want) == set(VisionTransformer(TINY).state_dict())
    assert {"register_tokens", "blocks.0.mlp.w12.weight", "blocks.2.mlp.w3.bias",
            "blocks.1.ls2.gamma"} <= set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    ex = features.ExtractConfig(feature_output_size=4, batch_size=8, compute_dtype="bfloat16",
                                block_impl="xla")
    out = features.extract_features(volume(16), got, TINY, ex, device="cpu")["k"]
    assert out.shape == (D, 4, 4, 4) and bool(torch.isfinite(out).all())


def test_loader_refuses_registers_a_config_lacks(tmp_path):
    sd = hub_state_dict()
    no_regs = dataclasses.replace(TINY, num_register_tokens=0)
    with pytest.raises(ValueError, match="register tokens"):
        dino.backbone_state_dict(sd, no_regs)
    with pytest.raises(KeyError):
        dino.backbone_state_dict({k: v for k, v in sd.items() if k != "register_tokens"}, TINY)


def test_the_jax_layout_refuses_swiglu_and_registers():
    sd = tiny_params()
    with pytest.raises(ValueError, match="SwiGLU"):
        dino.params_to_jax(sd)
    regs_only = tiny_params(dataclasses.replace(TINY, ffn="mlp"))
    with pytest.raises(ValueError, match="register"):
        dino.params_to_jax(regs_only)
    with pytest.raises(ValueError, match="SwiGLU"):
        dino.params_from_jax({"blocks": [{"w12": {}, "w3": {}}]})


def test_registry_holds_the_published_vitg14_models():
    reg = dino.resolve_model(dino2_model="vitg14_reg")
    assert (reg.patch_size, reg.embed_dim, reg.depth, reg.num_heads, reg.img_size) == \
        (14, 1536, 40, 24, 518)
    assert (reg.ffn, reg.hidden_dim, reg.num_register_tokens, reg.layerscale) == \
        ("swiglu", 4096, 4, True)
    assert (reg.interpolate_antialias, reg.interpolate_offset, reg.prefix_tokens) == \
        (True, 0.0, 5)
    g = dino.resolve_model(dino2_model="vitg14")
    assert (g.ffn, g.hidden_dim, g.num_register_tokens, g.interpolate_antialias,
            g.interpolate_offset) == ("swiglu", 4096, 0, False, 0.1)
    from vittf_tpu_torch.cli.infer import build_parser

    assert build_parser().parse_args(["--data-path", "v.npy", "--dino2-model",
                                      "vitg14_reg"]).dino2_model == "vitg14_reg"


def test_vitg14_reg_parameter_count():
    """1,136,485,376 parameters in the RGB hub layout (the published
    ``dinov2_vitg14_reg`` backbone without its mask token)."""
    cfg = dino.resolve_model(dino2_model="vitg14_reg")
    with torch.device("meta"):
        model = VisionTransformer(cfg)
    assert sum(p.numel() for p in model.parameters()) == 1_136_485_376
    assert set(model.state_dict()) == set(dino._backbone_keys(cfg))


def test_init_keeps_the_existing_draws():
    """SwiGLU draws w12 / w3 where fc1 / fc2 were and the registers last:
    every other tensor is the draw it was."""
    base = init_vit_params(dataclasses.replace(TINY, ffn="mlp", num_register_tokens=0))
    reg = init_vit_params(dataclasses.replace(TINY, ffn="mlp"))
    assert set(reg) - set(base) == {"register_tokens"}
    assert all(torch.equal(reg[k], base[k]) for k in base)
    swi = init_vit_params(TINY)
    assert TINY.hidden_dim == 128  # (int(192 · 2/3) + 7) // 8 · 8
    assert swi["blocks.0.mlp.w12.weight"].shape == (2 * 128, D)
    assert swi["blocks.2.mlp.w3.weight"].shape == (D, 128)
    for k in ("pos_embed", "patch_embed.proj.weight", "blocks.0.attn.qkv.weight"):
        assert torch.equal(swi[k], base[k]), k
    VisionTransformer(TINY).load_state_dict(swi)


def test_tensor_parallel_forward_refuses_swiglu():
    from vittf_tpu_torch.parallel.mesh import tp_vit_forward

    with pytest.raises(ValueError, match="swiglu"):
        tp_vit_forward({}, torch.zeros(1, 3, 8, 8), TINY, None)


def test_flops_count_swiglu_and_the_prefix_tokens():
    from vittf_tpu_torch.utils.flops import extraction_flops, vit_slice_flops

    N, D, H = 1029, 1536, 4096
    cfg = dino.resolve_model(dino2_model="vitg14_reg")
    block = 8 * N * D * D + 6 * N * D * H + 4 * N * N * D
    by_hand = 2 * (N - 5) * D * 14 * 14 + 39 * block + 2 * N * D * D
    assert vit_slice_flops(N, cfg) == by_hand
    ex = features.ExtractConfig(feature_output_size=32, batch_size=32)
    assert extraction_flops((256,) * 3, cfg, ex) == pytest.approx(1.944e15, rel=1e-3)
    assert extraction_flops((256,) * 3, cfg, ex) == 768 * vit_slice_flops(N, cfg)
