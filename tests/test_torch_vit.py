"""Port parity: vittf_tpu_torch.models (ViT + DINO registry) vs vittf_tpu.

The same weights (a torch DINO-semantics model converted by the JAX
package, then mapped back with ``params_from_jax``) and the same numpy
images go through ``vit_forward_raw`` and the port's ``forward_raw``.
Parity mode ('highest', fp32) agrees to 1e-5; bf16 speed mode to 0.05 of
the output scale (the two frameworks round bf16 matmuls and their bias adds
at different places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_vit import TINY, _make_pair
from vittf_tpu.models import dino as jdino
from vittf_tpu.models.vit import init_vit_params as jax_init
from vittf_tpu.models.vit import vit_forward_raw
from vittf_tpu_torch.models import dino as tdino
from vittf_tpu_torch.models.vit import ViTConfig, VisionTransformer, init_vit_params


def port_cfg(cfg) -> ViTConfig:
    """The port's config for a JAX ``ViTConfig``."""
    return ViTConfig(**dataclasses.asdict(cfg))


def as_numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def port_model(jax_params, cfg, dtype=torch.float32) -> VisionTransformer:
    sd = tdino.params_from_jax(as_numpy_tree(jax_params))
    return VisionTransformer.from_state_dict(port_cfg(cfg), sd).to(dtype)


@pytest.fixture(scope="module")
def tiny_pair():
    return _make_pair(TINY, seed=5)


def test_params_from_jax_round_trip(tiny_pair):
    """params_from_jax inverts convert_torch_state_dict, and the hub
    state_dict it reproduces loads into the port's module unchanged."""
    tmodel, params = tiny_pair
    sd = tdino.params_from_jax(as_numpy_tree(params))
    hub = tmodel.state_dict()
    assert set(sd) == set(hub)
    for key, val in hub.items():
        torch.testing.assert_close(sd[key], val, rtol=0, atol=0)
    back = jdino.convert_torch_state_dict(sd, TINY)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    VisionTransformer(port_cfg(TINY)).load_state_dict(hub)


@pytest.mark.parametrize(
    "cfg,key",
    [
        (TINY, (0, 0)),
        (dataclasses.replace(TINY, layerscale=True, depth=1), (0, 3)),
    ],
)
def test_init_vit_params_bit_exact(cfg, key):
    want = tdino.params_from_jax(as_numpy_tree(jax_init(cfg, jnp.asarray(key, jnp.uint32))))
    got = init_vit_params(port_cfg(cfg), key)
    assert set(got) == set(want)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


@pytest.mark.parametrize("img_hw", [(16, 16), (24, 16), (32, 40)])
def test_forward_parity_highest(tiny_pair, img_hw):
    _, params = tiny_pair
    x = np.random.default_rng(0).standard_normal((2, 3, *img_hw)).astype(np.float32)
    want_tok, want_qkv = vit_forward_raw(
        params, jnp.asarray(x), TINY, precision="highest", attn_impl="xla"
    )
    got_tok, got_qkv = port_model(params, TINY).forward_raw(
        torch.from_numpy(x), precision="highest"
    )
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(want_tok), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_qkv.numpy(), np.asarray(want_qkv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("thirds", [None, (1,), (0, 2)])
def test_capture_thirds_parity(tiny_pair, thirds):
    _, params = tiny_pair
    x = np.random.default_rng(1).standard_normal((3, 3, 16, 24)).astype(np.float32)
    _, want = vit_forward_raw(
        params, jnp.asarray(x), TINY, precision="highest", attn_impl="xla",
        stop_after_capture=True, capture_thirds=thirds,
    )
    tok, got = port_model(params, TINY).forward_raw(
        torch.from_numpy(x), precision="highest", stop_after_capture=True,
        capture_thirds=thirds,
    )
    assert tok is None and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mlp_capture_and_layerscale_parity():
    cfg = dataclasses.replace(TINY, layerscale=True)
    _, params = _make_pair(cfg, seed=6)
    x = np.random.default_rng(2).standard_normal((2, 3, 16, 16)).astype(np.float32)
    want_tok, want_mlp = vit_forward_raw(
        params, jnp.asarray(x), cfg, precision="highest", attn_impl="xla", capture="mlp"
    )
    got_tok, got_mlp = port_model(params, cfg).forward_raw(
        torch.from_numpy(x), precision="highest", capture="mlp"
    )
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(want_tok), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_mlp.numpy(), np.asarray(want_mlp), rtol=1e-5, atol=1e-5)


def test_forward_bf16_speed_mode(tiny_pair):
    _, params = tiny_pair
    x = np.random.default_rng(3).standard_normal((2, 3, 16, 16)).astype(np.float32)
    want_tok, want_qkv = vit_forward_raw(
        params, jnp.asarray(x), TINY, precision="default", attn_impl="xla",
        compute_dtype=jnp.bfloat16,
    )
    got_tok, got_qkv = port_model(params, TINY, torch.bfloat16).forward_raw(
        torch.from_numpy(x), precision="default"
    )
    assert got_qkv.dtype == torch.bfloat16
    for got, want in ((got_tok, want_tok), (got_qkv, want_qkv)):
        want = np.asarray(want).astype(np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 0.05 * np.abs(want).max(), (err, np.abs(want).max())


# The port's fields the JAX package's ViTConfig lacks, at their defaults
# (DINO v1 and DINOv2 without registers: a GELU MLP, DINO's position rule).
PORT_ONLY_DEFAULTS = {"ffn": "mlp", "num_register_tokens": 0, "interpolate_antialias": False,
                      "interpolate_offset": 0.1}
# ViT-g/14's FFN as published (facebookresearch/dinov2 vit_giant2,
# ffn_layer='swiglufused': w12 1536 -> 8192, w3 4096 -> 1536), which the port
# takes from the published model and the JAX package does not hold.
PUBLISHED_FFN = {"vitg14": {"ffn": "swiglu", "hidden_dim": 4096}}


def test_registry_matches_jax():
    for name, cfg in jdino.ALL_ARCHS.items():
        port = tdino.ALL_ARCHS[name]
        jax_fields = dataclasses.asdict(cfg)
        port_fields = dataclasses.asdict(port)
        assert {k: port_fields[k] for k in jax_fields} == jax_fields, name
        published = PUBLISHED_FFN.get(name, {})
        extra = {k: v for k, v in port_fields.items() if k not in jax_fields}
        assert extra == {**PORT_ONLY_DEFAULTS, **{k: v for k, v in published.items()
                                                  if k in PORT_ONLY_DEFAULTS}}, name
        assert port.hidden_dim == published.get("hidden_dim", cfg.hidden_dim), name
        assert port.head_dim == 64
    assert tdino.resolve_model().name == "vits8"
    assert tdino.resolve_model(dino2_model="vitl14").patch_size == 14
    with pytest.raises(ValueError):
        tdino.resolve_model("vits8", "vits14")


def test_load_dino_checkpoint_and_npz(tmp_path, tiny_pair):
    from vittf_tpu.models.serialization import save_params_npz
    from vittf_tpu_torch.models.serialization import load_params_npz

    tmodel, params = tiny_pair
    pth = tmp_path / "ckpt.pth"
    torch.save({"teacher": {f"backbone.{k}": v for k, v in tmodel.state_dict().items()}}, pth)
    sd = tdino.load_dino_checkpoint(pth, port_cfg(TINY))
    npz = save_params_npz(tmp_path / "params.npz", params)
    sd2 = tdino.params_from_jax(load_params_npz(npz))
    for key, val in tmodel.state_dict().items():
        torch.testing.assert_close(sd[key], val, rtol=0, atol=0)
        torch.testing.assert_close(sd2[key], val, rtol=0, atol=0)
