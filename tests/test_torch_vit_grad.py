"""Port parity: the port's trainable ViT forward (``VisionTransformer.forward``
through ``torch.func.functional_call``) and ``split_qkv`` against
``vittf_tpu.models.vit``.

The training forward runs the inference forward's embed, blocks and capture
with an autograd graph and the plain attention: its output equals
``forward_raw``'s bit for bit on the CPU. Its gradients are held against
``jax.grad`` of ``vit_forward_raw`` (XLA attention, the path
``train/vit_ssl.py`` trains through) at the TINY configuration, within 1e-5
of each leaf's largest gradient; a leaf the loss does not reach gets zeros
in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vit import as_numpy_tree, port_cfg
from tests.test_vit import TINY, _make_pair
from vittf_tpu.models.vit import split_qkv as jax_split_qkv
from vittf_tpu.models.vit import vit_forward_raw
from vittf_tpu_torch.models.dino import params_from_jax
from vittf_tpu_torch.models.vit import VisionTransformer, split_qkv


@pytest.fixture(scope="module")
def params():
    return _make_pair(TINY, seed=9)[1]


def _trainable(params):
    return VisionTransformer.from_state_dict(
        port_cfg(TINY), params_from_jax(as_numpy_tree(params))).requires_grad_(True)


@pytest.mark.parametrize("stop", [False, True], ids=["whole", "stop_after_capture"])
def test_training_forward_equals_forward_raw(params, stop):
    model = _trainable(params)
    assert all(p.requires_grad for p in model.parameters())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 16, 24)).astype(np.float32))
    tok, qkv = model(x, stop_after_capture=stop)
    assert qkv.requires_grad
    want_tok, want_qkv = model.forward_raw(x, attn_impl="plain", stop_after_capture=stop)
    assert torch.equal(qkv, want_qkv)
    assert (tok is None) == stop and (stop or torch.equal(tok, want_tok))


def test_trained_state_dict_feeds_extraction(params):
    """A trainable module's state dict, after a step, is again a state dict
    that ``extract_features`` takes, and its features move with it."""
    from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features

    model = _trainable(params)
    x = torch.from_numpy(np.random.default_rng(2).random((2, 3, 16, 16)).astype(np.float32))
    _, qkv = model(x, stop_after_capture=True)
    qkv.square().mean().backward()
    sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:  # the capture's dead leaves have none
                p -= 0.1 * p.grad
    sd1 = {k: v.detach() for k, v in model.state_dict().items()}
    vol = np.random.default_rng(3).random((16, 16, 16)).astype(np.float32)
    cfg = ExtractConfig(feature_output_size=4, precision="highest")
    f0, f1 = (extract_features(vol, sd, port_cfg(TINY), cfg, device="cpu")["k"] for sd in (sd0, sd1))
    assert f1.shape == (TINY.embed_dim, 4, 4, 4) and torch.isfinite(f1).all()
    assert not torch.equal(f0, f1)


@pytest.mark.parametrize("stop", [False, True], ids=["whole", "stop_after_capture"])
def test_gradients_match_jax_grad(params, stop):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    w_qkv = rng.standard_normal((2, 17, 3 * TINY.embed_dim)).astype(np.float32)
    w_tok = rng.standard_normal((2, 17, TINY.embed_dim)).astype(np.float32)

    def jax_loss(p):
        tok, qkv = vit_forward_raw(p, jnp.asarray(x), TINY, attn_impl="xla",
                                   stop_after_capture=stop)
        loss = jnp.sum(jnp.tanh(qkv) * w_qkv)
        return loss if stop else loss + jnp.sum(tok * w_tok)

    want = params_from_jax(as_numpy_tree(jax.grad(jax_loss)(params)))
    sd = {k: v.requires_grad_(True) for k, v in params_from_jax(as_numpy_tree(params)).items()}
    model = VisionTransformer.from_state_dict(port_cfg(TINY), sd)
    tok, qkv = torch.func.functional_call(model, sd, (torch.from_numpy(x),),
                                          {"stop_after_capture": stop})
    loss = (torch.tanh(qkv) * torch.from_numpy(w_qkv)).sum()
    if not stop:
        loss = loss + (tok * torch.from_numpy(w_tok)).sum()
    grads = torch.autograd.grad(loss, list(sd.values()), allow_unused=True,
                                materialize_grads=True)
    for (name, w), g in zip(want.items(), (dict(zip(sd, grads))[k] for k in want)):
        scale = max(float(w.abs().max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)
    last = f"blocks.{TINY.depth - 1}"
    if stop:  # the capture's dead leaves get zeros, as jax.grad gives
        for name in (f"{last}.attn.proj.weight", f"{last}.mlp.fc2.bias", "norm.weight"):
            assert not want[name].any() and not dict(zip(sd, grads))[name].any()


def test_split_qkv_matches_jax():
    qkv = np.random.default_rng(5).standard_normal((2, 7, 3 * 12)).astype(np.float32)
    want = jax_split_qkv(jnp.asarray(qkv), 3)
    got = split_qkv(torch.from_numpy(qkv), 3)
    for g, w in zip(got, want):
        assert g.shape == (2, 7, 12)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
