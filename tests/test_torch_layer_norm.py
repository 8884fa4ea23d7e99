"""The residual + LayerNorm passes of the per-op ViT block (``ops/layer_norm.py``,
K11 on the card).

On the CPU the plain twins run: they must be the composition the block
computed before the kernel existed, bit for bit (``parent_layer_norm``,
``parent_block_forward``: that code, kept here as it was), through
``forward_raw`` and the trainable ``forward`` alike, and no launch may be
counted. The wrapper's refusals are held where they raise before a launch.

The ``card`` tests need a CUDA card (they skip without one; run them with
``python -m pytest --noconftest -m card tests/test_torch_layer_norm.py``, the
package's conftest imports JAX): the kernel against the twin run on the card
in its three modes at the two per-op extraction cells' launch shapes, and the
launches of one ``extract_features`` call at each extraction cell's settings.
The kernel's statistics sum in another order than PyTorch's reductions, so
y may differ from the twin's: at most one value in a thousand, each within
what that rounding can move the normalised value ŷ (``chip_smoke.hold_ln``).
x' has no sum and is held bit-equal.
"""
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from vittf_tpu_torch.models import vit
from vittf_tpu_torch.models.vit import ViTConfig, VisionTransformer
from vittf_tpu_torch.ops.attention import multi_head_attention
from vittf_tpu_torch.ops.layer_norm import (
    MAX_DIM,
    _launch,
    layer_norm,
    layer_norm_plain,
    residual,
    residual_layer_norm,
)
from vittf_tpu_torch.ops.swiglu import swiglu

DIMS = [384, 768, 1536]
DTYPES = [torch.bfloat16, torch.float32]
SEED = 2_654_435_761


def parent_layer_norm(x, ln):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + ln.eps)).to(x.dtype)
    return y * ln.weight + ln.bias


def parent_block_forward(self, x, precision="default", attn_impl="auto", capture=None,
                         rope=None):
    assert rope is None  # the parent's blocks had no RoPE
    qkv = self.attn.qkv(parent_layer_norm(x, self.norm1))
    a = multi_head_attention(qkv, self.num_heads, attn_impl)
    a = self.attn.proj(a)
    if hasattr(self, "ls1"):
        a = a * self.ls1.gamma
    x = x + a
    y = parent_layer_norm(x, self.norm2)
    if self.ffn == "swiglu":
        y = self.mlp.w3(swiglu(self.mlp.w12(y), attn_impl))
    else:
        y = F.gelu(self.mlp.fc1(y), approximate="none" if precision == "highest" else "tanh")
        y = self.mlp.fc2(y)
    if hasattr(self, "ls2"):
        y = y * self.ls2.gamma
    x = x + y
    captured = {"qkv": qkv, "mlp": y}.get(capture) if capture else None
    return x, captured


def rows(shape, gen, device="cpu", dtype=torch.bfloat16):
    """Rows whose means and scales vary (offsets up to 50, scales 1 to 20),
    as a residual stream's do, and one row in eight quiet (mean 0, scale
    5e-5 to 1e-3, its variance about eps), so the statistics' every term
    counts, eps too (as ``chip_smoke.ln_inputs``)."""
    lead = (*shape[:-1], 1)
    z = torch.randn(shape, generator=gen)
    scale = torch.exp(3 * torch.rand(lead, generator=gen) - 3) * 20
    offset = 50 * (2 * torch.rand(lead, generator=gen) - 1)
    quiet = torch.rand(lead, generator=gen) < 0.125
    x = z * torch.where(quiet, 5e-5 * scale, scale) + torch.where(quiet, 0.0, offset)
    return x.to(device, dtype)


def norm_params(D, gen, device="cpu", dtype=torch.bfloat16):
    """(gamma, ln): gamma U[0.25, 1.25], weight 1 + N(0, 0.1), bias N(0, 0.05)."""
    gamma = (0.25 + torch.rand(D, generator=gen)).to(device, dtype)
    ln = SimpleNamespace(weight=(1 + 0.1 * torch.randn(D, generator=gen)).to(device, dtype),
                         bias=(0.05 * torch.randn(D, generator=gen)).to(device, dtype), eps=1e-6)
    return gamma, ln


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("with_gamma", [True, False], ids=["gamma", "no_gamma"])
@pytest.mark.parametrize("D", DIMS)
def test_the_twins_are_the_parents_composition(D, with_gamma, dtype):
    gen = torch.Generator().manual_seed(SEED + D)
    x = rows((3, 5, D), gen, dtype=dtype)
    a = torch.randn((3, 5, D), generator=gen).to(dtype)
    gamma, ln = norm_params(D, gen, dtype=dtype)
    gamma = gamma if with_gamma else None
    before = layer_norm.launches
    want_x = x + (a * gamma if with_gamma else a)
    assert torch.equal(layer_norm(x, ln), parent_layer_norm(x, ln))
    assert torch.equal(layer_norm_plain(x, ln.weight, ln.bias, ln.eps), parent_layer_norm(x, ln))
    got_x, got_y = residual_layer_norm(x, a, gamma, ln)
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_y, parent_layer_norm(want_x, ln))
    assert torch.equal(residual(x, a, gamma), want_x)
    assert torch.equal(residual(x, a, gamma, impl="plain"), want_x)
    assert layer_norm.launches == before


def loud_vit(D, with_gamma, dtype, gen) -> VisionTransformer:
    """Two blocks at width D (DINOv2's SwiGLU, registers and LayerScale with
    gamma, DINO v1's GELU MLP without), every weight away from its identity
    (LayerNorm gains and shifts, gammas U[0.25, 1.25]) so each pass counts."""
    cfg = ViTConfig(patch_size=8, embed_dim=D, depth=2, num_heads=D // 64, mlp_ratio=1.0,
                    img_size=16, layerscale=with_gamma, name=f"loud{D}",
                    ffn="swiglu" if with_gamma else "mlp",
                    num_register_tokens=4 if with_gamma else 0)
    model = VisionTransformer(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(0.25 + torch.rand(p.shape, generator=gen))
            elif "norm" in name and name.endswith("weight"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen))
            elif name.endswith("bias") or name in ("cls_token", "pos_embed", "register_tokens"):
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    return model.to(dtype)


def parent_way(monkeypatch):
    """The model as the parent computed it: the block and the LayerNorms of
    ``_forward`` without ``ops.layer_norm``."""
    monkeypatch.setattr(vit.Block, "forward", parent_block_forward)
    monkeypatch.setattr(vit, "layer_norm", lambda x, ln, impl="auto": parent_layer_norm(x, ln))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("with_gamma", [True, False], ids=["gamma", "no_gamma"])
@pytest.mark.parametrize("D", DIMS)
def test_the_vit_on_the_cpu_is_the_parents(D, with_gamma, dtype, monkeypatch):
    gen = torch.Generator().manual_seed(SEED + 7 * D + with_gamma)
    model = loud_vit(D, with_gamma, dtype, gen)
    images = torch.randn((2, 3, 16, 16), generator=gen).to(dtype)
    precision = "highest" if dtype == torch.float32 else "default"
    calls = {
        "whole": dict(),
        "stop after the capture": dict(stop_after_capture=True, capture_thirds=(1,)),
        "mlp capture": dict(capture="mlp"),
        "plain": dict(attn_impl="plain"),
    }

    def run():
        out = {name: model.forward_raw(images, precision, **kw) for name, kw in calls.items()}
        model.requires_grad_(True)
        model.zero_grad()
        tokens, qkv = model.forward(images, precision)
        (tokens.float().square().sum() + qkv.float().sum()).backward()
        out["forward"] = (tokens.detach(), qkv.detach())
        out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
        model.requires_grad_(False)
        return out

    before = layer_norm.launches
    got = run()
    assert layer_norm.launches == before
    with monkeypatch.context() as m:
        parent_way(m)
        want = run()
    for name in (*calls, "forward"):
        for g, w in zip(got[name], want[name]):
            assert (g is None) == (w is None), name
            assert g is None or torch.equal(g, w), name
    for n, g in got["grads"].items():
        assert torch.equal(g, want["grads"][n]), n


def _misaligned(x):
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


REFUSALS = {  # case: what the error says
    "width not a multiple of 8": "multiples of 8",
    "width above the register budget": "multiples of 8 up to",
    "mixed dtypes": "one dtype",
    "a float32 LayerNorm weight": "one dtype",
    "misaligned rows": "16-byte aligned",
    "rows not contiguous": "contiguous",
    "a branch of another shape": "shapes",
}


def refused_inputs(case):
    """(x, a, gamma, ln) on the CPU, right but for ``case``."""
    D = {"width not a multiple of 8": 60, "width above the register budget": MAX_DIM + 8}
    gen = torch.Generator().manual_seed(SEED)
    x = rows((4, D.get(case, 64)), gen)
    a = x.clone()
    gamma, ln = norm_params(x.shape[-1], gen)
    if case == "mixed dtypes":
        a = a.float()
    elif case == "a float32 LayerNorm weight":
        ln.weight = ln.weight.float()
    elif case == "misaligned rows":
        x = _misaligned(x)
    elif case == "rows not contiguous":
        x = x.t().contiguous().t()
    elif case == "a branch of another shape":
        a = a[:2]
    return x, a, gamma, ln


@pytest.mark.parametrize("case", list(REFUSALS))
def test_the_wrapper_refuses_before_a_launch(case):
    x, a, gamma, ln = refused_inputs(case)
    before = layer_norm.launches
    with pytest.raises(ValueError, match=REFUSALS[case]):
        _launch(x, a, gamma, ln)
    assert layer_norm.launches == before


def test_an_unknown_impl_raises():
    x, a, gamma, ln = refused_inputs("none")
    for call in (lambda: layer_norm(x, ln, "fused"), lambda: residual(x, a, gamma, "cuda"),
                 lambda: residual_layer_norm(x, a, gamma, ln, "kernel")):
        with pytest.raises(ValueError, match="unknown layer_norm impl"):
            call()


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("mode", ["ln", "residual_ln", "residual", "residual_ln_no_gamma"])
@pytest.mark.parametrize("shape", [(32776, 768), (32928, 1536)], ids=["vitb8", "vitg14reg"])
def test_the_kernel_against_the_twin_at_the_cells_shapes(card, shape, mode):
    from chip_smoke import hold_ln, ln_inputs

    x, a, gamma, ln = ln_inputs(shape, torch.Generator().manual_seed(SEED + shape[1]))
    gamma = None if mode.endswith("no_gamma") else gamma
    before = layer_norm.launches
    if mode == "ln":
        hold_ln(mode, layer_norm(x, ln), x, ln)
    elif mode == "residual":
        assert torch.equal(residual(x, a, gamma), residual(x, a, gamma, impl="plain"))
    else:
        got_x, got_y = residual_layer_norm(x, a, gamma, ln)
        want_x = residual(x, a, gamma, impl="plain")
        assert torch.equal(got_x, want_x)
        hold_ln(mode, got_y, want_x, ln)
    torch.cuda.synchronize()
    assert layer_norm.launches == before + 1


@pytest.mark.card
@pytest.mark.parametrize("cell,per_call", [("vitb8-extract-256", 3264),
                                           ("vitg14reg-extract-256", 2832),
                                           ("vits8-extract-256", 96)])
def test_the_launches_of_one_extraction_call(card, cell, per_call):
    """(blocks run whole × 3 + the last block's LN1) × batches: 11 × 3 + 1
    over 96 batches at ViT-B/8, 39 × 3 + 1 over 24 at ViT-g/14; ViT-S/8's
    fused blocks (K3) leave only the last block's LN1, once a batch."""
    from portbench.harness import extract, extract_dinov2, inputs, spec
    from vittf_tpu_torch.pipeline.features import extract_features

    c = spec.load_cell(cell)
    if c.traffic["loop"] == "extract_dinov2":
        *_, vit_cfg, ecfg, params, vol = extract_dinov2.make_inputs(c, SEED, card)
    else:
        model, ex = extract.settings(c)
        vit_cfg, ecfg = extract.program_config(model, ex)
        params = inputs.vit_weights(model, SEED, card)
        vol, _ = inputs.phantom(int(c.traffic["volume"]), SEED, card)
    before = layer_norm.launches
    feats = extract_features(vol, params, vit_cfg, ecfg, device=card)["k"]
    torch.cuda.synchronize()
    assert layer_norm.launches - before == per_call
    assert bool(torch.isfinite(feats).all())
