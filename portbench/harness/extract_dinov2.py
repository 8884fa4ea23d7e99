"""Extraction traffic on a DINOv2 configuration: ``extract_features`` called
back to back on one volume, as ``extract.py`` runs it, with a DINOv2 ViT
(SwiGLU FFN, LayerScale, register tokens, DINOv2's position resize).

The window, the set-up and the comparison are ``extract.py``'s; what
differs is what a DINOv2 model needs:

- the program's ``ViTConfig`` is built from the configuration before any
  weight is made, so a program that lacks the DINOv2 fields fails at once;
- the weights (``weights``): one normal draw on the card in the hub layout,
  scaled per kind, with LayerScale gammas spread per channel over
  [0.25, 1.25], the register tokens at the scale of the embedded patch
  tokens and the q and k rows of each qkv projection at twice the other
  weights' scale, so that attention is peaked enough for the registers to
  take a large share of it in some heads: leaving out the registers, a
  block's LayerScale or swapping the SwiGLU halves each moves the features
  far past the limits (at the other weights' scale the registers barely
  reach the features; at three times it the bf16 error itself grows to the
  size of a fault);
- the reference is ``reference/dinov2.py``;
- the FLOP and byte plan counts the SwiGLU FFN (6·N·D·H a block) and every
  token, CLS and the registers too (``plan``); it fills
  ``work['vit_flops']`` and ``work['attention']`` for the existing readers
  and ``work['swiglu']`` (the gate's launches and bytes) for
  ``swiglu_roofline``;
- the gate kernel's launch counter (``ops.swiglu.swiglu.launches``) over
  the window is ``counters['swiglu_launches']``; on the card it must equal
  one launch per whole block per slice batch, or the run raises.

Traffic keys: ``volume`` (side of the cubic phantom), ``check_slots``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import flops, inputs, spec
from portbench.harness.device import log, memory_peak, reset_peak, synchronize
from portbench.harness.extract import check_slots, feature_errors, lattice
from portbench.harness.outcome import Outcome, limit_checks
from portbench.harness.trace import Window, span

MODEL_KEYS = ("patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio", "hidden_dim",
              "img_size", "num_register_tokens", "interpolate_antialias", "interpolate_offset")
MODEL_FIXED = {"ffn": "swiglu", "layerscale": True, "qkv_bias": True, "ffn_bias": True}
EXTRACT_KEYS = ("compute_dtype", "block_impl", "batch_size", "feature_output_size")
EXTRACT_FIXED = {"slice_along": "all", "return_keys": ["k"]}

# kind → (scale, shift) of a standard normal draw; 'l' (LayerScale) is drawn
# uniform in [shift, shift + scale]
KINDS = {"w": (0.02, 0.0), "b": (0.02, 0.0), "g": (0.1, 1.0), "n": (0.05, 0.0),
         "r": (0.5, 0.0), "l": (1.0, 0.25)}
QK_SCALE = 2.0  # the q and k rows of each qkv projection, over the other weights'


def settings(cell) -> tuple[dict, dict]:
    """(model, extraction settings) of a cell; any key or value the weights,
    the reference or the program here do not run raises ValueError."""
    model = dict(spec.require(cell.config, "model", MODEL_KEYS, MODEL_FIXED))
    missing = sorted(set(MODEL_KEYS) - set(model))
    if missing:
        raise ValueError(f"model: the harness needs {missing}")
    ex = spec.require(cell.config, "extract", EXTRACT_KEYS, EXTRACT_FIXED)
    return model, ex


def program_config(model: dict, ex: dict):
    """The program's ``ViTConfig`` and ``ExtractConfig``; raises where the
    program's SwiGLU width differs from the configuration's."""
    from vittf_tpu_torch.models.vit import ViTConfig
    from vittf_tpu_torch.pipeline.features import ExtractConfig

    vit = ViTConfig(patch_size=model["patch_size"], embed_dim=model["embed_dim"],
                    depth=model["depth"], num_heads=model["num_heads"],
                    mlp_ratio=model["mlp_ratio"], img_size=model["img_size"], layerscale=True,
                    ffn="swiglu", num_register_tokens=model["num_register_tokens"],
                    interpolate_antialias=model["interpolate_antialias"],
                    interpolate_offset=model["interpolate_offset"])
    if vit.hidden_dim != model["hidden_dim"]:
        raise ValueError(f"the program's SwiGLU width is {vit.hidden_dim}, "
                         f"the configuration's {model['hidden_dim']}")
    ecfg = ExtractConfig(feature_output_size=ex["feature_output_size"],
                         slice_along=ex["slice_along"], batch_size=ex["batch_size"],
                         return_keys=tuple(ex["return_keys"]),
                         compute_dtype=ex["compute_dtype"], block_impl=ex["block_impl"])
    return vit, ecfg


def param_shapes(model: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of a DINOv2 ViT's hub ``state_dict`` backbone
    (``dinov2_vitg14_reg``'s layout without ``mask_token``); kinds as
    ``KINDS``: 'r' the register tokens, 'l' the LayerScale gammas."""
    D, P, H = model["embed_dim"], model["patch_size"], model["hidden_dim"]
    grid = model["img_size"] // P
    out = [("cls_token", (1, 1, D), "w"), ("pos_embed", (1, 1 + grid * grid, D), "w")]
    if model["num_register_tokens"]:
        out.append(("register_tokens", (1, model["num_register_tokens"], D), "r"))
    out += [("patch_embed.proj.weight", (D, 3, P, P), "w"), ("patch_embed.proj.bias", (D,), "b")]
    for i in range(model["depth"]):
        b = f"blocks.{i}"
        out += [(f"{b}.norm1.weight", (D,), "g"), (f"{b}.norm1.bias", (D,), "n"),
                (f"{b}.attn.qkv.weight", (3 * D, D), "w"), (f"{b}.attn.qkv.bias", (3 * D,), "b"),
                (f"{b}.attn.proj.weight", (D, D), "w"), (f"{b}.attn.proj.bias", (D,), "b"),
                (f"{b}.ls1.gamma", (D,), "l"),
                (f"{b}.norm2.weight", (D,), "g"), (f"{b}.norm2.bias", (D,), "n"),
                (f"{b}.mlp.w12.weight", (2 * H, D), "w"), (f"{b}.mlp.w12.bias", (2 * H,), "b"),
                (f"{b}.mlp.w3.weight", (D, H), "w"), (f"{b}.mlp.w3.bias", (D,), "b"),
                (f"{b}.ls2.gamma", (D,), "l")]
    out += [("norm.weight", (D,), "g"), ("norm.bias", (D,), "n")]
    return out


def weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """A hub-layout fp32 ``state_dict`` drawn on ``device`` from ``seed``:
    one normal draw for everything but the gammas, one uniform draw for
    them, scaled per kind (``KINDS``), the q and k rows of every qkv
    projection scaled by ``QK_SCALE``."""
    shapes = param_shapes(model)
    order = sorted(range(len(shapes)), key=lambda i: "wbgnrl".index(shapes[i][2]))
    sizes = [int(np.prod(shapes[i][1])) for i in order]
    n_normal = sum(s for i, s in zip(order, sizes) if shapes[i][2] != "l")
    gen = inputs.device_generator(seed, "weights", device)
    flat = torch.empty(sum(sizes), device=device)
    flat[:n_normal].normal_(generator=gen)
    flat[n_normal:].uniform_(generator=gen)
    start = 0
    for kind in "wbgnrl":
        n = sum(s for i, s in zip(order, sizes) if shapes[i][2] == kind)
        scale, shift = KINDS[kind]
        flat[start:start + n].mul_(scale).add_(shift)
        start += n
    out, start = {}, 0
    for i, n in zip(order, sizes):
        name, shape, _ = shapes[i]
        out[name] = flat[start:start + n].view(shape)
        start += n
    D = model["embed_dim"]
    for i in range(model["depth"]):
        out[f"blocks.{i}.attn.qkv.weight"][:2 * D].mul_(QK_SCALE)
    return {name: out[name] for name, _, _ in shapes}


# ---- the yardstick's arithmetic for a DINOv2 block


def block_flops(n_tokens: int, D: int, H: int) -> float:
    """One image through one pre-LN DINOv2 block: qkv 6ND², proj 2ND², the
    SwiGLU FFN (w12, 2H wide, and w3) 6·N·D·H, QKᵀ and PV 4N²D."""
    N = n_tokens
    return 8 * N * D * D + 6 * N * D * H + 4 * N * N * D


def slice_flops(n_tokens: int, model: dict, capture_thirds: int = 1) -> float:
    """One image through the extraction ViT: every block but the last whole,
    the last one's qkv projection for the captured thirds, and the patch
    embed of the patches alone on one channel (the grayscale fold)."""
    D, P, H = model["embed_dim"], model["patch_size"], model["hidden_dim"]
    patches = n_tokens - 1 - model["num_register_tokens"]
    full = (model["depth"] - 1) * block_flops(n_tokens, D, H)
    return 2 * patches * D * P * P + full + 2 * capture_thirds * n_tokens * D * D


def plan(vol_shape, model: dict, ex: dict) -> list[dict]:
    """``flops.extraction_plan`` with every token counted: CLS, the
    registers and the patches."""
    out = flops.extraction_plan(vol_shape, model, ex)
    for a in out:
        a["tokens"] += model["num_register_tokens"]
    return out


def extraction_flops(vol_shape, model: dict, ex: dict) -> float:
    thirds = len(ex["return_keys"])
    return sum(a["slices"] * slice_flops(a["tokens"], model, thirds)
               for a in plan(vol_shape, model, ex))


def swiglu_bytes(rows: int, H: int, elt: int = 2) -> float:
    """One gate launch over ``rows`` tokens: the (rows, 2H) projection read
    once and the (rows, H) activation written once."""
    return elt * 3.0 * rows * H


def window_work(vol_shape, model: dict, ex: dict, calls: int) -> dict:
    """The ViT work of ``calls`` whole calls, for the per-layer readers:
    total FLOPs and, per kernel, launches with each one's FLOPs and bytes."""
    D, heads, H = model["embed_dim"], model["num_heads"], model["hidden_dim"]
    work = {"vit_flops": calls * extraction_flops(vol_shape, model, ex),
            "attention": [], "swiglu": []}
    for a in plan(vol_shape, model, ex):  # every block but the captured last one, per batch
        n = calls * a["batches"] * (model["depth"] - 1)
        B, N = a["batch"], a["tokens"]
        work["attention"].append((n, flops.attention_flops(B, heads, N, D // heads),
                                  flops.attention_bytes(B, heads, N, D // heads)))
        work["swiglu"].append((n, 0.0, swiglu_bytes(B * N, H)))
    return work


def expected_launches(vol_shape, model: dict, ex: dict, calls: int, dev) -> int:
    """Gate launches of ``calls`` calls: one per whole block per slice batch
    on the card; none on the CPU, where the plain twin runs."""
    if dev.type != "cuda":
        return 0
    return calls * (model["depth"] - 1) * sum(a["batches"] for a in plan(vol_shape, model, ex))


def check_launches(delta: int, expected: int) -> None:
    """Raise unless the window's gate launches are the ones its calls make:
    the per-layer metric divides exactly that work."""
    if delta != expected:
        raise RuntimeError(f"the window launched the SwiGLU gate {delta} times, its calls "
                           f"make {expected}")


def make_inputs(cell, seed: int, dev):
    """(model, ex, program ViTConfig, ExtractConfig, weights, volume); the
    program's configs first, so a program without them fails at once."""
    model, ex = settings(cell)
    vit, ecfg = program_config(model, ex)
    params = weights(model, seed, dev)
    vol, _ = inputs.phantom(int(cell.traffic["volume"]), seed, dev)
    return model, ex, vit, ecfg, params, vol


def reference_lattice(cell, model, ex, params, vol, seed: int, precision: str = "fp32"):
    """(slots, the reference's features on the seed's lattice)."""
    from portbench.reference import dinov2 as reference

    _, grid = flops.compute_im_sizes(tuple(vol.shape), ex["feature_output_size"],
                                     model["patch_size"])
    slots = check_slots(grid, int(cell.traffic["check_slots"]), seed)
    return slots, reference.extract(vol, params, model, ex, precision, slots)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> Outcome:
    """One run of a DINOv2 extraction cell; ``device='cpu'`` runs the
    program's plain twins, for the tests."""
    from vittf_tpu_torch import kernels
    from vittf_tpu_torch.ops.swiglu import swiglu
    from vittf_tpu_torch.pipeline.features import extract_features

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    model, ex, vit, ecfg, params, vol = make_inputs(cell, seed, dev)
    synchronize(dev)
    log(f"inputs made {time.perf_counter() - t_start:.2f} s in")
    if dev.type == "cuda":
        kernels.load_library()
    log(f"library loaded {time.perf_counter() - t_start:.2f} s in")

    def call():
        return extract_features(vol, params, vit, ecfg, device=dev)["k"]

    call()
    synchronize(dev)
    setup_s = time.perf_counter() - t_start
    reset_peak(dev)
    calls, launches0 = 0, swiglu.launches
    with Window(trace) as w:
        deadline = w.t0 + seconds
        while True:
            with span("extract_features"):
                feats = call()
            synchronize(dev)
            calls += 1
            if time.perf_counter() >= deadline:
                break
        w.close()
    peak = memory_peak(dev)
    launches = swiglu.launches - launches0
    check_launches(launches, expected_launches(tuple(vol.shape), model, ex, calls, dev))
    t_ref = time.perf_counter()
    slots, ref = reference_lattice(cell, model, ex, params, vol, seed)
    values = feature_errors(lattice(feats, slots), ref)
    log(f"{calls} calls in {w.seconds:.3f} s; {launches} gate launches; reference "
        f"{time.perf_counter() - t_ref:.1f} s; {values}")
    return Outcome(
        end_to_end={"setup_s": setup_s, "extract_mvox_s": calls * vol.numel() / w.seconds / 1e6},
        attempted=calls, failed=0, checks=limit_checks(values, cell.limits),
        memory_peak_bytes=peak, window_s=w.seconds, trace=w.trace,
        work=window_work(tuple(vol.shape), model, ex, calls),
        counters={"swiglu_launches": launches})
