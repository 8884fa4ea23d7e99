"""Extraction traffic on a DINOv3 configuration: ``extract_features`` called
back to back on one volume, as ``extract.py`` runs it, with a DINOv3 ViT
(axial RoPE on q and k in every block and no position table, head dim 128,
SwiGLU FFN aligned to 64, storage tokens, LayerScale, no qkv bias,
LayerNorm eps 1e-5).

The window, the set-up and the comparison are ``extract.py``'s; what
differs is what a DINOv3 model needs:

- the program's ``ViTConfig`` is built from the configuration before any
  weight is made, so a program that lacks the DINOv3 fields fails at once,
  not after drawing 27 GB of weights;
- the weights (``weights``): one draw on the card in the program's layout
  (``register_tokens`` for the storage tokens, ``mlp.w12`` for w1 over w2),
  scaled per kind as the DINOv2 cell's, the q and k rows of each qkv
  projection at ``QK_SCALE`` times the other weights' scale; the
  reference reads the same tensors under the published names
  (``published``: views, no copy);
- the reference is ``reference/dinov3.py``;
- the FLOP and byte plan counts the SwiGLU FFN (6·N·D·H a block) and every
  token, CLS and the storage tokens too (``plan``); it fills
  ``work['vit_flops']``, ``work['rope_attention']`` (K1's RoPE launches:
  4·B·H·N²·hd and q, k, v, o and the table's bytes), ``work['swiglu']`` and
  ``work['layer_norm']`` (K11's launches by bytes) for the readers;
- K1's RoPE launches, K10's and K11's over the window
  (``attention.rope_launches``, ``swiglu.launches``,
  ``layer_norm.launches``) are ``counters['rope_launches']``,
  ``counters['swiglu_launches']`` and ``counters['layer_norm_launches']``;
  on the card the first two must equal one launch per whole block per slice
  batch and K11's three per whole block and one per batch, or the run
  raises;
- the warm-up is one slice batch an axis (``features._extract``'s
  ``select``), not a whole call: every batch has the cell's one shape.

Traffic keys: ``volume`` (side of the cubic phantom), ``check_slots``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import flops, inputs, spec
from portbench.harness.device import log, memory_peak, reset_peak, synchronize
from portbench.harness.extract import check_slots, feature_errors, lattice
from portbench.harness.extract_dinov2 import block_flops, swiglu_bytes
from portbench.harness.outcome import Outcome, limit_checks
from portbench.harness.trace import Window, span

MODEL_KEYS = ("patch_size", "embed_dim", "depth", "num_heads", "ffn_ratio", "hidden_dim",
              "n_storage_tokens", "rope_base", "norm_eps")
# swiglu64: the program's width is checked against ``hidden_dim`` instead
MODEL_FIXED = {"ffn": "swiglu", "swiglu_align": 64, "layerscale": True, "qkv_bias": False,
               "proj_bias": True, "ffn_bias": True, "position": "rope",
               "rope_normalize_coords": "separate"}
EXTRACT_KEYS = ("compute_dtype", "block_impl", "batch_size", "feature_output_size")
EXTRACT_FIXED = {"slice_along": "all", "return_keys": ["k"]}

# kind → (scale, shift) of a standard normal draw; 'l' (LayerScale) is drawn
# uniform in [shift, shift + scale]
KINDS = {"w": (0.02, 0.0), "b": (0.02, 0.0), "g": (0.1, 1.0), "n": (0.05, 0.0),
         "r": (0.5, 0.0), "l": (1.0, 0.25)}
QK_SCALE = 1.25  # the q and k rows of each qkv projection, over the other weights'


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
    program's SwiGLU width or RoPE base differs from the configuration's."""
    from vittf_tpu_torch.models.vit import ROPE_BASE, ViTConfig
    from vittf_tpu_torch.pipeline.features import ExtractConfig

    vit = ViTConfig(patch_size=model["patch_size"], embed_dim=model["embed_dim"],
                    depth=model["depth"], num_heads=model["num_heads"],
                    mlp_ratio=float(model["ffn_ratio"]), layerscale=True, ffn="swiglu",
                    num_register_tokens=model["n_storage_tokens"], position="rope",
                    qkv_bias=False, norm_eps=model["norm_eps"], name="dinov3")
    if vit.hidden_dim != model["hidden_dim"]:
        raise ValueError(f"the program's SwiGLU width is {vit.hidden_dim}, "
                         f"the configuration's {model['hidden_dim']}")
    if model["rope_base"] != ROPE_BASE:
        raise ValueError(f"the program's RoPE base is {ROPE_BASE}, "
                         f"the configuration's {model['rope_base']}")
    ecfg = ExtractConfig(feature_output_size=ex["feature_output_size"],
                         slice_along=ex["slice_along"], batch_size=ex["batch_size"],
                         return_keys=tuple(ex["return_keys"]),
                         compute_dtype=ex["compute_dtype"], block_impl=ex["block_impl"])
    return vit, ecfg


def param_shapes(model: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of the program's layout of a DINOv3 backbone
    (``dinov3_vit7b16``'s without ``mask_token`` and ``rope_embed.periods``,
    which follow from the base); kinds as ``KINDS``: 'r' the storage tokens,
    'l' the LayerScale gammas."""
    D, P, H = model["embed_dim"], model["patch_size"], model["hidden_dim"]
    out = [("cls_token", (1, 1, D), "w"), ("register_tokens", (1, model["n_storage_tokens"], D), "r"),
           ("patch_embed.proj.weight", (D, 3, P, P), "w"), ("patch_embed.proj.bias", (D,), "b")]
    for i in range(model["depth"]):
        b = f"blocks.{i}"
        out += [(f"{b}.norm1.weight", (D,), "g"), (f"{b}.norm1.bias", (D,), "n"),
                (f"{b}.attn.qkv.weight", (3 * D, D), "w"),
                (f"{b}.attn.proj.weight", (D, D), "w"), (f"{b}.attn.proj.bias", (D,), "b"),
                (f"{b}.ls1.gamma", (D,), "l"),
                (f"{b}.norm2.weight", (D,), "g"), (f"{b}.norm2.bias", (D,), "n"),
                (f"{b}.mlp.w12.weight", (2 * H, D), "w"), (f"{b}.mlp.w12.bias", (2 * H,), "b"),
                (f"{b}.mlp.w3.weight", (D, H), "w"), (f"{b}.mlp.w3.bias", (D,), "b"),
                (f"{b}.ls2.gamma", (D,), "l")]
    out += [("norm.weight", (D,), "g"), ("norm.bias", (D,), "n")]
    return out


def weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """An fp32 ``state_dict`` in the program's layout drawn on ``device`` from
    ``seed``: one normal draw for everything but the gammas, one uniform
    draw for them, scaled per kind (``KINDS``), the q and k rows of every
    qkv projection scaled by ``QK_SCALE``."""
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


def published(params: dict, model: dict) -> dict[str, torch.Tensor]:
    """The program's layout under the published ``state_dict`` names the
    reference reads: ``storage_tokens``, and ``mlp.w1`` / ``mlp.w2`` the two
    halves of ``mlp.w12``; views of the same tensors."""
    H = model["hidden_dim"]
    out = {}
    for name, t in params.items():
        if name == "register_tokens":
            out["storage_tokens"] = t
        elif ".mlp.w12." in name:
            out[name.replace("w12", "w1")], out[name.replace("w12", "w2")] = t[:H], t[H:]
        else:
            out[name] = t
    return out


# ---- the yardstick's arithmetic for a DINOv3 block


def slice_flops(n_tokens: int, model: dict, capture_thirds: int = 1) -> float:
    """One image through the extraction ViT: every block but the last whole
    (``extract_dinov2.block_flops``: DINOv3's w1 and w2 are its w12; the
    rotation of q and k is elementwise and not counted), the last one's qkv
    projection for the captured thirds, and the patch embed of the patches
    alone on one channel (the grayscale fold)."""
    D, P, H = model["embed_dim"], model["patch_size"], model["hidden_dim"]
    patches = n_tokens - 1 - model["n_storage_tokens"]
    full = (model["depth"] - 1) * block_flops(n_tokens, D, H)
    return 2 * patches * D * P * P + full + 2 * capture_thirds * n_tokens * D * D


def plan(vol_shape, model: dict, ex: dict) -> list[dict]:
    """``flops.extraction_plan`` with every token counted (CLS, the storage
    tokens, the patches) and each axis's patch grid."""
    _, grid = flops.compute_im_sizes(tuple(vol_shape), ex["feature_output_size"],
                                     model["patch_size"])
    out = flops.extraction_plan(vol_shape, model, ex)
    for a, (_, (d0, d1)) in zip(out, flops.AXES):
        a["tokens"] += model["n_storage_tokens"]
        a["grid"] = (grid[d0], grid[d1])
    return out


def extraction_flops(vol_shape, model: dict, ex: dict) -> float:
    thirds = len(ex["return_keys"])
    return sum(a["slices"] * slice_flops(a["tokens"], model, thirds)
               for a in plan(vol_shape, model, ex))


def rope_attention_bytes(batch: int, heads: int, n_tokens: int, head_dim: int, grid) -> float:
    """One RoPE attention launch: q, k, v in and o out in bf16, and the
    (2, h + w, hd/4) fp32 table read once."""
    table = 4.0 * 2 * (grid[0] + grid[1]) * (head_dim // 4)
    return flops.attention_bytes(batch, heads, n_tokens, head_dim) + table


def layer_norm_bytes(rows: int, D: int, mode: str, elt: int = 2) -> float:
    """One K11 launch over (rows, D): 'ln' reads x and writes y; 'residual_ln'
    reads x and the branch and writes x' and y; 'residual' reads x and the
    branch and writes x'; each reads its (D,) gamma, weight and bias once."""
    rows_io = {"ln": 2, "residual_ln": 4, "residual": 3}[mode]
    params = {"ln": 2, "residual_ln": 3, "residual": 1}[mode]
    return elt * (rows_io * rows * D + params * D)


def window_work(vol_shape, model: dict, ex: dict, calls: int) -> dict:
    """The ViT work of ``calls`` whole calls, for the per-layer readers:
    total FLOPs and, per kernel, launches with each one's FLOPs and bytes."""
    D, heads, H = model["embed_dim"], model["num_heads"], model["hidden_dim"]
    hd = D // heads
    work = {"vit_flops": calls * extraction_flops(vol_shape, model, ex),
            "rope_attention": [], "swiglu": [], "layer_norm": []}
    for a in plan(vol_shape, model, ex):
        batches = calls * a["batches"]
        n = batches * (model["depth"] - 1)  # every block but the captured last one, per batch
        B, N = a["batch"], a["tokens"]
        work["rope_attention"].append((n, flops.attention_flops(B, heads, N, hd),
                                       rope_attention_bytes(B, heads, N, hd, a["grid"])))
        work["swiglu"].append((n, 0.0, swiglu_bytes(B * N, H)))
        # a whole block: LN1, the attention residual with LN2, the FFN
        # residual; the captured last block: LN1 alone
        for mode, count in (("ln", n + batches), ("residual_ln", n), ("residual", n)):
            work["layer_norm"].append((count, 0.0, layer_norm_bytes(B * N, D, mode)))
    return work


def expected_launches(vol_shape, model: dict, ex: dict, calls: int, dev) -> dict:
    """Each counter's launches over ``calls`` calls, per slice batch on the
    card: K1 RoPE and K10 one a whole block, K11 three a whole block and the
    captured last block's LN1 (``window_work``); none on the CPU, where the
    plain twins run."""
    batches = calls * sum(a["batches"] for a in plan(vol_shape, model, ex))
    whole = (model["depth"] - 1) * batches if dev.type == "cuda" else 0
    return {"rope_launches": whole, "swiglu_launches": whole,
            "layer_norm_launches": 3 * whole + batches if whole else 0}


def check_launches(counted: dict, expected: dict) -> None:
    """Raise unless each kernel's launches over the window are the ones its
    calls make: the per-layer metrics divide exactly that work."""
    for name, delta in counted.items():
        if delta != expected[name]:
            raise RuntimeError(f"the window's {name} are {delta}; "
                               f"its calls make {expected[name]}")


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
    from portbench.reference import dinov3 as reference

    _, grid = flops.compute_im_sizes(tuple(vol.shape), ex["feature_output_size"],
                                     model["patch_size"])
    slots = check_slots(grid, int(cell.traffic["check_slots"]), seed)
    return slots, reference.extract(vol, published(params, model), model, ex, precision, slots)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> Outcome:
    """One run of a DINOv3 extraction cell; ``device='cpu'`` runs the
    program's plain twins, for the tests."""
    from vittf_tpu_torch import kernels
    from vittf_tpu_torch.ops.attention import attention
    from vittf_tpu_torch.ops.layer_norm import layer_norm
    from vittf_tpu_torch.ops.swiglu import swiglu
    from vittf_tpu_torch.pipeline.features import _extract

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    model, ex, vit, ecfg, params, vol = make_inputs(cell, seed, dev)
    synchronize(dev)
    log(f"inputs made {time.perf_counter() - t_start:.2f} s in")
    if dev.type == "cuda":
        kernels.load_library()
    log(f"library loaded {time.perf_counter() - t_start:.2f} s in")

    def call(select=None):
        return _extract(vol, params, vit, ecfg, dev, select)["k"]

    # every batch of the call has one shape: one batch an axis warms the
    # whole path (the model's build, each kernel, the pool and the merge)
    call(lambda n: range(1))
    synchronize(dev)
    setup_s = time.perf_counter() - t_start
    reset_peak(dev)
    calls, rope0, gate0, ln0 = 0, attention.rope_launches, swiglu.launches, layer_norm.launches
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
    counters = {"rope_launches": attention.rope_launches - rope0,
                "swiglu_launches": swiglu.launches - gate0,
                "layer_norm_launches": layer_norm.launches - ln0}
    check_launches(counters, expected_launches(tuple(vol.shape), model, ex, calls, dev))
    t_ref = time.perf_counter()
    slots, ref = reference_lattice(cell, model, ex, params, vol, seed)
    values = feature_errors(lattice(feats, slots), ref)
    log(f"{calls} calls in {w.seconds:.3f} s; {counters}; reference "
        f"{time.perf_counter() - t_ref:.1f} s; {values}")
    return Outcome(
        end_to_end={"setup_s": setup_s, "extract_mvox_s": calls * vol.numel() / w.seconds / 1e6},
        attempted=calls, failed=0, checks=limit_checks(values, cell.limits),
        memory_peak_bytes=peak, window_s=w.seconds, trace=w.trace,
        work=window_work(tuple(vol.shape), model, ex, calls), counters=counters)
