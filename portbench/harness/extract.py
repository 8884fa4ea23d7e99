"""Extraction traffic: ``extract_features`` called back to back on one volume.

The user's one-off wait after loading a volume. The window runs whole calls
until ``seconds`` have passed, each ended by a synchronize; the rate is the
input voxels of all of them over the time from the window's start to the
end of the last. Set-up makes the weights and the phantom on the card and
runs one call, which loads the kernel library and meets every shape of the
window.

Correctness: the last call's features against the plain fp32 ViT
(``reference/vit.py``) run on the same volume and weights after the window,
on a lattice of output voxels drawn from the seed (``check_slots`` slots of
each axis; each voxel sums the pooled features of three slice groups, so
the reference runs only the slices those slots pool), by the relative
Frobenius error over the lattice and by its worst voxel (the voxel's error
norm over the RMS of the reference's voxel norms), which a fault confined
to a few slices moves.

Traffic keys: ``volume`` (side of the cubic phantom), ``check_slots``.
"""
from __future__ import annotations

import time

import torch

from portbench.harness import flops, inputs, spec
from portbench.harness.outcome import Outcome, limit_checks
from portbench.harness.device import log, memory_peak, reset_peak, synchronize
from portbench.harness.trace import Window, span


def settings(cell) -> tuple[dict, dict]:
    """(model, extraction settings) of a cell. The weights (``inputs``) and
    the reference ViT have qkv biases and no LayerScale, and the reference
    sweeps all three axes and returns k: a configuration that asks for
    anything else raises."""
    model = dict(spec.require(cell.config, "model", (
        "patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio", "img_size"),
        {"qkv_bias": True, "layerscale": False}))
    model["hidden_dim"] = int(model["embed_dim"] * model["mlp_ratio"])
    ex = spec.require(cell.config, "extract", (
        "compute_dtype", "block_impl", "batch_size", "feature_output_size"),
        {"slice_along": "all", "return_keys": ["k"]})
    return model, ex


def program_config(model: dict, ex: dict):
    from vittf_tpu_torch.models.vit import ViTConfig
    from vittf_tpu_torch.pipeline.features import ExtractConfig

    vit = ViTConfig(patch_size=model["patch_size"], embed_dim=model["embed_dim"],
                    depth=model["depth"], num_heads=model["num_heads"],
                    mlp_ratio=model["mlp_ratio"],
                    img_size=model["img_size"])
    ecfg = ExtractConfig(feature_output_size=ex["feature_output_size"],
                         slice_along=ex["slice_along"], batch_size=ex["batch_size"],
                         return_keys=tuple(ex["return_keys"]),
                         compute_dtype=ex["compute_dtype"], block_impl=ex["block_impl"])
    return vit, ecfg


def feature_errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """feat_rel_err: ‖got − ref‖ / ‖ref‖ over the whole (F, …) volume;
    feat_voxel_err: the largest voxel's ‖got − ref‖ over the RMS voxel ‖ref‖."""
    if tuple(got.shape) != tuple(ref.shape):
        return {}
    F_ = ref.shape[0]
    diff = (got.float() - ref).reshape(F_, -1)
    r = ref.reshape(F_, -1)
    rel = diff.norm() / r.norm()
    voxel = diff.norm(dim=0).max() / r.norm(dim=0).square().mean().sqrt()
    return {"feat_rel_err": float(rel), "feat_voxel_err": float(voxel)}


def check_slots(grid, per_axis: int, seed: int) -> list:
    """A seeded lattice of the output grid: ``per_axis`` sorted slots of
    each axis."""
    rng = inputs.host_rng(seed, "checked slots")
    return [sorted(rng.choice(n, size=min(per_axis, n), replace=False).tolist()) for n in grid]


def lattice(feats: torch.Tensor, slots) -> torch.Tensor:
    """The (F, …) voxels of ``feats`` on the lattice ``slots``."""
    idx = [torch.as_tensor(s, device=feats.device) for s in slots]
    return feats[:, idx[0]][:, :, idx[1]][:, :, :, idx[2]]


def window_work(vol_shape, model: dict, ex: dict, calls: int) -> dict:
    """The ViT work of ``calls`` whole calls, for the per-layer readers:
    total FLOPs and, per kernel, launches with each one's FLOPs and bytes."""
    plan = flops.extraction_plan(vol_shape, model, ex)
    D, H, hidden = model["embed_dim"], model["num_heads"], model["hidden_dim"]
    blocks = []
    for a in plan:  # every block but the captured last one, per batch
        n = calls * a["batches"] * (model["depth"] - 1)
        blocks.append((n, a["batch"], a["tokens"]))
    fused = ex["block_impl"] != "xla" and ex["compute_dtype"] == "bfloat16"
    work = {"vit_flops": calls * flops.extraction_flops(vol_shape, model, ex)}
    key = "fused_block" if fused else "attention"
    work[key] = [
        (n, flops.block_flops(N, D, hidden) * B, flops.block_bytes(B, N, D, hidden)) if fused
        else (n, flops.attention_flops(B, H, N, D // H), flops.attention_bytes(B, H, N, D // H))
        for n, B, N in blocks]
    return work


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> Outcome:
    """One run of an extraction cell; ``device='cpu'`` runs the program's
    plain twins, for the tests."""
    from vittf_tpu_torch import kernels
    from vittf_tpu_torch.pipeline.features import extract_features

    from portbench.reference import vit as reference

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    model, ex = settings(cell)
    vit, ecfg = program_config(model, ex)
    if dev.type == "cuda":
        kernels.load_library()
    log(f"library loaded {time.perf_counter() - t_start:.2f} s in")
    params = inputs.vit_weights(model, seed, dev)
    vol, _ = inputs.phantom(int(cell.traffic["volume"]), seed, dev)
    synchronize(dev)
    log(f"inputs made {time.perf_counter() - t_start:.2f} s in")

    def call():
        return extract_features(vol, params, vit, ecfg, device=dev)["k"]

    call()
    synchronize(dev)
    setup_s = time.perf_counter() - t_start
    reset_peak(dev)
    calls = 0
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
    t_ref = time.perf_counter()
    slots = check_slots(feats.shape[1:], int(cell.traffic["check_slots"]), seed)
    ref = reference.extract(vol, params, model, ex, "fp32", slots)
    values = feature_errors(lattice(feats, slots), ref)
    log(f"{calls} calls in {w.seconds:.3f} s; reference {time.perf_counter() - t_ref:.1f} s; "
        f"{values}")
    checks = limit_checks(values, cell.limits)
    return Outcome(
        end_to_end={"setup_s": setup_s, "extract_mvox_s": calls * vol.numel() / w.seconds / 1e6},
        attempted=calls, failed=0, checks=checks, memory_peak_bytes=peak,
        window_s=w.seconds, trace=w.trace,
        work=window_work(tuple(vol.shape), model, ex, calls))
