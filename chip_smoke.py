#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``vittf_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--profile]

Builds the port's CUDA kernels from ``vittf_tpu_torch/csrc``, holds each
against its plain PyTorch twin at the main path's shapes, then drives the
main path through the two CLI entry points (feature extraction with DINO
ViT-S/8 at full width and random weights, then NTF prediction) and answers
three interactive similarity requests with the features resident on the
card. Phases:

1. card, versions, kernel build time;
2. attention kernel vs plain at (8, 6, 4097, 64) bf16/fp32 and (2, 6, 17, 64),
   and fp32 on the fused (8, 4097, 1152) qkv buffer through
   ``multi_head_attention``;
3. similarity kernel vs plain at feats (64³, 384), queries (1280, 384), C = 5;
4. main path: ``infer`` on a 128³ phantom, ``predict_ntf``, three requests;
   both kernels' launch counters must have risen;
5. ``infer --fast`` on a 256³ phantom;
6. a 64³ extraction through the kernels vs the plain twins;
7. with ``--profile`` only: torch.profiler traces of a warm 128³ extraction
   and of three requests (device busy time, idle share, top kernels).

Every phase raises on failure. The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it is a JSON object with
one entry per kernel. Without a visible CUDA device the script exits 1 and
prints no result. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from vittf_tpu_torch import kernels
from vittf_tpu_torch.cli import infer, predict_ntf
from vittf_tpu_torch.core.io import load_features
from vittf_tpu_torch.models.dino import resolve_model
from vittf_tpu_torch.models.vit import init_vit_params
from vittf_tpu_torch.ops.attention import attention, attention_plain, multi_head_attention
from vittf_tpu_torch.ops.similarity import class_mean_matrix, similarity, similarity_plain
from vittf_tpu_torch.pipeline.annotations import annotations_from_labels
from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features
from vittf_tpu_torch.pipeline.ntf import compute_similarities, fuse_predictions

ATTN_SHAPE = (8, 6, 4097, 64)  # vits8 at fos 64: 8 slices, 6 heads, 64²+1 tokens
SIM_N, SIM_F, SIM_PER_CLASS, SIM_C = 64**3, 384, 256, 5


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 7) -> float:
    """Median device time of ``fn`` in ms (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phantom(size: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(volume fp32, labels uint8): five ellipsoids of distinct intensity in
    a noisy background, the shape of a CT-ORG-style labeled volume."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*(np.linspace(-1, 1, size, dtype=np.float32),) * 3,
                                indexing="ij"))
    labels = np.zeros((size,) * 3, np.uint8)
    vol = rng.normal(0.0, 0.05, (size,) * 3).astype(np.float32)
    for c in range(1, 6):
        center = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
        radii = rng.uniform(0.15, 0.35, 3).astype(np.float32)
        inside = (((grid - center[:, None, None, None]) / radii[:, None, None, None]) ** 2).sum(0) <= 1
        labels[inside] = c
        vol[inside] += 0.2 * c
    return vol, labels


def check_close(name, got, want, rtol, atol):
    """Elementwise |got - want| <= atol + rtol·|want|; returns max |got - want|."""
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max err {err.max().item()}")
    return err.max().item()


def phase_attention(gen):
    results = {}
    for shape, dtype in ((ATTN_SHAPE, torch.bfloat16), (ATTN_SHAPE, torch.float32),
                         ((2, 6, 17, 64), torch.float32)):
        q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype) for _ in range(3))
        got, want = attention(q, k, v), attention_plain(q, k, v)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            # bf16 contract: 0.05·max|ref| (scores and p round at other places)
            err = (got.float() - want.float()).abs().max().item()
            lim = 0.05 * want.float().abs().max().item()
            if not err <= lim or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"attention bf16 {shape}: err {err} > {lim}")
        else:
            err = check_close(f"attention fp32 {shape}", got, want, 2e-5, 2e-5)
        ms, plain_ms = cuda_ms(lambda: attention(q, k, v)), cuda_ms(lambda: attention_plain(q, k, v))
        print(f"attention {shape} {str(dtype)[6:]}: max_abs_err {err} kernel {ms} ms plain {plain_ms} ms")
        results[(shape, dtype)] = (err, ms, plain_ms)
    # the main path's layout: q/k/v as strided views of the fused (B, N, 3D)
    # qkv buffer, output written head-merged
    B, H, N, hd = ATTN_SHAPE
    qkv = torch.randn((B, N, 3 * H * hd), generator=gen).cuda()
    got = multi_head_attention(qkv, H)
    want = multi_head_attention(qkv, H, impl="plain")
    err = check_close(f"attention fp32 fused qkv {tuple(qkv.shape)}", got, want, 2e-5, 2e-5)
    print(f"attention fused qkv {tuple(qkv.shape)} float32: max_abs_err {err}")
    return results[(ATTN_SHAPE, torch.bfloat16)]


def phase_similarity(gen):
    # clustered features (class centers + noise) so that in-class scores sit
    # above the 0.25 threshold and cross-class scores below it
    labels = torch.randint(0, SIM_C, (SIM_N,), generator=gen)
    centers = torch.randn(SIM_C, SIM_F, generator=gen) / SIM_F**0.5
    feats = centers[labels] + 0.5 * torch.randn(SIM_N, SIM_F, generator=gen) / SIM_F**0.5
    picks = torch.cat([torch.nonzero(labels == c)[:SIM_PER_CLASS, 0] for c in range(SIM_C)])
    feats, queries = feats.cuda(), feats[picks].cuda()
    m = torch.from_numpy(class_mean_matrix([SIM_PER_CLASS] * SIM_C, len(picks))).cuda()
    out = None
    for mean_first in (False, True):
        def run_kernel():
            return similarity(feats, queries, m, mean_first=mean_first, out_layout="cn")

        def run_plain():
            return similarity_plain(feats, queries, m, mean_first=mean_first, out_layout="cn")

        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        err = check_close(f"similarity mean_first={mean_first}", got, want, 1e-4, 1e-5)
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
        print(f"similarity ({SIM_N}, {SIM_F}) x ({len(picks)}, {SIM_F}) C={SIM_C} "
              f"mean_first={mean_first}: max_abs_err {err} max|ref| "
              f"{want.abs().max().item()} kernel {ms} ms plain {plain_ms} ms")
        out = out or (err, ms, plain_ms)
    return out


def phase_main_path(seed, workdir: Path):
    size = 128
    vol, labels = phantom(size, seed)
    np.save(workdir / "volume.npy", vol)
    np.save(workdir / "labels.npy", labels)

    attention.launches = 0
    similarity.launches = 0
    t0 = time.perf_counter()
    infer.main(["--data-path", str(workdir / "volume.npy"), "--dino-model", "vits8",
                "--feature-output-size", "64", "--slice-along", "all",
                "--compute-dtype", "bfloat16"])
    t_extract = time.perf_counter() - t0
    t0 = time.perf_counter()
    predict_ntf.main(["--data", str(workdir), "--num-samples", "256", "--seed", str(seed)])
    t_predict = time.perf_counter() - t0

    feats_path = workdir / "volume_vits8_all_features64.npy"
    art = np.load(feats_path, allow_pickle=True)[()]
    if art["k"].shape != (384, 64, 64, 64) or art["k"].dtype != np.float16:
        raise AssertionError(f"features artifact {art['k'].shape} {art['k'].dtype}")
    if not np.isfinite(art["k"]).all():
        raise AssertionError("features artifact holds non-finite values")
    pred = np.load(workdir / "ntf_pred256.0both.npy")
    if pred.shape != (64, 64, 64) or pred.dtype != np.uint8 or pred.max() > 5:
        raise AssertionError(f"prediction {pred.shape} {pred.dtype} max {pred.max()}")
    metrics = json.loads((workdir / "ntf_metrics256.0both.json").read_text())
    if not 0.0 <= metrics["mIoU"] <= 1.0:
        raise AssertionError(f"mIoU {metrics['mIoU']}")

    # interactive requests: new annotation draws against resident features
    feat_t = torch.from_numpy(load_features(feats_path)).cuda()
    labels_f = np.flip(labels, axis=-3).copy()
    req_s = []
    for r in range(1, 4):
        ann = annotations_from_labels(labels_f, 256, "both",
                                      rng=np.random.default_rng(seed + r), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sims = compute_similarities(vol.shape, feat_t, ann)
        pred_r = fuse_predictions(sims)
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t0)
    n_attn, n_sim = attention.launches, similarity.launches

    # the last request's maps against the plain path: uint8 maps may differ
    # by 1 where fp32 reassociation moves a value across an integer boundary
    plain = compute_similarities(vol.shape, feat_t, ann, impl="plain")
    for name in sims:
        d = (sims[name].int() - plain[name].int()).abs()
        if d.max().item() > 1 or d.count_nonzero().item() > 1e-3 * d.numel():
            raise AssertionError(f"request map {name}: {d.count_nonzero().item()} voxels differ")
    if tuple(pred_r.shape) != (64, 64, 64):
        raise AssertionError(f"request prediction shape {tuple(pred_r.shape)}")
    print(f"main path: extraction {t_extract} s ({size**3 / t_extract / 1e6} Mvoxel/s, "
          f"infer CLI wall incl. weight init), predict {t_predict} s, "
          f"request p50 {float(np.median(req_s)) * 1e3} ms (each {[s * 1e3 for s in req_s]} ms), "
          f"mIoU {metrics['mIoU']}")
    print(f"launches in the main path: attention {n_attn}, similarity {n_sim}")
    if n_attn == 0 or n_sim == 0:
        raise AssertionError(f"a kernel was not launched: attention {n_attn}, similarity {n_sim}")
    return n_attn, n_sim


def phase_fast(seed, workdir: Path):
    vol, _ = phantom(256, seed + 7)
    np.save(workdir / "fast.npy", vol)
    out = workdir / "fast_features.npy"
    t0 = time.perf_counter()
    infer.main(["--data-path", str(workdir / "fast.npy"), "--cache-path", str(out),
                "--feature-output-size", "64", "--fast"])
    dt = time.perf_counter() - t0
    k = np.load(out, allow_pickle=True)[()]["k"]
    if k.shape != (384, 64, 64, 64) or not np.isfinite(k).all():
        raise AssertionError(f"fast features {k.shape}")
    print(f"fast mode 256^3: {dt} s ({256**3 / dt / 1e6} Mvoxel/s, infer CLI wall incl. weight init)")


def phase_consistency(seed):
    cfg = resolve_model("vits8")
    params = init_vit_params(cfg, (0, seed))
    vol, _ = phantom(64, seed + 9)
    feats = {}
    for impl in ("auto", "plain"):
        ex = ExtractConfig(feature_output_size=64, compute_dtype="bfloat16", attn_impl=impl)
        feats[impl] = extract_features(vol, params, cfg, ex, device="cuda")["k"]
    got, want = feats["auto"], feats["plain"]
    err = (got - want).abs().max().item()
    lim = 0.02 * want.abs().max().item()  # bf16 block-stack contract
    print(f"64^3 extraction kernels vs plain: max_abs_err {err} (limit {lim}), shape {tuple(got.shape)}")
    if not err <= lim or tuple(got.shape) != (384, 64, 64, 64):
        raise AssertionError("kernel and plain extraction disagree")


def device_breakdown(prof, wall_s: float, label: str, top: int = 6):
    """Print device busy time, idle share and the top kernels of a trace.

    Busy time is the union of the card's activity intervals (kernels,
    copies, memsets) in the trace; idle share is 1 - busy / ``wall_s``,
    the host wall time of the traced calls between two synchronizes.
    """
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        print(f"profile {label}: the trace holds no device time")
        return
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    per_name: dict[str, list[float]] = {}
    for e in events:
        per_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    busy_s = busy_us / 1e6
    print(f"profile {label}: wall {wall_s} s, device busy {busy_s} s, "
          f"idle share {1 - busy_s / wall_s}")
    for name, ds in sorted(per_name.items(), key=lambda kv: -sum(kv[1]))[:top]:
        print(f"  {sum(ds) / 1e3} ms ({sum(ds) / busy_us:.4f} of busy), {len(ds)} x, {name[:90]}")


def phase_profile(seed):
    """torch.profiler traces of the two library calls users wait on: a warm
    128³ full-sweep extraction, and three interactive requests against the
    features resident on the card."""
    from torch.profiler import ProfilerActivity, profile

    cfg = resolve_model("vits8")
    params = init_vit_params(cfg, (0, seed))
    vol, labels = phantom(128, seed)
    ex = ExtractConfig(feature_output_size=64, compute_dtype="bfloat16")
    extract_features(vol, params, cfg, ex, device="cuda")  # warm-up
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        feats = extract_features(vol, params, cfg, ex, device="cuda")["k"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_breakdown(prof, wall, "extraction 128^3 full sweep")

    labels_f = np.flip(labels, axis=-3).copy()
    anns = [annotations_from_labels(labels_f, 256, "both", rng=np.random.default_rng(seed + r),
                                    device="cuda") for r in range(1, 4)]
    fuse_predictions(compute_similarities(vol.shape, feats, anns[0]))  # warm-up
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for ann in anns:
            fuse_predictions(compute_similarities(vol.shape, feats, ann))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_breakdown(prof, wall, "3 interactive requests, 64^3 features")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace extraction and requests with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1

    # fp32 references run in IEEE fp32 (no TF32 in matmuls or convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    kernels.load_library()
    print(f"kernel build+load {kernels.build_seconds} s -> {kernels.library_path().name}")

    gen = torch.Generator().manual_seed(args.seed)
    attn_err, attn_ms, attn_plain = phase_attention(gen)
    sim_err, sim_ms, sim_plain = phase_similarity(gen)
    with tempfile.TemporaryDirectory(prefix="vittf_smoke_") as tmp:
        n_attn, n_sim = phase_main_path(args.seed, Path(tmp))
        phase_fast(args.seed, Path(tmp))
    phase_consistency(args.seed)
    if args.profile:
        phase_profile(args.seed)

    print(smi)
    print(json.dumps({"kernels": [
        {"name": "attention", "route": "cuda",
         "source": "vittf_tpu_torch/csrc/attention.cu",
         "replaces": "vittf_tpu/ops/attention.py:73", "launches": n_attn,
         "max_abs_err": attn_err, "ms": attn_ms, "plain_ms": attn_plain},
        {"name": "similarity", "route": "cuda",
         "source": "vittf_tpu_torch/csrc/similarity.cu",
         "replaces": "vittf_tpu/ops/similarity.py:109", "launches": n_sim,
         "max_abs_err": sim_err, "ms": sim_ms, "plain_ms": sim_plain},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
