#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``vittf_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--profile]

Builds the port's CUDA kernels from ``vittf_tpu_torch/csrc``, holds each
against its plain PyTorch twin at the main path's shapes, then drives the
main path through the two CLI entry points (feature extraction with DINO
ViT-S/8 at full width and random weights, then NTF prediction) and answers
three interactive similarity requests with the features resident on the
card; then the fused-block extraction path (resident, host-streamed and
fast); then the refinement path: the prediction CLI with the bilateral
solver and the island filter, and three refined requests. Phases:

1. card, versions, kernel build time;
2. attention kernel vs plain at (8, 6, 4097, 64) bf16/fp32 and (2, 6, 17, 64),
   and fp32 on the fused (8, 4097, 1152) qkv buffer through
   ``multi_head_attention``;
3. similarity kernel vs plain at feats (64³, 384), queries (1280, 384), C = 5;
4. bilateral splat, slice and blur kernels vs plain on a 128³ crop (σ_s 7,
   σ_l 5, C = 5: a (19, 19, 19, 52) lattice per class) and a ragged
   (61, 47, 53) crop, and a 2-D solve through the kernels vs plain;
5. fused block kernel vs plain at (8, 4097, 384) bf16, held on loud weights
   (``loud_params``: every term reaches the output; the branch out − x is
   compared) with and without the softmax row max and with bf16 scores,
   each of the 11 loud blocks, and a (2, 640 + 37, 384) case with
   ``n_valid=640``; timed on ViT-S/8 block 0, and the 11-block ViT-S/8 stack;
6. main path: ``infer`` on a 128³ phantom, ``predict_ntf``, three requests;
   the attention and similarity launch counters must have risen;
7. fused path: ``infer --block-impl fused`` on the same volume (528 fused
   block launches, no attention launch; features within 0.02·max|ref| of
   phase 6's), ``infer --streamed --block-impl fused --chunk-batches 3``
   (features equal to the resident fused run's) and ``infer --fast
   --block-impl fused`` on a 256³ phantom (264 launches); then a 32³
   extraction with loud weights, kernels vs the plain twin;
8. refinement path: ``predict_ntf --bilateral-solver --largest-island`` on
   the same volume and features, then three requests with
   ``bilateral_solver=True, bls_shape_bucket=8``; the splat, slice and blur
   counters must have risen in both, and the last request's maps agree with
   the plain twins' (|Δ| ≤ 1 on ≤ 1e-3 of the voxels);
9. whole-grid refinement of five classes on a 256³ sim grid, kernels vs
   plain (same contract, wall times of both);
10. ``infer --fast`` on a 256³ phantom;
11. a 64³ extraction through the kernels vs the plain twins;
12. with ``--profile`` only: torch.profiler traces of a warm 128³
    extraction (per-op blocks and fused blocks), of three requests and of
    three refined requests (device busy time, idle share, top kernels).

Every phase raises on failure. The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it is a JSON object with
one entry per kernel. Without a visible CUDA device the script exits 1 and
prints no result. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from vittf_tpu_torch import kernels
from vittf_tpu_torch.cli import infer, predict_ntf
from vittf_tpu_torch.core.io import load_features
from vittf_tpu_torch.models import vit as vit_module
from vittf_tpu_torch.models.dino import resolve_model
from vittf_tpu_torch.models.vit import VisionTransformer, init_vit_params
from vittf_tpu_torch.ops.attention import attention, attention_plain, multi_head_attention
from vittf_tpu_torch.ops.bilateral import (
    _blur,
    _grid_extents,
    bilateral_solve_gray,
    bls_blur,
    bls_slice,
    bls_slice_plain,
    bls_splat,
    bls_splat_plain,
)
from vittf_tpu_torch.ops.fused_block import fused_block, fused_block_plain
from vittf_tpu_torch.ops.similarity import class_mean_matrix, similarity, similarity_plain
from vittf_tpu_torch.pipeline.annotations import annotations_from_labels
from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features
from vittf_tpu_torch.pipeline.ntf import compute_similarities, fuse_predictions
from vittf_tpu_torch.pipeline.refine import make_bls_reference, refine_similarities_batched

ATTN_SHAPE = (8, 6, 4097, 64)  # vits8 at fos 64: 8 slices, 6 heads, 64²+1 tokens
BLOCK_SHAPE = (8, 4097, 384)  # the same slice batch as tokens of width D
LOUD_PEAK, K_SHIFT = 4.0, 80.0  # loud_params' Wq/Wk scale; the row-max case's k-bias scale
SIM_N, SIM_F, SIM_PER_CLASS, SIM_C = 64**3, 384, 256, 5
BLS_SS, BLS_SL, BLS_C = 7, 5, 5  # the refinement's grid (pipeline/refine.py) and 5 classes
BLS_KERNELS = (bls_splat, bls_slice, bls_blur)


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


def check_rel(name, got, want, frac):
    """max |got - want| <= frac·max|want| and finite; returns the error."""
    err = (got.float() - want.float()).abs().max().item()
    lim = frac * want.float().abs().max().item()
    if not err <= lim or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: max err {err} > {lim}")
    return err


def phase_attention(gen):
    results = {}
    for shape, dtype in ((ATTN_SHAPE, torch.bfloat16), (ATTN_SHAPE, torch.float32),
                         ((2, 6, 17, 64), torch.float32)):
        q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype) for _ in range(3))
        got, want = attention(q, k, v), attention_plain(q, k, v)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            # bf16 contract: 0.05·max|ref| (scores and p round at other places)
            err = check_rel(f"attention bf16 {shape}", got, want, 0.05)
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


def phase_bilateral(gen):
    """K4, K5 and K8 against their plain twins on the same inputs. Luma is
    integer-valued in [0, 255], as the uint8 reference the refinement feeds."""
    out = {}
    for shape, C in (((128,) * 3, BLS_C), ((61, 47, 53), 2)):
        luma = torch.randint(0, 256, (C,) + shape, generator=gen).float().cuda()
        t, c = (torch.rand((C,) + shape, generator=gen).cuda() for _ in range(2))
        ext = _grid_extents(shape, BLS_SS, BLS_SL)
        got = bls_splat(luma, t, c, BLS_SS, BLS_SL)
        want = bls_splat_plain(luma, t, c, BLS_SS, BLS_SL)
        torch.cuda.synchronize()
        if not torch.equal(got[:, 0], want[:, 0]) or got[:, 0].sum().item() != luma.numel():
            raise AssertionError(f"bls_splat {shape}: counts differ")
        splat_err = check_close(f"bls_splat {shape} sums", got[:, 1:], want[:, 1:], 1e-5, 1e-6)
        lat = torch.randn((C,) + ext, generator=gen).cuda()
        got = bls_slice(luma, lat.reshape(C, -1, ext[-1]), BLS_SS, BLS_SL)
        want = bls_slice_plain(luma, lat.reshape(C, -1, ext[-1]), BLS_SS, BLS_SL)
        if not torch.equal(got, want):
            raise AssertionError(f"bls_slice {shape}: differs from plain")
        blur_err = check_close(f"bls_blur {(C,) + ext}", bls_blur(lat), _blur(lat), 1e-6, 1e-6)
        times = {}
        for name, fn in (
            ("bls_splat", lambda: bls_splat(luma, t, c, BLS_SS, BLS_SL)),
            ("bls_splat_plain", lambda: bls_splat_plain(luma, t, c, BLS_SS, BLS_SL)),
            ("bls_slice", lambda: bls_slice(luma, lat, BLS_SS, BLS_SL)),
            ("bls_slice_plain", lambda: bls_slice_plain(luma, lat, BLS_SS, BLS_SL)),
            ("bls_blur", lambda: bls_blur(lat)),
            ("bls_blur_plain", lambda: _blur(lat)),
        ):
            times[name] = cuda_ms(fn)
        print(f"bilateral kernels {shape} C={C} lattice {ext}: splat max_abs_err {splat_err} "
              f"kernel {times['bls_splat']} ms plain {times['bls_splat_plain']} ms; slice exact "
              f"kernel {times['bls_slice']} ms plain {times['bls_slice_plain']} ms; blur "
              f"max_abs_err {blur_err} kernel {times['bls_blur']} ms plain "
              f"{times['bls_blur_plain']} ms")
        out = out or {
            "bls_splat": (splat_err, times["bls_splat"], times["bls_splat_plain"]),
            "bls_slice": (0.0, times["bls_slice"], times["bls_slice_plain"]),
            "bls_blur": (blur_err, times["bls_blur"], times["bls_blur_plain"]),
        }
    # a 2-D solve: the kernels take it as one z-plane (blur dim 5)
    img = torch.randint(0, 256, (96, 80), generator=gen).float().cuda()
    t2, c2 = (torch.rand((96, 80), generator=gen).cuda() for _ in range(2))
    kw = dict(sigma_spatial=3, sigma_luma=8, blur_dim=5)
    err = check_close("2-D solve", bilateral_solve_gray(t2, img, c2, **kw),
                      bilateral_solve_gray(t2, img, c2, pixel_impl="scatter", **kw), 1e-4, 1e-5)
    print(f"2-D bilateral solve (96, 80) kernels vs plain: max_abs_err {err}")
    return out


def loud_params(seed: int, peak: float) -> tuple:
    """(config, state dict): ViT-S/8 with LayerScale whose 11 fused blocks
    have weights that make every term of K3 reach its output.

    ``init_vit_params`` gives zero biases, unit LayerNorms and 0.02-std
    linears: there the attention branch moves a block's output by at most
    about one bf16 ulp of the residual, and a wrong softmax, a leak of
    padded keys or a dropped bias would pass a limit on the output. Here
    biases and LayerNorm shifts are N(0, 0.5²), gains 1 + N(0, 0.5²),
    LayerScale gammas U(0.35, 1.05), the v/proj/fc1/fc2 weights are scaled
    to outputs of unit size, and Wq, Wk by ``peak`` so that softmax rows are
    peaked. The final block (per-op) keeps its init. On inputs of std 0.1 a
    block's max |out − x| is 5.4–8.6: kernel and twin differ by up to 2 bf16
    ulps there (an fp32 accumulation-order difference flips an intermediate
    cast), and 0.02·max|branch| is at least 2.7 ulps.
    """
    cfg = dataclasses.replace(resolve_model("vits8"), layerscale=True)
    sd = init_vit_params(cfg, (1, seed))
    gen = torch.Generator().manual_seed(seed)
    D = cfg.embed_dim

    def normal(t, std):
        return std * torch.randn(t.shape, generator=gen)

    for i in range(cfg.depth - 1):
        b = f"blocks.{i}."
        for name in ("attn.qkv.bias", "attn.proj.bias", "mlp.fc1.bias", "mlp.fc2.bias",
                     "norm1.bias", "norm2.bias"):
            sd[b + name] = normal(sd[b + name], 0.5)
        for name in ("norm1.weight", "norm2.weight"):
            sd[b + name] = 1 + normal(sd[b + name], 0.5)
        for name in ("ls1.gamma", "ls2.gamma"):
            sd[b + name] = 0.35 + 0.7 * torch.rand(D, generator=gen)
        qkv = sd[b + "attn.qkv.weight"]
        qkv[:2 * D] *= peak  # q and k
        qkv[2 * D:] *= 2.5  # v
        for name, scale in (("attn.proj.weight", 4.0), ("mlp.fc1.weight", 3.0),
                            ("mlp.fc2.weight", 2.0)):
            sd[b + name] *= scale
    return cfg, sd


def check_branch(name, got, want, x, frac):
    """The block's branch (out − x) against the twin's: max |Δ| <=
    frac·max|want − x|, and finite; returns (error, limit)."""
    ref = want.float() - x.float()
    err = (got.float() - want.float()).abs().max().item()
    lim = frac * ref.abs().max().item()
    if not err <= lim or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: max err {err} > {lim} (branch max {ref.abs().max().item()})")
    return err, lim


def phase_fused_block(gen):
    """K3 against its plain twin at the main path's slice batch. Timed on
    ViT-S/8 block 0 (``init_vit_params`` seed (0, 0)); held on the loud
    blocks of ``loud_params``, comparing the branch (out − x), so that a
    wrong softmax, bias, LayerNorm affine, LayerScale or a padded-key leak
    shows. Limits: 0.02·max|branch|, 0.05 with bf16 scores (the on-chip
    contract of tests_tpu/test_kernels_tpu.py, here on the branch)."""
    cfg = resolve_model("vits8")
    H = cfg.num_heads
    model = VisionTransformer.from_state_dict(cfg, init_vit_params(cfg, (0, 0)))
    timed = list(model.to("cuda", torch.bfloat16).blocks)[:-1]  # the 11 non-final blocks
    loud_cfg, sd = loud_params(0, LOUD_PEAK)
    loud = list(VisionTransformer.from_state_dict(loud_cfg, sd).to("cuda", torch.bfloat16).blocks)[:-1]
    # the row-max case: a large k bias shifts each row's scores by q·b_k (up
    # to ~400 in the exp2 domain); the softmax is shift-invariant, and only
    # the row max keeps exp2 finite
    shifted = {k: v.detach() for k, v in loud[0].named_parameters()}
    shifted["attn.qkv.bias"] = shifted["attn.qkv.bias"].clone()
    shifted["attn.qkv.bias"][384:768] *= K_SHIFT
    x = (0.5 * torch.randn(BLOCK_SHAPE, generator=gen)).to("cuda", torch.bfloat16)
    xl = (0.1 * torch.randn(BLOCK_SHAPE, generator=gen)).to("cuda", torch.bfloat16)
    if bool(torch.isfinite(fused_block_plain(xl, shifted, H, softmax_max=False)).all()):
        raise AssertionError("the shifted block does not overflow without the row max")
    out = None
    for softmax_max, score_dtype in ((False, "fp32"), (True, "fp32"), (False, "bf16")):
        kw = dict(softmax_max=softmax_max, score_dtype=score_dtype)
        blk = shifted if softmax_max else loud[0]
        err, lim = check_branch(f"fused_block {kw}", fused_block(xl, blk, H, **kw),
                                fused_block_plain(xl, blk, H, **kw), xl,
                                0.05 if score_dtype == "bf16" else 0.02)
        ms = cuda_ms(lambda: fused_block(x, timed[0], H, **kw))
        plain_ms = cuda_ms(lambda: fused_block_plain(x, timed[0], H, **kw))
        print(f"fused_block {BLOCK_SHAPE} bf16 softmax_max={softmax_max} score={score_dtype}: "
              f"max_abs_err {err} (limit {lim}, {'shifted ' if softmax_max else ''}loud block 0) "
              f"kernel {ms} ms plain {plain_ms} ms (ViT-S/8 block 0)")
        out = out or (err, ms, plain_ms)
    # each loud block on the same input: one step each, since bf16 rounding
    # compounds over a stack
    errs = [check_branch(f"fused_block loud block {i}", fused_block(xl, b, H, softmax_max=False),
                         fused_block_plain(xl, b, H, softmax_max=False), xl, 0.02)
            for i, b in enumerate(loud)]
    print(f"fused_block loud blocks 0-10, softmax_max=False: max_abs_err / limit "
          f"{[round(e / lim, 4) for e, lim in errs]}")

    def stack(fn):
        y = x
        for w in timed:
            y = fn(y, w, H, softmax_max=False)
        return y

    got, want = stack(fused_block), stack(fused_block_plain)
    torch.cuda.synchronize()
    err = check_rel("fused_block 11-block stack", got, want, 0.02)
    ms, plain_ms = cuda_ms(lambda: stack(fused_block), reps=3), cuda_ms(lambda: stack(fused_block_plain), reps=3)
    print(f"fused_block 11-block stack {BLOCK_SHAPE} softmax_max=False (ViT-S/8): max_abs_err {err} "
          f"max|ref| {want.float().abs().max().item()} kernel {ms} ms plain {plain_ms} ms")
    # n_valid masks 37 padded tokens of random content, which would move
    # the loud block's output if they leaked into a softmax
    xp = (0.1 * torch.randn((2, 677, 384), generator=gen)).to("cuda", torch.bfloat16)
    xs = xp[:, :640].contiguous()
    got = fused_block(xp, loud[0], H, n_valid=640)
    err_p, lim_p = check_branch("fused_block n_valid=640 vs plain", got,
                                fused_block_plain(xp, loud[0], H, n_valid=640), xp, 0.02)
    unpadded = fused_block(xs, loud[0], H)
    err, lim = check_branch("fused_block n_valid=640 vs unpadded", got[:, :640], unpadded, xs, 0.02)
    print(f"fused_block (2, 677, 384) n_valid=640 (loud block 0): vs plain max_abs_err {err_p} "
          f"(limit {lim_p}); vs the unpadded tokens {err} (limit {lim}), bit-identical "
          f"{torch.equal(got[:, :640], unpadded)}")
    return out


def check_u8_maps(name, got, want):
    """uint8 maps agree up to 1 (255 and 0 are neighbours across the
    reference's wraparound at 256) on at most 1e-3 of the voxels: a fp32
    difference moves a value across a quantization boundary, and the
    solve's output is constant over each lattice vertex."""
    d = (got.int() - want.int()) % 256
    d = torch.minimum(d, 256 - d)
    n_diff = d.count_nonzero().item()
    if d.max().item() > 1 or n_diff > 1e-3 * d.numel():
        raise AssertionError(f"{name}: {n_diff} of {d.numel()} voxels differ, max {d.max().item()}")
    return n_diff


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
    return n_attn, n_sim, vol, labels, feat_t


def fast_volume(seed, workdir: Path) -> Path:
    """The 256³ phantom of the fast-mode runs, written once."""
    path = workdir / "fast.npy"
    if not path.exists():
        np.save(path, phantom(256, seed + 7)[0])
    return path


def run_fused_infer(label, args, expect):
    """One ``infer --block-impl fused`` run: the fused block must launch
    ``expect`` times and the attention kernel never (counts set to 0 just
    before the run and read just after). Returns the CLI wall seconds."""
    fused_block.launches = 0
    attention.launches = 0
    t0 = time.perf_counter()
    infer.main(args + ["--block-impl", "fused"])
    dt = time.perf_counter() - t0
    n, n_attn = fused_block.launches, attention.launches
    print(f"infer --block-impl fused, {label}: {dt} s (infer CLI wall incl. weight init); "
          f"launches fused_block {n}, attention {n_attn}")
    if n != expect or n_attn != 0:
        raise AssertionError(f"{label}: fused_block {n} launches (expected {expect}), attention {n_attn}")
    return dt


def phase_fused_path(seed, workdir: Path):
    """The fused-block extraction path on phase 6's 128³ volume, resident and
    host-streamed, then fast mode at 256³. 48 slice batches x 11 non-final
    blocks = 528 fused-block launches; fast mode 24 x 11 = 264."""
    common = ["--data-path", str(workdir / "volume.npy"), "--dino-model", "vits8",
              "--feature-output-size", "64", "--slice-along", "all", "--compute-dtype", "bfloat16"]
    resident, streamed = workdir / "fused_features.npy", workdir / "streamed_features.npy"
    t_res = run_fused_infer("128^3 resident", common + ["--cache-path", str(resident)], 528)
    n_main = fused_block.launches
    t_str = run_fused_infer("128^3 --streamed --chunk-batches 3", common + [
        "--cache-path", str(streamed), "--streamed", "--chunk-batches", "3"], 528)
    per_op = np.load(workdir / "volume_vits8_all_features64.npy", allow_pickle=True)[()]["k"]
    fused = np.load(resident, allow_pickle=True)[()]["k"]
    if fused.shape != per_op.shape or not np.isfinite(fused).all():
        raise AssertionError(f"fused features {fused.shape}")
    ref = per_op.astype(np.float32)
    err = float(np.abs(fused.astype(np.float32) - ref).max())
    lim = 0.02 * float(np.abs(ref).max())  # the bf16 block-stack contract
    print(f"fused vs per-op 128^3 features: max_abs_err {err} (limit {lim})")
    if not err <= lim:
        raise AssertionError("fused and per-op extraction disagree")
    got = np.load(streamed, allow_pickle=True)[()]["k"]
    np.testing.assert_allclose(got.astype(np.float32), fused.astype(np.float32), rtol=1e-6, atol=0)
    print(f"streamed vs resident fused features: bit-identical {np.array_equal(got, fused)}")
    out = workdir / "fast_fused_features.npy"
    t_fast = run_fused_infer("256^3 --fast", ["--data-path", str(fast_volume(seed, workdir)),
                                              "--cache-path", str(out), "--feature-output-size", "64",
                                              "--fast"], 264)
    k = np.load(out, allow_pickle=True)[()]["k"]
    if k.shape != (384, 64, 64, 64) or not np.isfinite(k).all():
        raise AssertionError(f"fast fused features {k.shape}")
    print(f"fused path: 128^3 resident {t_res} s, streamed {t_str} s, fast 256^3 {t_fast} s "
          f"({256**3 / t_fast / 1e6} Mvoxel/s), all infer CLI wall incl. weight init")
    loud_extraction(seed)
    return n_main


def loud_extraction(seed):
    """The fused extraction path with the loud weights of ``loud_params``,
    where every block's branch reaches the features, against the same path
    with the plain twin in the kernel's place: a 32³ phantom at fos 64 (12
    slice batches of 4097 tokens, 132 block calls); 0.02·max|ref|."""
    cfg, sd = loud_params(seed, LOUD_PEAK)
    vol, _ = phantom(32, seed + 5)
    ex = ExtractConfig(feature_output_size=64, compute_dtype="bfloat16", block_impl="fused")
    n0 = fused_block.launches
    got = extract_features(vol, sd, cfg, ex, device="cuda")["k"]
    n = fused_block.launches - n0
    with mock.patch.object(vit_module, "fused_block", fused_block_plain):
        want = extract_features(vol, sd, cfg, ex, device="cuda")["k"]
    if n != 132 or fused_block.launches - n0 != n:
        raise AssertionError(f"loud extraction: {n} kernel launches, expected 132")
    err = check_rel("loud fused extraction vs plain twin", got, want, 0.02)
    print(f"loud fused extraction 32^3 fos 64, kernel vs plain twin: max_abs_err {err} "
          f"(limit {0.02 * want.abs().max().item()})")


def bls_requests(vol, feat_t, anns, impl="auto"):
    """Refined interactive requests; returns each one's maps, label volume
    and wall seconds."""
    out = []
    for ann in anns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sims = compute_similarities(vol, feat_t, ann, bilateral_solver=True, bls_shape_bucket=8,
                                    impl=impl)
        pred = fuse_predictions(sims)
        torch.cuda.synchronize()
        out.append((sims, pred, time.perf_counter() - t0))
    return out


def phase_refinement(seed, workdir: Path, vol, labels, feat_t):
    """The refinement path: the CLI with per-class tight crops and the
    island filter, then refined requests with bucketed batched crops."""
    for fn in BLS_KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    predict_ntf.main(["--data", str(workdir), "--num-samples", "256", "--seed", str(seed),
                      "--bilateral-solver", "--largest-island"])
    t_cli = time.perf_counter() - t0
    n_cli = [fn.launches for fn in BLS_KERNELS]
    pred = np.load(workdir / "ntf_pred256.0bothblsisl.npy")
    if pred.shape != (64, 64, 64) or pred.dtype != np.uint8 or pred.max() > 5 or not pred.any():
        raise AssertionError(f"refined prediction {pred.shape} {pred.dtype} max {pred.max()}")
    metrics = json.loads((workdir / "ntf_metrics256.0bothblsisl.json").read_text())
    if not 0.0 <= metrics["mIoU"] <= 1.0:
        raise AssertionError(f"refined mIoU {metrics['mIoU']}")

    labels_f = np.flip(labels, axis=-3).copy()
    anns = [annotations_from_labels(labels_f, 256, "both", rng=np.random.default_rng(seed + r),
                                    device="cuda") for r in range(1, 4)]
    reqs = bls_requests(vol, feat_t, anns)
    n_all = [fn.launches for fn in BLS_KERNELS]
    n_req = [a - b for a, b in zip(n_all, n_cli)]
    sims, pred_r, _ = reqs[-1]
    plain = compute_similarities(vol, feat_t, anns[-1], bilateral_solver=True,
                                 bls_shape_bucket=8, impl="plain")
    n_diff = sum(check_u8_maps(f"refined request map {k}", sims[k], plain[k]) for k in sims)
    if tuple(pred_r.shape) != (64, 64, 64):
        raise AssertionError(f"refined request prediction shape {tuple(pred_r.shape)}")
    req_ms = [r[2] * 1e3 for r in reqs]
    print(f"refinement path: predict CLI --bilateral-solver --largest-island {t_cli} s, "
          f"mIoU {metrics['mIoU']}; refined request p50 {float(np.median(req_ms))} ms "
          f"(each {req_ms} ms); last request vs plain: {n_diff} voxels differ by 1")
    print(f"launches (splat, slice, blur): CLI {n_cli}, requests {n_req}")
    if min(n_cli) == 0 or min(n_req) == 0:
        raise AssertionError(f"a bilateral kernel was not launched: CLI {n_cli}, requests {n_req}")
    return n_all


def phase_whole_grid(seed):
    """refine_similarities_batched on a 256³ sim grid (the half-res grid of a
    512³ CT), five classes, support over the whole grid: kernels vs plain,
    in turns plain, kernels, kernels, plain."""
    size, C = 256, BLS_C
    vol, labels = phantom(size, seed + 11)
    shape = (size,) * 3
    ref = make_bls_reference(vol, shape, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lab = torch.from_numpy(labels).cuda()
    cls = torch.arange(1, C + 1, device="cuda").reshape(C, 1, 1, 1)
    sims = 0.15 + 0.6 * (lab[None] == cls).float()
    sims += 0.1 * torch.rand((C,) + shape, generator=gen, device="cuda")
    runs = {"scatter": [], "auto": []}
    outs = {}
    for impl in ("scatter", "auto", "auto", "scatter"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[impl] = refine_similarities_batched(sims, None, shape, ref_u8=ref, pixel_impl=impl)
        torch.cuda.synchronize()
        runs[impl].append(time.perf_counter() - t0)
    n_diff = check_u8_maps("whole-grid refinement", outs["auto"], outs["scatter"])
    print(f"whole-grid refinement {shape} C={C}: kernels {runs['auto']} s, plain "
          f"{runs['scatter']} s; {n_diff} of {outs['auto'].numel()} voxels differ by 1")


def phase_fast(seed, workdir: Path):
    out = workdir / "fast_features.npy"
    t0 = time.perf_counter()
    infer.main(["--data-path", str(fast_volume(seed, workdir)), "--cache-path", str(out),
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
    if tuple(got.shape) != (384, 64, 64, 64):
        raise AssertionError(f"64^3 extraction shape {tuple(got.shape)}")
    err = check_rel("64^3 extraction kernels vs plain", got, want, 0.02)  # bf16 block-stack contract
    print(f"64^3 extraction kernels vs plain: max_abs_err {err} (limit "
          f"{0.02 * want.abs().max().item()}), shape {tuple(got.shape)}")


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
    """torch.profiler traces of the library calls users wait on: a warm 128³
    full-sweep extraction, three interactive requests against the features
    resident on the card, and three refined requests."""
    from torch.profiler import ProfilerActivity, profile

    cfg = resolve_model("vits8")
    params = init_vit_params(cfg, (0, seed))
    vol, labels = phantom(128, seed)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for block_impl in ("fused", "xla"):
        ex = ExtractConfig(feature_output_size=64, compute_dtype="bfloat16", block_impl=block_impl)
        extract_features(vol, params, cfg, ex, device="cuda")  # warm-up
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            feats = extract_features(vol, params, cfg, ex, device="cuda")["k"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device_breakdown(prof, wall, f"extraction 128^3 full sweep, block_impl={block_impl}")

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

    bls_requests(vol, feats, anns[:1])  # warm-up
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        bls_requests(vol, feats, anns)
        wall = time.perf_counter() - t0
    device_breakdown(prof, wall, "3 refined requests (bilateral_solver, bucket 8), 64^3 features")


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
    bls = phase_bilateral(gen)
    k3_err, k3_ms, k3_plain = phase_fused_block(gen)
    with tempfile.TemporaryDirectory(prefix="vittf_smoke_") as tmp:
        n_attn, n_sim, vol, labels, feat_t = phase_main_path(args.seed, Path(tmp))
        n_k3 = phase_fused_path(args.seed, Path(tmp))
        n_bls = phase_refinement(args.seed, Path(tmp), vol, labels, feat_t)
        del feat_t
        phase_whole_grid(args.seed)
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
    ] + [
        {"name": name, "route": "cuda", "source": "vittf_tpu_torch/csrc/bilateral.cu",
         "replaces": f"vittf_tpu/ops/bilateral.py:{line}", "launches": n,
         "max_abs_err": bls[name][0], "ms": bls[name][1], "plain_ms": bls[name][2]}
        for name, line, n in zip(("bls_splat", "bls_slice", "bls_blur"), (333, 412, 495), n_bls)
    ] + [
        {"name": "fused_block", "route": "cuda",
         "source": "vittf_tpu_torch/csrc/fused_block.cu",
         "replaces": "vittf_tpu/ops/fused_block.py:292", "launches": n_k3,
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
