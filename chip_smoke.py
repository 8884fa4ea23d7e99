#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``vittf_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--profile] [--ptxas]

Builds the port's CUDA kernels from ``vittf_tpu_torch/csrc``, holds each
against its plain PyTorch twin at the main path's shapes, then drives the
main path through the two CLI entry points (feature extraction with DINO
ViT-S/8 at full width and random weights, then NTF prediction) and answers
three interactive similarity requests with the features resident on the
card; then the fused-block extraction path (resident, host-streamed and
fast); then the refinement path: the prediction CLI with the bilateral
solver and the island filter, and three refined requests; then the
blocked-form refinement (the split-form witness, the 2-D solver and
coarse-to-fine) and the served path (the ``serve`` CLI answering annotation
edits in a directory); and the chained GEMM probe, the baselines path (the
device SVM predict), the trainer foundations, the four CNN trainers with
the training CLI, and the tools path; then the ViT self-supervision, the
quality harness and the multi-device layer. Phases:

1. card, versions, kernel build time;
2. attention kernel vs plain at (8, 6, 4097, 64) bf16/fp32, fp32 at
   (2, 6, 17, 64), bf16 at N = 17, 64, 65, 128, 129 and 4097 with q as drawn
   and scaled by 8 (peaked rows), each bf16 result also against the twin run
   in fp32 and against its repeat, and fp32 and bf16 on the fused
   (8, 4097, 1152) qkv buffer through ``multi_head_attention``;
3. similarity kernel vs plain at feats (64³, 384), queries (1280, 384), C = 5,
   both ``mean_first`` modes, then at the edges of its tiling (A = 70, 1290;
   C = 1, 7, 32; F = 36, 768; N short of a tile), every result against its
   repeat, each class alone against its map among five (bit-equal), and
   scores exactly at the threshold;
4. bilateral splat, slice and blur kernels vs plain on a 128³ crop (σ_s 7,
   σ_l 5, C = 5: a (19, 19, 19, 52) lattice per class) and a ragged
   (61, 47, 53) crop, the splat bit-equal to the plain twin run on CPU
   tensors and to its repeat; on the same crops the reblock, unreblock,
   blocked splat (bit-equal likewise) and blocked slice kernels vs plain (and
   vs the fused kernels' results), the slices equal to their repeats and held
   where their 16-byte runs meet ragged edges (tiny and misaligned classes,
   65 535 classes, ranks 1 and 2, knife edges at σ_l 7), the blocked splat
   and slice with one row per cell on a 2048 × 2048 image (σ_s 24, σ_l 4: 576
   pixels per cell, 64 bins), and a 2-D solve through the kernels vs plain;
   the blur bit-equal to its twin on CPU tensors, on the card and to its
   repeat (output poisoned with NaN), there and on ``blur_edge_cases`` (L 37,
   52, 64; X 1, 3, 19; ranks 2-4; 1 or 5 classes; blur dim 5; an input off a
   16-byte boundary) and at the whole-grid and 2-D solver lattices; the
   reblock and the unreblock equal to their twins at X % 4 = 0-3, σ_s 4 and
   7, 1 or 2 classes, inputs and the unreblock's output off a 16-byte
   boundary (``reblock_edge_cases``); kernels and yardsticks timed ten calls
   an event pair, one call beside it, the blur and both transposes beside a
   copy floor
   (``out.copy_(src)`` of as many bytes: no library call computes them);
5. fused block kernel vs plain at (8, 4097, 384) bf16, held on loud weights
   (``loud_params``: every term reaches the output; the branch out − x is
   compared at 0.02·max|branch|) without the softmax row max and, on a block
   whose k bias shifts the scores, with it, each result equal to its repeat;
   a block whose every p underflows (row sum 0); each of the 11 loud blocks;
   3 x N tokens at N = 64, 65, 127, 129 and widths 128, 512 and 768; a
   (2, 640 + 37, 384) case with ``n_valid=640``; timed on ViT-S/8 block 0
   (the block, and each of its five launches alone), and the 11-block stack;
5a. chained GEMM kernel vs plain at (2048, 1536) x (1536, 1536), chain 1, 2
   and 32, in its three modes (bf16: one bf16 step at chain 1, 0.03·max|ref|
   after; int8+requant and int8+shift bit-equal, also on operands with a zero
   row and products that scale to exact .5 ties), each equal to its repeat,
   timed beside 32 ``torch.matmul`` / ``torch._int_mm`` calls; rows 1, 127,
   129 at dim 128, 384 and 1536, and a dim the kernel refuses; then the probe's
   entry point ``scripts.bench_int8_gemm`` at its defaults (63 launches), its
   printed lines passed through;
5b. baselines path: ``compose_features`` on a 256³ phantom,
   ``sample_train_data``, then ``svm_predict_device`` over all 16.8 M voxels
   with a seeded stand-in classifier (12 000 support vectors, 6 classes),
   from a device tensor and host-streamed (bit-equal), against an fp64
   evaluation of the same vote on 200 000 voxels (agreement >= 0.9999);
5c. trainer foundations: ``make_multiclass_volume`` at 128³ equal to the CPU
   run; ``feature_extractor_forward`` and ``pawsnet_forward`` (train and
   eval) at the JAX defaults on 4096 crops of 7³, the losses and their
   gradients, one ``ProbeTrainer.fit`` epoch on 384-wide features, each
   against the same call on CPU tensors; a parameter ``.npz`` and a
   checkpoint read back equal;
5d. trainers: ``ContrastiveTrainer``, ``IntraCLRTrainer`` and ``PAWSTrainer``
   on a 128³ ``make_multiclass_volume`` phantom and
   ``DenseContrastiveTrainer`` (a full-volume forward and backward a step)
   on a 96³ one, each at its JAX default config, 10 steps on the card and
   10 on the CPU from the same initial values and draws (TF32 off): finite
   records, each step's records within 1e-4 of the CPU's; the contrastive
   trainers run free and end with parameters within 1e-4 and optimizer
   state within 1e-3 of each leaf's largest (counts equal; the biases
   ahead of a GroupNorm or BatchNorm named and left out), PAWS takes the
   card's state before each CPU step and is held so at every step; median
   step ms; the dense step at 128³ on the card alone; then
   ``cli/train.py --trainer paws --iterations 4`` with checkpoints, and
   again with ``--iterations 8 --resume`` (the log goes on at step 5,
   checkpoints at 2, 4, 6, 8);
5e. SwiGLU gate (K10, ``phase_swiglu``) at the ViT-g/14 cell's launch,
   (32 928, 8192) bf16, and at ragged shapes (rows 1, 7, 129; widths 8, 24,
   1544; a (2, 1029, 2H) batch), output poisoned with NaN first: bit-equal
   to the plain twin run on the card's tensors and to its repeat, within one
   bf16 step of the twin on CPU tensors (the host's exp may differ in the
   last fp32 bit); timed ten calls an event pair beside its 6·M·H-byte
   bound, the twin and ``F.silu(x1) * x2``; then the path
   (``phase_swiglu_path``): ViT-g/14-reg at full width and three blocks
   through ``extract_features`` on a 64³ phantom (448² slices, 1029 tokens,
   batch 32: 12 gate launches), kernels vs plain twins at the bf16
   block-stack contract, and ``block_impl='fused'`` refused before a launch;
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
   ``bilateral_solver=True, bls_shape_bucket=8`` given the reference as the
   served session keeps it, twice (a key's first request runs its refine
   core eager, its second captures it, later ones and the second round
   replay), then once more without the reference (each request uploads and
   resizes the volume); the splat, slice and blur counters must have risen,
   the last request's maps agree with the plain twins' (|Δ| ≤ 1 on ≤ 1e-3
   of the voxels) and equal their own repeat, second round and run without
   the reference bit for bit; what the graph cache did per request; then,
   the cache dropped, six requests held against the slice-based core with
   the eager solve, ``torch.equal``: an eager first sighting, a capture and
   replays at other starts (``witness_fresh``);
8a. refine core witness (``phase_core_witness``): the core of five classes
   of a (96, 80, 64) grid at two crop shapes, four calls each with starts at
   the low faces, the high faces, mixed and inside, each held as in phase 8;
8b. capture parts (``phase_capture_parts``): a capture's eager warm-up,
   ``torch.cuda.graph``'s entry, capture, instantiation and first replays
   timed apart for solves at 5 × 128³, the whole grid's chunk 4 × 256³ and
   a 2-D 2048², and for a request's refine core (5 × 64³, crop 48³), and
   the same capture without the entry and on a fresh stream, each replay
   ``torch.equal`` to the eager body;
9. whole-grid refinement of five classes on a 256³ sim grid, kernels vs
   plain (same contract, wall times of both; the first call's two chunks
   are an eager sighting and a capture, the second call's two replays),
   memory reserved before and after, and a whole-grid chunk's graph held as
   in phase 8;
10. ``infer --fast`` on a 256³ phantom;
11. a 64³ extraction through the kernels vs the plain twins;
12. blocked path: the whole-grid refinement of five classes at 128³ with
    ``pixel_impl='reblock'`` against ``'auto'`` and ``'scatter'``, then
    ``apply_bilateral_solver2d`` on 2048² and 512² phantom slices, kernels vs
    ``'scatter'`` (the blocked kernels' counters must have risen, the fused
    splat's and slice's must not), timed as a graph replay beside the eager
    body and the fused kernels called directly on the image as one z-plane;
    the 128³ ``'reblock'`` and ``'auto'`` refinements and each 2-D solve
    held as in phase 8, eager sighting, capture and replay;
13. coarse-to-fine: phase 9's refinement with ``bs_params={'coarse_to_fine':
    True}`` and with ``fine_maxiter=25`` beside the direct one (wall, peak
    memory, maps' deviation from the direct ones, memory reserved), its
    graph held as in phase 8, and one class on a 512³ grid, direct and
    coarse-to-fine; one class's float solves are held to mean |delta| <=
    2e-3 and equal > 0.5 masks on >= 0.999; the 256³ fast extraction's peak
    memory is printed in phase 10;
13b. graph memory (``phase_graph_memory``): ten distinct large keys in a
    row (one class on 512³ at five ``cg_maxiter``, five classes on 256³ at
    five ``lam``), after each the graph cache's entries and bytes against
    its budget, memory reserved and the card's free memory; the bytes must
    stay within the budget and the count within ``GRAPH_BOUND``;
14. served path: ``serve --max-updates 4`` on a 128³ artifact directory,
    without and with ``--bilateral-solver``, while a thread writes
    ``annotations.npy`` four times (five classes; one class edited; a class
    added; cleared); every answer is held against a fresh recompute (bit-equal
    without the solver; with it within 1e-3, the recompute bit-equal to its
    repeat, bit-equal to the kernel's similarities through the plain twins'
    solve with a deterministic ``index_add_``, those similarities within
    phase 3's contract of the twin's, and within ±1 of the plain route made
    so); the start-up warm-up's and the first refined edit's refine cores
    equal their witness; what the graph cache did per edit;
14a. tools path: the similarity kernel with no threshold on scores of either
    sign vs plain; ``compare_sampling_strategies`` at 64³ x 384 (5 similarity
    launches, maps vs the plain route within the uint8 contract);
    ``resample_topk`` and ``apply_bilateral_solver3d_rgb`` (64³ RGB phantom)
    against the same calls on CPU tensors; an ``mlp``-source extraction at 32³;
14b. ViT self-supervision (``phase_vit_ssl``): ``train_vit_selfsup`` at
    ViT-S/8 full width, ``supcon``, ``infonce`` and ``dino`` 10 steps each
    at the JAX defaults (im_sz 64, batch 16) on a 128³ phantom; median step
    ms; steps 1-2 of each replayed on CPU tensors from the card's state
    (loss 1e-4, gradients 1e-3 of each leaf's largest, parameters and the
    DINO teacher per ``check_adam_step``, the centre 1e-4); then
    ``VIT_SSL_ORACLE`` for 250 steps (~30 s), its loss trajectory;
14c. quality harness (``phase_quality``): ``fastmode_quality_experiment``
    and ``refinement_quality_experiment`` at 128³ (fos 32) on the random
    ViT-S/8 (per-op blocks) and on 14b's trained weights (fused blocks):
    mIoU, stage times, the launch counters (the attention or fused block,
    similarity, splat, slice and blur kernels must have run); ``ntf_predict``
    (fp32) through the kernels vs the plain twins on the card, predictions
    apart on at most 1e-3 of the voxels;
14d. multi-device layer (``phase_parallel``), one rank on NCCL: the sharded
    extraction (128³, fos 64, bf16) and similarity ``torch.equal`` to the
    plain ones, the pipeline forward with one stage (equal with one
    microbatch; 1e-5 of max|ref| with two) and the tensor-parallel forward
    with ``model=1`` (1e-5) against the plain forward, ``infer
    --data-parallel`` under the one-rank group writing phase 6's artifact;
    then two ranks on the one card over gloo with CUDA tensors, their
    results held at 1e-5 (an error in either rank fails the phase);
15. with ``--profile`` only: torch.profiler traces of a warm 128³
    extraction (per-op blocks and fused blocks), of three requests, of
    three refined requests (their refine cores captured beforehand) and of
    one PAWS and one dense trainer step at 128³ (device busy time, idle
    share, top kernels), and the three refined requests once more with
    Python stacks: every pageable host-to-device copy with its source.

On CUDA tensors every bilateral solve in a kernel form and every refine
core of ``refine_similarities_batched`` go through the graph cache
(``utils/cuda_graphs.py``): a key's first call runs eager, its second
captures and replays, later calls replay. The launch counters count the
kernels an eager call or a replay runs; a capture launches none.
With ``--ptxas`` phase 1 also prints every kernel's registers, shared memory,
spills and performance warnings.

Every phase raises on failure. The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it is a JSON object with
one entry per kernel. Without a visible CUDA device the script exits 1 and
prints no result. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import datetime
import functools
import io
import json
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from vittf_tpu_torch import kernels
from vittf_tpu_torch.cli import infer, predict_ntf, serve
from vittf_tpu_torch.core.io import load_features
from vittf_tpu_torch.models import vit as vit_module
from vittf_tpu_torch.models.dino import resolve_model
from vittf_tpu_torch.models.vit import VisionTransformer, init_vit_params
from vittf_tpu_torch.ops.bilateral_sparse import apply_bilateral_solver3d_rgb
from vittf_tpu_torch.ops.query import resample_topk
from vittf_tpu_torch.pipeline.annotations import sample_uniform
from vittf_tpu_torch.pipeline.baselines import compose_features, sample_train_data, svm_predict_device
from vittf_tpu_torch.pipeline.compare_sampling import compare_sampling_strategies, normalize_features
from vittf_tpu_torch.ops.attention import attention, attention_plain, multi_head_attention
from vittf_tpu_torch.ops.bilateral import (
    _bilateral_solve_eager,
    _blocked_pixel_view,
    _blur,
    _grid_extents,
    _lattice_solve,
    _launch,
    _luma_bins,
    _vertex_ids,
    apply_bilateral_solver2d,
    bilateral_solve_gray,
    bilateral_solve_gray_batched,
    bls_blur,
    bls_reblock,
    bls_reblock_plain,
    bls_slice,
    bls_slice_blocked,
    bls_slice_blocked_plain,
    bls_slice_plain,
    bls_splat,
    bls_splat_blocked,
    bls_splat_blocked_plain,
    bls_splat_plain,
    bls_unreblock,
    bls_unreblock_plain,
)
from vittf_tpu_torch.ops.chain_gemm import MODES as CHAIN_MODES
from vittf_tpu_torch.ops.chain_gemm import chain_gemm, chain_gemm_plain, wrap_int8
from vittf_tpu_torch.ops.fused_block import (
    _block_weights,
    fused_block,
    fused_block_plain,
    kernel_buffers,
    launch_kernel,
)
from vittf_tpu_torch.ops.similarity import class_mean_matrix, similarity, similarity_plain
from vittf_tpu_torch.ops.swiglu import swiglu, swiglu_plain
from vittf_tpu_torch.pipeline.annotations import annotations_from_labels
from vittf_tpu_torch.core.synthetic import make_multiclass_volume
from vittf_tpu_torch.models.cnn3d import (
    FeatureExtractorConfig,
    PAWSNetConfig,
    feature_extractor_forward,
    init_pawsnet,
    pawsnet_forward,
)
from vittf_tpu_torch.models.serialization import (
    load_params_npz,
    restore_checkpoint,
    save_checkpoint,
    save_params_npz,
)
from vittf_tpu_torch.models.serialization import checkpoint_steps
from vittf_tpu_torch.train.contrastive import ContrastiveTrainer
from vittf_tpu_torch.train.dense import DenseContrastiveTrainer
from vittf_tpu_torch.train.intra_clr import IntraCLRTrainer
from vittf_tpu_torch.train.losses import infonce_loss, paws_loss
from vittf_tpu_torch.train.paws import PAWSTrainer, _lars_label_fn
from vittf_tpu_torch.train.optim import tree_leaves, tree_map_with_path
from vittf_tpu_torch.train.probe import ProbeConfig, ProbeTrainer
from vittf_tpu_torch.cli import train as train_cli
from vittf_tpu_torch.parallel.extract import extract_features_sharded, similarity_sharded
from vittf_tpu_torch.parallel.mesh import make_mesh, shard_params, tp_vit_forward
from vittf_tpu_torch.parallel.pipeline_parallel import pp_vit_forward
from vittf_tpu_torch.pipeline import quality
from vittf_tpu_torch.train import vit_ssl
from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features
from vittf_tpu_torch.pipeline import refine as refine_module
from vittf_tpu_torch.pipeline import session as session_module
from vittf_tpu_torch.pipeline.ntf import (
    CT_ORG_THRESHOLDS,
    compute_similarities,
    fuse_predictions,
    fuse_predictions_host,
)
from vittf_tpu_torch.pipeline.refine import make_bls_reference, refine_similarities_batched
from vittf_tpu_torch.scripts import bench_int8_gemm
from vittf_tpu_torch.utils.cuda_timing import copy_floor, ten_call_ms
from vittf_tpu_torch.utils.cuda_timing import one_call_ms as cuda_ms
from vittf_tpu_torch.utils import cuda_graphs
from vittf_tpu_torch.utils.tensor import ieee_matmul

ATTN_SHAPE = (8, 6, 4097, 64)  # vits8 at fos 64: 8 slices, 6 heads, 64²+1 tokens
SWIGLU_SHAPE = (32 * 1029, 2 * 4096)  # ViT-g/14-reg's w12 output: batch 32 of 32²+5 tokens
BLOCK_SHAPE = (8, 4097, 384)  # the same slice batch as tokens of width D
LOUD_PEAK, K_SHIFT = 4.0, 80.0  # loud_params' Wq/Wk scale; the row-max case's k-bias scale
SIM_N, SIM_F, SIM_PER_CLASS, SIM_C = 64**3, 384, 256, 5
BLS_SS, BLS_SL, BLS_C = 7, 5, 5  # the refinement's grid (pipeline/refine.py) and 5 classes
BLS_KERNELS = (bls_splat, bls_slice, bls_blur)
BLOCKED_KERNELS = (bls_reblock, bls_unreblock, bls_splat_blocked, bls_slice_blocked)
GRAPHS = cuda_graphs.GRAPHS  # captured solves and refine cores: hits, misses, eager, entries
BLS2D_SS, BLS2D_SL = 24, 4  # the 2-D solver's default grid
# published peaks of one H100 SXM at its full power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
K9_ROWS, K9_DIM, K9_CHAIN = 2048, 1536, 32  # the probe's defaults
K9_BF16_LIMIT = 0.03  # bf16 at chain 32: share of max|ref| (see phase_chain_gemm)


def kernel_entry(err, ms, plain_ms, nbytes, ops, peak, library_ms=None) -> dict:
    """One kernel's measurements with its bound: the larger of the bytes it
    must move (inputs read once, outputs written once) over the memory rate
    and its operations over the peak rate ``peak`` ('bf16' or 'int8' tensor
    cores, or 'fp32' cores)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[peak] * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def poisoned(fn, shape):
    """``fn()`` right after a NaN-filled fp32 block of ``shape`` went back to
    the allocator, which hands it to the next output of that size: an
    element the kernel leaves unwritten then shows as NaN, not as an earlier
    result."""
    torch.full(shape, float("nan"), device="cuda")
    return fn()


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
    """K1 against its plain twin. bf16 is held at 0.05·max|ref| (scores and p
    round at other places) and at 0.02·max|ref| to the twin run in fp32 on the
    same values, fp32 at 2e-5. Beside the main path's shape: one
    partial tile (N = 17), exact tiles (64, 128: one key tile, one query
    tile), one key and one query past a tile (65, 129), the main path's 4097
    (ragged by one in both), and peaked softmaxes (q scaled by 8: a row's
    mass sits on a few keys and the running max moves from tile to tile, so
    a wrong max or a missed rescale shows). Each bf16 result must equal its
    repeat."""
    results = {}
    cases = [(ATTN_SHAPE, torch.bfloat16, 1.0), (ATTN_SHAPE, torch.float32, 1.0),
             ((2, 6, 17, 64), torch.float32, 1.0)]
    cases += [((2, 6, n, 64), torch.bfloat16, q_scale)
              for n in (17, 64, 65, 128, 129) for q_scale in (1.0, 8.0)]
    cases += [((2, 6, 4097, 64), torch.bfloat16, 8.0)]
    for shape, dtype, q_scale in cases:
        q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype) for _ in range(3))
        q = q * q_scale
        got, want = attention(q, k, v), attention_plain(q, k, v)
        torch.cuda.synchronize()
        name = f"attention {str(dtype)[6:]} {shape} q x {q_scale}"
        if dtype == torch.bfloat16:
            # the sharper yardstick: the twin in fp32 on the same bf16 values
            # (the bf16 twin rounds its scores to bf16, the kernel keeps them
            # fp32; on peaked rows that rounding is the twin's own error, so
            # those are held to the fp32 twin alone)
            exact = attention_plain(q.float(), k.float(), v.float())
            err32 = check_rel(f"{name} vs the fp32 twin", got, exact, 0.02)
            err = check_rel(name, got, want, 0.05) if q_scale == 1.0 else err32
            assert_equal(f"{name}: repeat", attention(q, k, v), got)
            print(f"{name}: max_abs_err to the fp32 twin {err32}, bf16 twin to fp32 twin "
                  f"{(want.float() - exact).abs().max().item()}")
            del exact
        else:
            err = check_close(name, got, want, 2e-5, 2e-5)
        if shape != ATTN_SHAPE:
            print(f"{name}: max_abs_err {err} max|ref| {want.float().abs().max().item()}")
            continue
        ms, plain_ms = cuda_ms(lambda: attention(q, k, v)), cuda_ms(lambda: attention_plain(q, k, v))
        print(f"{name}: max_abs_err {err} kernel {ms} ms plain {plain_ms} ms")
        results[dtype] = (err, ms, plain_ms, q, k, v)
    # the main path's layout: q/k/v as strided views of the fused (B, N, 3D)
    # qkv buffer, output written head-merged
    B, H, N, hd = ATTN_SHAPE
    qkv = torch.randn((B, N, 3 * H * hd), generator=gen).to("cuda")
    got = multi_head_attention(qkv, H)
    want = multi_head_attention(qkv, H, impl="plain")
    err = check_close(f"attention fp32 fused qkv {tuple(qkv.shape)}", got, want, 2e-5, 2e-5)
    print(f"attention fused qkv {tuple(qkv.shape)} float32: max_abs_err {err}")
    qkv = qkv.bfloat16()
    got = multi_head_attention(qkv, H)
    err = check_rel(f"attention bf16 fused qkv {tuple(qkv.shape)}", got,
                    multi_head_attention(qkv, H, impl="plain"), 0.05)
    ms = cuda_ms(lambda: multi_head_attention(qkv, H))
    print(f"attention fused qkv {tuple(qkv.shape)} bfloat16: max_abs_err {err} kernel {ms} ms")
    err, ms, plain_ms, q, k, v = results[torch.bfloat16]
    # the yardstick: one library call on the same inputs, used nowhere in the port
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    flops = 4 * B * H * N * N * hd
    print(f"attention {ATTN_SHAPE} bfloat16: scaled_dot_product_attention {lib_ms} ms; kernel "
          f"{flops / ms / 1e9} TFLOP/s, library {flops / lib_ms / 1e9} TFLOP/s; float32 kernel "
          f"{results[torch.float32][1]} ms")
    return kernel_entry(err, ms, plain_ms, nbytes=4 * q.numel() * q.element_size(),
                        ops=flops, peak="bf16", library_ms=lib_ms)


def similarity_case(gen, n, a_counts, f=SIM_F):
    """Clustered features (class centers + noise) so that in-class scores sit
    above the 0.25 threshold and cross-class scores below it: (feats (n, f),
    queries, class-mean matrix) on the card, ``a_counts[c]`` annotations
    drawn from the voxels of class c."""
    C = len(a_counts)
    labels = torch.randint(0, C, (n,), generator=gen)
    centers = torch.randn(C, f, generator=gen) / f**0.5
    feats = centers[labels] + 0.5 * torch.randn(n, f, generator=gen) / f**0.5
    picks = torch.cat([torch.nonzero(labels == c)[:k, 0] for c, k in enumerate(a_counts)])
    if len(picks) != sum(a_counts):
        raise AssertionError("similarity_case: a class has too few voxels")
    m = torch.from_numpy(class_mean_matrix(list(a_counts), len(picks)))
    return feats.to("cuda"), feats[picks].to("cuda"), m.to("cuda")


def phase_similarity(gen):
    """K2 against its plain twin (IEEE fp32 both) at the request's shape, both
    ``mean_first`` modes, and at the edges of its tiling: annotations short of
    one chunk (70) and past ten (1290), voxels short of a tile, one class and
    the 32 the kernel allows (which takes the 96-voxel tile at F = 384), wide
    features (F = 768: the 64-voxel tile) and F not a multiple of the slab
    (F = 36). Every result must equal its repeat: K2 has no atomics."""
    feats, queries, m = similarity_case(gen, SIM_N, [SIM_PER_CLASS] * SIM_C)
    out = None
    for mean_first in (False, True):
        def run_kernel():
            return similarity(feats, queries, m, mean_first=mean_first, out_layout="cn")

        def run_plain():
            return similarity_plain(feats, queries, m, mean_first=mean_first, out_layout="cn")

        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        err = check_close(f"similarity mean_first={mean_first}", got, want, 1e-4, 1e-5)
        assert_equal(f"similarity mean_first={mean_first}: repeat", run_kernel(), got)
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
        flops = 2 * SIM_N * queries.shape[0] * (SIM_F + SIM_C)
        print(f"similarity ({SIM_N}, {SIM_F}) x ({queries.shape[0]}, {SIM_F}) C={SIM_C} "
              f"mean_first={mean_first}: max_abs_err {err} max|ref| "
              f"{want.abs().max().item()} kernel {ms} ms ({flops / ms / 1e9} TFLOP/s) "
              f"plain {plain_ms} ms")
        # the score product and the class contraction, in IEEE fp32; no one
        # library call computes the function (the plain twin is a cuBLAS
        # product plus elementwise passes)
        out = out or kernel_entry(
            err, ms, plain_ms, nbytes=4 * (feats.numel() + queries.numel() + m.numel()
                                           + SIM_C * SIM_N),
            ops=flops, peak="fp32")
    for n, a_counts, f in ((1000, [70], SIM_F), (4099, [258] * 5, SIM_F), (777, [3] * 32, SIM_F),
                           (2049, [40] * 7, SIM_F), (1000, [50, 20], 768), (300, [33, 37], 36)):
        fe, qu, mm = similarity_case(gen, n, a_counts, f)
        for mean_first in (False, True):
            got = similarity(fe, qu, mm, mean_first=mean_first)
            want = similarity_plain(fe, qu, mm, mean_first=mean_first)
            name = (f"similarity ({n}, {f}) x ({qu.shape[0]}, {f}) C={len(a_counts)} "
                    f"mean_first={mean_first}")
            err = check_close(name, got, want, 1e-4, 1e-5)
            assert_equal(f"{name}: repeat", similarity(fe, qu, mm, mean_first=mean_first), got)
            if not want.abs().max().item() > 1e-3:
                raise AssertionError(f"{name}: the reference is flat")
            print(f"{name}: max_abs_err {err} max|ref| {want.abs().max().item()}")
    # a class computed alone has the bits it has among other classes (the
    # served session recomputes edited classes alone): K2 contracts in
    # annotation order, and rows of M that are 0 change nothing
    fe, qu, mm = similarity_case(gen, 4099, [258, 70, 290, 33, 258])
    full = similarity(fe, qu, mm, out_layout="cn")
    for c, (lo, hi) in enumerate(((0, 258), (258, 328), (328, 618), (618, 651), (651, 909))):
        alone = similarity(fe, qu[lo:hi].contiguous(), mm[lo:hi, c:c + 1].contiguous(),
                           out_layout="cn")
        assert_equal(f"similarity class {c} alone vs among five", alone[0], full[c])
    print("similarity: each of five classes alone equals its map among the five, bit for bit")
    # scores exactly at the threshold pass it (>=): 0.5·0.5 = 0.25 in even
    # rows, 0.25·0.5 below it in odd rows, both exact in fp32
    fe = torch.zeros((256, 8), device="cuda")
    fe[0::2, 0], fe[1::2, 0] = 0.5, 0.25
    qu = torch.zeros((4, 8), device="cuda")
    qu[:, 0] = 0.5
    mm = torch.full((4, 1), 0.25, device="cuda")
    got = similarity(fe, qu, mm, threshold=0.25, exponent=2.5)
    want = torch.zeros((256, 1), device="cuda")
    want[0::2] = 0.25 ** 2.5
    assert_equal("similarity at the threshold", got, want)
    assert_equal("similarity_plain at the threshold",
                 similarity_plain(fe, qu, mm, threshold=0.25, exponent=2.5), want)
    print("similarity: scores equal to the threshold pass it, kernel and plain")
    return out


def assert_equal(name, got, want):
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: differs from the expected tensor")


def phase_bilateral(gen):
    """K4, K5, K8 and the blocked-form K6a, K6b, K7a, K7b against their plain
    twins on the same inputs. Luma is integer-valued in [0, 255], as the
    uint8 reference the refinement feeds, but for four voxels per class just
    below a bin edge. The splats (K4, K7a) sum every
    vertex in ascending voxel order, so they must equal their plain twins run
    on CPU tensors bit for bit, and their own repeat; the twins on the card
    (atomic ``index_add_``) are held at 1e-5 and their error is printed. The
    slices (K5, K7b) must equal their twins and their repeats, their outputs
    poisoned with NaN first (``poisoned``); ``slice_edge_cases`` holds them
    where their 16-byte runs meet ragged edges.
    Yardsticks: one ``index_add_`` (the splats) and one ``gather`` (the
    slices) on indices made beforehand. Kernels and yardsticks are timed ten
    calls an event pair (``ten_call_ms``: the host's launch path stays off
    the card's clock), with the one-call reading beside it; the plain twins
    one call an event pair."""
    out = {}
    ss, sl = BLS_SS, BLS_SL
    for shape, C in (((128,) * 3, BLS_C), ((61, 47, 53), 2)):
        luma = torch.randint(0, 256, (C,) + shape, generator=gen).float()
        # knife edges: the largest floats below a bin's edge stay in the lower bin
        edges = torch.tensor([5.0, 10.0, 35.0, 255.0])
        luma[:, 0, 0, :4] = torch.nextafter(edges, torch.zeros(4))
        luma = luma.to("cuda")
        t, c = (torch.rand((C,) + shape, generator=gen).to("cuda") for _ in range(2))
        ext = _grid_extents(shape, ss, sl)
        L, n_cells, nverts, vox = ext[-1], int(np.prod(ext[:-1])), int(np.prod(ext)), luma.numel()
        got = bls_splat(luma, t, c, ss, sl)
        # the twin on CPU tensors: index_add_ adds in ascending voxel order
        # there, the order the kernel promises (on the card it is atomic)
        want = bls_splat_plain(luma.cpu(), t.cpu(), c.cpu(), ss, sl).to("cuda")
        if got[:, 0].sum().item() != vox:
            raise AssertionError(f"bls_splat {shape}: counts differ")
        assert_equal(f"bls_splat {shape} vs the plain twin on CPU tensors", got, want)
        assert_equal(f"bls_splat {shape}: repeat", bls_splat(luma, t, c, ss, sl), got)
        splat_err = check_close(f"bls_splat {shape} vs the plain twin on the card", got,
                                bls_splat_plain(luma, t, c, ss, sl), 1e-5, 1e-6)
        lat = torch.randn((C,) + ext, generator=gen).to("cuda")
        yl = lat.reshape(C, -1, L)
        sliced = poisoned(lambda: bls_slice(luma, yl, ss, sl), luma.shape)
        assert_equal(f"bls_slice {shape}", sliced, bls_slice_plain(luma, yl, ss, sl))
        assert_equal(f"bls_slice {shape}: repeat",
                     poisoned(lambda: bls_slice(luma, yl, ss, sl), luma.shape), sliced)
        check_blur(f"{(C,) + ext}", lat, 6)

        # the blocked form on the same planes: bins and t·c are made in torch
        bins, tc = _luma_bins(luma, sl).to(torch.int32), t * c
        il_b, c_b, tc_b = bls_reblock(bins, ss, -1), bls_reblock(c, ss), bls_reblock(tc, ss)
        assert_equal(f"bls_reblock {shape} int32", il_b, bls_reblock_plain(bins, ss, -1))
        assert_equal(f"bls_reblock {shape} fp32", tc_b, bls_reblock_plain(tc, ss))
        assert_equal(f"bls_unreblock {shape}", bls_unreblock(c_b, ss, shape), c)
        assert_equal(f"bls_unreblock {shape} vs plain", bls_unreblock(il_b, ss, shape),
                     bls_unreblock_plain(il_b, ss, shape))
        got_b = bls_splat_blocked(il_b, c_b, tc_b, L, ss)
        want_b = bls_splat_blocked_plain(il_b.cpu(), c_b.cpu(), tc_b.cpu(), L, ss).to("cuda")
        assert_equal(f"bls_splat_blocked {shape} vs the plain twin on CPU tensors", got_b, want_b)
        assert_equal(f"bls_splat_blocked {shape}: repeat",
                     bls_splat_blocked(il_b, c_b, tc_b, L, ss), got_b)
        assert_equal(f"bls_splat_blocked {shape} counts vs bls_splat", got_b[:, 0], got[:, 0])
        splat_b_err = check_close(f"bls_splat_blocked {shape} vs the plain twin on the card",
                                  got_b, bls_splat_blocked_plain(il_b, c_b, tc_b, L, ss),
                                  1e-5, 1e-6)
        sliced_b = poisoned(lambda: bls_slice_blocked(il_b, yl, ss), il_b.shape)
        assert_equal(f"bls_slice_blocked {shape}", sliced_b, bls_slice_blocked_plain(il_b, yl, ss))
        assert_equal(f"bls_slice_blocked {shape}: repeat",
                     poisoned(lambda: bls_slice_blocked(il_b, yl, ss), il_b.shape), sliced_b)
        assert_equal(f"blocked slice + unreblock {shape} vs bls_slice",
                     bls_unreblock(sliced_b, ss, shape), sliced)

        vid = _vertex_ids(shape, luma, ss, sl)[0]
        flat_ids = (vid + torch.arange(C, device="cuda").reshape((C, 1, 1, 1)) * nverts).reshape(-1)
        src = torch.stack([torch.ones_like(c), c, tc], dim=-1).reshape(-1, 3)
        acc = torch.zeros((C * nverts, 3), device="cuda")
        vid_b = (il_b.long().clamp(min=0)
                 + torch.arange(n_cells, device="cuda").repeat_interleave(ss)[None, :, None] * L)
        flat_ids_b = (vid_b + torch.arange(C, device="cuda").reshape(C, 1, 1) * nverts).reshape(-1)
        src_b = torch.stack([(il_b >= 0).float(), c_b, tc_b], dim=-1).reshape(-1, 3)
        calls = (  # the kernels and their yardsticks
            ("bls_splat", lambda: bls_splat(luma, t, c, ss, sl)),
            ("index_add_", lambda: acc.zero_().index_add_(0, flat_ids, src)),
            ("bls_slice", lambda: bls_slice(luma, yl, ss, sl)),
            ("gather", lambda: torch.gather(yl.reshape(C, -1), 1, vid.reshape(C, -1))),
            ("bls_blur", lambda: bls_blur(lat)),
            ("copy_blur", copy_floor(lat.numel())),
            ("bls_reblock", lambda: bls_reblock(c, ss)),
            ("copy_reblock", copy_floor((vox + il_b.numel()) // 2)),
            ("bls_unreblock", lambda: bls_unreblock(c_b, ss, shape)),
            ("copy_unreblock", copy_floor((vox + il_b.numel()) // 2)),
            ("bls_splat_blocked", lambda: bls_splat_blocked(il_b, c_b, tc_b, L, ss)),
            ("index_add_blocked", lambda: acc.zero_().index_add_(0, flat_ids_b, src_b)),
            ("bls_slice_blocked", lambda: bls_slice_blocked(il_b, yl, ss)),
            ("gather_blocked", lambda: torch.gather(yl.reshape(C, -1), 1, vid_b.reshape(C, -1))),
        )
        times = {name: ten_call_ms(fn) for name, fn in calls}
        one = {name: cuda_ms(fn) for name, fn in calls}
        times.update({name: cuda_ms(fn) for name, fn in (
            ("bls_splat_plain", lambda: bls_splat_plain(luma, t, c, ss, sl)),
            ("bls_slice_plain", lambda: bls_slice_plain(luma, yl, ss, sl)),
            ("bls_blur_plain", lambda: _blur(lat)),
            ("bls_reblock_plain", lambda: bls_reblock_plain(c, ss)),
            ("bls_unreblock_plain", lambda: bls_unreblock_plain(c_b, ss, shape)),
            ("bls_splat_blocked_plain", lambda: bls_splat_blocked_plain(il_b, c_b, tc_b, L, ss)),
            ("bls_slice_blocked_plain", lambda: bls_slice_blocked_plain(il_b, yl, ss)),
        )})

        def ms(name):  # ten calls an event pair, and one call
            return f"{times[name]} ms (one call {one[name]})"

        print(f"bilateral kernels {shape} C={C} lattice {ext}: splat equal to the twin on CPU "
              f"tensors (the twin on the card is off by {splat_err}) "
              f"kernel {ms('bls_splat')} plain {times['bls_splat_plain']} ms index_add_ "
              f"{ms('index_add_')}; slice exact kernel {ms('bls_slice')} plain "
              f"{times['bls_slice_plain']} ms gather {ms('gather')}; blur exact kernel "
              f"{ms('bls_blur')} plain {times['bls_blur_plain']} ms copy floor "
              f"{ms('copy_blur')}")
        print(f"blocked kernels {shape} C={C} rows {tuple(il_b.shape[1:])}: reblock exact kernel "
              f"{ms('bls_reblock')} plain {times['bls_reblock_plain']} ms copy floor "
              f"{ms('copy_reblock')}; unreblock exact "
              f"kernel {ms('bls_unreblock')} plain {times['bls_unreblock_plain']} ms copy floor "
              f"{ms('copy_unreblock')}; "
              f"blocked splat equal to the twin on CPU tensors (the twin on the card is off by "
              f"{splat_b_err}) kernel {ms('bls_splat_blocked')} "
              f"plain {times['bls_splat_blocked_plain']} ms index_add_ "
              f"{ms('index_add_blocked')}; blocked slice exact kernel "
              f"{ms('bls_slice_blocked')} plain {times['bls_slice_blocked_plain']} ms "
              f"gather {ms('gather_blocked')}")
        slots, lattice = il_b.numel(), C * nverts
        out = out or {
            # bytes: each input plane read once, each output written once (fp32)
            # the splats' error is to the plain twin on CPU tensors: equal
            "bls_splat": kernel_entry(0.0, times["bls_splat"], times["bls_splat_plain"],
                                      4 * (3 * vox + 3 * lattice), 4 * vox, "fp32",
                                      times["index_add_"]),
            "bls_slice": kernel_entry(0.0, times["bls_slice"], times["bls_slice_plain"],
                                      4 * (2 * vox + lattice), vox, "fp32", times["gather"]),
            "bls_blur": kernel_entry(0.0, times["bls_blur"], times["bls_blur_plain"],
                                     4 * 2 * lattice, 9 * lattice, "fp32"),
            "bls_reblock": kernel_entry(0.0, times["bls_reblock"], times["bls_reblock_plain"],
                                        4 * (vox + slots), 0, "fp32"),
            "bls_unreblock": kernel_entry(0.0, times["bls_unreblock"],
                                          times["bls_unreblock_plain"], 4 * (slots + vox), 0,
                                          "fp32"),
            "bls_splat_blocked": kernel_entry(
                0.0, times["bls_splat_blocked"], times["bls_splat_blocked_plain"],
                4 * (3 * slots + 3 * lattice), 3 * slots, "fp32", times["index_add_blocked"]),
            "bls_slice_blocked": kernel_entry(
                0.0, times["bls_slice_blocked"], times["bls_slice_blocked_plain"],
                4 * (2 * slots + lattice), slots, "fp32", times["gather_blocked"]),
        }
    slice_edge_cases(gen)
    blur_edge_cases(gen)
    blur_lattice_rows(gen)
    reblock_edge_cases(gen)
    phase_blocked_2d_kernels(gen)
    # a 2-D solve: the blocked kernels take it with one row per cell (blur dim 5)
    img = torch.randint(0, 256, (96, 80), generator=gen).float().to("cuda")
    t2, c2 = (torch.rand((96, 80), generator=gen).to("cuda") for _ in range(2))
    kw = dict(sigma_spatial=3, sigma_luma=8, blur_dim=5)
    err = check_close("2-D solve", bilateral_solve_gray(t2, img, c2, **kw),
                      bilateral_solve_gray(t2, img, c2, pixel_impl="scatter", **kw), 1e-4, 1e-5)
    print(f"2-D bilateral solve (96, 80) kernels vs plain: max_abs_err {err}")
    return out


def check_blur(name, lat, blur_dim):
    """K8 on ``lat`` bit-equal to ``_blur`` run on CPU tensors and on the
    card and to its own repeat, outputs poisoned with NaN first (a vertex the
    kernel skips shows); the same for ``lat`` copied to a base one word past
    a 16-byte boundary."""
    got = poisoned(lambda: bls_blur(lat, blur_dim), lat.shape)
    assert_equal(f"bls_blur {name} vs the plain twin on CPU tensors", got,
                 _blur(lat.cpu(), blur_dim).to("cuda"))
    assert_equal(f"bls_blur {name} vs the plain twin on the card", got, _blur(lat, blur_dim))
    assert_equal(f"bls_blur {name}: repeat",
                 poisoned(lambda: bls_blur(lat, blur_dim), lat.shape), got)
    off = torch.empty(lat.numel() + 1, device="cuda")[1:].view(lat.shape)
    off.copy_(lat)
    assert_equal(f"bls_blur {name}, input off a 16-byte boundary",
                 poisoned(lambda: bls_blur(off, blur_dim), lat.shape), got)


def blur_edge_cases(gen):
    """K8 where its 16-byte runs meet edges: L 37 (runs cross x boundaries),
    52 and 64; X 1, 3 and 19; lattices of rank 4 with Z = 1 or Y = 1, of rank
    3 and 2; one class and five (classes that start off a 16-byte boundary);
    blur dim 5; values with zeros of both signs. Each through ``check_blur``."""
    cases = (((5, 19, 19, 19, 37), 6), ((1, 7, 3, 1, 52), 6), ((5, 4, 6, 3, 37), 6),
             ((1, 1, 5, 19, 64), 6), ((5, 3, 1, 19, 37), 6), ((1, 2, 2, 1, 37), 6),
             ((5, 9, 3, 37), 5), ((1, 19, 19, 64), 5), ((5, 19, 37), 6), ((1, 3, 52), 5),
             ((5, 1, 1, 1, 37), 6))
    for ext, blur_dim in cases:
        lat = torch.randn(ext, generator=gen)
        lat[lat.abs() < 0.1] = 0.0
        lat[(lat.abs() > 0.1) & (lat.abs() < 0.2)] = -0.0
        check_blur(f"{ext} dim {blur_dim}", lat.to("cuda"), blur_dim)
    print(f"blur edge cases: K8 bit-equal to its twin on CPU tensors and on the card and to its "
          f"repeat on {len(cases)} lattices (L 37 / 52 / 64, X 1 / 3 / 19, ranks 2-4, 1 or 5 "
          "classes, blur dim 5, inputs off a 16-byte boundary)")


def blur_lattice_rows(gen):
    """K8 at the lattices of the whole-grid refinement (phase 9: a 256³ grid at
    σ_s 7, σ_l 5, as many classes as one chunk of ``refine_similarities_batched``
    holds: a 42 MB lattice, 84 MB moved, beyond the 50 MB L2) and of the 2-D solver
    (2048² at σ_s 24, σ_l 4, blur dim 5): bit-equal through ``check_blur``,
    timed ten calls an event pair beside a copy floor of the same bytes."""
    chunk = 70_000_000 // 256**3  # pipeline/refine.py: VITTF_BLS_CHUNK_VOXELS // crop voxels
    for name, ext, blur_dim in (
            ("whole-grid", (chunk,) + _grid_extents((256,) * 3, BLS_SS, BLS_SL), 6),
            ("2-D solver", (1,) + _grid_extents((2048, 2048), BLS2D_SS, BLS2D_SL), 5)):
        lat = torch.randn(ext, generator=gen).to("cuda")
        check_blur(f"{name} {ext}", lat, blur_dim)
        nbytes = 8 * lat.numel()
        kernel = ten_call_ms(lambda: bls_blur(lat, blur_dim))
        floor = ten_call_ms(copy_floor(lat.numel()))
        print(f"blur {name} lattice {ext} ({nbytes / 1e6} MB moved): exact kernel {kernel} ms, "
              f"copy floor {floor} ms, bound {nbytes / HBM_BYTES_PER_S * 1e3} ms")


def reblock_edge_cases(gen):
    """K6a and K6b equal to their twins, outputs poisoned with NaN first, at
    X % 4 = 0, 1, 2 and 3 (16-byte accesses or one word at a time), σ_s 4 and
    7, one class and two, int32 (K6a with fill -1) and fp32 (fill 0). K6b
    reads blocked arrays drawn whole, so a padded slot it wrongly writes
    shows. With X % 4 = 0: K6a's input and K6b's input off a 16-byte
    boundary (the tile's lead), and K6b's output off one (its C entry called
    on an output view: one word at a time)."""
    n = 0
    for shape in ((9, 13, 20), (10, 6, 1), (7, 11, 18), (13, 5, 23), (15, 9, 22)):
        for ss in (4, 7):
            for B in (1, 2):
                bins = torch.randint(0, 60, (B,) + shape, generator=gen, dtype=torch.int32)
                vals = torch.rand((B,) + shape, generator=gen)
                for x, fill in ((bins.to("cuda"), -1), (vals.to("cuda"), 0)):
                    name = f"{B} x {shape} ss {ss} {x.dtype}"
                    out_shape = bls_reblock_plain(x, ss, fill).shape
                    got = poisoned(lambda: bls_reblock(x, ss, fill), out_shape)
                    assert_equal(f"bls_reblock {name}", got, bls_reblock_plain(x, ss, fill))
                    xb = (torch.randint(-60, 60, out_shape, generator=gen, dtype=torch.int32)
                          if x.dtype == torch.int32 else torch.rand(out_shape, generator=gen))
                    xb = xb.to("cuda")
                    back = poisoned(lambda: bls_unreblock(xb, ss, shape), x.shape)
                    assert_equal(f"bls_unreblock {name}", back, bls_unreblock_plain(xb, ss, shape))
                    n += 2
                    if shape[2] % 4 == 0:
                        off, off_b = (torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:]
                                      .view(t.shape).copy_(t) for t in (x, xb))
                        assert_equal(f"bls_reblock {name}, input off a 16-byte boundary",
                                     poisoned(lambda: bls_reblock(off, ss, fill), out_shape), got)
                        assert_equal(f"bls_unreblock {name}, input off a 16-byte boundary",
                                     poisoned(lambda: bls_unreblock(off_b, ss, shape), x.shape),
                                     back)
                        out = torch.full((x.numel() + 1,), float("nan"), device="cuda")
                        out = out.view(x.dtype)[1:].view(x.shape)
                        _launch("vittf_bls_unreblock", xb.device, xb.data_ptr(), out.data_ptr(),
                                B, *shape, ss)
                        assert_equal(f"bls_unreblock {name}, output off a 16-byte boundary",
                                     out, back)
                        n += 3
    print(f"reblock edge cases: K6a and K6b equal to their twins on {n} cases (X % 4 = 0-3, "
          "sigma_s 4 and 7, 1 or 2 classes, int32 and fp32, inputs and K6b's output off a "
          "16-byte boundary)")


def slice_edge_cases(gen):
    """K5 and K7b where their 16-byte runs meet ragged edges: classes of 1 to
    7 voxels, rows of 1 to 5, classes that start off a 16-byte boundary,
    65 535 classes (the grid's y extent), one cell a class, ranks 1 and 2,
    inputs that start off a 16-byte boundary; and sigma_luma 7, where voxels
    just below a bin edge go to the next bin under a reciprocal multiply (at
    5 no fp32 luma does), placed at each class's first and last voxels. Each
    slice equals its plain twin and its repeat, outputs poisoned with NaN;
    K4 equals its twin on CPU tensors on the same inputs."""
    cases = (((1, 1, 1), 3, 1, 5), ((1, 2, 3), 3, 2, 5), ((3, 5, 7), 2, 7, 7),
             ((2, 3, 130), 4, 3, 7), ((29, 31, 43), 3, 7, 7), ((37,), 2, 4, 5),
             ((9, 11), 3, 24, 4), ((1, 1, 3), 65535, 1, 5))
    for shape, C, ss, sl in cases:
        luma = torch.randint(0, 256, (C,) + shape, generator=gen).float().reshape(C, -1)
        edges = torch.tensor([float(sl * k) for k in (1, 2, 4, 7)] + [255.0])
        knife = torch.nextafter(edges, torch.zeros(len(edges)))
        k = min(luma.shape[1], len(knife))
        luma[:, :k], luma[:, -k:] = knife[:k], knife[-k:]
        luma = luma.reshape((C,) + shape).to("cuda")
        t, c = (torch.rand((C,) + shape, generator=gen).to("cuda") for _ in range(2))
        ext = _grid_extents(shape, ss, sl)
        yl = torch.randn((C, int(np.prod(ext[:-1])), ext[-1]), generator=gen).to("cuda")
        name = f"{C} x {shape} sigma ({ss}, {sl})"
        sliced = poisoned(lambda: bls_slice(luma, yl, ss, sl), luma.shape)
        assert_equal(f"bls_slice {name}", sliced, bls_slice_plain(luma, yl, ss, sl))
        assert_equal(f"bls_slice {name}: repeat",
                     poisoned(lambda: bls_slice(luma, yl, ss, sl), luma.shape), sliced)
        assert_equal(f"bls_splat {name} vs the plain twin on CPU tensors",
                     bls_splat(luma, t, c, ss, sl),
                     bls_splat_plain(luma.cpu(), t.cpu(), c.cpu(), ss, sl).to("cuda"))
        bins = _luma_bins(luma, sl).to(torch.int32)
        if len(shape) == 3:
            il_b, groups = bls_reblock(bins, ss, -1), ss
        else:
            il_b, groups = _blocked_pixel_view(bins, ss, ext[:-1], -1).contiguous(), 1
        sliced_b = poisoned(lambda: bls_slice_blocked(il_b, yl, groups), il_b.shape)
        assert_equal(f"bls_slice_blocked {name}", sliced_b,
                     bls_slice_blocked_plain(il_b, yl, groups))
        assert_equal(f"bls_slice_blocked {name}: repeat",
                     poisoned(lambda: bls_slice_blocked(il_b, yl, groups), il_b.shape), sliced_b)
        if len(shape) == 3:
            assert_equal(f"blocked slice + unreblock {name} vs bls_slice",
                         bls_unreblock(sliced_b, ss, shape), sliced)
        # inputs one word past a 16-byte boundary (the wrappers align a copy)
        lu_off = torch.empty(luma.numel() + 1, device="cuda")[1:].view(luma.shape)
        lu_off.copy_(luma)
        il_off = torch.empty(il_b.numel() + 1, dtype=il_b.dtype, device="cuda")[1:].view(il_b.shape)
        il_off.copy_(il_b)
        assert_equal(f"bls_slice {name}, luma off a 16-byte boundary",
                     bls_slice(lu_off, yl, ss, sl), sliced)
        assert_equal(f"bls_slice_blocked {name}, bins off a 16-byte boundary",
                     bls_slice_blocked(il_off, yl, groups), sliced_b)
    print(f"slice edge cases: K5 and K7b equal their twins and repeats on {len(cases)} cases "
          "(classes of 1-7 voxels, misaligned classes and inputs, 65 535 classes, ranks 1-3, "
          "knife edges at sigma_luma 7)")


def phase_blocked_2d_kernels(gen):
    """K7a and K7b with one row per cell (G = 1) at the 2-D solver's default
    grid on a 2048 x 2048 image: 86 x 86 cells of 576 pixel slots, 64 bins.
    Timed as ``phase_bilateral`` times, K7b beside one ``gather`` on indices
    made beforehand."""
    ss, sl, shape = BLS2D_SS, BLS2D_SL, (2048, 2048)
    ext = _grid_extents(shape, ss, sl)
    sp_ext, L = ext[:-1], ext[-1]
    luma = torch.randint(0, 256, (1,) + shape, generator=gen).float().to("cuda")
    t, c = (torch.rand((1,) + shape, generator=gen).to("cuda") for _ in range(2))
    il_b = _blocked_pixel_view(_luma_bins(luma, sl).to(torch.int32), ss, sp_ext, -1).contiguous()
    c_b = _blocked_pixel_view(c, ss, sp_ext).contiguous()
    tc_b = _blocked_pixel_view(t * c, ss, sp_ext).contiguous()
    got = bls_splat_blocked(il_b, c_b, tc_b, L)
    want = bls_splat_blocked_plain(il_b.cpu(), c_b.cpu(), tc_b.cpu(), L).to("cuda")
    assert_equal("bls_splat_blocked 2-D vs the plain twin on CPU tensors", got, want)
    assert_equal("bls_splat_blocked 2-D: repeat", bls_splat_blocked(il_b, c_b, tc_b, L), got)
    if got[:, 0].sum().item() != luma.numel():
        raise AssertionError("bls_splat_blocked 2-D: fill slots were counted")
    err = check_close("bls_splat_blocked 2-D vs the plain twin on the card", got,
                      bls_splat_blocked_plain(il_b, c_b, tc_b, L), 1e-5, 1e-6)
    yl = torch.randn((1, il_b.shape[1], L), generator=gen).to("cuda")
    sliced = poisoned(lambda: bls_slice_blocked(il_b, yl), il_b.shape)
    assert_equal("bls_slice_blocked 2-D", sliced, bls_slice_blocked_plain(il_b, yl))
    assert_equal("bls_slice_blocked 2-D: repeat",
                 poisoned(lambda: bls_slice_blocked(il_b, yl), il_b.shape), sliced)
    vid = (il_b.long().clamp(min=0)
           + torch.arange(il_b.shape[1], device="cuda")[None, :, None] * L).reshape(1, -1)
    calls = (("splat", lambda: bls_splat_blocked(il_b, c_b, tc_b, L)),
             ("slice", lambda: bls_slice_blocked(il_b, yl)),
             ("gather", lambda: torch.gather(yl.reshape(1, -1), 1, vid)))
    ms = {name: ten_call_ms(fn) for name, fn in calls}
    one = {name: cuda_ms(fn) for name, fn in calls}
    ms.update({name: cuda_ms(fn) for name, fn in (
        ("splat_plain", lambda: bls_splat_blocked_plain(il_b, c_b, tc_b, L)),
        ("slice_plain", lambda: bls_slice_blocked_plain(il_b, yl)),
    )})
    slots = il_b.numel()
    bound = kernel_entry(0.0, ms["slice"], ms["slice_plain"], 4 * (2 * slots + yl.numel()),
                         slots, "fp32")["bound_ms"]
    print(f"blocked kernels 2-D {shape} sigma ({ss}, {sl}) rows {tuple(il_b.shape[1:])} L={L}: "
          f"splat equal to the twin on CPU tensors (the twin on the card is off by {err}) kernel "
          f"{ms['splat']} ms (one call {one['splat']}) plain {ms['splat_plain']} ms; "
          f"slice exact kernel {ms['slice']} ms (one call {one['slice']}) plain "
          f"{ms['slice_plain']} ms gather {ms['gather']} ms (one call {one['gather']}); "
          f"slice bound {bound} ms")


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


K3_LAUNCHES = ("LN1+qkv", "attention", "proj+residual", "LN2+fc1+GELU", "fc2+residual")


def random_block(gen, D, Hd):
    """Hub-named tensors of one block of width ``D`` with LayerScale, every
    term loud (as ``loud_params``): unit-size products, biases and LayerNorm
    shifts N(0, 0.5²), gains 1 + N(0, 0.5²), gammas U(0.35, 1.05)."""
    def normal(*shape, std=0.5):
        return std * torch.randn(shape, generator=gen)

    blk = {"attn.qkv.weight": normal(3 * D, D, std=D**-0.5), "attn.qkv.bias": normal(3 * D),
           "attn.proj.weight": normal(D, D, std=D**-0.5), "attn.proj.bias": normal(D),
           "mlp.fc1.weight": normal(Hd, D, std=D**-0.5), "mlp.fc1.bias": normal(Hd),
           "mlp.fc2.weight": normal(D, Hd, std=Hd**-0.5), "mlp.fc2.bias": normal(D)}
    for n in ("norm1", "norm2"):
        blk[n + ".weight"], blk[n + ".bias"] = 1 + normal(D), normal(D)
    for n in ("ls1.gamma", "ls2.gamma"):
        blk[n] = 0.35 + 0.7 * torch.rand(D, generator=gen)
    return {k: v.to("cuda", torch.bfloat16) for k, v in blk.items()}


def fused_launch_ms(x, blk, H, softmax_max):
    """ms of each of K3's five launches run alone, on buffers that a whole
    run of the block has filled, ten launches an event pair (``ten_call_ms``)."""
    w = _block_weights(blk, H, x.dtype)
    bufs = kernel_buffers(x, w)
    launch_kernel(x, w, bufs, x.shape[1], H, softmax_max)
    return [ten_call_ms(lambda m=1 << i: launch_kernel(x, w, bufs, x.shape[1], H, softmax_max, m))
            for i in range(len(K3_LAUNCHES))]


def phase_fused_block(gen):
    """K3 against its plain twin at the main path's slice batch. Timed on
    ViT-S/8 block 0 (``init_vit_params`` seed (0, 0)), the block and each of
    its five launches alone; held on the loud blocks of ``loud_params``,
    comparing the branch (out − x), so that a wrong softmax, bias, LayerNorm
    affine, LayerScale or a padded-key leak shows. Limit: 0.02·max|branch|
    (the on-chip contract of tests_tpu/test_kernels_tpu.py, here on the
    branch), everywhere: with and without the row max, at token counts on
    both sides of the kernels' tile edges, at widths 128, 512 and 768, and
    where every p underflows."""
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
    # the underflow case: q = −8·1 and k = 8·1 whatever the token, so every
    # score is −8·8·64·(1/8)·log2(e) = −739 and exp2 gives 0: without the row
    # max the row sum is 0 and the attention output must be 0, not 0·inf
    under = {k: v.detach().clone() for k, v in loud[0].named_parameters()}
    under["attn.qkv.weight"][:768] = 0
    under["attn.qkv.bias"][:384], under["attn.qkv.bias"][384:768] = -8.0, 8.0
    x = (0.5 * torch.randn(BLOCK_SHAPE, generator=gen)).to("cuda", torch.bfloat16)
    xl = (0.1 * torch.randn(BLOCK_SHAPE, generator=gen)).to("cuda", torch.bfloat16)
    if bool(torch.isfinite(fused_block_plain(xl, shifted, H, softmax_max=False)).all()):
        raise AssertionError("the shifted block does not overflow without the row max")
    out = None
    for softmax_max in (False, True):
        blk = shifted if softmax_max else loud[0]
        got = fused_block(xl, blk, H, softmax_max=softmax_max)
        err, lim = check_branch(f"fused_block softmax_max={softmax_max}", got,
                                fused_block_plain(xl, blk, H, softmax_max=softmax_max), xl, 0.02)
        assert_equal(f"fused_block softmax_max={softmax_max}, repeat",
                     fused_block(xl, blk, H, softmax_max=softmax_max), got)
        # four calls an event pair: device time, as a stack of blocks runs it
        ms = ten_call_ms(lambda: fused_block(x, timed[0], H, softmax_max=softmax_max), calls=4)
        plain_ms = cuda_ms(lambda: fused_block_plain(x, timed[0], H, softmax_max=softmax_max))
        each = fused_launch_ms(x, timed[0], H, softmax_max)
        print(f"fused_block {BLOCK_SHAPE} bf16 softmax_max={softmax_max}: "
              f"max_abs_err {err} (limit {lim}, share {err / lim}, "
              f"{'shifted ' if softmax_max else ''}loud block 0), equal to its repeat; "
              f"kernel {ms} ms plain {plain_ms} ms (ViT-S/8 block 0); launches alone "
              f"{dict(zip(K3_LAUNCHES, each))} ms, sum {sum(each)}")
        # four linear products (24·D² flops per token) and the attention
        # (4·N²·D per slice); bytes: tokens in and out, the weights once
        Bb, Nb, Db = BLOCK_SHAPE
        out = out or kernel_entry(
            err, ms, plain_ms, nbytes=2 * (2 * x.numel() + 12 * Db * Db),
            ops=Bb * Nb * 24 * Db * Db + 4 * Bb * Nb * Nb * Db, peak="bf16")
    got = fused_block(xl, under, H, softmax_max=False)
    err, lim = check_branch("fused_block, every p underflows", got,
                            fused_block_plain(xl, under, H, softmax_max=False), xl, 0.02)
    print(f"fused_block {BLOCK_SHAPE} softmax_max=False, every score -739 (row sum 0): "
          f"max_abs_err {err} (limit {lim})")
    # each loud block on the same input: one step each, since bf16 rounding
    # compounds over a stack
    errs = [check_branch(f"fused_block loud block {i}", fused_block(xl, b, H, softmax_max=False),
                         fused_block_plain(xl, b, H, softmax_max=False), xl, 0.02)
            for i, b in enumerate(loud)]
    print(f"fused_block loud blocks 0-10, softmax_max=False: max_abs_err / limit "
          f"{[round(e / lim, 4) for e, lim in errs]}")
    # token counts on both sides of the tile edges (a last key tile of one
    # key, a last row block of one row; 3·N is no multiple of 128), and the
    # widths whose column tiles are 128 wide or whose rows fill the resident
    # block (D = 128: qkv in 192-wide tiles, the rest in 128; D = 512), and a
    # width whose rows no longer fit it (D = 768: every linear streamed)
    shares = {}
    for D, n_tokens in ((384, (64, 65, 127, 129)), (128, (129,)), (512, (129,)), (768, (129,))):
        blk = loud[0] if D == 384 else random_block(gen, D, 4 * D)
        blk_max = shifted if D == 384 else blk
        for n in n_tokens:
            xs = (0.1 * torch.randn((3, n, D), generator=gen)).to("cuda", torch.bfloat16)
            for softmax_max, b in ((False, blk), (True, blk_max)):
                e, lim = check_branch(
                    f"fused_block (3, {n}, {D}) softmax_max={softmax_max}",
                    fused_block(xs, b, D // 64, softmax_max=softmax_max),
                    fused_block_plain(xs, b, D // 64, softmax_max=softmax_max), xs, 0.02)
                shares[(D, n, softmax_max)] = round(e / lim, 4)
    print(f"fused_block (3, N, D) loud blocks, (D, N, softmax_max): max_abs_err / limit {shares}")

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


def check_u8_maps(name, got, want, share=1e-3):
    """uint8 maps agree up to 1 (255 and 0 are neighbours across the
    reference's wraparound at 256) on at most ``share`` of the voxels: a fp32
    difference moves a value across a quantization boundary, and the
    solve's output is constant over each lattice vertex."""
    d = (got.int() - want.int()) % 256
    d = torch.minimum(d, 256 - d)
    n_diff = d.count_nonzero().item()
    if d.max().item() > 1 or n_diff > share * d.numel():
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
    feat_t = torch.from_numpy(load_features(feats_path)).to("cuda")
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
    # (255 and 0 count as neighbours: the reference's cast wraps at 256)
    plain = compute_similarities(vol.shape, feat_t, ann, impl="plain")
    n_diff = sum(check_u8_maps(f"request map {name}", sims[name], plain[name]) for name in sims)
    if tuple(pred_r.shape) != (64, 64, 64):
        raise AssertionError(f"request prediction shape {tuple(pred_r.shape)}")
    print(f"main path: extraction {t_extract} s ({size**3 / t_extract / 1e6} Mvoxel/s, "
          f"infer CLI wall incl. weight init), predict {t_predict} s, "
          f"request p50 {float(np.median(req_s)) * 1e3} ms (each {[s * 1e3 for s in req_s]} ms), "
          f"mIoU {metrics['mIoU']}; last request vs plain: {n_diff} voxels differ by 1")
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


def host_ms(fn):
    """(``fn()``, ms on the host clock between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def capture_parts(label, args, body_fn):
    """The parts of one capture of ``body_fn(*args)`` on the host clock,
    each between two synchronizes: the eager body on the current stream and
    on a side stream (the warm-up of a capture on a key's first call),
    ``torch.cuda.graph``'s entry (synchronize, ``empty_cache``,
    ``_host_emptyCache``), the capture, ``capture_end``
    (instantiation), the first and a second replay, the eager body right
    after the entry emptied the caches and once more warm; then the same
    capture with ``capture_begin`` on the side stream and no entry, and on
    a fresh stream that never ran the body. Each replay is held
    ``torch.equal`` to the eager body."""
    inputs = tuple(a.contiguous() for a in args)
    cur, side = torch.cuda.current_stream(), torch.cuda.Stream()

    def body():
        return body_fn(*inputs)

    def on(stream, fn):
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = host_ms(fn)
        cur.wait_stream(stream)
        return out

    def capture(stream):
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved()
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.capture_begin()
            out = body()
            t1 = time.perf_counter()
            graph.capture_end()
            t2 = time.perf_counter()
        cur.wait_stream(stream)
        return graph, out, (t1 - t0) * 1e3, (t2 - t1) * 1e3, torch.cuda.memory_reserved() - reserved

    want, ms_cur = host_ms(body)
    _, ms_side = on(side, body)
    _, ms_entry = host_ms(lambda: (torch.cuda.synchronize(), torch.cuda.empty_cache(),
                                   torch._C._host_emptyCache()))
    parts = {"eager current stream": ms_cur, "eager side stream": ms_side,
             "graph entry": ms_entry}
    graph, out, parts["capture"], parts["capture_end"], pool = capture(side)
    _, parts["first replay"] = host_ms(graph.replay)
    assert_equal(f"{label}: replay after the entry", out, want)
    _, parts["second replay"] = host_ms(graph.replay)
    _, parts["eager after the entry"] = host_ms(body)
    _, parts["eager warm"] = host_ms(body)
    del graph, out
    graph, out, parts["capture, no entry"], parts["capture_end, no entry"], pool2 = capture(side)
    _, parts["first replay, no entry"] = host_ms(graph.replay)
    assert_equal(f"{label}: replay, capture without the entry", out, want)
    del graph, out
    try:
        graph, out, *_ = capture(torch.cuda.Stream())
        graph.replay()
        assert_equal(f"{label}: replay, capture on a fresh stream", out, want)
        fresh = "captured and equal"
        del graph, out
    except RuntimeError as e:
        fresh = f"failed: {str(e)[:200]}"
    print(f"capture parts {label}: " + ", ".join(f"{k} {v} ms" for k, v in parts.items())
          + f"; pool {pool / 2**30} GiB (no entry: {pool2 / 2**30} GiB); capture on a fresh "
          f"stream {fresh}")
    return parts


def phase_capture_parts(seed):
    """``capture_parts`` for three solve keys: five classes of a 128³ crop
    (``'auto'``), the whole 256³ grid's chunk of four classes, and a 2-D
    2048² solve (σ_s 24, σ_l 4, blur dim 5); then for the refine core of
    five classes of a 64³ grid (a refined request's) at a 48³ crop."""
    solve = functools.partial(_bilateral_solve_eager, sigma_spatial=BLS_SS, sigma_luma=BLS_SL)
    for size, C in ((128, BLS_C), (256, 4)):
        ref, sims = whole_grid_case(size, seed + size, C)
        lu = ref.float()[None].expand(sims.shape)
        conf = 0.4 + 0.5 * torch.rand(sims.shape, device="cuda",
                                      generator=torch.Generator(device="cuda").manual_seed(seed))
        capture_parts(f"({C}, {size}^3) 'auto'", (sims, lu, conf), solve)
        del ref, sims, lu, conf
    r, t = phantom2d(2048, seed + 2048)
    capture_parts("2-D 2048^2", (t[None], r[None], torch.full_like(t, 0.999)[None]),
                  functools.partial(_bilateral_solve_eager, sigma_spatial=BLS2D_SS,
                                    sigma_luma=BLS2D_SL, blur_dim=5))
    ref, sims = whole_grid_case(64, seed + 64, BLS_C)
    starts = torch.tensor([[0, 8, 16], [16, 0, 8], [8, 16, 0], [16, 16, 16], [0, 0, 0]],
                          device="cuda")
    solve_kw = dict(sigma_spatial=BLS_SS, sigma_luma=BLS_SL, lam=256.0, cg_maxiter=25,
                    coarse_to_fine=False, fine_maxiter=10, pixel_impl="auto")
    capture_parts(f"refine core ({BLS_C}, 64^3) crop 48^3", (sims, ref, starts), functools.partial(
        refine_module._refine_indexed_core, crop_shape=(48, 48, 48), solve_kw=solve_kw))


def copy_sources(prof, label):
    """Print every pageable host-to-device copy of a trace taken with
    ``with_stack=True`` and ``record_shapes=True``: count, card time, the op
    that made it with its input shapes, and the repository's frames around
    it (the trace's Python function events on the op's thread whose span
    holds the op, innermost first)."""
    events = list(prof.events())
    frames = [f for f in events if ".py(" in f.name
              and ("vittf_tpu_torch" in f.name or "chip_smoke" in f.name)]
    rows = {}
    for e in events:
        for k in getattr(e, "kernels", []):
            if "HtoD" not in k.name or "Pageable" not in k.name:
                continue
            around = sorted((f for f in frames if f.thread == e.thread
                             and f.time_range.start <= e.time_range.start
                             and e.time_range.end <= f.time_range.end),
                            key=lambda f: -f.time_range.start)
            key = (e.name, str(e.input_shapes), tuple(f.name for f in around[:3]))
            n, us = rows.get(key, (0, 0.0))
            rows[key] = (n + 1, us + k.duration)
    print(f"pageable host-to-device copies, {label}: {sum(n for n, _ in rows.values())} "
          f"({len(frames)} Python frames of the repository in the trace)")
    for (name, shapes, stack), (n, us) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        print(f"  {n} x, {us / 1e3} ms, {name} {shapes} at {' <- '.join(stack)}")


def graph_counts() -> tuple[int, int, int]:
    """The graph cache's (hits, misses, eager): replays of a kept graph,
    captures, first sightings run eager."""
    return GRAPHS.hits, GRAPHS.misses, GRAPHS.eager


def graph_kinds(before: tuple[int, int, int]) -> str:
    """What the cache did since ``before``, e.g. 'eager' or '1 capture'."""
    names = ("replay", "capture", "eager")
    parts = [f"{n} {name}" for n, name in zip((a - b for a, b in zip(graph_counts(), before)),
                                               names) if n]
    return ", ".join(parts) or "no graph call"


def graph_witness_of(key, args, body):
    """The witness of one call through the graph cache: a solve's eager body,
    or for a refine core the slice-based ``_refine_batched_core`` at the
    host starts, its solve the eager body."""
    if key[0] != "refine core":
        return body(*args)
    sims, vol_u8, starts = args
    with mock.patch.object(refine_module, "bilateral_solve_gray_batched", _bilateral_solve_eager):
        return refine_module._refine_batched_core(sims, vol_u8, starts.cpu().numpy(),
                                                  body.keywords["crop_shape"],
                                                  body.keywords["solve_kw"])


@contextlib.contextmanager
def timed_captures():
    """Time every capture made inside the block (``cuda_graphs.capture``:
    the input copies, capture and instantiation, without the replay), on
    the host clock between two synchronizes; yields the list of ms."""
    real, times = cuda_graphs.capture, []

    def timed(*args):
        out, ms = host_ms(lambda: real(*args))
        times.append(ms)
        return out

    with mock.patch.object(cuda_graphs, "capture", timed):
        yield times


@contextlib.contextmanager
def graph_witness(label, calls=None):
    """Hold the calls through the graph cache made inside the block (the
    first ``calls`` of them, or all) against their witness on the same
    inputs (``graph_witness_of``), ``torch.equal``: a key's eager first
    sighting, its capture (capture, then replay) and its replays alike. The
    witness's launches are not counted. Yields {'eager': n, 'capture': n,
    'replay': n}, the calls held."""
    real = cuda_graphs.graphed
    held = {"eager": 0, "capture": 0, "replay": 0}

    def checked(key, args, body, wrappers, cache=GRAPHS):
        if calls is not None and sum(held.values()) >= calls:
            return real(key, args, body, wrappers, cache)
        before = (cache.misses, cache.eager)
        got = real(key, args, body, wrappers, cache)
        kind = ("eager" if cache.eager > before[1] else
                "capture" if cache.misses > before[0] else "replay")
        want, _ = cuda_graphs.uncounted(lambda: graph_witness_of(key, args, body), wrappers)
        what = "refine core" if key[0] == "refine core" else "solve"
        assert_equal(f"{label}: graphed {what} ({kind}) vs its witness", got, want)
        held[kind] += 1
        return got

    with mock.patch.object(cuda_graphs, "graphed", checked):
        yield held


def witness_fresh(label, *runs) -> dict:
    """Drop every captured graph and sighting, then call each of ``runs``
    under ``graph_witness``; an eager first sighting, a capture and a
    replay must all be held. The runs give one key other inputs, so a
    replay that read stale buffers would differ from the witness."""
    GRAPHS.clear()
    with graph_witness(label) as held:
        for run in runs:
            run()
    if not all(held.values()):
        raise AssertionError(f"{label}: graph calls held {held}, need an eager first sighting, "
                             "a capture and a replay")
    print(f"{label}: every graphed answer equals its witness bit for bit ({held})")
    return held


def graph_line(since: tuple[int, int, int]) -> str:
    """The graph cache's hits (replays), misses (captures) and eager first
    sightings since ``since`` (``graph_counts()``), the entries it keeps,
    their bytes against the budget, and the card's reserved memory."""
    hits, misses, eager = (a - b for a, b in zip(graph_counts(), since))
    calls = max(hits + misses + eager, 1)
    budget = GRAPHS.budget_bytes(torch.device("cuda", 0))
    return (f"graph cache {hits} replays, {misses} captures, {eager} eager first sightings "
            f"(replay share {hits / calls}), {len(GRAPHS.entries)} kept holding "
            f"{GRAPHS.nbytes / 2**30} GiB of a {budget / 2**30} GiB budget; memory reserved "
            f"{torch.cuda.memory_reserved() / 2**30} GiB, allocated "
            f"{torch.cuda.memory_allocated() / 2**30} GiB")


def bls_requests(vol, feat_t, anns, impl="auto", ref=None):
    """Refined interactive requests, given the reference ``ref`` as the
    served session keeps it (None: each request builds it from ``vol``);
    returns each one's maps, label volume, wall seconds and what the graph
    cache did (``graph_kinds``)."""
    out = []
    for ann in anns:
        before = graph_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sims = compute_similarities(vol, feat_t, ann, bilateral_solver=True, bls_shape_bucket=8,
                                    bls_ref_u8=ref, impl=impl)
        pred = fuse_predictions(sims)
        torch.cuda.synchronize()
        out.append((sims, pred, time.perf_counter() - t0, graph_kinds(before)))
    return out


def phase_refinement(seed, workdir: Path, vol, labels, feat_t):
    """The refinement path: the CLI with per-class tight crops and the
    island filter, then refined requests with bucketed batched crops."""
    for fn in BLS_KERNELS:
        fn.launches = 0
    since = graph_counts()
    t0 = time.perf_counter()
    predict_ntf.main(["--data", str(workdir), "--num-samples", "256", "--seed", str(seed),
                      "--bilateral-solver", "--largest-island"])
    t_cli = time.perf_counter() - t0
    n_cli = [fn.launches for fn in BLS_KERNELS]
    print(f"refinement path, predict CLI: {graph_line(since)}")
    since = graph_counts()
    pred = np.load(workdir / "ntf_pred256.0bothblsisl.npy")
    if pred.shape != (64, 64, 64) or pred.dtype != np.uint8 or pred.max() > 5 or not pred.any():
        raise AssertionError(f"refined prediction {pred.shape} {pred.dtype} max {pred.max()}")
    metrics = json.loads((workdir / "ntf_metrics256.0bothblsisl.json").read_text())
    if not 0.0 <= metrics["mIoU"] <= 1.0:
        raise AssertionError(f"refined mIoU {metrics['mIoU']}")

    labels_f = np.flip(labels, axis=-3).copy()
    anns = [annotations_from_labels(labels_f, 256, "both", rng=np.random.default_rng(seed + r),
                                    device="cuda") for r in range(1, 4)]
    # the reference as the served session keeps it; a key's first request runs
    # eager, its second captures, the later ones and the second round replay
    ref = make_bls_reference(vol, tuple(s // 2 for s in vol.shape), device="cuda")
    with timed_captures() as caps:
        reqs = bls_requests(vol, feat_t, anns, ref=ref)
        replays = bls_requests(vol, feat_t, anns, ref=ref)
    n_all = [fn.launches for fn in BLS_KERNELS]
    # the same requests again, each building the reference from the volume
    noref = bls_requests(vol, feat_t, anns)
    n_req = [a - b for a, b in zip(n_all, n_cli)]
    sims, pred_r, *_ = reqs[-1]
    plain = compute_similarities(vol, feat_t, anns[-1], bilateral_solver=True,
                                 bls_shape_bucket=8, impl="plain")
    n_diff = sum(check_u8_maps(f"refined request map {k}", sims[k], plain[k]) for k in sims)
    # no kernel of the route sums with atomics: a refined request equals its repeat
    again = bls_requests(vol, feat_t, anns[-1:], ref=ref)[0][0]
    for k in sims:
        assert_equal(f"refined request map {k}: repeat", again[k], sims[k])
        assert_equal(f"refined request map {k}: second round", replays[-1][0][k], sims[k])
        assert_equal(f"refined request map {k}: reference from the volume", noref[-1][0][k],
                     sims[k])
    if tuple(pred_r.shape) != (64, 64, 64):
        raise AssertionError(f"refined request prediction shape {tuple(pred_r.shape)}")
    req_ms = [r[2] * 1e3 for r in reqs]
    replay_ms = [r[2] * 1e3 for r in replays]
    noref_ms = [r[2] * 1e3 for r in noref]
    print(f"refinement path: predict CLI --bilateral-solver --largest-island {t_cli} s, "
          f"mIoU {metrics['mIoU']}; refined request (given the reference) p50 "
          f"{float(np.median(req_ms))} ms (each {req_ms} ms, graph cache "
          f"{[r[3] for r in reqs]}, the captures alone {caps} ms); second round p50 "
          f"{float(np.median(replay_ms))} ms (each {replay_ms} ms, {[r[3] for r in replays]}); "
          f"without the reference (each request "
          f"uploads and resizes the volume) p50 {float(np.median(noref_ms))} ms (each "
          f"{noref_ms} ms, {[r[3] for r in noref]}); last request vs plain: {n_diff} voxels "
          f"differ by 1; its repeat, its second round and its run without the reference are "
          f"bit-equal")
    print(f"refinement path, requests: {graph_line(since)}")
    print(f"launches (splat, slice, blur): CLI {n_cli}, requests {n_req}")
    if min(n_cli) == 0 or min(n_req) == 0:
        raise AssertionError(f"a bilateral kernel was not launched: CLI {n_cli}, requests {n_req}")
    # an eager first sighting, a capture, then replays on the other draws where
    # they crop to its bucketed shape (all three do here), with other starts
    witness_fresh("refined request", lambda: bls_requests(vol, feat_t, anns * 2, ref=ref))
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
    lab = torch.from_numpy(labels).to("cuda")
    cls = torch.arange(1, C + 1, device="cuda").reshape(C, 1, 1, 1)
    sims = 0.15 + 0.6 * (lab[None] == cls).float()
    sims += 0.1 * torch.rand((C,) + shape, generator=gen, device="cuda")
    runs, kinds = {"scatter": [], "auto": []}, []
    outs = {}
    since = graph_counts()
    reserved = torch.cuda.memory_reserved() / 2**30
    with timed_captures() as caps:
        for impl in ("scatter", "auto", "auto", "scatter"):
            before = graph_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[impl] = refine_similarities_batched(sims, None, shape, ref_u8=ref,
                                                     pixel_impl=impl)
            torch.cuda.synchronize()
            runs[impl].append(time.perf_counter() - t0)
            kinds += [graph_kinds(before)] if impl == "auto" else []
    n_diff = check_u8_maps("whole-grid refinement", outs["auto"], outs["scatter"])
    print(f"whole-grid refinement {shape} C={C}: kernels {runs['auto']} s (graph cache {kinds}: "
          f"two chunks of one key; the capture alone {caps} ms), plain {runs['scatter']} s; "
          f"{n_diff} of {outs['auto'].numel()} voxels differ by 1; memory reserved before "
          f"{reserved} GiB; "
          f"{graph_line(since)}")
    # two chunks of four classes a call: an eager sighting and a capture, then
    # replays on other classes
    witness_fresh("whole-grid chunk", *(lambda: refine_similarities_batched(
        sims, None, shape, ref_u8=ref),) * 2)


CORE_STARTS = (  # five classes' (x, y, z) starts, as shares of the room left by the crop
    ((0, 0, 0),) * 5,
    ((1, 1, 1),) * 5,
    ((0, 1, 1), (1, 0, 0), (1, 1, 0), (0.3, 0.6, 0.1), (0, 0, 1)),
    ((0.5, 0.2, 0.9), (0.1, 0.8, 0.4), (1, 0.5, 0), (0, 1, 0.5), (0.7, 0.3, 1)),
)


def phase_core_witness(seed, sim_shape=(96, 80, 64), crops=((48, 40, 32), (40, 48, 24))):
    """The refine core through the graph cache (``pipeline/refine.py::
    _refine_core``) on five classes of a ``sim_shape`` grid, for each crop
    shape four calls with other starts: at the low faces, at the high
    faces, mixed, and inside (an eager sighting, a capture, two replays),
    each held ``torch.equal`` to the slice-based ``_refine_batched_core``
    with the eager solve (``witness_fresh``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sims = torch.rand((BLS_C,) + sim_shape, generator=gen, device="cuda")
    vol_u8 = torch.randint(0, 256, sim_shape, generator=gen, device="cuda", dtype=torch.uint8)
    solve_kw = dict(sigma_spatial=BLS_SS, sigma_luma=BLS_SL, lam=256.0, cg_maxiter=25,
                    coarse_to_fine=False, fine_maxiter=10, pixel_impl="auto")
    runs = []
    for crop in crops:
        room = np.asarray(sim_shape) - np.asarray(crop)
        for shares in CORE_STARTS:
            starts = torch.from_numpy(np.rint(np.asarray(shares) * room).astype(np.int64))
            runs.append(functools.partial(refine_module._refine_core, sims, vol_u8,
                                          starts.to("cuda"), crop, solve_kw))
    return witness_fresh(f"refine core {sim_shape} crops {crops}", *runs)


def phase_graph_memory(seed):
    """More than ``GRAPH_BOUND`` distinct large keys in a row: one class on
    a 512³ grid at five ``cg_maxiter`` (two calls each: the second
    captures), then five classes on a 256³ grid at five ``lam`` (a call's
    second chunk captures). After each key: the cache's entries and bytes
    against its budget, memory reserved and the card's free memory; the
    bytes must stay within the budget and the count within the bound."""
    GRAPHS.clear()
    torch.cuda.empty_cache()
    budget = GRAPHS.budget_bytes(torch.device("cuda", 0))
    since = graph_counts()
    cases = [(512, 1, {"cg_maxiter": n}) for n in (25, 24, 23, 22, 21)]
    cases += [(256, BLS_C, {"lam": lam}) for lam in (256.0, 128.0, 64.0, 32.0, 16.0)]
    grids = {}
    for size, C, bs in cases:
        if size not in grids:
            grids = {size: whole_grid_case(size, seed + size, C)}  # one grid at a time
        ref, sims = grids[size]
        secs = [timed_refine(sims, (size,) * 3, ref, bs_params=bs)[1]
                for _ in range(2 if C == 1 else 1)]
        free, total = torch.cuda.mem_get_info()
        print(f"graph memory {size}^3 x {C} {bs}: {secs} s; {len(GRAPHS.entries)} kept, "
              f"{GRAPHS.nbytes / 2**30} GiB of the {budget / 2**30} GiB budget (entries "
              f"{[e.nbytes / 2**30 for e in GRAPHS.entries.values()]} GiB); memory reserved "
              f"{torch.cuda.memory_reserved() / 2**30} GiB, allocated "
              f"{torch.cuda.memory_allocated() / 2**30} GiB; card free {free / 2**30} of "
              f"{total / 2**30} GiB")
        if GRAPHS.nbytes > budget or len(GRAPHS.entries) > cuda_graphs.GRAPH_BOUND:
            raise AssertionError(f"graph cache holds {GRAPHS.nbytes} bytes in "
                                 f"{len(GRAPHS.entries)} entries, budget {budget}")
    print(f"graph memory: {graph_line(since)}")
    # the step filled the cache on purpose: leave it empty for the phases after it
    del grids
    GRAPHS.clear()
    torch.cuda.empty_cache()


def whole_grid_case(size, seed, C):
    """(uint8 reference, (C, size³) similarity maps) made on the card: C
    ellipsoids of distinct intensity in noise, and one noisy map per
    ellipsoid with support over the whole grid."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ax = torch.linspace(-1, 1, size, device="cuda")
    ref = 0.05 * torch.randn((size,) * 3, generator=gen, device="cuda")
    sims = []
    for k in range(C):
        center = torch.rand(3, generator=gen, device="cuda") - 0.5
        radii = 0.15 + 0.2 * torch.rand(3, generator=gen, device="cuda")
        d2 = sum((((ax - center[i]) / radii[i]) ** 2).reshape(
            tuple(size if j == i else 1 for j in range(3))) for i in range(3))
        inside = d2 <= 1
        ref += 0.2 * (k + 1) * inside
        sim = 0.15 + 0.6 * inside
        sim += 0.1 * torch.rand((size,) * 3, generator=gen, device="cuda")
        sims.append(sim)
        del d2, inside
    ref -= ref.min()
    ref_u8 = torch.trunc(255.0 * ref / ref.max()).to(torch.uint8)
    return ref_u8, torch.stack(sims)


def timed_refine(sims, shape, ref, **kw):
    """One ``refine_similarities_batched`` call: (maps, wall s, peak bytes
    allocated on the card during it, above what was held before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = refine_similarities_batched(sims, None, shape, ref_u8=ref, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - held


def phantom2d(size, seed):
    """(reference in [0, 255], noisy target in [0, 1]) on the card: four
    ellipses of distinct intensity; the target marks the first one."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ax = torch.linspace(-1, 1, size, device="cuda")
    ref = 0.05 * torch.randn((size, size), generator=gen, device="cuda")
    target = None
    for k in range(4):
        center = torch.rand(2, generator=gen, device="cuda") - 0.5
        radii = 0.2 + 0.25 * torch.rand(2, generator=gen, device="cuda")
        inside = (((ax[:, None] - center[0]) / radii[0]) ** 2
                  + ((ax[None, :] - center[1]) / radii[1]) ** 2) <= 1
        ref += 0.2 * (k + 1) * inside
        if target is None:
            target = inside.float() + 0.25 * torch.randn((size, size), generator=gen, device="cuda")
    ref -= ref.min()
    return torch.trunc(255.0 * ref / ref.max()), target.clamp(0, 1)


def solve2d_fused(t, r, c):
    """The 2-D solve through the fused splat and slice called directly, the
    image as one z-plane: the route a 2-D solve took before the blocked
    kernels, kept here as their yardstick."""
    ext = _grid_extents(tuple(t.shape), BLS2D_SS, BLS2D_SL)
    m, w, b = bls_splat(r[None], t[None], c[None], BLS2D_SS, BLS2D_SL).reshape(1, 3, -1).unbind(1)
    y = _lattice_solve(m, w, b, ext, lam=256.0, A_diag_min=1e-5, cg_tol=1e-5, cg_maxiter=25,
                       bistoch_iters=10, blur_dim=5)
    out = bls_slice(r[None], y.reshape(1, -1, ext[-1]).contiguous(), BLS2D_SS, BLS2D_SL)
    return torch.nan_to_num(out)[0]


def phase_blocked_path(seed, size=128, sizes_2d=(2048, 512)):
    """The blocked-form refinement. First the split form as the witness of
    the fused kernels: five classes over a whole 128³ grid, ``'reblock'``
    (K6 + K7) against ``'auto'`` (K4/K5) and ``'scatter'``. Then the 2-D
    solver, which takes the blocked kernels with one row per cell. Returns
    the blocked kernels' launches in the path's own runs: the witness and the
    first three ``apply_bilateral_solver2d`` calls of each size (an eager
    first sighting, a capture and a replay)."""
    for fn in BLS_KERNELS + BLOCKED_KERNELS:
        fn.launches = 0
    shape = (size,) * 3
    ref, sims = whole_grid_case(size, seed + 13, BLS_C)
    outs, secs, captured = {}, {}, 0
    for impl in ("scatter", "auto", "reblock", "reblock", "auto", "scatter"):
        misses = GRAPHS.misses
        outs[impl], dt, _ = timed_refine(sims, shape, ref, pixel_impl=impl)
        secs.setdefault(impl, []).append(dt)
        captured += GRAPHS.misses - misses if impl == "reblock" else 0
    # each run is one chunk: the first 'reblock' run eager, the second a capture and its replay
    n_auto = check_u8_maps("reblock vs auto", outs["reblock"], outs["auto"])
    n_scatter = check_u8_maps("reblock vs scatter", outs["reblock"], outs["scatter"])
    n_witness = [fn.launches for fn in BLOCKED_KERNELS]
    print(f"witness {shape} C={BLS_C}: reblock {secs['reblock']} s, auto {secs['auto']} s, "
          f"scatter {secs['scatter']} s (the first 'reblock' and 'auto' runs eager, the second "
          f"captures); reblock "
          f"vs auto {n_auto}, vs scatter {n_scatter} of {outs['auto'].numel()} voxels differ by "
          f"1; launches (reblock, unreblock, blocked splat, blocked slice) {n_witness}")
    # one solve a run (one chunk): eager, or a capture and its one replay
    solves = 2
    if n_witness != [3 * solves, solves, solves, solves] or captured != 1:
        raise AssertionError(f"witness launches {n_witness} with {captured} captures")
    for impl in ("reblock", "auto"):  # the classes in other orders: a capture, then a replay
        witness_fresh(f"{impl} whole-grid 128^3", *(
            functools.partial(refine_similarities_batched, x, None, shape, ref_u8=ref,
                              pixel_impl=impl) for x in (sims, sims.flip(0), sims.roll(1, 0))))
    del outs, sims, ref

    n_path = n_witness  # the witness, then the first three 2-D solves of each size, untimed
    for size in sizes_2d:
        r, t = phantom2d(size, seed + size)
        before = [fn.launches for fn in BLS_KERNELS + BLOCKED_KERNELS]
        misses = GRAPHS.misses
        with graph_witness(f"2-D solve {size}") as held:
            # its key's first sighting (witness_fresh above dropped every graph)
            binary, solved = apply_bilateral_solver2d(t, r)
            apply_bilateral_solver2d(t.flip(0), r)  # a capture on another target
            apply_bilateral_solver2d(t.flip(1), r)  # a replay on a third
        after = [fn.launches for fn in BLS_KERNELS + BLOCKED_KERNELS]
        splat4, slice5, _, rb, urb, splat7, slice7 = (a - b for a, b in zip(after, before))
        if (splat7, slice7) != (3, 3) or splat4 or slice5 or rb or urb \
                or GRAPHS.misses - misses != 1 or held != {"eager": 1, "capture": 1, "replay": 1}:
            raise AssertionError(f"2-D solve launches: {[a - b for a, b in zip(after, before)]}, "
                                 f"graphed solves held {held}")
        n_path = [n + d for n, d in zip(n_path, (rb, urb, splat7, slice7))]
        binary_p, solved_p = apply_bilateral_solver2d(t, r, pixel_impl="scatter")
        err = check_close(f"2-D solver {size}", solved, solved_p, 0.0, 1e-3)
        n_mask = (binary != binary_p).count_nonzero().item()
        if n_mask > 1e-3 * binary.numel() or not 0 < binary.sum().item() < binary.numel():
            raise AssertionError(f"2-D solver {size}: masks differ on {n_mask} pixels")
        c = torch.full_like(t, 0.999)
        kw = dict(sigma_spatial=BLS2D_SS, sigma_luma=BLS2D_SL, blur_dim=5)
        err_f = check_close(f"2-D solve {size} blocked vs fused route",
                            bilateral_solve_gray(t, r, c, **kw), solve2d_fused(t, r, c), 0.0, 1e-3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply_bilateral_solver2d(t, r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = {name: cuda_ms(fn, reps=3) for name, fn in (
            ("blocked", lambda: bilateral_solve_gray(t, r, c, **kw)),
            ("eager", lambda: _bilateral_solve_eager(t[None], r[None], c[None], **kw)),
            ("fused", lambda: solve2d_fused(t, r, c)),
            ("scatter", lambda: bilateral_solve_gray(t, r, c, pixel_impl="scatter", **kw)),
        )}
        print(f"2-D solver ({size}, {size}) sigma ({BLS2D_SS}, {BLS2D_SL}): solved kernels vs "
              f"scatter max_abs_err {err}, masks differ on {n_mask} pixels, mask area "
              f"{int(binary.sum().item())}; apply_bilateral_solver2d wall {wall} s (with hole "
              f"filling and the island filter); solve alone: blocked kernels, graph replay "
              f"{ms['blocked']} ms, op by op (the eager body) {ms['eager']} ms; fused kernels on "
              f"one z-plane {ms['fused']} ms (max_abs_err between them {err_f}), scatter "
              f"{ms['scatter']} ms")
    return n_path


def map_deviation(a, b) -> tuple[str, float]:
    """uint8 maps: (|delta| statistics modulo the wraparound, the lowest
    per-class Pearson correlation)."""
    d = (a.int() - b.int()) % 256
    d = torch.minimum(d, 256 - d)
    x, y = a.flatten(1).float(), b.flatten(1).float()
    x, y = x - x.mean(dim=1, keepdim=True), y - y.mean(dim=1, keepdim=True)
    corr = ((x * y).sum(dim=1) / (x.norm(dim=1) * y.norm(dim=1))).min().item()
    return (f"mean |delta| {d.float().mean().item()}, max {d.max().item()}, share within 3 "
            f"{(d <= 3).float().mean().item()}, lowest per-class correlation {corr}"), corr


def lattice_residual(m, w, b, ext, y, lam=256.0, blur_dim=5, bistoch_iters=10):
    """|b - A(y)| per vertex of the solver's system for one class, with the
    operator rebuilt here from the splat at the solver's defaults:
    bistochastization, then A = lam·(Dm - Dn·blur·Dn) + diag(w), the identity
    on empty vertices."""
    lat = (1,) + tuple(ext)

    def blur(v):
        return bls_blur(v.reshape(lat).contiguous(), blur_dim).reshape(1, -1)

    occupied = m > 0
    n = occupied.float()
    for _ in range(bistoch_iters):
        bn = blur(n)
        n = torch.where(occupied, torch.sqrt(n * m / torch.where(bn > 0, bn, 1.0)), 0.0)
    Ay = torch.where(occupied, lam * (n * blur(n) * y - n * blur(n * y)) + w * y, y)
    return (b - Ay).abs()


def coarse_to_fine_floats(shape, ref, sim):
    """One class's solve in floats, the whole grid as its crop, direct and
    coarse-to-fine: held to the bound of the CPU test of the two-level solve
    (mean |delta| <= 2e-3, the > 0.5 masks agree on >= 0.999 of the voxels).
    The max is not held: it is one lattice vertex, and the vertex of the
    largest deviation is printed with its value, its voxel count and the
    residual |b - A(y)| there in both solves, beside the residual's rms over
    the occupied vertices and the coarse-to-fine value after 25 fine steps."""
    lu, t = ref[None].float(), sim[None]
    conf = torch.full((1,) + shape, 0.9, device="cuda")
    kw = dict(sigma_spatial=BLS_SS, sigma_luma=BLS_SL)
    outs = {"direct": bilateral_solve_gray_batched(t, lu, conf, **kw),
            "c2f": bilateral_solve_gray_batched(t, lu, conf, coarse_to_fine=True, **kw),
            "c2f25": bilateral_solve_gray_batched(t, lu, conf, coarse_to_fine=True,
                                                  fine_maxiter=25, **kw)}
    e = (outs["direct"] - outs["c2f"]).abs()
    m_d, m_c = outs["direct"] > 0.5, outs["c2f"] > 0.5
    mean, agree = e.mean().item(), (m_d == m_c).float().mean().item()
    vid, ext = _vertex_ids(shape, lu, BLS_SS, BLS_SL)
    vid = vid.reshape(-1)
    m, w, b = bls_splat(lu, t, conf, BLS_SS, BLS_SL).reshape(1, 3, -1).unbind(1)
    at = vid[e.reshape(-1).argmax()].item()
    lines = []
    for name, out in outs.items():
        # the solve is constant over a vertex: read the lattice back from the voxels
        y = torch.zeros_like(m)
        y[0, vid] = out.reshape(-1)
        res = lattice_residual(m, w, b, ext, y)
        rms = res[m > 0].square().mean().sqrt().item()
        lines.append(f"{name}: max {out.max().item()}, value at the vertex {y[0, at].item()}, "
                     f"residual there {res[0, at].item()}, residual rms {rms}")
    print(f"coarse-to-fine {shape} one class, floats: |delta| max {e.max().item()} mean {mean}, "
          f"> 0.5 masks agree on {agree} ({int(m_d.sum().item())} voxels inside); largest "
          f"deviation at lattice vertex {tuple(map(int, np.unravel_index(at, ext)))} of {ext}, "
          f"{int(m[0, at].item())} voxels, b {b[0, at].item()}; " + "; ".join(lines))
    if not mean <= 2e-3 or not agree >= 0.999 or not m_d.sum().item() > 1000:
        raise AssertionError(f"coarse-to-fine {shape}: mean |delta| {mean}, masks agree {agree}")


def phase_coarse_to_fine(seed, cases=((256, BLS_C), (512, 1))):
    """Coarse-to-fine beside the direct solve: the whole-grid 256³
    refinement of five classes (phase 9's size), then one class on a 512³
    grid. The two solves differ by CG convergence only, and the first class's
    float solves are held to that (``coarse_to_fine_floats``). Each uint8 map
    is scaled by its own 0.99·max before it is quantized, so a different peak
    vertex rescales a whole map: the maps of the batched refinement are held
    to a correlation of 0.9 per class, and their deviation is printed."""
    c2f, c2f25 = {"coarse_to_fine": True}, {"coarse_to_fine": True, "fine_maxiter": 25}
    for size, C in cases:
        shape = (size,) * 3
        ref, sims = whole_grid_case(size, seed + 17, C)
        res = {}
        since = graph_counts()
        reserved = torch.cuda.memory_reserved() / 2**30
        # 25 fine steps (ROADMAP §C 7) at the whole grid's size only
        order = (("direct", None), ("c2f", c2f)) + ((("c2f25", c2f25),) * 2 if C > 1 else ())
        for name, bs in order + order[1::-1]:
            out, dt, peak = timed_refine(sims, shape, ref, bs_params=bs)
            res.setdefault(name, []).append((dt, peak))
            res[name + "_out"] = out
        stats, corr = map_deviation(res["c2f_out"], res["direct_out"])
        print(f"coarse-to-fine {shape} C={C}: direct {[r[0] for r in res['direct']]} s, peak "
              f"{res['direct'][0][1] / 2**30} GiB; coarse-to-fine {[r[0] for r in res['c2f']]} s, "
              f"peak {res['c2f'][0][1] / 2**30} GiB (each key's first run eager, its second "
              f"captures); maps: {stats}")
        if "c2f25" in res:
            stats25, corr25 = map_deviation(res["c2f25_out"], res["direct_out"])
            print(f"coarse-to-fine {shape} C={C}, fine_maxiter 25: "
                  f"{[r[0] for r in res['c2f25']]} s, peak {res['c2f25'][0][1] / 2**30} GiB; "
                  f"maps vs direct: {stats25}")
            if not corr25 > 0.9:
                raise AssertionError(f"coarse-to-fine {shape} fine_maxiter 25: correlation {corr25}")
        print(f"coarse-to-fine {shape} C={C}: memory reserved before {reserved} GiB; "
              f"{graph_line(since)}")
        if not corr > 0.9 or not res["c2f_out"].any():
            raise AssertionError(f"coarse-to-fine {shape}: correlation {corr}")
        del res
        if C > 1:
            # two chunks of four classes a call: an eager sighting and a capture,
            # then replays on other classes
            witness_fresh(f"coarse-to-fine {shape} C={C}", *(lambda: refine_similarities_batched(
                sims, None, shape, ref_u8=ref, bs_params=c2f),) * 2)
        coarse_to_fine_floats(shape, ref, sims[0])
        del ref, sims
        torch.cuda.empty_cache()


def serve_frames(labels, seed, n=256):
    """Four annotation edits: five classes of ``n`` annotations; one class
    redrawn with more; a class added; everything cleared."""
    ann = annotations_from_labels(labels, n, "both", rng=np.random.default_rng(seed + 21))
    redraw = annotations_from_labels(labels, n + n // 8, "both",
                                     rng=np.random.default_rng(seed + 22))
    names = list(ann)
    second = {**ann, names[2]: redraw[names[2]]}
    third = {**second, "extra": redraw[names[0]][:n - n // 4]}
    return [ann, second, third, {}]


def plain_solve(vol, feat_t, classes, ref, impl) -> tuple[dict, torch.Tensor]:
    """``classes`` through the refined route with the similarity of ``impl``
    ('auto': the kernel; 'plain': its twin) and the plain twins' solve
    (``pixel_impl='scatter'``) under deterministic algorithms, where the
    card's ``index_add_`` sums in the ascending order the splat kernels
    take. Returns the uint8 maps and the float similarities solved."""
    real, solved = refine_module.refine_similarities_batched, []

    def solve(sims, volume, sim_shape, **kw):
        solved.append(sims)
        was = (torch.are_deterministic_algorithms_enabled(),
               torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            return real(sims, volume, sim_shape, **{**kw, "pixel_impl": "scatter"})
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])

    with mock.patch.object(refine_module, "refine_similarities_batched", solve):
        maps = compute_similarities(vol, feat_t, classes, bilateral_solver=True,
                                    bls_shape_bucket=8, bls_ref_u8=ref, impl=impl,
                                    mean_first=False)
    return maps, solved[0]


def phase_served(seed, workdir: Path, vol, labels, feats_path: Path, n=256):
    """The served path: ``serve`` on an artifact directory, driven through
    its ``main`` while a thread plays the frontend. Without the solver every
    answer equals a fresh full recompute bit for bit. With it, an edit
    recomputes only the edited classes over their own crop, so each answer's
    edited maps are held against a fresh recompute of those classes by the
    kernels within the refined-request contract (|delta| <= 1 on <= 1e-3 of
    the voxels), and that recompute must equal its own repeat bit for bit:
    no kernel of the route sums with atomics. A wrong crop, class or stale
    map moves values by more than 1. The route is bounded in its two halves
    apart (ROADMAP §C 15): each edited map must equal, bit for bit, the
    kernel's similarities through the plain twins' solve with ``index_add_``
    deterministic (``plain_solve``), and those similarities must lie within
    phase 3's contract (1e-4, 1e-5) of the plain twin's; the map's distance
    (±1) to the whole plain route made deterministic is printed (the solve
    turns a few ulps of similarity into ±1 on up to 1.9e-3 of a map's
    voxels). The other maps must be the previous answer's bit for bit, and
    the deviation from a full recompute is printed. Returns the launch
    counts of both runs."""
    feat_t = torch.from_numpy(load_features(feats_path)).to("cuda")
    frames = serve_frames(labels, seed, n)
    sim_shape = tuple(s // 2 for s in vol.shape)
    ref = make_bls_reference(vol, sim_shape, device="cuda")
    counted = (similarity,) + BLS_KERNELS
    launches = []
    for solver in (False, True):
        d = workdir / f"serve_{'bls' if solver else 'plain'}"
        d.mkdir()
        np.save(d / "volume.npy", vol)
        shutil.copy(feats_path, d / feats_path.name)
        answered, answers, secs, kinds = threading.Semaphore(0), [], [], []

        def frontend():
            for frame in frames:
                tmp = d / "annotations.tmp.npy"
                np.save(tmp, frame, allow_pickle=True)
                tmp.replace(d / "annotations.npy")
                if not answered.acquire(timeout=300):
                    return
                answers.append((np.load(d / "similarities.npy", allow_pickle=True)[()],
                                np.load(d / "predictions.npy")))

        def on_update(n, dt):
            secs.append(dt)
            kinds.append(graph_kinds(last[0]))
            last[0] = graph_counts()
            answered.release()

        watch = functools.partial(session_module.watch_directory, on_update=on_update)
        for fn in counted:
            fn.launches = 0
        thread = threading.Thread(target=frontend, daemon=True)
        since = graph_counts()
        last = [since]
        # the start-up warm-up's and the first edit's refine cores are held against
        # their witness (the first edit's time includes that run)
        with mock.patch.object(session_module, "watch_directory", watch), \
                graph_witness("served edit", calls=2) as held, timed_captures() as caps:
            thread.start()
            serve.main(["--data", str(d), "--max-updates", str(len(frames)), "--poll-interval",
                        "0.05"] + (["--bilateral-solver"] if solver else []))
        thread.join(timeout=300)
        cache = graph_line(since)
        if solver and sum(held.values()) != 2 or not solver and any(held.values()):
            raise AssertionError(f"served path: graphed solves held {held}")
        launches.append([fn.launches for fn in counted])
        if len(answers) != len(frames):
            raise AssertionError(f"serve answered {len(answers)} of {len(frames)} edits")

        n_diff, full_dev, prev = [], [], {}
        n_det, sim_err = [], []
        for i, (frame, (sims, pred)) in enumerate(zip(frames, answers)):
            if list(sims) != list(frame):
                raise AssertionError(f"serve answer {i}: classes {list(sims)}")
            if not frame:
                if pred.any() or pred.shape != sim_shape:
                    raise AssertionError("serve: cleared annotations left a prediction")
                continue
            ths = CT_ORG_THRESHOLDS[:len(frame)] if len(frame) <= 5 else [0.25] * len(frame)
            if not np.array_equal(pred, fuse_predictions_host(sims, ths)):
                raise AssertionError(f"serve answer {i}: prediction is not the fuse of its maps")
            full = compute_similarities(vol, feat_t, frame, bilateral_solver=solver,
                                        bls_shape_bucket=8 if solver else None, bls_ref_u8=ref)
            if not solver:
                for k in frame:
                    assert_equal(f"serve answer {i} map {k}", torch.from_numpy(sims[k]).to("cuda"),
                                 full[k])
                assert_equal(f"serve answer {i} prediction", torch.from_numpy(pred).to("cuda"),
                             fuse_predictions(full, ths))
                continue
            edited = {k: v for k, v in frame.items()
                      if k not in prev or not np.array_equal(v, prev[k][0])}
            fresh, again = (compute_similarities(
                vol, feat_t, edited, bilateral_solver=True, bls_shape_bucket=8, bls_ref_u8=ref,
                mean_first=False) for _ in range(2))
            witness, sims_kernel = plain_solve(vol, feat_t, edited, ref, "auto")
            det_plain, sims_plain = plain_solve(vol, feat_t, edited, ref, "plain")
            check_close(f"serve answer {i}: the similarity kernel vs its plain twin",
                        sims_kernel, sims_plain, 1e-4, 1e-5)
            sim_err.append((sims_kernel - sims_plain).abs().max().item()
                           / sims_plain.abs().max().item())
            for k in frame:
                got = torch.from_numpy(sims[k]).to("cuda")
                if k in edited:
                    n_diff.append(check_u8_maps(f"serve answer {i} map {k}", got, fresh[k]))
                    assert_equal(f"repeat of request {i} map {k}", again[k], fresh[k])
                    assert_equal(f"serve answer {i} map {k} vs the plain twins' solve",
                                 got, witness[k])
                    n_det.append(check_u8_maps(f"serve answer {i} map {k} vs the plain "
                                               "twins' deterministic route", got,
                                               det_plain[k], 1.0))
                else:
                    assert_equal(f"serve answer {i} unedited map {k}", got,
                                 torch.from_numpy(prev[k][1]).to("cuda"))
                full_dev.append((got.int() - full[k].int()).abs().float().mean().item())
            prev = {k: (frame[k], sims[k]) for k in frame}
        line = (f"served path{' --bilateral-solver' if solver else ''}: 4 edits answered in "
                f"{[x * 1e3 for x in secs]} ms (graph cache per edit, the first with the start-up "
                f"warm-up: {kinds}; the captures alone {caps} ms; {cache}; the warm-up's and "
                f"the first edit's answers equal their witness: {held}); launches (similarity, "
                f"splat, slice, blur) {launches[-1]}; ")
        print(line + (f"voxels of {sim_shape} that differ by 1, per edited map: answer vs a "
                      f"fresh recompute {n_diff} (the recompute equals its repeat bit for bit, "
                      f"and the plain twins' deterministic solve of the kernel's similarities "
                      f"equals every answer bit for bit, the kernel's similarities within "
                      f"{sim_err} of the twin's largest, per edit), vs the plain twins' route made "
                      f"deterministic {n_det}; mean |delta| to a full recompute of all classes "
                      f"per map {full_dev}" if solver else "every map and prediction equals a full "
                      "recompute bit for bit"))
    if launches[0][0] == 0 or min(launches[1]) == 0 or any(launches[0][1:]):
        raise AssertionError(f"served path launches {launches}")
    return launches


def phase_fast(seed, workdir: Path):
    out = workdir / "fast_features.npy"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    infer.main(["--data-path", str(fast_volume(seed, workdir)), "--cache-path", str(out),
                "--feature-output-size", "64", "--fast"])
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    k = np.load(out, allow_pickle=True)[()]["k"]
    if k.shape != (384, 64, 64, 64) or not np.isfinite(k).all():
        raise AssertionError(f"fast features {k.shape}")
    print(f"fast mode 256^3: {dt} s ({256**3 / dt / 1e6} Mvoxel/s, infer CLI wall incl. weight "
          f"init); peak memory allocated {peak} GiB")


def phase_swiglu(gen):
    """K10 against its plain twin: bit-equal on the card's tensors (silu and
    the product in fp32, one rounding to bf16, as the twin), to its repeat,
    with the output poisoned first; within one bf16 step (2^-7 relative) of
    the twin on CPU tensors, whose exp may round its last fp32 bit
    otherwise. x is drawn at 3σ so silu sees its whole range."""
    cases = [SWIGLU_SHAPE, (1, 16), (7, 48), (129, 2 * 1544), (2, 1029, 2 * 4096)]
    for shape in cases:
        x = (3 * torch.randn(shape, generator=gen)).to("cuda", torch.bfloat16)
        out_shape = (*shape[:-1], shape[-1] // 4)  # fp32 of the bf16 output's bytes
        got = poisoned(lambda: swiglu(x), out_shape)
        name = f"swiglu {tuple(shape)}"
        assert_equal(f"{name} vs the twin on the card", got, swiglu_plain(x))
        assert_equal(f"{name}: repeat", poisoned(lambda: swiglu(x), out_shape), got)
        host = swiglu_plain(x.cpu())
        err = check_close(f"{name} vs the twin on CPU tensors", got.cpu(), host, 2**-7, 0.0)
        print(f"{name}: equal to the twin on the card and to its repeat; max_abs_err to the "
              f"CPU twin {err}, {int((got.cpu() != host).sum())} of {host.numel()} differ")
    x = (3 * torch.randn(SWIGLU_SHAPE, generator=gen)).to("cuda", torch.bfloat16)
    M, H = SWIGLU_SHAPE[0], SWIGLU_SHAPE[1] // 2
    x1, x2 = x.chunk(2, dim=-1)
    ms = ten_call_ms(lambda: swiglu(x))
    plain_ms = ten_call_ms(lambda: swiglu_plain(x))
    # the yardstick: one PyTorch expression on the same halves, used nowhere in the port
    lib_ms = ten_call_ms(lambda: torch.nn.functional.silu(x1) * x2)
    nbytes = 6 * M * H
    print(f"swiglu {SWIGLU_SHAPE} bfloat16: kernel {ms} ms ({nbytes / ms / 1e9} GB/s), "
          f"bound {nbytes / HBM_BYTES_PER_S * 1e3} ms; plain {plain_ms} ms; "
          f"F.silu(x1) * x2 {lib_ms} ms")
    return kernel_entry(0.0, ms, plain_ms, nbytes=nbytes, ops=0, peak="bf16", library_ms=lib_ms)


def phase_swiglu_path(seed):
    """ViT-g/14-reg at full width with three blocks (LayerScale gammas at 1,
    so every block reaches the output) through ``extract_features`` on a
    64³ phantom: 448² slices of 1029 tokens, 6 batches of 32, two whole
    blocks each: 12 gate launches; kernels vs plain twins (both bf16) at the
    bf16 block-stack contract of ``phase_consistency``; the fused block
    refused. Returns the gate's launches."""
    cfg = dataclasses.replace(resolve_model(dino2_model="vitg14_reg"), depth=3)
    params = init_vit_params(cfg, (0, seed))
    params = {k: torch.ones_like(v) if k.endswith(".gamma") else v for k, v in params.items()}
    vol, _ = phantom(64, seed + 11)
    feats, before = {}, swiglu.launches
    for impl in ("auto", "plain"):
        ex = ExtractConfig(feature_output_size=32, batch_size=32, compute_dtype="bfloat16",
                           attn_impl=impl)
        t0 = time.perf_counter()
        feats[impl] = extract_features(vol, params, cfg, ex, device="cuda")["k"]
        torch.cuda.synchronize()
        print(f"ViT-g/14-reg x 3 blocks on 64^3 ({impl}): {time.perf_counter() - t0} s")
    launches = swiglu.launches - before
    if launches != 12:
        raise AssertionError(f"swiglu launched {launches} times on the path, not 12")
    got, want = feats["auto"], feats["plain"]
    if tuple(got.shape) != (1536, 32, 32, 32):
        raise AssertionError(f"ViT-g/14-reg extraction shape {tuple(got.shape)}")
    err = check_rel("ViT-g/14-reg extraction kernels vs plain", got, want, 0.02)
    print(f"ViT-g/14-reg extraction kernels vs plain: max_abs_err {err} (limit "
          f"{0.02 * want.abs().max().item()}); {launches} gate launches")
    try:
        extract_features(vol, params, cfg, ExtractConfig(compute_dtype="bfloat16",
                                                         block_impl="fused"), device="cuda")
    except ValueError as e:
        print(f"block_impl='fused' refused for SwiGLU: {e}")
    else:
        raise AssertionError("block_impl='fused' ran a SwiGLU model")
    return launches


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


def k9_hard_operands(xi, wi):
    """The probe's int8 operands with the bit-defined corners planted: row 0
    of x is zero (row max 0: the 1e-6 floor, scale 1.27e8, result 0) and row
    1 gives the products 254, 1, 5, 9, -1, -5, 0, ...: scale exactly 0.5, so
    0.5, 2.5, 4.5 and their negatives are ties that round to the even
    neighbour (0, 2, 4) where ``roundf`` would give 1, 3, 5."""
    xi, wi = xi.clone(), wi.clone()
    xi[:2] = 0
    xi[1, 0], xi[1, 1] = 2, 1
    wi[:2] = 0
    wi[0, 0] = 127
    wi[1, :6] = torch.tensor([0, 1, 5, 9, -1, -5], dtype=torch.int8)
    return xi, wi


def k9_library(x, w, chain, mode):
    """The library's route to the same function, timed as a yardstick only:
    ``torch.matmul`` in bf16, ``torch._int_mm`` plus the elementwise epilogue
    in int8."""
    for _ in range(chain):
        if mode == "bf16":
            x = x @ w
            continue
        y = torch._int_mm(x, w)
        if mode == "int8+requant":
            yf = y.float()
            scale = torch.full_like(yf[:, :1], 127.0) / yf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
            x = torch.round(yf * scale).to(torch.int8)
        else:
            x = wrap_int8(y >> 8)
    return x


def k9_bf16_drift(x, w, chain):
    """(max |a − b|, max |a|) after ``chain`` bf16 steps taken in two fp32
    accumulation orders: a = one product over K, b = two half-K products
    summed. A bf16 rounding flips per step and the chain feeds it forward:
    the yardstick for the tolerance of the bf16 kernel."""
    wf, half = w.float(), w.shape[0] // 2
    a = b = x
    with ieee_matmul():
        for _ in range(chain):
            a = (a.float() @ wf).to(torch.bfloat16)
            bf = b.float()
            b = (bf[:, :half] @ wf[:half] + bf[:, half:] @ wf[half:]).to(torch.bfloat16)
    return (a.float() - b.float()).abs().max().item(), a.float().abs().max().item()


def k9_check(x, w, chain, mode, name):
    """One K9 call against the plain version: the int8 modes equal, bf16 one
    bf16 step at chain 1 and K9_BF16_LIMIT·max|ref| after that. Returns the
    largest deviation."""
    got, want = chain_gemm(x, w, chain, mode), chain_gemm_plain(x, w, chain, mode)
    torch.cuda.synchronize()
    if mode != "bf16":
        assert_equal(name, got, want)
        return 0.0
    if chain == 1:
        return check_close(name, got, want, 2.0**-7, 1e-3)
    return check_rel(name, got, want, K9_BF16_LIMIT)


def phase_chain_gemm(gen=None):
    """K9 against its plain version at the probe's shapes, chain 1, 2 and 32
    (both ping-pong parities), three modes. The int8 modes are bit-defined and
    must be equal, on the probe's operands and on ``k9_hard_operands``. bf16:
    one bf16 step at chain 1 (|delta| <= 2^-7·|ref| + 1e-3); at chain 32
    K9_BF16_LIMIT·max|ref|, which must be no more than 3x the largest share by
    which two fp32 accumulation orders of the plain version move apart over
    the chain (``k9_bf16_drift``), read here on the card at the probe's shape
    and on CPU tensors at 256 and 512 rows. Then the edges: 1, 127 and 129
    rows (a row block of one row) at dim 128, 384 and the probe's (a cluster
    of one block of 128 columns, of two and of eight of 192), and a dim the
    kernel refuses. ``gen`` is unused (the probe seeds its own operands); it
    is the phases' common signature, by which
    ``scripts/kernel_variants.py`` calls them."""
    inputs = bench_int8_gemm.make_inputs(K9_ROWS, K9_DIM, "cuda")
    hard = k9_hard_operands(*inputs["int8+requant"])
    shares = []
    for rows, where in ((K9_ROWS, "cuda"), (256, "cpu"), (512, "cpu")):
        xb, wb = inputs["bf16"]
        drift, ref = k9_bf16_drift(xb[:rows].to(where), wb.to(where), K9_CHAIN)
        shares.append(drift / ref)
        print(f"chain_gemm bf16: two accumulation orders of the plain version on {where}, {rows} rows, "
              f"chain {K9_CHAIN}: max|delta| {drift} = {drift / ref} of max|ref|")
    if not K9_BF16_LIMIT <= 3 * max(shares):
        raise AssertionError(f"chain_gemm bf16 limit {K9_BF16_LIMIT} is over 3x the largest drift {max(shares)}")
    ops = 2 * K9_ROWS * K9_DIM * K9_DIM * K9_CHAIN
    modes = {}
    for mode in CHAIN_MODES:
        x, w = inputs[mode]
        errs = {}
        for chain in (1, 2, K9_CHAIN):
            errs[chain] = k9_check(x, w, chain, mode, f"chain_gemm {mode} chain {chain}")
            if mode != "bf16":
                k9_check(*hard, chain, mode, f"chain_gemm {mode} chain {chain}, planted rows")
        if mode == "int8+requant":
            first = chain_gemm(*hard, 1, mode)
            want = torch.tensor([127, 0, 2, 4, 0, -2], dtype=torch.int8, device="cuda")
            if first[0].any() or not torch.equal(first[1, :6], want):
                raise AssertionError(f"chain_gemm requant corners: {first[1, :8].tolist()}")
        assert_equal(f"chain_gemm {mode} chain {K9_CHAIN}, repeat",
                     chain_gemm(x, w, K9_CHAIN, mode), chain_gemm(x, w, K9_CHAIN, mode))
        ms = cuda_ms(lambda: chain_gemm(x, w, K9_CHAIN, mode))
        plain_ms = cuda_ms(lambda: chain_gemm_plain(x, w, K9_CHAIN, mode), reps=3)
        lib_ms = cuda_ms(lambda: k9_library(x, w, K9_CHAIN, mode))
        modes[mode] = kernel_entry(
            errs[K9_CHAIN], ms, plain_ms, nbytes=x.element_size() * (2 * x.numel() + w.numel()),
            ops=ops, peak="bf16" if mode == "bf16" else "int8", library_ms=lib_ms)
        print(f"chain_gemm ({K9_ROWS}, {K9_DIM}) x ({K9_DIM}, {K9_DIM}) chain {K9_CHAIN} {mode}: "
              f"max_abs_err chain 1 {errs[1]}, chain 2 {errs[2]}, chain {K9_CHAIN} {errs[K9_CHAIN]}; "
              f"kernel {ms} ms ({ops / ms / 1e9} Tops/s) plain {plain_ms} ms library {lib_ms} ms "
              f"bound {modes[mode]['bound_ms']} ms")
    for dim in (128, 384, K9_DIM):
        for rows in (1, 127, 129):
            small = bench_int8_gemm.make_inputs(rows, dim, "cuda")
            for mode in CHAIN_MODES:
                for chain in (1, 2, 5):
                    k9_check(*small[mode], chain, mode, f"chain_gemm {mode} ({rows}, {dim}) chain {chain}")
    print(f"chain_gemm rows 1, 127, 129 x dim 128, 384, {K9_DIM}, chain 1, 2, 5: int8 modes equal, "
          f"bf16 inside its limits")
    try:
        chain_gemm(*bench_int8_gemm.make_inputs(8, 640, "cuda")["bf16"], 1, "bf16")
    except ValueError as e:
        print(f"chain_gemm dim 640 (five column tiles) refused: {e}")
    else:
        raise AssertionError("chain_gemm took dim 640")
    return {**modes["bf16"], "modes": modes}


def phase_probe_path():
    """The probe's entry point at its defaults: 3 modes x (1 warm-up + 20
    timed calls) = 63 launches; its five printed lines are passed through."""
    chain_gemm.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_int8_gemm.main([])
    n = chain_gemm.launches
    lines = buf.getvalue().rstrip().splitlines()
    print("\n".join(lines))
    print(f"launches in the probe's path: chain_gemm {n}")
    if rc != 0 or len(lines) != 5 or n != 63:
        raise AssertionError(f"probe path: rc {rc}, {len(lines)} lines, {n} launches")
    return n


def stand_in_svc(train_X, train_y, seed):
    """A seeded stand-in for a fitted ``sklearn.svm.SVC`` (the card's machine
    has no sklearn), carrying exactly the fitted attributes that
    ``svm_predict_device`` reads. The support vectors are the sampled
    training rows grouped by class, as libsvm keeps them; in the pair (i, j)
    class i's vectors weigh in with +u and class j's with −u, u ~ U(0, 1)
    (sklearn's compressed one-vs-one layout of y·alpha)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(train_y, kind="stable")
    sv, y = train_X[order].astype(np.float64), train_y[order]
    classes = np.unique(y)
    k = len(classes)
    n_support = np.array([(y == c).sum() for c in classes], np.int32)
    starts = np.concatenate([[0], np.cumsum(n_support)])
    dual = np.zeros((k - 1, len(y)))
    for i in range(k):
        for j in range(i + 1, k):
            dual[j - 1, starts[i]:starts[i + 1]] = rng.uniform(0, 1, n_support[i])
            dual[i, starts[j]:starts[j + 1]] = -rng.uniform(0, 1, n_support[j])
    return types.SimpleNamespace(
        kernel="rbf", support_vectors_=sv, dual_coef_=dual,
        intercept_=rng.normal(0, 0.1, k * (k - 1) // 2), n_support_=n_support,
        classes_=classes.astype(np.uint8), _gamma=1.0 / sv.shape[1])


def svm_votes_fp64(clf, x, chunk=8192):
    """The one-vs-one vote of ``clf`` on (n, F) rows in fp64, written
    independently of the port's tile function: per pair a signed sum over
    the two classes' support vectors."""
    sv = torch.as_tensor(clf.support_vectors_, dtype=torch.float64, device=x.device)
    dual = torch.as_tensor(clf.dual_coef_, dtype=torch.float64, device=x.device)
    b = torch.as_tensor(clf.intercept_, dtype=torch.float64, device=x.device)
    starts = np.concatenate([[0], np.cumsum(clf.n_support_)])
    k = len(clf.classes_)
    out = []
    for s0 in range(0, x.shape[0], chunk):
        xc = x[s0:s0 + chunk].double()
        K = torch.exp(-clf._gamma * torch.cdist(xc, sv).square())
        votes = torch.zeros((xc.shape[0], k), dtype=torch.int64, device=x.device)
        p = 0
        for i in range(k):
            for j in range(i + 1, k):
                si, sj = slice(starts[i], starts[i + 1]), slice(starts[j], starts[j + 1])
                dec = K[:, si] @ dual[j - 1, si] + K[:, sj] @ dual[i, sj] + b[p]
                votes[:, i] += dec > 0
                votes[:, j] += dec <= 0
                p += 1
        out.append(votes.argmax(dim=1))
    return torch.cat(out).cpu().numpy().astype(np.uint8)


def phase_baselines(seed, size=256, per_class=2000, n_check=200_000):
    """The baselines path: ``compose_features`` on a 256³ phantom,
    ``sample_train_data`` at 2000 annotations for each of 6 classes, then
    ``svm_predict_device`` over every voxel with the stand-in classifier
    (12 000 support vectors), once from the device tensor and once streamed
    from host memory. Both routes must agree bit for bit, and with an fp64
    evaluation of the same vote on 200 000 voxels at >= 0.9999 (a flip needs
    a decision within ~1e-5 of 0)."""
    vol, labels = phantom(size, seed + 23)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = compose_features(torch.from_numpy(vol).to("cuda"))
    torch.cuda.synchronize()
    t_compose = time.perf_counter() - t0
    if tuple(feats.shape) != (11, size, size, size) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"composed features {tuple(feats.shape)}")
    rng = np.random.default_rng(seed)
    ann = annotations_from_labels(labels, per_class, "uniform", rng=rng, device="cuda")
    ann["background"] = sample_uniform(torch.from_numpy(labels == 0).to("cuda"), per_class, rng=rng)
    train_X, train_y = sample_train_data(feats, ann)
    clf = stand_in_svc(train_X, train_y, seed)
    flat = torch.movedim(feats, 0, -1).reshape(-1, 11)
    n = flat.shape[0]
    del feats
    secs, preds = {}, {}
    for route, x in (("device", flat), ("host-streamed", flat.cpu().numpy())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds[route] = svm_predict_device(clf, x, device="cuda")
        torch.cuda.synchronize()
        secs[route] = time.perf_counter() - t0
    if not np.array_equal(preds["device"], preds["host-streamed"]):
        raise AssertionError("svm_predict_device: the two input routes disagree")
    pick = np.sort(np.random.default_rng(seed + 1).choice(n, n_check, replace=False))
    want = svm_votes_fp64(clf, flat[torch.from_numpy(pick).to("cuda")])
    agree = float((preds["device"][pick] == want).mean())
    counts = np.bincount(preds["device"], minlength=6)
    print(f"baselines path {size}^3: compose_features {t_compose} s; train rows {train_X.shape}, "
          f"support vectors {clf.support_vectors_.shape}; svm_predict_device over {n} voxels: "
          f"device tensor {secs['device']} s ({n / secs['device'] / 1e6} Mvoxel/s), host-streamed "
          f"{secs['host-streamed']} s ({n / secs['host-streamed'] / 1e6} Mvoxel/s), routes "
          f"bit-equal; agreement with the fp64 vote on {n_check} voxels {agree}; predicted "
          f"class counts {counts.tolist()}")
    if train_X.shape != (6 * per_class, 11) or not agree >= 0.9999 or (counts > 0).sum() < 3:
        raise AssertionError(f"baselines path: agreement {agree}, class counts {counts.tolist()}")


def card_ms(fn) -> tuple[object, float]:
    """``fn()``'s result and its wall ms on the host clock, the card
    synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def tree_to(tree, device):
    """A tree of tensors (dicts, lists, tuples, named tuples; other leaves
    kept) copied to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_to(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree.detach().to(device, copy=True) if torch.is_tensor(tree) else tree


def check_trees(name, got, want, rtol, atol) -> float:
    """Every tensor of ``got`` (on the card) within the tolerance of the
    same leaf of ``want`` (on the CPU); returns the largest |difference|."""
    if torch.is_tensor(want):
        return check_close(name, got.detach().cpu(), want, rtol, atol)
    items = want.items() if isinstance(want, dict) else enumerate(want)
    return max(check_trees(f"{name}.{k}", got[k], w, rtol, atol) for k, w in items)


def phase_foundations(seed, n_crops=4096, ks=7, probe_rows=2048, width=384, n_classes=5):
    """The trainer foundations on the card, each against the same call on
    CPU tensors (TF32 off): ``make_multiclass_volume`` at 128³ equal to the
    CPU result (without and with noise); ``feature_extractor_forward`` and
    ``pawsnet_forward`` (train and eval, class head on) at the JAX defaults
    (conv layers 8, 16, 32, hidden 128) on 4096 crops of 7³ at 1e-4, their
    BN running stats too; ``infonce_loss`` and ``paws_loss`` at 1e-5 and
    their autograd gradients at 1e-4; one ``ProbeTrainer.fit`` epoch on
    384-wide features (64 AdamW steps) with a finite, falling loss and
    parameters within 1e-4 of the CPU run's; a parameter ``.npz`` and a
    checkpoint written from card tensors and read back equal. Times are one
    call on the host clock, the card synchronized."""
    with tempfile.TemporaryDirectory(prefix="vittf_found_") as tmp:
        return _phase_foundations(seed, Path(tmp), n_crops, ks, probe_rows, width, n_classes)


def _phase_foundations(seed, tmp, n_crops, ks, probe_rows, width, n_classes):
    for noise in (0.0, 0.05):
        (vol, lab), ms = card_ms(lambda: make_multiclass_volume(128, noise, seed, device="cuda"))
        want_v, want_l = make_multiclass_volume(128, noise, seed, device="cpu")
        assert_equal(f"make_multiclass_volume noise {noise}", vol.cpu(), want_v)
        assert_equal(f"make_multiclass_volume labels noise {noise}", lab.cpu(), want_l)
        print(f"foundations: make_multiclass_volume 128^3 noise {noise} equal to the CPU run, "
              f"{ms} ms on the card")

    gen = torch.Generator().manual_seed(seed)
    cfg = PAWSNetConfig()
    params, state = init_pawsnet(cfg, gen, device="cpu")
    crops = torch.randn((n_crops, 1, ks, ks, ks), generator=gen)
    params_c, state_c, crops_c = (tree_to(t, "cuda") for t in (params, state, crops))
    enc_cfg = FeatureExtractorConfig(1, cfg.conv_layers, (cfg.conv_layers[-1],))
    got, ms = card_ms(lambda: feature_extractor_forward(params_c["encoder"], crops_c, enc_cfg))
    err = check_close("feature_extractor_forward", got.cpu(),
                      feature_extractor_forward(params["encoder"], crops, enc_cfg), 1e-4, 1e-4)
    print(f"foundations: feature_extractor_forward on {tuple(crops.shape)} -> {tuple(got.shape)} "
          f"within {err} of the CPU run, {ms} ms on the card")
    for train in (True, False):
        (out, new_s), ms = card_ms(lambda: pawsnet_forward(params_c, state_c, crops_c, cfg, train,
                                                           return_class_pred=True))
        want, want_s = pawsnet_forward(params, state, crops, cfg, train, return_class_pred=True)
        err = max(check_trees(f"pawsnet_forward train={train}", out, want, 1e-4, 1e-4),
                  check_trees(f"pawsnet BN state train={train}", new_s, want_s, 1e-4, 1e-4))
        print(f"foundations: pawsnet_forward train={train} (feat, pred, class) and BN running "
              f"stats within {err} of the CPU run, {ms} ms on the card")

    pos, neg = torch.randn((3, 2, 64, 32), generator=gen), torch.randn((3, 16, 1, 32), generator=gen)
    av, tv = torch.randn((64, 32), generator=gen), torch.randn((64, 32), generator=gen)
    sup = torch.randn((40, 32), generator=gen)
    lab = torch.eye(n_classes)[torch.randint(0, n_classes, (40,), generator=gen)]
    clas = torch.randn((104, n_classes), generator=gen)

    def losses(pos, neg, av, sup, clas, lab, tv):
        leaves = [t.requires_grad_(True) for t in (pos, neg, av, sup, clas)]
        vals = (infonce_loss(pos, neg),) + paws_loss(av, sup, lab, tv, sup, lab, clas_pred=clas)
        sum(vals).backward()
        return [v.detach() for v in vals], [t.grad for t in leaves]

    inputs = (pos, neg, av, sup, clas, lab, tv)
    (vals_c, grads_c), ms = card_ms(lambda: losses(*(t.clone().cuda() for t in inputs)))
    vals, grads = losses(*(t.clone() for t in inputs))
    err_v = check_trees("infonce_loss / paws_loss", vals_c, vals, 1e-5, 1e-5)
    err_g = check_trees("loss gradients", grads_c, grads, 1e-4, 1e-4)
    print(f"foundations: infonce_loss + paws_loss (loss, me-max, class loss) within {err_v}, "
          f"their gradients within {err_g} of the CPU run, {ms} ms on the card (with backward)")

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_classes, width)).astype(np.float32)
    y = rng.integers(0, n_classes, probe_rows)
    x = (0.5 * centers[y] + rng.standard_normal((probe_rows, width))).astype(np.float32)
    pcfg = ProbeConfig(epochs=1)
    card = ProbeTrainer(width, n_classes, pcfg, seed=seed, device="cuda")
    host = ProbeTrainer(width, n_classes, pcfg, seed=seed, device="cpu",
                        params=[{k: v.cpu() for k, v in layer.items()} for layer in card.params])
    loss_c, ms = card_ms(lambda: card.fit(x, y))
    loss_h = host.fit(x, y)
    first, last = float(np.mean(loss_c[:8])), float(np.mean(loss_c[-8:]))
    if not (np.isfinite(loss_c).all() and last < 0.8 * first):
        raise AssertionError(f"ProbeTrainer.fit: loss {first} -> {last}")
    err = max(check_trees("ProbeTrainer params", card.params, host.params, 1e-4, 1e-4),
              check_close("ProbeTrainer losses", torch.tensor(loss_c), torch.tensor(loss_h),
                          1e-4, 1e-4))
    print(f"foundations: ProbeTrainer.fit one epoch on ({probe_rows}, {width}) features, "
          f"{len(loss_c)} AdamW steps, loss {first} -> {last} (first and last eight), params "
          f"within {err} of the CPU run, {ms} ms on the card")

    (_, ms) = card_ms(lambda: save_params_npz(tmp / "p.npz", params_c))
    back = load_params_npz(tmp / "p.npz")
    check_trees("params .npz round trip", back, params, 0, 0)
    save_checkpoint(tmp / "ck", {"params": params_c, "state": state_c,
                                 "opt": card.opt.state_dict(), "step": 1}, 1)
    ck = restore_checkpoint(tmp / "ck", map_location="cuda")
    check_trees("checkpoint round trip", ck["params"], params, 0, 0)
    if ck["step"] != 1 or ck["opt"]["state"][0]["exp_avg"].device.type != "cuda":
        raise AssertionError("checkpoint round trip: step or optimizer state")
    print(f"foundations: PAWSNet params .npz ({ms} ms to write) and a checkpoint (params, BN "
          "state, AdamW state, step) read back equal")


def _records(rec) -> dict:
    """A trainer step's record as a dict (IntraCLR's is its loss)."""
    return rec if isinstance(rec, dict) else {"loss": rec}


TRAINERS = ("ContrastiveTrainer", "IntraCLRTrainer", "PAWSTrainer", "DenseContrastiveTrainer")
# biases whose shift a later normalization removes: the conv biases of the
# encoders' layers (a GroupNorm follows each) and, in PAWSNet, every bias
# that reaches a BatchNorm with no nonlinearity between (the encoder's last
# bias; in the heads bn0's and fc1's, and the projection's fc2 and fc3,
# whose features the other heads see only detached). Their gradients are
# sums that cancel to rounding, so their optimizer state holds the card's
# and the CPU's reduction orders
NORM_FED = re.compile(r"(^|\.)((convs|lins)\.\d+\.conv\.bias|encoder\.last\.bias"
                      r"|(proj|head|predict)\.(bn0|fc1)\.bias|proj\.fc[23]\.bias)$")


def trainer_phantom(seed, size) -> tuple[np.ndarray, np.ndarray]:
    """A ``make_multiclass_volume`` phantom (volume, int32 labels) on the host."""
    vol_t, lab_t = make_multiclass_volume(size, 0.05, seed, device="cpu")
    return vol_t.numpy(), lab_t.numpy().astype(np.int32)


def make_trainer(name, phantom, seed, device):
    """Trainer ``name`` at its JAX default config on ``phantom``; PAWS takes
    three classes, the shell's value (3) marking its unlabeled voxels."""
    vol, lab = phantom
    names = ["background", "sphere", "torus", "shell"]
    if name == "ContrastiveTrainer":
        return ContrastiveTrainer(vol, lab, seed=seed, device=device)
    if name == "IntraCLRTrainer":
        return IntraCLRTrainer(vol, seed=seed, device=device)
    if name == "PAWSTrainer":
        return PAWSTrainer(vol, lab, names[:3], seed=seed, device=device)
    return DenseContrastiveTrainer(vol, lab, names, seed=seed, device=device)


def trainer_state(trainer) -> dict:
    """What a trainer's step reads and writes besides its host draws."""
    return {f: getattr(trainer, f) for f in ("params", "head_params", "bn_state", "opt_state")
            if hasattr(trainer, f)}


def opt_state_leaves(trainer, state=None, paths=None, prefix="opt_state"):
    """(name, leaf) of a trainer's optimizer state: the step counts, and each
    tensor of a per-parameter list named by its parameter's path."""
    if state is None:
        params = (trainer.params, trainer.head_params) if hasattr(trainer, "head_params") \
            else trainer.params
        paths = []
        tree_map_with_path(lambda p, _: paths.append(".".join(p)), params)
        if isinstance(trainer.opt_state, dict):  # multi_transform: a state per label
            labels = tree_leaves(_lars_label_fn(trainer.params))
            paths = {k: [p for p, lab in zip(paths, labels) if lab == k]
                     for k in trainer.opt_state}
        state = trainer.opt_state
    if isinstance(state, dict):
        for k, s in state.items():
            yield from opt_state_leaves(trainer, s, paths[k], f"{prefix}.{k}")
    elif isinstance(state, list):
        if len(state) != len(paths):
            raise AssertionError(f"{prefix}: {len(state)} tensors for {len(paths)} parameters")
        for p, t in zip(paths, state):
            yield f"{prefix}.{p}", t
    elif isinstance(state, tuple):
        for f, s in zip(getattr(state, "_fields", range(len(state))), state):
            yield from opt_state_leaves(trainer, s, paths, f"{prefix}.{f}")
    else:
        yield prefix, state


def check_opt_state(name, card, host, share) -> tuple[float, list[str]]:
    """The card trainer's optimizer state against the CPU trainer's: every
    count equal, every moment or trace within ``share`` of its leaf's largest
    |value|, but the ``NORM_FED`` leaves (returned by name). Returns the
    largest leaf-scaled difference and the names left out."""
    got, want = dict(opt_state_leaves(card)), dict(opt_state_leaves(host))
    if got.keys() != want.keys():
        raise AssertionError(f"{name}: optimizer states of other structure")
    worst, skipped, bad = 0.0, [], []
    for k, w in want.items():
        g = got[k]
        if not torch.is_tensor(w):
            if g != w:
                bad.append(f"{k}: count {g} on the card, {w} on the CPU")
        elif NORM_FED.search(k):
            skipped.append(k)
        else:
            scale = w.abs().max().item()
            err = (g.detach().cpu() - w).abs().max().item()
            if not err <= share * scale:
                bad.append(f"{k}: {err} apart, {share} of its largest {scale}")
            worst = max(worst, err / scale if scale else 0.0)
    if bad:
        raise AssertionError(f"{name} optimizer state: {bad}")
    return worst, skipped


def phase_trainers(seed, size=128, dense_size=96, steps=10):
    """5d: each trainer at its JAX default config on a ``size``³ phantom
    (the dense one, whose step is a full-volume forward and backward, on
    ``dense_size``³), ``steps`` steps on the card and on the CPU from the
    same initial values and draws (host indices from the same seed,
    augmentations from generators seeded alike), TF32 off. The crop and the
    dense contrastive trainers run free: each step's records within 1e-4 of
    the CPU step's, and after the last step the parameters (the dense head)
    within 1e-4 and the optimizer state (``check_opt_state``) within 1e-3 of
    each leaf's largest. PAWS at its defaults amplifies fp32 rounding (an
    H100 and the CPU part by 3.4e-3 in a loss by step 4 run free), so its
    CPU trainer takes the card trainer's state before each step, and each
    step is held from one state: records, parameters and BatchNorm state
    within 1e-4, the optimizer state as above. Then the dense step at
    ``size``³ on the card alone (timed), and the training CLI with
    checkpoints and a resume. Step times are host-clock ms of one step, the
    card synchronized."""
    phantoms = {n: trainer_phantom(seed, n) for n in {size, dense_size}}
    for name in TRAINERS:
        n = dense_size if name == "DenseContrastiveTrainer" else size
        resync = name == "PAWSTrainer"
        torch.cuda.reset_peak_memory_stats()
        card, host = (make_trainer(name, phantoms[n], seed, dev) for dev in ("cuda", "cpu"))
        ms, err_rec, err_state, err_opt, host_s, loss = [], 0.0, 0.0, 0.0, 0.0, []
        for i in range(steps):
            if resync:
                for f, tree in trainer_state(card).items():
                    tree = tree_to(tree, "cpu")
                    if f.endswith("params"):
                        tree = tree_map_with_path(lambda _, t: t.requires_grad_(True), tree)
                    setattr(host, f, tree)
            rec, t = card_ms(card.step)
            ms.append(t)
            t0 = time.perf_counter()
            want = _records(host.step())
            host_s += time.perf_counter() - t0
            for k, v in want.items():
                got = _records(rec)[k]
                if not np.isfinite(got):
                    raise AssertionError(f"{name} step {i + 1}: {k} = {got}")
                err_rec = max(err_rec, check_close(f"{name} step {i + 1} {k}", torch.tensor(got),
                                                   torch.tensor(v), 1e-4, 1e-4))
            if resync or i == steps - 1:
                got, want = trainer_state(card), trainer_state(host)
                del got["opt_state"], want["opt_state"]
                err_state = max(err_state, check_trees(f"{name} step {i + 1}", got, want,
                                                       1e-4, 1e-4))
                worst, skipped = check_opt_state(f"{name} step {i + 1}", card, host, 1e-3)
                err_opt = max(err_opt, worst)
            loss.append(_records(rec)["loss"])
        held = "each step from the card's state" if resync else "run free"
        print(f"trainers: {name} {n}^3 {card.cfg.__class__.__name__}() defaults, {steps} steps "
              f"{held}: loss {loss[0]} -> {loss[-1]}, each step's records within {err_rec}, "
              f"{'/'.join(trainer_state(card))[:-len('/opt_state')]} within {err_state} of "
              f"the CPU's, optimizer state counts equal and moments within {err_opt} of each "
              f"leaf's largest (left out, ahead of a norm: {len(skipped)} leaves "
              f"{[k.split('.', 1)[1] for k in skipped]}); step ms median "
              f"{float(np.median(ms))} (first {ms[0]}; CPU steps {host_s} s), peak "
              f"{torch.cuda.max_memory_allocated() / 2**30} GiB")
        del card, host
    if dense_size != size:
        torch.cuda.reset_peak_memory_stats()
        card = make_trainer("DenseContrastiveTrainer", phantoms[size], seed, "cuda")
        ms, loss = [], []
        for i in range(steps):
            rec, t = card_ms(card.step)
            if not all(np.isfinite(v) for v in rec.values()):
                raise AssertionError(f"DenseContrastiveTrainer {size}^3 step {i + 1}: {rec}")
            ms.append(t)
            loss.append(rec["loss"])
        print(f"trainers: DenseContrastiveTrainer {size}^3 on the card alone, {steps} steps: "
              f"loss {loss[0]} -> {loss[-1]}, finite; step ms median {float(np.median(ms))} "
              f"(first {ms[0]}), peak {torch.cuda.max_memory_allocated() / 2**30} GiB")
        del card
    torch.cuda.empty_cache()

    vol, lab = phantoms[size]
    with tempfile.TemporaryDirectory(prefix="vittf_train_") as tmp:
        tmp = Path(tmp)
        np.save(tmp / "data.npy", {"vol": vol, "mask": lab,
                                   "labels": ["background", "sphere", "torus"]}, allow_pickle=True)
        args = ["--trainer", "paws", "--data", str(tmp / "data.npy"), "--ckpt-dir",
                str(tmp / "ckpt"), "--ckpt-every", "2", "--log-jsonl", str(tmp / "log.jsonl"),
                "--log-every", "0"]
        rc, ms_first = card_ms(lambda: train_cli.main(args + ["--iterations", "4"]))
        rc2, ms_resume = card_ms(lambda: train_cli.main(args + ["--iterations", "8", "--resume"]))
        log = [json.loads(line) for line in (tmp / "log.jsonl").read_text().splitlines()]
        state = restore_checkpoint(tmp / "ckpt", map_location="cuda")
        if (rc, rc2) != (0, 0) or [r["step"] for r in log] != list(range(1, 9)) \
                or not all(np.isfinite(r["loss"]) for r in log) \
                or checkpoint_steps(tmp / "ckpt") != [2, 4, 6, 8] or state["step"] != 8:
            raise AssertionError(f"cli/train.py paws: rc {rc} {rc2}, log {log}, "
                                 f"checkpoints {checkpoint_steps(tmp / 'ckpt')}")
    print(f"trainers: cli/train.py --trainer paws on {size}^3: 4 iterations with checkpoints "
          f"{ms_first} ms, --resume to 8 {ms_resume} ms (log steps 1-8, losses "
          f"{[round(r['loss'], 4) for r in log]}, checkpoints at 2, 4, 6, 8); on {smi_line()}")


def rgb_phantom(size, seed):
    """(target (size³) fp32 in [0, 1], reference (3, size³) uint8): the
    phantom's ellipsoids in three colour channels of distinct mixing."""
    vol, labels = phantom(size, seed)
    v = (vol - vol.min()) / (vol.max() - vol.min())
    mix = np.array([[1.0, 0.0], [0.6, 0.4], [0.3, 0.7]], np.float32)
    tint = (labels.astype(np.float32) / 5.0)
    r = np.stack([m[0] * v + m[1] * tint for m in mix])
    rng = np.random.default_rng(seed + 1)
    t = np.clip((labels == 1) * 0.7 + 0.15 + 0.1 * rng.standard_normal(v.shape), 0, 1)
    return t.astype(np.float32), np.trunc(255.0 * r).astype(np.uint8)


def phase_tools(seed, workdir: Path, size=64):
    """The tools path: the sampling-strategy comparison at 64³ x 384 (K2 with
    no threshold and scores of either sign, maps against the plain route
    within the uint8 contract), ``resample_topk`` on tie-heavy maps, the
    sparse RGB bilateral solve against the same solve on CPU tensors, and
    an extraction with the CLIP/BLIP feature source. Returns K2's launches
    in the comparison's own run."""
    _, labels = phantom(size, seed + 29)
    gen = torch.Generator().manual_seed(seed + 29)
    centers = torch.randn(6, SIM_F, generator=gen)
    feats = centers[torch.from_numpy(labels.astype(np.int64))] + 1.5 * torch.randn(
        (size,) * 3 + (SIM_F,), generator=gen)
    feats = torch.movedim(feats, -1, 0).contiguous().to("cuda")  # (F, 64, 64, 64)

    # K2 in this regime, kernel against plain, exponents 2 (the tool's) and 3
    fn = normalize_features(feats)
    flat = torch.movedim(fn, 0, -1).reshape(-1, SIM_F).contiguous()
    queries = flat[:: flat.shape[0] // 256][:256].contiguous()
    m = torch.from_numpy(class_mean_matrix([256], 256)).to("cuda")
    errs = []
    for exponent in (2.0, 3.0):
        got = similarity(flat, queries, m, threshold=-1e30, exponent=exponent)
        want = similarity_plain(flat, queries, m, threshold=-1e30, exponent=exponent)
        errs.append(check_close(f"similarity no threshold exponent {exponent}", got, want,
                                1e-4, 1e-6))
        negative = int((want < 0).sum().item())
    print(f"similarity ({flat.shape[0]}, {SIM_F}) x (256, {SIM_F}) threshold -1e30, exponents "
          f"2 and 3: max_abs_err {errs}; negative means at exponent 3: {negative}")
    if negative == 0:
        raise AssertionError("the no-threshold case holds no negative score")

    similarity.launches = 0
    t0 = time.perf_counter()
    written = compare_sampling_strategies(feats, labels, 256, workdir / "cmp", rng=np.random.default_rng(seed))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_sim = similarity.launches
    plain = compare_sampling_strategies(feats, labels, 256, workdir / "cmp_plain",
                                        rng=np.random.default_rng(seed), impl="plain")
    n_diff = 0
    for key, path in written.items():
        got = np.load(path)
        if got.shape != (size,) * 3 or got.dtype != np.uint8 or not got.any():
            raise AssertionError(f"comparison map {key}: {got.shape} {got.dtype}")
        n_diff += check_u8_maps(f"comparison map {key}", torch.from_numpy(got),
                                torch.from_numpy(np.load(plain[key])))
    print(f"tools path: compare_sampling_strategies {size}^3 x {SIM_F}, {len(written)} maps in "
          f"{dt} s, similarity launches {n_sim}; vs the plain route {n_diff} voxels differ by 1")
    if len(written) != 5 or n_sim != 5:
        raise AssertionError(f"comparison: {len(written)} maps, {n_sim} launches")

    maps = torch.stack([torch.from_numpy(np.load(p)) for p in written.values()]).to("cuda")
    sims = (maps.float() / 255.0).reshape(5, 1, size, size, size)  # 256 levels: heavy ties
    got = resample_topk(fn, sims, K=8)
    want = resample_topk(fn.cpu(), sims.cpu(), K=8)
    err = check_close("resample_topk card vs CPU", got.cpu(), want, 1e-4, 1e-5)
    print(f"resample_topk {tuple(sims.shape)} K=8: max_abs_err to the CPU run {err}")
    del feats, fn, flat, maps, sims, got, want

    t, r = rgb_phantom(size, seed + 31)
    gp = {"sigma_spatial": 8, "sigma_luma": 16, "sigma_chroma": 16}
    t0 = time.perf_counter()
    got = apply_bilateral_solver3d_rgb(torch.from_numpy(t).to("cuda"), r, grid_params=gp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    want = apply_bilateral_solver3d_rgb(torch.from_numpy(t), r, grid_params=gp)
    err = check_close("sparse RGB bilateral solve card vs CPU", got.cpu(), want, 0.0, 2e-4)
    print(f"apply_bilateral_solver3d_rgb {size}^3: {dt} s (host hash build included), "
          f"max_abs_err to the CPU solve {err}, output std {want.std().item()}")
    if not want.std().item() > 0.01:
        raise AssertionError("the sparse solve's output is flat")

    cfg = resolve_model("vits8")
    params = init_vit_params(cfg, (0, seed))
    vol, _ = phantom(32, seed + 37)
    outs = {}
    for impl in ("auto", "plain"):
        ex = ExtractConfig(feature_output_size=32, compute_dtype="bfloat16", attn_impl=impl,
                           feature_source="mlp")
        outs[impl] = extract_features(vol, params, cfg, ex, device="cuda")["k"]
    if tuple(outs["auto"].shape) != (cfg.embed_dim // 3, 32, 32, 32):
        raise AssertionError(f"mlp-source features {tuple(outs['auto'].shape)}")
    err = check_rel("mlp-source extraction kernels vs plain", outs["auto"], outs["plain"], 0.02)
    print(f"mlp-source extraction 32^3 fos 32: shape {tuple(outs['auto'].shape)}, kernels vs "
          f"plain max_abs_err {err} (limit {0.02 * outs['plain'].abs().max().item()})")
    return n_sim


SSL_METHODS = ("supcon", "infonce", "dino")
SSL_CHECKED_STEPS = 2  # steps of each method replayed on CPU tensors
SSL_ORACLE_STEPS = 250  # the oracle's steps on the card (~30 s), fixed so that 14c repeats


def _cpu_replay(args, cfg):
    """A step's arguments copied to the CPU before the card runs it: trees
    of tensors and tensors copied (the trained tree requiring grad again),
    the AdamW rebuilt over the copies with the card optimizer's state,
    configs kept. Returns (args, the first moments before the step)."""
    out, m_old = [], None
    trees = [a for a in args if isinstance(a, dict)]
    params = trees[0]  # the trained tree (ssl, supcon: params; dino: student)
    for a in args:
        if a is params:
            out.append(tree_map_with_path(
                lambda _, t: t.detach().to("cpu", copy=True).requires_grad_(True), a))
        elif isinstance(a, torch.optim.Optimizer):
            opt = vit_ssl.make_optimizer(out[0], cfg)
            opt.load_state_dict(copy.deepcopy(a.state_dict()))  # no shared step count
            m_old = [opt.state[p]["exp_avg"].clone() if p in opt.state else torch.zeros_like(p)
                     for p in tree_leaves(out[0])]
            out.append(opt)
        elif isinstance(a, dict):  # the teacher, draws
            out.append(tree_to(a, "cpu"))
        elif torch.is_tensor(a):
            out.append(a.detach().to("cpu", copy=True))
        else:
            out.append(a)
    return out, m_old


def check_adam_step(name, card, host, grads, lr) -> float:
    """An AdamW step's parameters on the card within 1e-5 of each leaf's
    largest value of the CPU step's where the gradient is at least 1e-3 of
    the leaf's largest (there Adam's update lr·m̂/(√v̂ + eps) is smooth in
    it), and within 2·lr where it is smaller (Adam scales the rounding of a
    gradient near zero, as of the k bias softmax cancels, to a step of up
    to lr); returns the largest |difference| of the first kind."""
    worst = 0.0
    for (path, w), g, gr in zip(flat_leaves(host), tree_leaves(card), grads):
        d = (g.detach().cpu() - w.detach()).abs()
        big = gr.abs() >= 1e-3 * gr.abs().max()
        lim = 1e-5 * w.abs().max().item() + 1e-3 * lr
        e_big = d[big].max().item()
        e_small = d[~big].max().item() if (~big).any() else 0.0
        if e_big > lim or e_small > 2 * lr or not torch.isfinite(g).all():
            raise AssertionError(f"{name} {path}: card vs CPU {e_big} (limit {lim}), "
                                 f"small-gradient entries {e_small} (limit {2 * lr})")
        worst = max(worst, e_big)
    return worst


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in flat_leaves(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def phase_vit_ssl(seed, size=128):
    """5e: the ViT self-supervision at ViT-S/8 full width (random weights
    ``init_vit_params``), each method (``supcon``, ``infonce``, ``dino``) 10
    steps through ``train_vit_selfsup`` at the JAX defaults (im_sz 64, batch
    16) on a ``make_multiclass_volume`` phantom: the median step ms (host
    clock, the card synchronized), and the first ``SSL_CHECKED_STEPS`` steps
    replayed on CPU tensors from the card's state before each (parameters,
    AdamW state, the DINO teacher and centre) with the same slices and
    draws, TF32 off: the loss within 1e-4, the gradients (from Adam's first
    moment) within 1e-3 of each leaf's largest, the parameters as
    ``check_adam_step`` holds them, the teacher likewise, the centre within
    1e-4. Then ``VIT_SSL_ORACLE`` for ``SSL_ORACLE_STEPS`` steps; its loss
    trajectory is printed and its teacher returned (the state dict of the
    trained ViT)."""
    cfg = resolve_model("vits8")
    sd = init_vit_params(cfg, (0, seed))
    vol, labels = trainer_phantom(seed, size)
    step_names = {"supcon": "_supcon_step", "infonce": "_ssl_step", "dino": "_dino_step"}
    median = {}
    for method in SSL_METHODS:
        scfg = vit_ssl.ViTSelfSupConfig(method=method, steps=10)
        real = getattr(vit_ssl, step_names[method])
        ms, errs = [], []

        def step(*args):
            i = len(ms)
            if i < SSL_CHECKED_STEPS:
                host_args, m_old = _cpu_replay(args, scfg)
            out, t = card_ms(lambda: real(*args))
            ms.append(t)
            if i < SSL_CHECKED_STEPS:
                want = real(*host_args)
                opts = [next(a for a in r if isinstance(a, torch.optim.Optimizer))
                        for r in (out, want)]
                # the step's gradients from Adam's first moment, m = 0.9·m_old + 0.1·g
                g_card, grads = ([(o.state[p]["exp_avg"].cpu() - 0.9 * m) / 0.1
                                  for p, m in zip(tree_leaves(r[0]), m_old)]
                                 for o, r in zip(opts, (out, want)))
                name = f"vit_ssl {method} step {i + 1}"
                loss_err = check_close(f"{name} loss", out[-1].cpu(), want[-1], 1e-4, 0.0)
                g_err = max(check_rel(f"{name} gradient", g, w, 1e-3)
                            for g, w in zip(g_card, grads))
                p_err = check_adam_step(name, out[0], want[0], grads, scfg.learning_rate)
                if method == "dino":
                    p_err = max(p_err, check_adam_step(f"{name} teacher", out[1], want[1], grads,
                                                       scfg.learning_rate))
                    check_rel(f"{name} centre", out[3].cpu(), want[3], 1e-4)
                errs.append((loss_err, g_err, p_err))
            return out

        with mock.patch.object(vit_ssl, step_names[method], step):
            _, hist = vit_ssl.train_vit_selfsup(vol, sd, cfg, scfg, seed=seed, log_every=1,
                                                labels=labels, device="cuda")
        losses = [h["loss"] for h in hist]
        if len(ms) != 10 or not np.isfinite(losses).all():
            raise AssertionError(f"vit_ssl {method}: {len(ms)} steps, losses {losses}")
        median[method] = float(np.median(ms))
        print(f"vit_ssl {method}: ViT-S/8, im_sz 64, batch 16, 10 steps on {size}^3: loss "
              f"{losses[0]} -> {losses[-1]}; step ms median {median[method]} (first {ms[0]}); "
              f"steps 1-{SSL_CHECKED_STEPS} vs the same steps on CPU tensors from the card's "
              f"state (loss, gradient of each leaf's largest, parameters): {errs}")
    steps = SSL_ORACLE_STEPS
    ocfg = vit_ssl.ViTSelfSupConfig(**{**vit_ssl.VIT_SSL_ORACLE, "steps": steps})
    t0 = time.perf_counter()
    trained, hist = vit_ssl.train_vit_selfsup(vol, sd, cfg, ocfg, seed=seed,
                                              log_every=max(1, steps // 10), device="cuda")
    dt = time.perf_counter() - t0
    if not all(np.isfinite(h["loss"]) for h in hist) or set(trained) != set(sd):
        raise AssertionError(f"VIT_SSL_ORACLE: {hist}")
    print(f"vit_ssl VIT_SSL_ORACLE (dino, adjacent slices): {steps} steps in {dt} s, loss "
          f"trajectory {[(h['step'], round(h['loss'], 5)) for h in hist]}")
    return trained


def phase_quality(seed, trained, size=128):
    """5f: the quality harness at ``size``³ on ViT-S/8: the fast-mode A/B
    (``fastmode_quality_experiment``, fos 32) and the refinement A/B
    (``refinement_quality_experiment`` on the ViT's fos-32 features: the
    bilateral solver and the island filter), on the random weights (per-op
    blocks: the attention kernel) and on the weights trained in 5e (fused
    blocks: the fused block kernel); mIoU, stage times and the launch
    counters of each run, which must show the attention or fused block, the
    similarity, splat, slice and blur kernels. Then ``ntf_predict`` in
    parity mode (fp32) through the kernels and through the plain twins on
    the card: the predictions differ on at most 1e-3 of the voxels (phase
    6's knife-edge share)."""
    cfg = resolve_model("vits8")
    counted = (attention, fused_block, similarity) + BLS_KERNELS
    weights = {"random": (init_vit_params(cfg, (0, seed)), "xla"), "trained": (trained, "fused")}
    for label, (sd, block_impl) in weights.items():
        for fn in counted:
            fn.launches = 0
        ex = ExtractConfig(feature_output_size=size // 4, compute_dtype="bfloat16",
                           block_impl=block_impl)
        fast = quality.fastmode_quality_experiment(size, sd, cfg, ex, seed=seed, device="cuda")
        vol_t, _ = make_multiclass_volume(size, seed=seed, device="cuda")
        feats, t_feats = card_ms(lambda: extract_features(vol_t, sd, cfg, ex, device="cuda")["k"])
        refined, t_ref = card_ms(lambda: quality.refinement_quality_experiment(
            size, seed=seed, features=feats, feature_source=f"vit-{label}", device="cuda"))
        n = {fn.__name__: fn.launches for fn in counted}
        block = "attention" if block_impl == "xla" else "fused_block"
        if min(n[block], n["similarity"], n["bls_splat"], n["bls_slice"], n["bls_blur"]) == 0:
            raise AssertionError(f"quality {label}: a kernel was not launched: {n}")
        print(f"quality {label} weights ({block_impl} blocks), {size}^3 easy phantom, fos "
              f"{size // 4}: fast-mode A/B mIoU full {fast['full']['mIoU_fg']} fast "
              f"{fast['fast']['mIoU_fg']} (delta {fast['iou_delta']}), extract s full "
              f"{fast['full']['extract_s']} fast {fast['fast']['extract_s']}, similarity s "
              f"{fast['full']['similarity_s']}; refinement A/B mIoU base "
              f"{refined['base']['mIoU_fg']} bls {refined['bls']['mIoU_fg']} island "
              f"{refined['island']['mIoU_fg']} bls_island {refined['bls_island']['mIoU_fg']} "
              f"(ceiling {refined['grid_ceiling']['mIoU_fg']}), features {t_feats} ms, the four "
              f"cells {t_ref} ms; launches {n}")
    vol, labels = make_multiclass_volume(size, seed=seed, device="cuda")
    ann = annotations_from_labels(labels, 256, "both", rng=np.random.default_rng(seed),
                                  device="cuda")
    ex = ExtractConfig(feature_output_size=size // 4, precision="highest")
    got, times = quality.ntf_predict(vol, trained, cfg, ex, ann, device="cuda")
    plain_sim = functools.partial(compute_similarities, impl="plain")
    with mock.patch.object(quality, "compute_similarities", plain_sim):
        want, _ = quality.ntf_predict(vol, trained, cfg, dataclasses.replace(ex, attn_impl="plain"),
                                      ann, device="cuda")
    differ = (got != want).count_nonzero().item()
    if got.shape != vol.shape or differ > 1e-3 * got.numel():
        raise AssertionError(f"ntf_predict kernels vs plain twins: {differ} voxels differ")
    print(f"quality ntf_predict (fp32, trained weights) kernels vs plain twins on the card: "
          f"{differ} of {got.numel()} voxels differ; stage s {times}")


def _gloo_cuda_rank(rank, port, out_path):
    """One of two ranks on one card over gloo with CUDA tensors: the sharded
    extraction and similarity. Any error, gloo refusing CUDA tensors too,
    fails the rank and so the phase."""
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=2, rank=rank,
                                         timeout=datetime.timedelta(seconds=60))
    cfg = resolve_model("vits8")
    vol, _ = phantom(32, 3)
    ex = ExtractConfig(feature_output_size=16, compute_dtype="bfloat16")
    feats = extract_features_sharded(vol, init_vit_params(cfg, (0, 0)), cfg, ex, make_mesh(),
                                     device="cuda")["k"]
    f, q, m = similarity_inputs(feats)
    sims = similarity_sharded(f, q, m, make_mesh())
    if rank == 0:
        torch.save({"feats": feats.cpu(), "sims": sims.cpu()}, out_path)
    torch.distributed.destroy_process_group()


def similarity_inputs(feats):
    """(N, F) voxel features of a feature volume, 5 × 64 queries drawn from
    them and the class-mean matrix: a similarity call of the request's form."""
    f = feats.reshape(feats.shape[0], -1).T.contiguous()
    idx = torch.from_numpy(np.random.default_rng(0).choice(f.shape[0], 320)).to(f.device)
    m = torch.from_numpy(class_mean_matrix([64] * 5, 320)).to(f.device)
    return f, f[idx].contiguous(), m


def phase_parallel(seed, workdir: Path, fos=64):
    """5g: the multi-device layer at world size 1 on NCCL (one H100): the
    sharded extraction (128³, ViT-S/8, fos 64, bf16) and similarity are
    ``torch.equal`` to the plain extraction and the similarity kernel; the
    pipeline-parallel forward with one stage (one microbatch: equal; two:
    1e-5 of max|ref|) and the tensor-parallel forward with ``model=1``
    (1e-5 of max|ref|: its row biases are added after the product) against
    the plain forward, fp32; ``infer --data-parallel`` under the one-rank
    group writes the plain CLI's artifact (phase 6's) bit for bit. Then two
    ranks on the one card over gloo with CUDA tensors: what they compute is
    held against the plain path (1e-5 of max|ref|); an error in either rank,
    gloo refusing the CUDA tensors too, fails the phase."""
    from torch.distributed.device_mesh import DeviceMesh

    port = free_port()
    torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=1, rank=0)
    try:
        cfg = resolve_model("vits8")
        sd = init_vit_params(cfg, (0, seed))
        mesh = make_mesh()
        vol = np.load(workdir / "volume.npy")
        ex = ExtractConfig(feature_output_size=fos, compute_dtype="bfloat16")
        n0 = attention.launches
        got, t_sharded = card_ms(lambda: extract_features_sharded(vol, sd, cfg, ex, mesh,
                                                                  device="cuda")["k"])
        n_attn = attention.launches - n0
        want, t_plain = card_ms(lambda: extract_features(vol, sd, cfg, ex, device="cuda")["k"])
        assert_equal("sharded extraction, one rank", got, want)
        f, q, m = similarity_inputs(want)
        assert_equal("sharded similarity, one rank", similarity_sharded(f, q, m, mesh),
                     similarity(f, q, m))
        images = torch.randn((4, 3, 224, 224), generator=torch.Generator().manual_seed(seed)
                             ).to("cuda")
        model = VisionTransformer.from_state_dict(cfg, sd).to("cuda")
        ref = model.forward_raw(images, precision="highest")
        pipe = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("pipe",))
        sd_c = {k: v.to("cuda") for k, v in sd.items()}
        pp1 = pp_vit_forward(sd_c, images, cfg, pipe, n_micro=1, precision="highest",
                             attn_impl="auto")
        pp2 = pp_vit_forward(sd_c, images, cfg, pipe, n_micro=2, precision="highest",
                             attn_impl="auto")
        tp = tp_vit_forward(shard_params(sd_c, mesh), images, cfg, mesh, precision="highest")
        for name, out in (("pipeline, one stage, one microbatch", pp1),):
            for o, r in zip(out, ref):
                assert_equal(name, o, r)
        errs = [check_rel(name, o, r, 1e-5) for name, out in
                (("pipeline, one stage, two microbatches", pp2), ("tensor parallel, model=1", tp))
                for o, r in zip(out, ref)]
        dp = workdir / "dp_features.npy"
        infer.main(["--data-path", str(workdir / "volume.npy"), "--dino-model", "vits8",
                    "--feature-output-size", str(fos), "--compute-dtype", "bfloat16",
                    "--data-parallel", "--cache-path", str(dp)])
        plain_art = np.load(workdir / f"volume_vits8_all_features{fos}.npy",
                            allow_pickle=True)[()]
        if not np.array_equal(np.load(dp, allow_pickle=True)[()]["k"], plain_art["k"]):
            raise AssertionError("infer --data-parallel on one rank: not the plain artifact")
    finally:
        torch.distributed.destroy_process_group()
    print(f"parallel, one rank on NCCL: sharded extraction {vol.shape} fos {fos} ({n_attn} "
          f"attention launches) equal to the plain one ({t_sharded} ms vs {t_plain} ms), sharded "
          f"similarity equal to the kernel's; pipeline forward (1 stage) equal with one "
          f"microbatch, pipeline with two and tensor parallel (model=1) within {errs} of the "
          f"plain forward; infer --data-parallel writes the plain artifact")

    with tempfile.TemporaryDirectory(prefix="vittf_gloo_") as tmp:
        out_path = Path(tmp) / "rank0.pt"
        torch.multiprocessing.start_processes(_gloo_cuda_rank, args=(free_port(), out_path),
                                              nprocs=2, start_method="spawn", join=True)
        res = torch.load(out_path, weights_only=False)
    vol, _ = phantom(32, 3)
    ex = ExtractConfig(feature_output_size=16, compute_dtype="bfloat16")
    want = extract_features(vol, init_vit_params(cfg, (0, 0)), cfg, ex, device="cuda")["k"]
    err = check_rel("two gloo ranks: sharded extraction", res["feats"].cuda(), want, 1e-5)
    f, q, m = similarity_inputs(want)
    err_s = check_rel("two gloo ranks: sharded similarity", res["sims"].cuda(),
                      similarity(f, q, m), 1e-5)
    print(f"parallel, two ranks on one card over gloo with CUDA tensors: gloo takes them; "
          f"sharded extraction 32^3 within {err}, similarity within {err_s} of one process")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    resident on the card, three refined requests, and a warm step of the
    PAWS and the dense trainer at their defaults on a 128³ phantom."""
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

    ref = make_bls_reference(vol, tuple(n // 2 for n in vol.shape), device="cuda")

    for _ in range(2):  # warm-up: each request's key seen, then its refine core captured
        bls_requests(vol, feats, anns, ref=ref)
    since = graph_counts()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        bls_requests(vol, feats, anns, ref=ref)
        wall = time.perf_counter() - t0
    device_breakdown(prof, wall, "3 refined requests (bilateral_solver, bucket 8), 64^3 "
                     f"features; {graph_line(since)}")
    with profile(activities=acts, with_stack=True, record_shapes=True) as prof:
        bls_requests(vol, feats, anns, ref=ref)
    copy_sources(prof, "3 refined requests")

    phantom_128 = trainer_phantom(seed, 128)
    for name in ("PAWSTrainer", "DenseContrastiveTrainer"):
        trainer = make_trainer(name, phantom_128, seed, "cuda")
        trainer.step()  # warm-up
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            trainer.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device_breakdown(prof, wall, f"{name} step, 128^3, defaults")
        del trainer


def print_ptxas():
    """What ``nvcc -Xptxas -v`` says of every kernel: registers, shared
    memory, stack and spills, and any performance warning (one more compile
    of every source)."""
    for src, log in kernels.ptxas_report().items():
        entry = stack = ""
        for line in log.splitlines():
            if "Performance Loss" in line:  # e.g. serialized wgmma (C7513, C7514)
                print(f"ptxas {src}: {line.split(':', 1)[1].strip()}")
            elif "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "bytes stack frame" in line:
                stack = line.strip()
            elif "Used" in line and "registers" in line:
                print(f"ptxas {src} {entry}: {line.split(':', 1)[1].strip()}; {stack}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace extraction and requests with torch.profiler")
    ap.add_argument("--ptxas", action="store_true",
                    help="also print each kernel's registers, shared memory and spills")
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
    if args.ptxas:
        print_ptxas()

    gen = torch.Generator().manual_seed(args.seed)
    entries = {"attention": phase_attention(gen), "similarity": phase_similarity(gen)}
    entries.update(phase_bilateral(gen))
    entries["fused_block"] = phase_fused_block(gen)
    entries["chain_gemm"] = phase_chain_gemm()
    entries["swiglu"] = phase_swiglu(gen)
    n_swiglu = phase_swiglu_path(args.seed)
    n_k9 = phase_probe_path()
    phase_baselines(args.seed)
    phase_foundations(args.seed)
    phase_trainers(args.seed)
    with tempfile.TemporaryDirectory(prefix="vittf_smoke_") as tmp:
        n_attn, n_sim, vol, labels, feat_t = phase_main_path(args.seed, Path(tmp))
        n_k3 = phase_fused_path(args.seed, Path(tmp))
        n_bls = phase_refinement(args.seed, Path(tmp), vol, labels, feat_t)
        del feat_t
        phase_core_witness(args.seed)
        phase_capture_parts(args.seed)
        phase_whole_grid(args.seed)
        phase_fast(args.seed, Path(tmp))
        phase_consistency(args.seed)
        n_blocked = phase_blocked_path(args.seed)
        phase_coarse_to_fine(args.seed)
        phase_graph_memory(args.seed)
        phase_served(args.seed, Path(tmp), vol, labels,
                     Path(tmp) / "volume_vits8_all_features64.npy")
        n_sim += phase_tools(args.seed, Path(tmp))
        trained = phase_vit_ssl(args.seed)
        phase_quality(args.seed, trained)
        phase_parallel(args.seed, Path(tmp))
    if args.profile:
        phase_profile(args.seed)

    csrc = "vittf_tpu_torch/csrc/"
    kernel_list = [
        ("attention", "attention.cu", "vittf_tpu/ops/attention.py:73", n_attn),
        ("similarity", "similarity.cu", "vittf_tpu/ops/similarity.py:109", n_sim),
        ("bls_splat", "bilateral.cu", "vittf_tpu/ops/bilateral.py:333", n_bls[0]),
        ("bls_slice", "bilateral.cu", "vittf_tpu/ops/bilateral.py:412", n_bls[1]),
        ("bls_blur", "bilateral.cu", "vittf_tpu/ops/bilateral.py:495", n_bls[2]),
        ("fused_block", "fused_block.cu", "vittf_tpu/ops/fused_block.py:292", n_k3),
        ("bls_reblock", "bilateral_reblock.cu", "vittf_tpu/ops/bilateral.py:104", n_blocked[0]),
        ("bls_unreblock", "bilateral_reblock.cu", "vittf_tpu/ops/bilateral.py:165", n_blocked[1]),
        ("bls_splat_blocked", "bilateral_reblock.cu", "vittf_tpu/ops/bilateral.py:210",
         n_blocked[2]),
        ("bls_slice_blocked", "bilateral_reblock.cu", "vittf_tpu/ops/bilateral.py:279",
         n_blocked[3]),
        ("chain_gemm", "chain_gemm.cu", "scripts/bench_int8_gemm.py:60", n_k9),
        ("swiglu", "swiglu.cu", "none (DINOv2's SwiGLU gate)", n_swiglu),
    ]
    if min(n for *_, n in kernel_list) == 0:
        raise AssertionError(f"a kernel was launched no time on its path: {kernel_list}")
    print(f"graphs over the whole run: {graph_line((0, 0, 0))}")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
         "launches": n, **entries[name]}
        for name, src, replaces, n in kernel_list
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
