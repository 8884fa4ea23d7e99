"""Analytic FLOP counts for the extraction + similarity workloads.

Used by bench.py to report TFLOP/s and model FLOPs utilization (MFU)
alongside Mvoxel/s, so kernel regressions can't hide inside end-to-end
noise. Counts are matmul FLOPs (2·M·N·K per GEMM) of the work the device
actually executes — including batch-padding slices, which do run through
the ViT — so the ratio against peak reads as hardware utilization.
"""
from __future__ import annotations

# bf16 peak of one TPU v5e (v5 lite) chip, FLOP/s
TPU_V5E_BF16_PEAK = 197e12


def vit_slice_flops(
    n_tokens: int,
    cfg,
    last_block_qkv_only: bool = True,
    embed_in_ch: int = 1,
    capture_thirds: int = 1,
) -> float:
    """FLOPs for one slice (image) through the ViT forward.

    Per full block: qkv 6ND² + QKᵀ 2N²D + PV 2N²D + proj 2ND² + MLP
    2·(2·N·D·4D) = 24ND² + 4N²D. The capture block (last) stops after its
    qkv projection (models/vit.py stop_after_capture) and computes only
    the requested thirds (capture_thirds ∈ {1,2,3}; extraction defaults
    to k alone → 2ND²). Patch embedding: 2·(N-1)·D·(C·p²) — C=1 for
    scalar volumes (the grayscale replicate + ImageNet normalize are
    folded into the kernel, pipeline/features.fold_grayscale_patch_embed),
    3 for RGB inputs.
    A SwiGLU FFN (the port's DINOv2 ViT-g/14) counts 6·N·D·H for its w12
    (2H wide) and w3; N counts CLS and the register tokens, which the patch
    embed does not see.
    """
    N, D, p = n_tokens, cfg.embed_dim, cfg.patch_size
    ffn = (6 if cfg.ffn == "swiglu" else 4) * N * D * cfg.hidden_dim
    full_block = 8 * N * D * D + ffn + 4 * N * N * D
    depth_full = cfg.depth - 1 if last_block_qkv_only else cfg.depth
    last = 2 * capture_thirds * N * D * D if last_block_qkv_only else 0.0
    embed = 2 * (N - cfg.prefix_tokens) * D * (embed_in_ch * p * p)
    return embed + depth_full * full_block + last


def extraction_flops(vol_shape, cfg, ex_cfg) -> float:
    """Total ViT FLOPs for one extract_features call.

    Mirrors the slice-count logic of pipeline/features.py: per axis the
    slice count is the axis extent (full sweep) or the pooled output size
    (slice_subsample), rounded up to a whole number of batches — padded
    slices execute real compute. ``vol_shape`` may carry a leading
    channel dim ((C, W, H, D), the old/infer_multi.py RGB path) — the
    patch embed then runs C input channels instead of the folded 1.
    """
    from vittf_tpu_torch.pipeline.features import (
        _AXIS_RULES,
        compute_im_sizes,
    )

    vol_shape = tuple(vol_shape)
    in_ch = 1
    if len(vol_shape) == 4:
        in_ch, vol_shape = vol_shape[0], vol_shape[1:]

    im_sz, feat_out_sz = compute_im_sizes(
        tuple(vol_shape), ex_cfg.feature_output_size, cfg.patch_size
    )
    axes = (
        ["z", "y", "x"] if ex_cfg.slice_along == "all" else [ex_cfg.slice_along]
    )
    total = 0.0
    for ax in axes:
        perm, im_dims, out_axis = _AXIS_RULES[ax]
        f_h = im_sz[im_dims[0]] // cfg.patch_size
        f_w = im_sz[im_dims[1]] // cfg.patch_size
        n_tokens = f_h * f_w + cfg.prefix_tokens
        S = vol_shape[perm[0]]
        o_ax = feat_out_sz[out_axis - 1]
        pooled = ex_cfg.pooling()
        n_slices = o_ax if (ex_cfg.slice_subsample and pooled and S > o_ax) else S
        n_slices = -(-n_slices // ex_cfg.batch_size) * ex_cfg.batch_size
        thirds = (
            len(ex_cfg.return_keys)
            if ex_cfg.feature_source == "qkv"
            else 3
        )
        total += n_slices * vit_slice_flops(
            n_tokens, cfg, embed_in_ch=in_ch, capture_thirds=thirds
        )
    return total


def similarity_flops(feat_shape, n_annotations: int, n_classes: int) -> float:
    """Fused similarity kernel FLOPs: the (V, F) × (F, A) dot dominates;
    the per-class mean matmul adds (V, A) × (A, C)."""
    F, *dims = feat_shape
    V = dims[0] * dims[1] * dims[2]
    return 2.0 * V * F * n_annotations + 2.0 * V * n_annotations * n_classes
