"""The yardstick's arithmetic: operations and bytes of the work a cell asks
for, and the published peaks of one NVIDIA H100 SXM (dense, 700 W).

Counts are of the work the algorithm and its inputs need, whatever
implements it: matmul FLOPs (2·M·N·K per product) over the real tokens and
the real annotations, each input byte read once and each output byte written
once. Batch-padding slices are counted, since they run through the ViT. The
ViT and similarity counts follow the program's own arithmetic
(``vittf_tpu_torch/utils/flops.py``), kept here so that a change to the
program cannot move them.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# (slice axis of the (W, H, D) volume, image dims): the sweep order z, y, x
AXES = ((2, (0, 1)), (1, (0, 2)), (0, (1, 2)))


def compute_im_sizes(vol_shape, feature_output_size: int, patch_size: int):
    """Image and token-grid sizes of a volume (reference infer.py:317-319)."""
    ref_fact = sorted(vol_shape)[1] / feature_output_size
    im_sz = tuple(int(patch_size * (d // ref_fact)) for d in vol_shape)
    return im_sz, tuple(d // patch_size for d in im_sz)


def block_flops(n_tokens: int, D: int, hidden: int) -> float:
    """One image through one pre-LN block: qkv 6ND², proj 2ND², MLP 4N·D·hidden,
    QKᵀ and PV 4N²D."""
    N = n_tokens
    return 8 * N * D * D + 4 * N * D * hidden + 4 * N * N * D


def block_bytes(batch: int, n_tokens: int, D: int, hidden: int, elt: int = 2) -> float:
    """One block call on ``batch`` images: the activations in and out and the
    weights and biases read once."""
    weights = 4 * D * D + 2 * D * hidden + 3 * D + D + hidden + D + 4 * D
    return elt * (2 * batch * n_tokens * D + weights)


def attention_flops(batch: int, heads: int, n_tokens: int, head_dim: int) -> float:
    return 4.0 * batch * heads * n_tokens * n_tokens * head_dim


def attention_bytes(batch: int, heads: int, n_tokens: int, head_dim: int, elt: int = 2) -> float:
    return elt * 4.0 * batch * heads * n_tokens * head_dim  # q, k, v in, o out


def vit_slice_flops(n_tokens: int, model: dict, capture_thirds: int = 1, in_ch: int = 1) -> float:
    """One image through the extraction ViT: every block but the last whole,
    the last one's qkv projection for the captured thirds only, and the patch
    embed on ``in_ch`` channels (1: the grayscale fold)."""
    D, P = model["embed_dim"], model["patch_size"]
    full = (model["depth"] - 1) * block_flops(n_tokens, D, model["hidden_dim"])
    return 2 * (n_tokens - 1) * D * in_ch * P * P + full + 2 * capture_thirds * n_tokens * D * D


def extraction_plan(vol_shape, model: dict, extract: dict) -> list[dict]:
    """Per axis of one ``extract_features`` call over all three axes: slices
    run (padded to whole batches), batches, tokens a slice."""
    _, feat = compute_im_sizes(tuple(vol_shape), extract["feature_output_size"],
                               model["patch_size"])
    out = []
    for axis, (d0, d1) in AXES:
        B = extract["batch_size"]
        batches = -(-vol_shape[axis] // B)
        out.append({"slices": batches * B, "batches": batches, "batch": B,
                    "tokens": feat[d0] * feat[d1] + 1})
    return out


def extraction_flops(vol_shape, model: dict, extract: dict) -> float:
    thirds = len(extract["return_keys"])
    return sum(a["slices"] * vit_slice_flops(a["tokens"], model, thirds)
               for a in extraction_plan(vol_shape, model, extract))


def similarity_flops(n_voxels: int, F: int, n_annotations: int, n_classes: int) -> float:
    """The (V, F) × (F, A) dot and the (V, A) × (A, C) class mean."""
    return 2.0 * n_voxels * F * n_annotations + 2.0 * n_voxels * n_annotations * n_classes


def similarity_bytes(n_voxels: int, F: int, n_annotations: int, n_classes: int) -> float:
    """fp32 features, queries and class matrix in, (C, V) maps out."""
    return 4.0 * (n_voxels * F + n_annotations * F + n_annotations * n_classes
                  + n_classes * n_voxels)


def bound_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


def roofline_share(ctx, work_key: str, pattern: str, peak: float):
    """A kernel's share of its roofline in a traced window, in %: the least
    time its launches could take (``bound_seconds`` of each work item of
    ``ctx.work[work_key]``, (launches, FLOPs, bytes)) over their time in the
    trace, found by kernel name; None when the window ran none."""
    items = ctx.work.get(work_key)
    if ctx.trace is None or not items:
        return None
    seconds, launches = ctx.trace.kernel_seconds(pattern)
    if not launches or seconds <= 0.0:
        return None
    bound = sum(n * bound_seconds(f, b, peak) for n, f, b in items)
    return 100.0 * bound / seconds
