"""NTF (neural transfer function) similarity + prediction pipeline.

Port of ``vittf_tpu/pipeline/ntf.py`` (reference predict_ntf.py:24-101,
104-256): annotation features are sampled trilinearly, the fused similarity
kernel takes the dot product, thresholds, sharpens and averages per class,
optionally the bilateral solver refines each map on the half-res grid
(``pipeline/refine.py``), and the maps are quantized to uint8 by
255/(0.99·max) with torch's float→uint8 wraparound (nearest-resized to half
resolution without refinement). Per-class thresholds and a max-sim argmax
fuse them into a label volume. Everything runs on the features' device.
"""
from __future__ import annotations

import numpy as np
import torch

from vittf_tpu_torch.ops.resize import resize_nearest
from vittf_tpu_torch.ops.sampling import rel_coords_from_abs, sample_features3d
from vittf_tpu_torch.ops.similarity import (
    DEFAULT_EXPONENT,
    DEFAULT_THRESHOLD,
    class_mean_matrix,
    fused_similarity_m,
)
from vittf_tpu_torch.utils.logging import span

# CT-ORG fusion operating point (predict_ntf.py:207-208)
CT_ORG_THRESHOLDS = [0.486, 0.264, 0.236, 0.68, 0.291]


def quantize_uint8_torch(x: torch.Tensor) -> torch.Tensor:
    """float → uint8 with the reference's cast semantics: truncate, then
    wrap modulo 256. Written out (floor-mod of the truncated value) rather
    than a raw ``.to(torch.uint8)``, whose out-of-range result is not
    defined the same way on every device. A non-finite input (255/0·0 of an
    all-zero class quantized without a clamp) has a NaN remainder, which
    becomes 0 explicitly, as the CPU casts of both packages give it."""
    q = torch.remainder(torch.trunc(x), 256)
    return torch.nan_to_num(q, nan=0.0).to(torch.uint8)


def _bucket_annotations(total: int, step: int = 256) -> int:
    return -(-max(total, 1) // step) * step


def _raw_similarities(
    in_dims: tuple[int, int, int],
    features: torch.Tensor,
    abs_coords: torch.Tensor,  # (A_pad, 3), zero-padded
    class_mat: torch.Tensor,  # (A_pad, C), zero rows for padding
    threshold: float,
    exponent: float,
    mean_first: bool,
    impl: str,
) -> torch.Tensor:
    """Float (C, W', H', D') similarities on the feature grid."""
    feat_dims = tuple(features.shape[-3:])
    F_dim = features.shape[0]
    with span("ntf.sample"):
        rel = rel_coords_from_abs(abs_coords, in_dims)
        qf = sample_features3d(features, rel, mode="bilinear")[0, 0].contiguous()  # (A_pad, F)
    rows = torch.movedim(features, 0, -1)  # (W', H', D', F)
    if rows.is_contiguous():  # voxel-major features, as a session holds them
        feats_flat = rows.reshape(-1, F_dim)
    else:  # feature-major: one copy into the (V, F) rows
        with span("ntf.layout"):
            feats_flat = rows.reshape(-1, F_dim).contiguous()
    # class-major layout: the (C, N) result is already in volume order
    with span("ntf.k2"):
        sims_cn = fused_similarity_m(
            feats_flat, qf, class_mat, threshold=threshold, exponent=exponent,
            mean_first=mean_first, impl=impl, out_layout="cn",
        )
    return sims_cn.reshape(class_mat.shape[1], *feat_dims)


def _similarities(in_dims, features, abs_coords, class_mat, sim_shape, threshold,
                  exponent, mean_first, impl) -> torch.Tensor:
    """Whole no-refinement similarity path → (C, *sim_shape) uint8."""
    sims = _raw_similarities(in_dims, features, abs_coords, class_mat, threshold,
                             exponent, mean_first, impl)
    feat_dims = tuple(sims.shape[-3:])
    # per-class 0.99·max quantization + nearest resize (predict_ntf.py:95-100),
    # clamped so all-zero classes quantize to 0 instead of NaN
    with span("ntf.quantize"):
        quant = torch.clamp(0.99 * sims.amax(dim=(1, 2, 3), keepdim=True), min=1e-30)
        sims_u8 = quantize_uint8_torch(255.0 / quant * sims)
        if feat_dims != sim_shape:
            sims_u8 = resize_nearest(sims_u8, sim_shape)
    return sims_u8


def compute_similarities(
    volume,
    features: torch.Tensor,
    annotations: dict[str, np.ndarray],
    bilateral_solver: bool = False,
    threshold: float = DEFAULT_THRESHOLD,
    exponent: float = DEFAULT_EXPONENT,
    impl: str = "auto",
    bls_shape_bucket: int | None = None,
    bls_ref_u8: torch.Tensor | None = None,
    mean_first: bool | None = None,
) -> dict[str, torch.Tensor] | None:
    """Per-class uint8 similarity volumes at half resolution.

    Port of predict_ntf.py:24-101: annotation coords → rel coords over the
    FULL volume extent, bilinear feature sampling, fused
    dot-threshold-sharpen-mean (the single-class >1024 path averages raw
    dots first), optional 3D bilateral refinement on the half-res grid,
    255/(0.99·max) uint8 quantization (then a nearest resize to half
    resolution without refinement).

    Args:
        volume: the (W, H, D) volume. Without refinement only its extent is
            used (coordinates are normalized against it), so its shape will
            do and it never moves; the refinement needs its values, unless
            ``bls_shape_bucket`` is set and ``bls_ref_u8`` given.
        features: (F, W', H', D') feature volume; the work runs on its device.
        annotations: {class: (A_c, 3) absolute voxel coords}.
        bilateral_solver: refine each map with the bilateral solver; per
            class with its tight crop box (reference parity), or, with
            ``bls_shape_bucket``, all classes in one batched solve over a
            common bucketed crop (``refine_similarities_batched``).
        impl: 'auto' (the CUDA kernels on GPU, plain on CPU) | 'plain' (the
            plain twins of every kernel, on any device).
        bls_ref_u8: ``refine.make_bls_reference(volume, sim_shape)``, for
            callers that keep it across requests.
        mean_first: overrides the single-class >1024 mean-first decision.
            A session that recomputes only the edited classes passes the
            decision taken on the full class set, so that the recompute is
            bit-identical to recomputing every class.
    """
    if len(annotations) == 0:
        return None
    counts = tuple(int(v.shape[0]) for v in annotations.values())
    if sum(counts) == 0:
        return None
    in_dims = tuple(getattr(volume, "shape", volume)[-3:])
    if bilateral_solver and not hasattr(volume, "shape") and not (
        bls_shape_bucket and bls_ref_u8 is not None
    ):
        raise ValueError(
            "bilateral_solver=True builds its reference image from the volume's "
            "values: pass the volume array (or bls_shape_bucket with bls_ref_u8)"
        )
    sim_shape = tuple(d // 2 for d in in_dims)
    if mean_first is None:
        mean_first = len(annotations) == 1 and counts[0] > 1024

    with span("ntf.pack"):
        abs_np = np.concatenate(
            [np.asarray(v) for v in annotations.values()], axis=0
        ).astype(np.float32)
        # pad the annotation axis to a bucket; zero mean-matrix rows make it exact
        apad = _bucket_annotations(abs_np.shape[0])
        coords_p = np.zeros((apad, 3), np.float32)
        coords_p[: abs_np.shape[0]] = abs_np
        m = class_mean_matrix(list(counts), apad)

        # one upload of both: the padded coordinates, then the mean matrix
        packed = torch.from_numpy(np.concatenate([coords_p.ravel(), m.ravel()]))
        with span("sync.upload"):
            packed = packed.to(features.device)
        coords_t = packed[:coords_p.size].view(coords_p.shape)
        m_t = packed[coords_p.size:].view(m.shape)
    if not bilateral_solver:
        sims_u8 = _similarities(in_dims, features, coords_t, m_t, sim_shape, threshold,
                                exponent, mean_first, impl)
        return {name: sims_u8[c] for c, name in enumerate(annotations.keys())}

    # refine imports this module
    from vittf_tpu_torch.pipeline.refine import refine_similarities_batched, refine_similarity

    sims = _raw_similarities(in_dims, features, coords_t, m_t, threshold, exponent,
                             mean_first, impl)
    pixel_impl = "scatter" if impl == "plain" else "auto"
    if bls_shape_bucket:
        sims_u8 = refine_similarities_batched(
            sims, volume, sim_shape, shape_bucket=bls_shape_bucket, ref_u8=bls_ref_u8,
            pixel_impl=pixel_impl,
        )
        return {name: sims_u8[c] for c, name in enumerate(annotations.keys())}
    # reference-parity mode: per-class tight crop boxes, quantized without a
    # clamp (an all-zero class gives 255/0·0 = NaN, which quantizes to 0)
    volume = torch.as_tensor(volume, device=features.device)  # one upload for every class
    similarities = {}
    for c, name in enumerate(annotations.keys()):
        sim = refine_similarity(sims[c], volume, sim_shape, pixel_impl=pixel_impl)
        quant = 0.99 * sim.max()
        similarities[name] = quantize_uint8_torch(255.0 / quant * sim)
    return similarities


def fuse_predictions(
    similarities: dict[str, torch.Tensor],
    thresholds: list[float] = CT_ORG_THRESHOLDS,
) -> torch.Tensor:
    """Fuse per-class uint8 sims into a label volume (predict_ntf.py:203-215).

    Class i wins a voxel iff sim_i > threshold_i·255 and sim_i exceeds the
    best previous class (max-sim tie-break); labels are 1-based, 0 =
    background. Thresholds beyond the provided list fall back to 0.25.
    """
    with span("ntf.fuse"):
        sims = torch.stack(list(similarities.values()))
        ths = list(thresholds) + [DEFAULT_THRESHOLD] * max(0, sims.shape[0] - len(thresholds))
        pred = torch.zeros(sims.shape[1:], dtype=torch.uint8, device=sims.device)
        pred_vals = torch.zeros(sims.shape[1:], dtype=sims.dtype, device=sims.device)
        for i in range(sims.shape[0]):
            sim = sims[i]
            mask = (sim > int(float(ths[i]) * 255)) & (sim > pred_vals)
            pred = torch.where(mask, torch.full_like(pred, i + 1), pred)
            pred_vals = torch.where(mask, sim, pred_vals)
    return pred


def fuse_predictions_host(
    similarities: dict[str, np.ndarray],
    thresholds: list[float] = CT_ORG_THRESHOLDS,
) -> np.ndarray:
    """``fuse_predictions`` on host numpy arrays, bit-identical."""
    sims = [np.asarray(v, dtype=np.uint8) for v in similarities.values()]
    ths = list(thresholds) + [DEFAULT_THRESHOLD] * max(0, len(sims) - len(thresholds))
    pred = np.zeros(sims[0].shape, np.uint8)
    pred_vals = np.zeros(sims[0].shape, np.uint8)
    for i, sim in enumerate(sims):
        mask = (sim > int(ths[i] * 255)) & (sim > pred_vals)
        pred[mask] = np.uint8(i + 1)
        pred_vals[mask] = sim[mask]
    return pred


def upscale_prediction(pred: torch.Tensor, vol_shape: tuple) -> torch.Tensor:
    """Nearest-resize a label volume to the full volume shape
    (predict_ntf.py:217-218)."""
    if tuple(pred.shape[-3:]) == tuple(vol_shape[-3:]):
        return pred
    return resize_nearest(pred, tuple(vol_shape[-3:]))
