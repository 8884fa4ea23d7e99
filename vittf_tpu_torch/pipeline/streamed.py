"""Host-streamed feature extraction for volumes past device residency.

Port of ``vittf_tpu/pipeline/streamed.py``. The volume stays a host numpy
array; per axis it is a transposed view (fast mode gathers only the picked
planes on the host). One chunk of ``chunk_batches · batch_size`` raw slices
goes to the device at a time, in its compact dtype, and runs through the
same batch loop as the resident path (``features._accumulate``), which
carries the fp32 pool accumulators from chunk to chunk. The slice-axis pool
is an ordered sum over batches, so the result equals ``extract_features``
up to fp32 accumulation order. Device residency is one chunk plus the
(o_ax, fh·fw, D) accumulator per key, whatever the volume's size.
"""
from __future__ import annotations

import numpy as np
import torch

from vittf_tpu_torch.models.vit import ViTConfig, check_block_impl
from vittf_tpu_torch.pipeline.features import (
    _KEEP_DTYPES,
    ExtractConfig,
    _accumulate,
    _axis_geometry,
    _axis_pool,
    _build_model,
    _new_accumulators,
    _pool_to,
    _pooled_to_volume,
    _qkv_index,
    compute_im_sizes,
)
from vittf_tpu_torch.utils.tensor import resolve_device


def extract_features_streamed(
    vol: np.ndarray,
    params: dict,
    model_cfg: ViTConfig,
    cfg: ExtractConfig = ExtractConfig(),
    chunk_batches: int = 8,
    device: str | torch.device | None = None,
) -> dict[str, torch.Tensor]:
    """``extract_features`` over a host (W, H, D) scalar volume, streamed.

    ``chunk_batches`` bounds device residency to ``chunk_batches ·
    batch_size`` raw slices. Returns {key: (F, o0, o1, o2) fp32 tensor on
    ``device``}, the first CUDA device when it is None.
    """
    check_block_impl(model_cfg, cfg.block_impl)
    vol = np.asarray(vol)
    if vol.ndim != 3:
        raise ValueError("streamed extraction handles scalar (W, H, D) volumes")
    if chunk_batches < 1:
        raise ValueError(f"chunk_batches must be >= 1, got {chunk_batches}")
    device = resolve_device(device)
    im_sz, feat_out_sz = compute_im_sizes(vol.shape, cfg.feature_output_size, model_cfg.patch_size)
    model = _build_model(params, model_cfg, cfg.compute_dtype, device, grayscale=True)
    # one pass over the host array for the normalization scalars
    mima = tuple(torch.tensor(float(np.float32(f(vol))), device=device) for f in (np.min, np.max))
    key_idx = tuple(_qkv_index(k) for k in cfg.return_keys)
    D, bs = cfg.feature_dim(model_cfg.embed_dim), cfg.batch_size
    axes = ["z", "y", "x"] if cfg.slice_along == "all" else [cfg.slice_along]
    out: dict[str, torch.Tensor] = {}
    for ax in axes:
        perm, img_hw, f_hw, o_ax, out_axis = _axis_geometry(model_cfg, ax, im_sz, feat_out_sz)
        stack = vol.transpose(perm)  # (S, a, b) view, no copy
        pick, w_pool, o_ax = _axis_pool(stack.shape[0], o_ax, cfg.slice_along == "all",
                                        cfg.slice_subsample, device)
        if pick is not None:
            stack = stack[pick]  # host gather of the picked planes
        S = stack.shape[0]
        acc = _new_accumulators(len(key_idx), o_ax, f_hw, D, device)
        for lo in range(0, S, chunk_batches * bs):
            chunk = torch.from_numpy(np.ascontiguousarray(stack[lo:lo + chunk_batches * bs]))
            if chunk.dtype not in _KEEP_DTYPES:  # the resident path's compact set
                chunk = chunk.float()
            chunk = chunk.to(device)[:, None]  # H2D: (n, C=1, a, b)
            batches = ((lo + i, chunk[i:i + bs]) for i in range(0, chunk.shape[0], bs))
            acc = _accumulate(model, batches, acc, w_pool, img_hw, f_hw, key_idx, cfg, mima)
        for k, v in _pooled_to_volume(acc, cfg.return_keys, f_hw, o_ax, out_axis, D).items():
            if cfg.slice_along == "all":
                v = _pool_to(v, feat_out_sz)  # common grid before summing
            out[k] = v if k not in out else out[k] + v
    return out
