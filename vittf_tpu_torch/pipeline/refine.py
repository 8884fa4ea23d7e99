"""Similarity refinement: crop → bilateral solve → write-back.

Port of ``vittf_tpu/pipeline/refine.py``, the reference's BLS branch of
compute_similarities (predict_ntf.py:73-96): the scalar volume is
trilinearly resized to the half-res similarity grid and quantized to uint8,
the similarity map is cropped to its support (+2 pad at threshold 0.1),
refined with the 3D bilateral solver (σ_spatial 7, σ_luma = σ_chroma 5), and
written back.

Two entry points:
- ``refine_similarity``: one class, the reference-parity tight crop box.
- ``refine_similarities_batched``: all classes at once over one common
  bucketed crop shape: one box pass, one host fetch of the boxes, and one
  batched crop → Sobel → solve → write-back → quantize per class chunk, so
  each kernel launch serves every class of the chunk. On CUDA tensors in a
  kernel form that core runs through the port's graph cache
  (``utils/cuda_graphs.py``), one CUDA graph per core key (device, C,
  sim_shape, crop_shape, the solve's form and static arguments: the JAX
  twin's ``static_argnames`` plus the shapes), the crop starts a device
  input (``_refine_indexed_core``: index arithmetic for JAX's
  ``dynamic_slice`` / ``dynamic_update_slice``); the slice-based
  ``_refine_batched_core`` is its witness.

The JAX twin's speculative path (``_refine_batched_speculative``,
``VITTF_BLS_SPECULATIVE``) hides round trips of a remote TPU and is not
ported.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from vittf_tpu_torch.ops.bilateral import (
    _WRAPPERS,
    _bilateral_solve_eager,
    _graph_key,
    _pixel_ops,
    apply_bilateral_solver3d,
    bilateral_solve_gray_batched,
)
from vittf_tpu_torch.ops.crop import crop_pad, write_crop_into
from vittf_tpu_torch.ops.morphology import filter_sobel_separated
from vittf_tpu_torch.ops.resize import resize_linear
from vittf_tpu_torch.pipeline.ntf import quantize_uint8_torch
from vittf_tpu_torch.utils import cuda_graphs
from vittf_tpu_torch.utils.logging import span
from vittf_tpu_torch.utils.tensor import make_5d, norm_minmax

BLS_GRID_PARAMS = {  # predict_ntf.py:75-79
    "sigma_spatial": 7,
    "sigma_chroma": 5,
    "sigma_luma": 5,
}


def _bucket_box(mima, shape, bucket: int):
    """Grow a [mi, ma) box so each extent is a multiple of ``bucket``,
    keeping it inside ``shape`` (shifting the start when hitting the end)."""
    mi, ma = (np.asarray(m).copy() for m in mima)
    for d in range(3):
        want = -(-int(ma[d] - mi[d]) // bucket) * bucket
        want = min(want, shape[d])
        ma[d] = min(mi[d] + want, shape[d])
        mi[d] = ma[d] - want
    return mi, ma


def make_bls_reference(volume, sim_shape: tuple[int, int, int], device=None) -> torch.Tensor:
    """Half-res uint8 reference for the bilateral solve (predict_ntf.py:80-87
    downsample + quantize). A host array is uploaded in its own dtype (a
    uint8 CT ships one byte per voxel) and cast to fp32 on the device."""
    vol = torch.as_tensor(volume, device=device).float()
    vol = resize_linear(make_5d(vol), tuple(sim_shape)).reshape(tuple(sim_shape))
    return torch.trunc(255.0 * norm_minmax(vol)).to(torch.uint8)


def refine_similarity(sim: torch.Tensor, volume, sim_shape: tuple[int, int, int],
                      grid_params: dict | None = None, bs_params: dict | None = None,
                      shape_bucket: int | None = None, pixel_impl: str = "auto") -> torch.Tensor:
    """Refine one class's similarity map with the 3D bilateral solver.

    Args:
        sim: (W', H', D') float similarity on the feature grid; the work runs
            on its device.
        volume: (W, H, D) scalar volume (full resolution), array or tensor.
        sim_shape: target half-resolution grid (W//2, H//2, D//2).
        shape_bucket: if set, the crop box grows to multiples of it; None is
            the reference-parity tight box.

    Returns:
        (sim_shape) float32 refined similarity.
    """
    # resized in the volume's own dtype, as the JAX twin does (which holds
    # 64-bit arrays as 32-bit)
    vol = torch.as_tensor(volume, device=sim.device)
    if vol.dtype == torch.float64:
        vol = vol.float()
    vol = resize_linear(make_5d(vol), tuple(sim_shape)).reshape(tuple(sim_shape))
    vol_u8 = torch.trunc(255.0 * norm_minmax(vol)).to(torch.uint8)
    sim = sim.float()
    if tuple(sim.shape[-3:]) != tuple(sim_shape):
        sim = resize_linear(make_5d(sim), tuple(sim_shape)).reshape(tuple(sim_shape))
    crops, mima = crop_pad([sim, vol_u8], thresh=0.1, pad=2)
    if shape_bucket:
        mima = _bucket_box(mima, sim_shape, shape_bucket)
        mi, ma = mima
        crops = [t[..., mi[0]:ma[0], mi[1]:ma[1], mi[2]:ma[2]] for t in (sim, vol_u8)]
    csim, cvol = crops
    cref = cvol[None].expand((3,) + tuple(cvol.shape))
    csolved = apply_bilateral_solver3d(
        csim[None], cref, grid_params={**BLS_GRID_PARAMS, **(grid_params or {})},
        bs_params=bs_params, pixel_impl=pixel_impl,
    )
    return write_crop_into(sim, csolved, mima)


def _boxes_device(sims: torch.Tensor, thresh: float):
    """Per-class bounding boxes of ``sims > thresh``: (C, W, H, D) →
    ((C, 2, 3) int64 [mi; ma), (C,) bool non-empty). Empty classes get the
    full volume (``bounding_box`` parity)."""
    mask = sims > thresh
    out = []
    for d in range(3):
        axes = tuple(a for a in (1, 2, 3) if a != d + 1)
        line = mask.any(dim=axes[1]).any(dim=axes[0]).to(torch.uint8)  # (C, S_d)
        s = line.shape[1]
        empty = line.amax(dim=1) == 0
        mi = torch.where(empty, 0, torch.argmax(line, dim=1))
        ma = torch.where(empty, s, s - torch.argmax(line.flip(1), dim=1))
        out.append(torch.stack([mi, ma], dim=1))
    return torch.stack(out, dim=2), mask.flatten(1).any(dim=1)


def _prep_boxes_device(sims: torch.Tensor, sim_shape: tuple, thresh: float):
    """fp32 cast + resize to the sim grid + per-class boxes. Returns
    (sims on the sim grid, (C, 2, 3) boxes, (C,) non-empty flags)."""
    sims = sims.float()
    C = sims.shape[0]
    if tuple(sims.shape[-3:]) != tuple(sim_shape):
        sims = resize_linear(make_5d(sims), tuple(sim_shape)).reshape((C,) + tuple(sim_shape))
    boxes, nonempty = _boxes_device(sims, thresh)
    return sims, boxes, nonempty


def _refine_batched_core(sims: torch.Tensor, vol_u8: torch.Tensor, starts: np.ndarray,
                         crop_shape: tuple[int, int, int], solve_kw: dict) -> torch.Tensor:
    """Crop → Sobel confidence → bilateral solve → write-back → uint8
    quantize for all classes of ``sims`` (C, …) in one batched pass;
    ``solve_kw`` are ``bilateral_solve_gray_batched``'s keywords.
    Returns (C, …) uint8."""

    def crop(x, st):
        return x[st[0]:st[0] + crop_shape[0], st[1]:st[1] + crop_shape[1],
                 st[2]:st[2] + crop_shape[2]]

    csim = torch.stack([crop(s, st) for s, st in zip(sims, starts)])
    cvol = torch.stack([crop(vol_u8, st) for st in starts])
    C = sims.shape[0]
    sob = filter_sobel_separated(cvol[:, None].float() / 255.0).reshape((C,) + crop_shape)
    conf = sob.amax(dim=(1, 2, 3), keepdim=True) - sob
    solved = bilateral_solve_gray_batched(csim, cvol.float(), conf, **solve_kw)
    out = sims.clone()
    for c, st in enumerate(starts):
        crop(out[c], st).copy_(solved[c])
    # clamp keeps all-zero (empty) classes at 0 instead of NaN
    quant = torch.clamp(0.99 * out.amax(dim=(1, 2, 3), keepdim=True), min=1e-30)
    return quantize_uint8_torch(255.0 / quant * out)


def _crop_index(starts: torch.Tensor, crop_shape: tuple[int, int, int],
                sim_shape: tuple[int, int, int]) -> torch.Tensor:
    """(C, prod(crop_shape)) flat indices into a ``sim_shape`` map of the
    crops at ``starts`` ((C, 3) int64): ``starts[:, d] + arange(crop_d)``
    per axis, the index arithmetic of JAX's ``dynamic_slice``."""
    ax = [starts[:, d, None] + torch.arange(n, device=starts.device)
          for d, n in enumerate(crop_shape)]
    _, H, D = sim_shape
    flat = (ax[0][:, :, None, None] * H + ax[1][:, None, :, None]) * D + ax[2][:, None, None, :]
    return flat.reshape(starts.shape[0], -1)


def _refine_indexed_core(sims: torch.Tensor, vol_u8: torch.Tensor, starts: torch.Tensor,
                         crop_shape: tuple[int, int, int], solve_kw: dict) -> torch.Tensor:
    """``_refine_batched_core`` with the crop starts a (C, 3) int64 tensor on
    the device: crops gathered and written back through index arithmetic
    (JAX's ``dynamic_slice`` / ``dynamic_update_slice``), so its launches do
    not depend on the starts and one captured graph serves every start.
    The solve runs its eager body (graphs do not nest). Bit-equal to
    ``_refine_batched_core``: the same values reach the same ops."""
    C, sim_shape = sims.shape[0], tuple(sims.shape[1:])
    idx = _crop_index(starts, crop_shape, sim_shape)
    csim = torch.gather(sims.reshape(C, -1), 1, idx).reshape((C,) + crop_shape)
    cvol = vol_u8.reshape(-1)[idx].reshape((C,) + crop_shape)
    sob = filter_sobel_separated(cvol[:, None].float() / 255.0).reshape((C,) + crop_shape)
    conf = sob.amax(dim=(1, 2, 3), keepdim=True) - sob
    solved = _bilateral_solve_eager(csim, cvol.float(), conf, **solve_kw)
    out = sims.reshape(C, -1).scatter(1, idx, solved.reshape(C, -1)).reshape(sims.shape)
    # clamp keeps all-zero (empty) classes at 0 instead of NaN
    quant = torch.clamp(0.99 * out.amax(dim=(1, 2, 3), keepdim=True), min=1e-30)
    return quantize_uint8_torch(255.0 / quant * out)


def _core_key(device: torch.device, shape, crop_shape: tuple[int, int, int],
              solve_kw: dict) -> tuple:
    """What a captured refine core is specific to: the device, C and
    ``sim_shape`` of ``shape`` (C, *sim_shape), the crop shape, the solve's
    form and static arguments (the JAX twin's ``static_argnames`` plus the
    shapes); never the crop starts, an input of the graph."""
    return ("refine core", tuple(shape[1:])) + _graph_key(
        device, (shape[0],) + tuple(crop_shape), solve_kw)


def _refine_core(sims: torch.Tensor, vol_u8: torch.Tensor, starts: torch.Tensor,
                 crop_shape: tuple[int, int, int], solve_kw: dict) -> torch.Tensor:
    """The refine core of one class chunk, ``starts`` (C, 3) int64 on the
    chunk's device. CUDA tensors in a kernel form go through the graph
    cache (``utils/cuda_graphs.py``: eager on the key's first call,
    captured on the second, replayed after), the starts an input of the
    graph; CPU tensors and ``'scatter'`` run ``_refine_indexed_core``
    eagerly."""
    form, _ = _pixel_ops(solve_kw.get("pixel_impl", "auto"), 3)
    if sims.device.type != "cuda" or form == "scatter":
        return _refine_indexed_core(sims, vol_u8, starts, crop_shape, solve_kw)
    key = _core_key(sims.device, sims.shape, crop_shape, solve_kw)
    body = functools.partial(_refine_indexed_core, crop_shape=crop_shape, solve_kw=solve_kw)
    return cuda_graphs.graphed(key, (sims, vol_u8, starts), body, _WRAPPERS)


def refine_similarities_batched(sims: torch.Tensor, volume, sim_shape: tuple[int, int, int],
                                grid_params: dict | None = None,
                                bs_params: dict | None = None,
                                shape_bucket: int = 8,
                                ref_u8: torch.Tensor | None = None,
                                pixel_impl: str = "auto") -> torch.Tensor:
    """Refine + quantize all classes' similarity maps.

    Crops share one bucketed shape (the per-dimension max of the NON-EMPTY
    classes' padded boxes, grown to ``shape_bucket`` multiples); empty
    classes (the mid-annotation GUI state) do not take part in that decision
    and come back as all-zero maps. The solve covers a slightly larger
    region than the reference's tight per-class box (not bit parity with
    ``refine_similarity``).

    Classes are solved in equal chunks of at most ``VITTF_BLS_CHUNK_VOXELS``
    crop voxels (default 70e6; zero-padded tail classes solve corner crops of
    zeros). ``ref_u8`` is ``make_bls_reference``'s result, when the caller
    keeps it; otherwise it is built from ``volume``.

    ``bs_params`` may hold ``lam``, ``cg_maxiter``, ``fine_maxiter`` and
    ``coarse_to_fine``: a σ-doubled coarse solve starts the fine CG, which
    then runs ``fine_maxiter`` (10) steps instead of 25
    (``ops/bilateral.py::bilateral_solve_gray``). Off unless set here or by
    ``VITTF_BLS_COARSE=1``.

    Returns (C, *sim_shape) uint8 (already 255/(0.99·max)-quantized).
    """
    gp = {**BLS_GRID_PARAMS, **(grid_params or {})}
    bs = bs_params or {}
    vol_u8 = ref_u8 if ref_u8 is not None else make_bls_reference(
        volume, sim_shape, device=sims.device)
    C = sims.shape[0]
    with span("refine.boxes"):
        sims, boxes_d, nonempty_d = _prep_boxes_device(sims, tuple(sim_shape), 0.1)
        with span("sync.boxes"):
            boxes = boxes_d.cpu().numpy()
        with span("sync.nonempty"):
            nonempty = nonempty_d.cpu().numpy()
    with span("refine.plan"):
        if not nonempty.any():
            # nothing to refine: quantized zero maps (255/(0.99·0) clamped)
            return torch.zeros((C,) + tuple(sim_shape), dtype=torch.uint8, device=sims.device)
        mi = np.clip(boxes[:, 0] - 2, 0, None)  # pad=2, crop_pad parity
        ma = np.minimum(boxes[:, 1] + 2, np.asarray(sim_shape))
        ext = np.max((ma - mi)[nonempty], axis=0)
        ext = tuple(int(e) for e in np.minimum(-(-ext // shape_bucket) * shape_bucket, sim_shape))
        # per-class starts, made on the device from its boxes (no upload): the
        # padded box's start, shifted back where the common box would overflow;
        # empty classes solve a corner crop of zeros (writes zeros back)
        starts = torch.stack([(boxes_d[:, 0, d] - 2).clamp(0, sim_shape[d] - ext[d])
                              for d in range(3)], dim=1)
        starts = torch.where(nonempty_d[:, None], starts, 0)
        c2f = bs.get("coarse_to_fine")
        if c2f is None:
            c2f = os.environ.get("VITTF_BLS_COARSE", "0") != "0"
        solve_kw = dict(
            sigma_spatial=int(gp["sigma_spatial"]),
            sigma_luma=int(gp["sigma_luma"]),
            lam=float(bs.get("lam", 256.0)),
            cg_maxiter=int(bs.get("cg_maxiter", 25)),
            coarse_to_fine=bool(c2f),
            fine_maxiter=int(bs.get("fine_maxiter", 10)),
            pixel_impl=pixel_impl,
        )
        budget = int(os.environ.get("VITTF_BLS_CHUNK_VOXELS", 70_000_000))
        chunk = max(1, budget // max(1, int(np.prod(ext))))
    if chunk >= C:
        return _refine_core(sims, vol_u8, starts, ext, solve_kw)
    n_pad = -C % chunk
    if n_pad:
        sims = torch.cat([sims, sims.new_zeros((n_pad,) + tuple(sim_shape))])
        starts = torch.cat([starts, starts.new_zeros((n_pad, 3))])
    outs = [
        _refine_core(sims[i:i + chunk], vol_u8, starts[i:i + chunk], ext, solve_kw)
        for i in range(0, C + n_pad, chunk)
    ]
    return torch.cat(outs)[:C]
