"""Plain PyTorch similarity maps, refinement and label fusion.

The reference for an interactive edit (``InteractiveSession.update_annotations``
→ ``predict``), written from the reference pipeline (predict_ntf.py:24-101,
203-215) and the program's documented semantics of the bucketed refinement,
not from the program:

- a class's annotation features: trilinear ``grid_sample`` of the feature
  volume at (voxel + 0.5) / extent · 2 − 1, zero padding;
- its map: mean over its annotations of where(s ≥ τ, s, 0) ** e, s the dot
  of every voxel's features with an annotation's (fp32, TF32 off), τ and e
  the configuration's ``similarity`` threshold and exponent;
- without refinement: quantized to uint8 by 255 / (0.99 · max) with a
  float→uint8 wrap modulo 256, then a nearest resize to half the volume;
- with refinement: trilinear resize to half the volume (align_corners=False,
  axis by axis), the support box of
  map > 0.1 padded by 2 and grown to a multiple of the bucket (shifted back
  inside the grid), the half-resolution uint8 volume cropped alike, Sobel
  confidence, the bilateral solve with the configuration's ``refinement``
  σs, λ and CG steps, written back and quantized;
- fusion: class i takes a voxel where its map exceeds ⌊threshold_i · 255⌋
  and every earlier class's map there; 0 is background.

A session recomputes only the edited class, alone, so every class's map is
a function of its own annotations: ``class_map`` computes one. Its
``control`` is the same pipeline one precision below what the configuration
states, stage by stage: the similarity's products (fp32, TF32 off) with
their operands rounded to TF32, as a K2 on the tensor cores would take them;
the solve's other fp32 arithmetic with its lattice in bf16.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import bilateral

CT_ORG_THRESHOLDS = (0.486, 0.264, 0.236, 0.68, 0.291)  # predict_ntf.py:207-208
FUSE_FALLBACK = 0.25  # a class past the CT-ORG list, predict_ntf.py:71
BOX_THRESHOLD, BOX_PAD = 0.1, 2


def quantize(x: torch.Tensor) -> torch.Tensor:
    """255 / (0.99 · max) · x, truncated and wrapped modulo 256 (the
    reference's float → uint8 cast), an all-zero map to zeros."""
    scale = torch.clamp(0.99 * x.amax(), min=1e-30)
    q = torch.remainder(torch.trunc(255.0 / scale * x), 256)
    return torch.nan_to_num(q, nan=0.0).to(torch.uint8)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded (to nearest, ties to even) to TF32's 10 mantissa
    bits: the operands a TF32 product multiplies, on any device."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def raw_map(features: torch.Tensor, coords: np.ndarray, vol_shape, similarity: dict,
            tf32: bool = False) -> torch.Tensor:
    """(W', H', D') fp32 similarity of one class on the feature grid."""
    dev = features.device
    extent = torch.tensor(vol_shape, dtype=torch.float32, device=dev)
    rel = (torch.as_tensor(coords, device=dev).float() + 0.5) / extent * 2.0 - 1.0
    grid = rel.flip(-1).reshape(1, -1, 1, 1, 3)  # grid_sample's (x, y, z) = (D, H, W)
    q = F.grid_sample(features[None], grid, mode="bilinear", padding_mode="zeros",
                      align_corners=False).reshape(features.shape[0], -1)  # (F, A)
    f = features.reshape(features.shape[0], -1)
    if tf32:
        f, q = tf32_round(f), tf32_round(q)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = f.t() @ q  # (V, A)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    tau, e = similarity["threshold"], similarity["exponent"]
    g = torch.where(s >= tau, s, torch.zeros_like(s)) ** e
    return g.mean(dim=1).reshape(features.shape[1:])


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(out, in) weights of a 1-D linear resize, align_corners=False: output
    i reads (i + 0.5)·in/out − 0.5, clamped at 0, between its two nearest
    inputs."""
    src = np.maximum((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = np.where(i1 == i0, 0.0, src - np.floor(src))
    w = np.zeros((n_out, n_in))
    np.add.at(w, (np.arange(n_out), i0), 1.0 - frac)
    np.add.at(w, (np.arange(n_out), i1), frac)
    return w


def linear_resize(x: torch.Tensor, size) -> torch.Tensor:
    """Trilinear resize of a 3-D fp32 volume, one axis after the other in
    fp32 products (TF32 off)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for axis, n in enumerate(size):
            if x.shape[axis] != n:
                w = torch.as_tensor(_linear_weights(x.shape[axis], n), dtype=torch.float32,
                                    device=x.device)
                x = torch.movedim(torch.tensordot(w, x, dims=([1], [axis])), 0, axis)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    return x


def half_reference(vol: torch.Tensor) -> torch.Tensor:
    """The half-resolution uint8 volume the refinement's solve is guided by."""
    v = linear_resize(vol.float(), tuple(d // 2 for d in vol.shape))
    v = (v - v.min()) / (v.max() - v.min())
    return torch.trunc(255.0 * v).to(torch.uint8)


def _sobel(x: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude by [-0.5, 0, 0.5] central differences, zero padded,
    the squares summed from the last axis to the first."""
    out = torch.zeros_like(x)
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    for ax in (2, 1, 0):
        n = x.shape[ax]
        d = 0.5 * (xp.narrow(ax, 2, n) - xp.narrow(ax, 0, n))
        out = out + d.narrow((ax + 1) % 3, 1, x.shape[(ax + 1) % 3]).narrow(
            (ax + 2) % 3, 1, x.shape[(ax + 2) % 3]) ** 2
    return torch.sqrt(out)


def refine(sim: torch.Tensor, ref_u8: torch.Tensor, bucket: int, refinement: dict,
           bf16_lattice: bool = False) -> torch.Tensor:
    """One class's feature-grid map → refined uint8 map on ``ref_u8``'s grid."""
    shape = tuple(ref_u8.shape)
    sim = linear_resize(sim, shape)
    mask = sim > BOX_THRESHOLD
    if not bool(mask.any()):
        return torch.zeros(shape, dtype=torch.uint8, device=sim.device)
    lo, size = [], []
    for ax in range(3):
        hit = torch.nonzero(mask.any(dim=tuple(a for a in range(3) if a != ax))).reshape(-1)
        mi, ma = int(hit[0]), int(hit[-1]) + 1
        ext = min(shape[ax], ma + BOX_PAD) - max(0, mi - BOX_PAD)
        ext = min(-(-ext // bucket) * bucket, shape[ax])
        lo.append(min(max(0, mi - BOX_PAD), shape[ax] - ext))
        size.append(ext)
    box = tuple(slice(s, s + n) for s, n in zip(lo, size))
    cvol = ref_u8[box].float()
    sob = _sobel(cvol / 255.0)
    solved = bilateral.solve(sim[box][None], cvol[None], (sob.amax() - sob)[None],
                             sigma_spatial=refinement["sigma_spatial"],
                             sigma_luma=refinement["sigma_luma"], lam=refinement["lam"],
                             cg_maxiter=refinement["cg_maxiter"], bf16_lattice=bf16_lattice)[0]
    out = sim.clone()
    out[box] = solved
    return quantize(out)


def class_map(features, coords, vol_shape, config: dict, refine_with: torch.Tensor | None = None,
              bucket: int = 8, control: bool = False) -> torch.Tensor:
    """The uint8 map a session serves for one class with these annotations,
    under ``config``'s ``similarity`` and ``refinement``; ``control``
    computes it below the configuration's precision (see the module)."""
    sim = raw_map(features, coords, vol_shape, config["similarity"], tf32=control)
    if refine_with is not None:
        return refine(sim, refine_with, bucket, config["refinement"], bf16_lattice=control)
    half = tuple(d // 2 for d in vol_shape)
    return F.interpolate(quantize(sim)[None, None].float(), size=half,
                         mode="nearest")[0, 0].to(torch.uint8)


def fuse(maps: list[torch.Tensor], thresholds=CT_ORG_THRESHOLDS) -> torch.Tensor:
    """Label volume of per-class uint8 maps (1-based, 0 background)."""
    pred = torch.zeros_like(maps[0])
    best = torch.zeros_like(maps[0])
    for i, m in enumerate(maps):
        th = thresholds[i] if i < len(thresholds) else FUSE_FALLBACK
        win = (m > int(th * 255)) & (m > best)
        pred = torch.where(win, torch.full_like(pred, i + 1), pred)
        best = torch.where(win, m, best)
    return pred
