"""Crop-to-content helpers (reference bilateral_solver3d.py:183-209).

Port of ``vittf_tpu/ops/crop.py``. ``crop_pad`` computes the bounding box of
``sim > thresh`` (plus padding) and crops a list of volumes to it;
``write_crop_into`` writes a refined crop back. The box is data-dependent, so
the mask is fetched to the host, as in the JAX twin; the crops stay views of
the tensors on their device.
"""
from __future__ import annotations

import numpy as np
import torch


def bounding_box(mask: torch.Tensor, pad: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(mi, ma) corner arrays of the trailing-3-dims bounding box of ``mask``.

    Parity with reference crop_pad: mi clamped at 0, ma at shape (exclusive);
    an empty mask gives the whole volume.
    """
    shape = np.asarray(mask.shape[-3:])
    m = mask.to(torch.uint8).cpu().numpy()
    m = m.reshape(-1, *mask.shape[-3:]).any(axis=0)
    idx = np.argwhere(m)
    if idx.size == 0:
        return np.zeros(3, np.int64), shape.astype(np.int64)
    mi = np.clip(idx.min(axis=0) - pad, 0, None)
    ma = np.minimum(idx.max(axis=0) + pad + 1, shape)
    return mi, ma


def crop_pad(sim, thresh: float = 0.1, pad: int = 0):
    """Crop volume(s) to where ``sim > thresh`` (reference :183-204).

    ``sim`` may be a tensor or a list; the first element defines the box.
    Returns (cropped_or_list, (mi, ma)).
    """
    others = sim if isinstance(sim, list) else [sim]
    mi, ma = bounding_box(others[0] > thresh, pad=pad)
    cropped = [s[..., mi[0]:ma[0], mi[1]:ma[1], mi[2]:ma[2]] for s in others]
    if isinstance(sim, list):
        return cropped, (mi, ma)
    return cropped[0], (mi, ma)


def write_crop_into(uncropped: torch.Tensor, crop: torch.Tensor, mima) -> torch.Tensor:
    """A copy of ``uncropped`` with ``crop`` written at the box (reference
    :206-209); the input is left as it was, like the JAX twin's."""
    mi, ma = mima
    out = uncropped.clone()
    out[..., mi[0]:ma[0], mi[1]:ma[1], mi[2]:ma[2]] = crop
    return out
