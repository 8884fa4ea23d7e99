"""3D connected components and the largest-island filter.

Port of ``vittf_tpu/ops/connected.py`` (replaces the reference's cc_torch
CUDA extension, tests/test_connected_components.py:5,28). Two labelings:

- ``'device'``: min-label propagation with pointer jumping in plain torch on
  the mask's device; each iteration takes the 6-neighbour (4 in 2D) minimum
  and then jumps every label to its target's label, so it converges in
  O(log d) iterations for an island of diameter d. It stops at a fixed point
  or after ``max_iter`` iterations.
- ``'native'``: the shared host union-find ``native/vittf_native.cpp``
  (``vittf_tpu_torch.native``); one copy of the uint8 mask to the host.
"""
from __future__ import annotations

import numpy as np
import torch


def _neighbour(lab: torch.Tensor, ax: int, step: int, fill: int) -> torch.Tensor:
    """lab[i + step] along ``ax`` (step ±1), ``fill`` past the edge."""
    n = lab.shape[ax]
    edge = torch.full_like(lab.narrow(ax, 0, 1), fill)
    if step > 0:
        return torch.cat([lab.narrow(ax, 1, n - 1), edge], dim=ax)
    return torch.cat([edge, lab.narrow(ax, 0, n - 1)], dim=ax)


def connected_components(mask: torch.Tensor, max_iter: int = 64) -> torch.Tensor:
    """Label face-connected components of a 2D/3D boolean mask
    (scipy.ndimage.label's default cross structure).

    Returns int32 labels: 0 where the mask is false, otherwise 1 + the flat
    index of the component's minimal voxel; the same partition as
    scipy.ndimage.label, numbered differently.
    """
    mask = mask.bool()
    n = mask.numel()
    big = n + 2
    flat_ids = torch.arange(1, n + 1, dtype=torch.int64, device=mask.device).reshape(mask.shape)
    lab = torch.where(mask, flat_ids, big)
    for _ in range(max_iter):
        m = lab
        for ax in range(mask.ndim):
            m = torch.minimum(m, torch.minimum(_neighbour(lab, ax, 1, big),
                                               _neighbour(lab, ax, -1, big)))
        m = torch.where(mask, m, big).reshape(-1)
        # labels hold 1 + the flat index of a voxel of the same component:
        # replace each with that voxel's own label (path halving)
        jumped = torch.where(m <= n, m[torch.clamp(m - 1, 0, n - 1)], m)
        nxt = torch.where(mask, jumped.reshape(mask.shape), big)
        if torch.equal(nxt, lab):
            break
        lab = nxt
    return torch.where(mask, lab, 0).to(torch.int32)


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Voxel count per label id (flat, length = numel + 2)."""
    flat = labels.reshape(-1).long()
    return torch.bincount(flat[flat > 0], minlength=labels.numel() + 2).to(torch.int32)


def largest_component(mask: torch.Tensor, max_iter: int = 64, impl: str = "auto") -> torch.Tensor:
    """Keep only the largest connected component of ``mask`` (bool out, on
    the mask's device); ties go to the component met first in scan order.

    ``impl``: ``'native'`` (host union-find; 2D masks as depth-1 volumes,
    where 6-connectivity is 4-connectivity), ``'device'`` (label propagation
    in torch), or ``'auto'``: native for 2D and 3D masks. As in the JAX
    twin, the device form of an empty mask returns all True (every voxel
    carries the background label that wins the empty size table), the
    native form all False.
    """
    if impl == "auto":
        impl = "native" if mask.ndim in (2, 3) else "device"
    if impl == "native":
        from vittf_tpu_torch.native import cc3d_largest

        host = mask.to(torch.uint8).cpu().numpy()
        keep = cc3d_largest(host[None] if host.ndim == 2 else host)
        return torch.from_numpy(keep.reshape(host.shape)).to(mask.device)
    if impl != "device":
        raise ValueError(f"unknown largest_component impl: {impl}")
    labels = connected_components(mask, max_iter=max_iter)
    sizes = component_sizes(labels)
    sizes[0] = 0  # background does not compete
    return labels == torch.argmax(sizes)


def filter_similarity_largest_island(sim_u8: torch.Tensor, threshold: int = 69,
                                     max_iter: int = 64, impl: str = "auto") -> torch.Tensor:
    """Threshold a uint8 similarity map, keep the largest island, zero the
    rest (semantics of tests/test_connected_components.py:26-61)."""
    keep = largest_component(sim_u8 > threshold, max_iter=max_iter, impl=impl)
    return torch.where(keep, sim_u8, torch.zeros_like(sim_u8)).to(torch.uint8)
