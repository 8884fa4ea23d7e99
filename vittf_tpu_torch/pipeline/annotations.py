"""Annotation samplers: synthetic annotations drawn from ground-truth masks.

Port of ``vittf_tpu/pipeline/annotations.py`` (reference
compare_feat_sampling.py:13-33):
- ``sample_uniform``: uniform without-replacement draw over mask voxels,
  with the >2²⁴ stride-2 thinning rule
- ``sample_surface``: voxels on a shell obtained by double binary erosion
  (connectivity ``dist_from_surface`` then 1), XOR
- ``sample_both``: half uniform + half surface

Two implementations, equal by construction:

- ``impl='device'`` (default): the mask stays on its device. ``np.argwhere``
  lists voxels in C order, so the k-th listed voxel is the voxel of rank k
  in the mask's flat cumulative count; one cumsum + searchsorted selects
  ranks without building the list.
- ``impl='host'``: the reference's shape, ``np.argwhere`` over the mask on
  the host, then ``rng.choice`` without replacement.

Both draw the same values from the numpy ``Generator`` in the same order
(as the JAX package does), so every path of both packages returns the same
coordinates for the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

from vittf_tpu_torch.ops.morphology import binary_erosion, generate_binary_structure
from vittf_tpu_torch.utils.tensor import resolve_device

# reference compare_feat_sampling.py:15-16 thins >2^24-voxel masks by striding
THIN_LIMIT = 2**24


def _default_rng(rng):
    return rng if rng is not None else np.random.default_rng()


def _host(mask) -> np.ndarray:
    return mask.cpu().numpy() if torch.is_tensor(mask) else np.asarray(mask)


def _check_impl(impl: str) -> None:
    if impl not in ("device", "host"):
        raise ValueError(f"unknown impl {impl!r}: 'device' or 'host'")


def _select_ranks(mask: torch.Tensor, ranks: np.ndarray) -> np.ndarray:
    """Coords of the mask voxels with the given C-order ranks, (n, 3) int64."""
    cs = torch.cumsum(mask.reshape(-1).to(torch.int64), dim=0)
    r = torch.from_numpy(np.asarray(ranks, np.int64)).to(mask.device)
    pos = torch.searchsorted(cs, r, right=True)
    coords = torch.stack(torch.unravel_index(pos, tuple(mask.shape)), dim=-1)
    return coords.cpu().numpy().astype(np.int64).reshape(-1, mask.ndim)


def sample_uniform(
    mask: torch.Tensor,
    n_samples: int,
    thin_to_reasonable: bool = False,
    rng: np.random.Generator | None = None,
    impl: str = "device",
) -> np.ndarray:
    """(n, 3) voxel coords drawn uniformly without replacement."""
    rng = _default_rng(rng)
    _check_impl(impl)
    if impl == "host":
        idxs = np.argwhere(_host(mask))
        while thin_to_reasonable and idxs.shape[0] > THIN_LIMIT:
            idxs = idxs[::2]
        n = min(n_samples, idxs.shape[0])
        return idxs[rng.choice(idxs.shape[0], size=n, replace=False)]
    count = int(mask.sum())
    # idxs[::2] keeps ranks 0, 2, 4, …: t thinnings leave ceil-halved counts
    # and map thinned rank r back to original rank r·2^t
    stride = 1
    while thin_to_reasonable and count > THIN_LIMIT:
        count = (count + 1) // 2
        stride *= 2
    n = min(n_samples, count)
    sel = rng.choice(count, size=n, replace=False)
    return _select_ranks(mask, sel * stride)


def surface_shell(mask: torch.Tensor, dist_from_surface: int = 4) -> torch.Tensor:
    """Shell mask: erode(struct=conn d) XOR erode again (struct=conn 1)."""
    mask = torch.as_tensor(mask)
    outer = binary_erosion(mask, generate_binary_structure(3, dist_from_surface))
    inner = binary_erosion(outer, generate_binary_structure(3, 1))
    return inner ^ outer


def sample_surface(
    mask: torch.Tensor,
    n_samples: int,
    dist_from_surface: int = 4,
    rng: np.random.Generator | None = None,
    impl: str = "device",
) -> np.ndarray:
    """(n, 3) coords on the erosion shell; all shell voxels if the shell is
    smaller than ``n_samples`` (reference :26-30)."""
    rng = _default_rng(rng)
    _check_impl(impl)
    shell = surface_shell(mask, dist_from_surface)
    if impl == "host":
        surf = np.argwhere(_host(shell))
        if surf.shape[0] > n_samples:
            return surf[rng.choice(surf.shape[0], size=n_samples, replace=False)]
        return surf
    count = int(shell.sum())
    if count > n_samples:
        ranks = rng.choice(count, size=n_samples, replace=False)
    else:
        ranks = np.arange(count)
    return _select_ranks(shell, ranks)


def sample_both(
    mask: torch.Tensor,
    n_samples: int,
    dist_from_surface: int = 4,
    thin_to_reasonable: bool = False,
    rng: np.random.Generator | None = None,
    impl: str = "device",
) -> np.ndarray:
    """Half uniform, half surface (reference :32-33)."""
    rng = _default_rng(rng)
    return np.concatenate(
        [
            sample_uniform(mask, n_samples // 2, thin_to_reasonable, rng=rng, impl=impl),
            sample_surface(mask, n_samples // 2, dist_from_surface, rng=rng, impl=impl),
        ]
    )


SAMPLING_MODES = {
    "uniform": sample_uniform,
    "surface": sample_surface,
    "both": sample_both,
}


def annotations_from_labels(
    labels,
    num_samples: float,
    mode: str = "both",
    rng: np.random.Generator | None = None,
    device: str | torch.device | None = None,
    impl: str = "device",
) -> dict[str, np.ndarray]:
    """Draw per-class annotations from a GT label volume.

    Reference semantics (predict_ntf.py:157-172): ``num_samples > 1`` is an
    absolute count (capped at the class size); ``0 < num_samples ≤ 1`` a
    fraction of class voxels; classes with zero samples are skipped; keys
    are ``ntf{i}``. ``impl='device'``: the labels go to ``device`` (the
    first CUDA device when None) once; masks, shells and counts stay there.
    ``impl='host'``: numpy masks, and the samplers' host path.
    """
    rng = _default_rng(rng)
    _check_impl(impl)
    draw = SAMPLING_MODES[mode]
    if impl == "host":
        labels = _host(labels)
    else:
        if not torch.is_tensor(labels):
            labels = torch.from_numpy(np.ascontiguousarray(labels))
        labels = labels.to(resolve_device(device))
    n_classes = int(labels.max())
    out = {}
    for i in range(1, n_classes + 1):
        mask = labels == i
        size = int(mask.sum())
        if num_samples > 1.0:
            n = min(int(num_samples), size)
        elif num_samples > 0.0:
            n = int(num_samples * size)
        else:
            raise ValueError(f"Invalid num_samples: {num_samples}")
        if n > 0:
            kwargs = {"rng": rng, "impl": impl}
            if mode in ("uniform", "both"):
                kwargs["thin_to_reasonable"] = True
            out[f"ntf{i}"] = draw(mask, n, **kwargs)
    return out
