"""Data-parallel feature extraction and similarity over a mesh's ``data`` axis.

Port of ``vittf_tpu/parallel/extract.py`` on ``torch.distributed``:

- extraction: the slice batches of each sweep are split over the ranks of
  ``data``; each rank runs the resident path's batch loop
  (``pipeline.features._accumulate``: the ViT and the pooled accumulation,
  the kernels on a CUDA device) over its share, and one all-reduce (SUM) of
  each sweep's fp32 pooled accumulators combines them (JAX's cubic 'all'
  sweep makes one psum for the three axes; the sums are the same). Exact
  up to summation order, because the slice-axis adaptive pool is a linear
  sum over slices (infer.py:332's sum becomes the all-reduce); with one
  rank it is the resident path bit for bit;
- similarity: the flattened voxel axis is split over ``data`` (queries
  replicated), no collective but the gather that gives every rank the whole
  (N, C) map, as the JAX package's global array does.

Ranks along ``model`` and ``dcn`` hold replicas and compute the same.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vittf_tpu_torch.models.vit import ViTConfig
from vittf_tpu_torch.pipeline.features import ExtractConfig, _extract
from vittf_tpu_torch.utils.tensor import resolve_device


def _data_axis(mesh: DeviceMesh) -> tuple[int, int, object]:
    """(ranks along ``data``, this rank's index there, its group)."""
    return mesh.size(1), mesh.get_local_rank("data"), mesh.get_group("data")


def _all_reduce_flat(accs: list[torch.Tensor], group) -> None:
    """One SUM all-reduce over every accumulator (a flat copy when there are
    several), in place."""
    if dist.get_world_size(group) == 1:
        return  # the identity
    if len(accs) == 1:
        dist.all_reduce(accs[0], group=group)
        return
    flat = torch.cat([a.reshape(-1) for a in accs])
    dist.all_reduce(flat, group=group)
    off = 0
    for a in accs:
        a.view(-1).copy_(flat[off:off + a.numel()])
        off += a.numel()


def _rank_device(device) -> torch.device:
    """``device``; else this rank's card: ``cuda:LOCAL_RANK`` under a
    launcher that sets it (``torchrun``), the first card in a world of one.
    Raises when neither tells which card is this rank's."""
    if device is not None or dist.get_world_size() == 1:
        return resolve_device(device)
    if "LOCAL_RANK" not in os.environ:
        raise ValueError("several ranks and no LOCAL_RANK: pass this rank's device")
    resolve_device(None)  # raises when no card is visible
    return torch.device("cuda", int(os.environ["LOCAL_RANK"]))


def extract_features_sharded(
    vol,
    params: dict,
    model_cfg: ViTConfig,
    cfg: ExtractConfig,
    mesh: DeviceMesh,
    device=None,
) -> dict[str, torch.Tensor]:
    """Data-parallel ``extract_features`` over ``mesh``'s ``data`` axis, on
    ``device`` (None: this rank's card, ``_rank_device``). Every rank
    returns the whole result."""
    ndata, rank, group = _data_axis(mesh)

    def select(n_batches):
        # a contiguous share of ⌈n / ranks⌉ batches; JAX pads the batch axis
        # to a multiple of the ranks with batches of zero pool weight, which
        # add nothing, and a rank here skips them instead
        per = -(-n_batches // ndata)
        return range(rank * per, min((rank + 1) * per, n_batches))

    return _extract(vol, params, model_cfg, cfg, _rank_device(device), select,
                    lambda acc: _all_reduce_flat(acc, group))


def similarity_sharded(
    feats_flat: torch.Tensor,
    queries: torch.Tensor,
    class_mat: torch.Tensor,
    mesh: DeviceMesh,
    threshold: float = 0.25,
    exponent: float = 2.5,
    mean_first: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Voxel-sharded fused similarity: rank r of ``data`` scores rows
    [r·n, (r+1)·n) of the (N, F) features (n = ⌈N / ranks⌉), every rank
    returns the whole (N, C) map. ``impl``: 'auto' (the similarity kernel
    on a CUDA device, its plain twin on the CPU) | 'plain'."""
    from vittf_tpu_torch.ops.similarity import similarity, similarity_plain

    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown similarity impl: {impl!r}")
    fn = similarity if impl == "auto" else similarity_plain
    ndata, rank, group = _data_axis(mesh)
    N = feats_flat.shape[0]
    n = -(-N // ndata)
    local = fn(feats_flat[rank * n:(rank + 1) * n], queries, class_mat, threshold, exponent,
               mean_first)
    if ndata == 1:
        return local
    piece = local.new_zeros((n, local.shape[1]))  # the last rank's rows padded
    piece[:local.shape[0]] = local
    parts = [torch.empty_like(piece) for _ in range(ndata)]
    dist.all_gather(parts, piece, group=group)
    return torch.cat(parts)[:N]
