"""Device mesh construction and the tensor-parallel ViT.

Port of ``vittf_tpu/parallel/mesh.py`` on ``torch.distributed``. The mesh is
a (dcn, data, model) ``DeviceMesh`` over ranks 0.. of the default process
group (``torch.distributed.init_process_group`` first; one process a
device):

- ``data``  — data parallelism over slice batches in extraction and over
              the voxel axis in similarity (``parallel/extract.py``);
- ``model`` — tensor parallelism over attention heads and the MLP hidden
              width (Megatron's column → row split);
- ``dcn``   — the outer level; ranks along it hold replicas.

Where GSPMD reshards the JAX package's contiguously split qkv kernel around
the DINO (3, heads, hd) reshape, the port splits the qkv projection by head
within each of q, k and v, so each rank holds whole heads and runs attention
on them locally (``tp_vit_forward``); the row-split products (proj, fc2) are
summed by an all-reduce over ``model`` and their biases added once after it.
"""
from __future__ import annotations

import types

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from vittf_tpu_torch.models.vit import ViTConfig, _layer_norm, embed_tokens
from vittf_tpu_torch.ops.attention import multi_head_attention

# each block's split: 'column_heads' splits dim 0 by head within each of q,
# k and v; 'column' splits dim 0; 'row_heads' / 'row' split dim 1 (the
# input of the row-parallel product); the rest is replicated
_BLOCK_SPLITS = {
    "attn.qkv.weight": "column_heads", "attn.qkv.bias": "column_heads",
    "attn.proj.weight": "row_heads",
    "mlp.fc1.weight": "column", "mlp.fc1.bias": "column",
    "mlp.fc2.weight": "row",
}


def make_mesh(data: int | None = None, model: int = 1, dcn: int = 1) -> DeviceMesh:
    """Build a (dcn, data, model) mesh over ranks 0 .. dcn·data·model − 1 of
    the default process group ('cuda' devices under NCCL, 'cpu' otherwise).
    ``data`` defaults to the world size over model·dcn."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if data is None:
        data = n // (model * dcn)
    want = dcn * data * model
    if want > n:
        raise ValueError(f"Mesh {dcn}x{data}x{model} needs {want} devices, have {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(want).reshape(dcn, data, model),
                      mesh_dim_names=("dcn", "data", "model"))


def vit_param_shardings(params: dict, mesh: DeviceMesh) -> dict[str, str]:
    """The tensor-parallel split of every ViT ``state_dict`` entry over the
    ``model`` axis: 'column_heads' (qkv weight and bias: dim 0, by head
    within each of q, k, v), 'column' (fc1 weight and bias: dim 0),
    'row_heads' (proj weight: dim 1, by head), 'row' (fc2 weight: dim 1) and
    'replicate' (everything else, the proj and fc2 biases too: they are added
    once, after the all-reduce). With ``model=1`` every split is the whole
    tensor."""
    out = {}
    for name in params:
        parts = name.split(".")
        split = _BLOCK_SPLITS.get(".".join(parts[2:])) if parts[0] == "blocks" else None
        out[name] = split or "replicate"
    return out


def _local(t: torch.Tensor, split: str, m: int, r: int) -> torch.Tensor:
    if split == "replicate" or m == 1:
        return t
    if split == "column_heads":  # dim 0 is q | k | v: rank r's rows of each
        return torch.cat([part.chunk(m, 0)[r] for part in t.chunk(3, 0)]).contiguous()
    dim = 0 if split == "column" else 1
    if t.shape[dim] % m:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {m} ranks")
    return t.chunk(m, dim)[r].contiguous()


def shard_params(params: dict, mesh: DeviceMesh) -> dict[str, torch.Tensor]:
    """This rank's shards of ``params`` (a hub-layout ``state_dict``) under
    ``vit_param_shardings``, at its coordinate on the ``model`` axis."""
    m, r = mesh.size(2), mesh.get_local_rank("model")
    splits = vit_param_shardings(params, mesh)
    return {name: _local(t, splits[name], m, r) for name, t in params.items()}


def _ln(params: dict, prefix: str):
    return types.SimpleNamespace(weight=params[f"{prefix}.weight"],
                                 bias=params[f"{prefix}.bias"], eps=1e-6)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def _gather_heads(qkv: torch.Tensor, group, heads_local: int) -> torch.Tensor:
    """Every rank's (B, N, 3·D/m) whole-head qkv → the full (B, N, 3D) in
    the DINO (3, heads, hd) layout."""
    m = dist.get_world_size(group)
    if m == 1:
        return qkv
    B, N, w = qkv.shape
    parts = [torch.empty_like(qkv) for _ in range(m)]
    dist.all_gather(parts, qkv.contiguous(), group=group)
    hd = w // (3 * heads_local)
    parts = [p.view(B, N, 3, heads_local, hd) for p in parts]
    return torch.cat(parts, dim=3).reshape(B, N, 3 * m * heads_local * hd)


def _tp_block(x, p, b, heads_local, precision, attn_impl, group, capture):
    """One pre-LN block with its heads and hidden width split over
    ``group``: ``models.vit.Block`` with the two row products all-reduced
    before their biases."""
    qkv = F.linear(_layer_norm(x, _ln(p, f"{b}.norm1")), p[f"{b}.attn.qkv.weight"],
                   p[f"{b}.attn.qkv.bias"])
    a = multi_head_attention(qkv, heads_local, attn_impl)
    a = _all_reduce(F.linear(a, p[f"{b}.attn.proj.weight"]), group) + p[f"{b}.attn.proj.bias"]
    if f"{b}.ls1.gamma" in p:
        a = a * p[f"{b}.ls1.gamma"]
    x = x + a
    y = F.linear(_layer_norm(x, _ln(p, f"{b}.norm2")), p[f"{b}.mlp.fc1.weight"],
                 p[f"{b}.mlp.fc1.bias"])
    y = F.gelu(y, approximate="none" if precision == "highest" else "tanh")
    y = _all_reduce(F.linear(y, p[f"{b}.mlp.fc2.weight"]), group) + p[f"{b}.mlp.fc2.bias"]
    if f"{b}.ls2.gamma" in p:
        y = y * p[f"{b}.ls2.gamma"]
    x = x + y
    if capture == "qkv":
        return x, _gather_heads(qkv, group, heads_local)
    return x, (y if capture == "mlp" else None)


@torch.no_grad()
def tp_vit_forward(
    local_params: dict,
    images: torch.Tensor,
    cfg: ViTConfig,
    mesh: DeviceMesh,
    precision: str = "default",
    attn_impl: str = "auto",
    return_qkv_last: bool = True,
    capture: str = "qkv",
):
    """``VisionTransformer.forward_raw`` with this rank's ``shard_params``
    shards: heads and the MLP width split over the mesh's ``model`` axis,
    the embed, LayerNorms and residuals replicated. Returns (tokens (B, 1+hw,
    D), the last block's full capture) on every rank. The MLP's split is
    fc1's columns and fc2's rows: a SwiGLU FFN raises ``ValueError``."""
    if cfg.ffn != "mlp":
        raise ValueError(f"the tensor-parallel block splits a GELU MLP; {cfg.name} has a "
                         f"{cfg.ffn} FFN")
    m = mesh.size(2)
    if cfg.num_heads % m:
        raise ValueError(f"{cfg.num_heads} heads do not split over {m} model ranks")
    group = mesh.get_group("model")
    p = local_params
    x = embed_tokens(images, p["patch_embed.proj.weight"], p["patch_embed.proj.bias"],
                     p["cls_token"], p["pos_embed"], p.get("register_tokens"),
                     cfg.interpolate_offset, cfg.interpolate_antialias)
    qkv_last = None
    for i in range(cfg.depth):
        want = capture if (return_qkv_last and i == cfg.depth - 1) else None
        x, cap = _tp_block(x, p, f"blocks.{i}", cfg.num_heads // m, precision, attn_impl,
                           group, want)
        if cap is not None:
            qkv_last = cap
    return _layer_norm(x, _ln(p, "norm")), qkv_last
