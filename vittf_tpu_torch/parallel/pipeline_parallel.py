"""Pipeline parallelism: GPipe-style staged ViT blocks over a ``pipe`` axis.

Port of ``vittf_tpu/parallel/pipeline_parallel.py`` on ``torch.distributed``.
Contiguous block ranges sit on successive ranks of a 1-D ``DeviceMesh`` whose
axis is named ``pipe``, and microbatches stream through them on the JAX
twin's schedule: M + P − 1 ticks; at tick t the first stage takes
microbatch t (while t < M), every stage applies its blocks, and the
activations move one hop along the ring (a send to stage + 1 and a receive
from stage − 1, the ``ppermute``); the last stage finishes microbatch
t − (P − 1) at tick t, and its outputs (with the last block's qkv capture)
are broadcast from it to every stage. The bubble is (P − 1)/(M + P − 1).
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vittf_tpu_torch.models.vit import Block, ViTConfig, embed_tokens
from vittf_tpu_torch.ops.layer_norm import layer_norm_plain


def stack_block_params(params: dict, n_stages: int) -> dict[str, torch.Tensor]:
    """Stack the blocks' ``state_dict`` entries stage-major: {name within a
    block (e.g. 'attn.qkv.weight'): (n_stages, blocks_per_stage, ...)}. The
    depth must divide evenly."""
    depth = 1 + max(int(k.split(".")[1]) for k in params if k.startswith("blocks."))
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    per = depth // n_stages
    names = [k[len("blocks.0."):] for k in params if k.startswith("blocks.0.")]
    return {
        n: torch.stack([params[f"blocks.{i}.{n}"] for i in range(depth)])
        .reshape(n_stages, per, *params[f"blocks.0.{n}"].shape)
        for n in names
    }


@functools.lru_cache(maxsize=None)
def _block_skeleton(cfg: ViTConfig) -> Block:
    """A parameterless block for ``functional_call`` (meta device)."""
    with torch.device("meta"):
        return Block(cfg)


def _ring_shift(y: torch.Tensor, group, stage: int, n_stages: int) -> torch.Tensor:
    """Send ``y`` to the next stage and receive the previous stage's."""
    if n_stages == 1:
        return y
    buf = torch.empty_like(y)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
           dist.P2POp(dist.irecv, buf, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


@torch.no_grad()
def pp_vit_blocks(
    stacked_blocks: dict,
    x_micro: torch.Tensor,
    cfg: ViTConfig,
    mesh: DeviceMesh,
    n_micro: int,
    precision: str = "default",
    attn_impl: str = "plain",
):
    """Run the transformer blocks pipeline-parallel over the mesh's ``pipe``
    axis; each rank applies the blocks of its stage (``stacked_blocks[stage]``).
    ``x_micro``: (M, B_mb, N, D) token activations, the same on every rank.
    Returns (x_out (M, B_mb, N, D), qkv_last (M, B_mb, N, 3D)) on every rank:
    the blocks applied in sequence, up to fp reordering."""
    group = mesh.get_group("pipe")
    n_stages, stage = mesh.size(0), mesh.get_local_rank("pipe")
    blk = _block_skeleton(cfg)
    per = next(iter(stacked_blocks.values())).shape[1]
    local = [{n: t[stage, i] for n, t in stacked_blocks.items()} for i in range(per)]

    def apply_stage(x):
        # every stage captures its chunk's final qkv; only the last stage's
        # is kept
        qkv = None
        for i, p in enumerate(local):
            x, cap = torch.func.functional_call(
                blk, p, (x, precision, attn_impl, "qkv" if i == per - 1 else None))
            if cap is not None:
                qkv = cap
        return x, qkv

    M = x_micro.shape[0]
    x_out = torch.zeros_like(x_micro)
    qkv_out = x_micro.new_zeros(x_micro.shape[:-1] + (3 * cfg.embed_dim,))
    buf = torch.zeros_like(x_micro[0])
    for t in range(M + n_stages - 1):
        x_in = x_micro[t] if stage == 0 and t < M else buf
        y, qkv = apply_stage(x_in)
        mb_done = t - (n_stages - 1)  # the last stage finishes this one now
        if stage == n_stages - 1 and 0 <= mb_done < M:
            x_out[mb_done] = y
            qkv_out[mb_done] = qkv
        buf = _ring_shift(y, group, stage, n_stages)
    if n_stages > 1:
        last = dist.get_global_rank(group, n_stages - 1)
        dist.broadcast(x_out, last, group=group)
        dist.broadcast(qkv_out, last, group=group)
    return x_out, qkv_out


@torch.no_grad()
def pp_vit_forward(
    params: dict,
    images: torch.Tensor,
    cfg: ViTConfig,
    mesh: DeviceMesh,
    n_micro: int = 4,
    precision: str = "default",
    attn_impl: str = "plain",
):
    """Full ViT forward with pipeline-parallel blocks: the patch and position
    embeds and the final LayerNorm run replicated, the block stack streams
    through the pipe. The batch must divide into ``n_micro`` microbatches.
    Returns (tokens, qkv_last) as ``VisionTransformer.forward_raw``. A RoPE
    model (DINOv3) raises ``ValueError``: the stages take no RoPE table."""
    if cfg.position != "learned":
        raise ValueError(f"the pipeline-parallel forward adds a learned position table; "
                         f"{cfg.name} has {cfg.position} positions")
    B = images.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} microbatches")
    x = embed_tokens(images, params["patch_embed.proj.weight"], params["patch_embed.proj.bias"],
                     params["cls_token"], params["pos_embed"], params.get("register_tokens"),
                     cfg.interpolate_offset, cfg.interpolate_antialias)
    x_micro = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    stacked = stack_block_params(params, mesh.size(0))
    x_out, qkv_out = pp_vit_blocks(stacked, x_micro, cfg, mesh, n_micro, precision, attn_impl)
    x_out = x_out.reshape(B, *x_out.shape[2:])
    qkv_out = qkv_out.reshape(B, *qkv_out.shape[2:])
    return layer_norm_plain(x_out, params["norm.weight"], params["norm.bias"]), qkv_out
