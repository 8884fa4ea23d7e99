"""Feature-extraction CLI — the reference ``infer.py`` command surface.

    python -m vittf_tpu_torch.cli.infer --data-path volume.npy --slice-along all

Port of ``vittf_tpu/cli/infer.py`` with the same flags. It runs on the
first CUDA device and raises when none is visible, unless ``--cpu`` is
given. ``--weights`` takes a DINO ``.pth`` or the JAX package's flat
``.npz``; with no weights, random weights are drawn exactly as the JAX CLI
draws them (``PRNGKey(0)``), so both CLIs extract the same features.
``--block-impl fused`` runs every non-final ViT block through the fused
block kernel (bf16); ``--streamed`` keeps the volume in host memory and
sends it to the device in chunks. The dispatch is the JAX CLI's:
``--streamed`` first, then ``--data-parallel`` over the ranks of a process
group when there is more than one (``parallel.extract_features_sharded``:
slice batches split over the ranks, one all-reduce), the plain path
otherwise; so ``--data-parallel`` with one rank (no process group, or a
group of one) writes the plain artifact. Several ranks come from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``; NCCL on the cards, a card a rank by ``LOCAL_RANK``; gloo
with ``--cpu``), and only rank 0 writes the artifact:

    torchrun --nproc_per_node 1 -m vittf_tpu_torch.cli.infer --data-path v.npy --data-parallel
"""
from __future__ import annotations

import os
import sys
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

DINO_ARCH_NAMES = ["vits16", "vits8", "vitb16", "vitb8"]
DINO2_ARCH_NAMES = ["vits14", "vitb14", "vitl14", "vitg14", "vitg14_reg"]
DINO3_ARCH_NAMES = ["vit7b16"]


def handle_output_path(args, model_name: str) -> Path:
    """Cache-path construction + overwrite guard (infer.py:266-288)."""
    data_path = Path(args.data_path)
    if not args.cache_path:
        args.cache_path = (
            data_path.parent
            / f"{data_path.stem}_{model_name}_{args.slice_along}_features"
            f"{args.feature_output_size}{data_path.suffix}"
        )
    cache_path = Path(args.cache_path)
    if cache_path.exists() and not args.overwrite:
        print(f"Cache file already exists: {cache_path}. Use --overwrite to overwrite.")
        sys.exit(1)
    return cache_path


def build_parser() -> ArgumentParser:
    p = ArgumentParser("Infer DINO features from saved volume")
    p.add_argument("--data-path", type=str, required=True)
    p.add_argument("--cache-path", type=str, default=None)
    p.add_argument("--dino-model", type=str, choices=DINO_ARCH_NAMES, default=None)
    p.add_argument("--dino2-model", type=str, choices=DINO2_ARCH_NAMES, default=None)
    p.add_argument("--dino3-model", type=str, choices=DINO3_ARCH_NAMES, default=None,
                   help="DINOv3 (axial RoPE, head dim 128; per-op blocks only)")
    p.add_argument("--weights", type=str, default=None,
                   help="Path to a DINO checkpoint (.pth) or converted params (.npz)")
    p.add_argument("--slice-along", type=str, choices=["x", "y", "z", "all"], default="all")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--feature-output-size", type=int, default=64)
    p.add_argument("--return-keys", type=str, nargs="+", default=["k"],
                   choices=["q", "k", "v"])
    p.add_argument("--precision", type=str, default="default",
                   choices=["default", "highest"])
    p.add_argument("--compute-dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--block-impl", type=str, default="xla",
                   choices=["xla", "fused", "fused_rows"],
                   help="'fused' = the fused transformer-block kernel for every "
                        "non-final block (bf16 only; fp32 keeps the per-op "
                        "blocks; no softmax row max); 'fused_rows' = the same "
                        "kernel with the row max, named after the TPU's "
                        "row-grid variant (ExtractConfig's 'fused_max')")
    p.add_argument("--fast", action="store_true",
                   help="Slice-subsample fast mode: run the ViT only on "
                        "the slices nearest the pooled output grid; NOT "
                        "artifact-parity with the full sweep")
    p.add_argument("--streamed", action="store_true",
                   help="Host-streamed extraction: the volume stays in host "
                        "memory and slice chunks go to the device one at a "
                        "time (implies --preserve-dtype)")
    p.add_argument("--chunk-batches", type=int, default=8,
                   help="slice batches per device-resident chunk for --streamed")
    p.add_argument("--preserve-dtype", action="store_true",
                   help="Keep compact volume dtypes (uint8, int16, fp16) on "
                        "the device instead of casting to fp32 (bit-identical "
                        "features)")
    p.add_argument("--feature-dtype", type=str, default="float16",
                   choices=["float16", "float32", "uint8"],
                   help="artifact storage dtype; uint8 = per-channel "
                        "quantized compact artifact")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard slice batches over the ranks of a process group "
                        "(torchrun); one rank: the plain path")
    p.add_argument("--overwrite", action="store_true")
    return p


def select_device(cpu: bool, local_rank: int = 0) -> torch.device:
    """``cpu`` or CUDA device ``local_rank``; no silent fallback to the CPU."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --cpu to run on the CPU")
    return torch.device("cuda", local_rank)


def load_params(args, cfg) -> dict[str, torch.Tensor]:
    from vittf_tpu_torch.models.dino import load_dino_checkpoint, params_from_jax
    from vittf_tpu_torch.models.serialization import load_params_npz
    from vittf_tpu_torch.models.vit import init_vit_params

    if args.weights:
        wp = Path(args.weights)
        if wp.suffix == ".npz":
            return params_from_jax(load_params_npz(wp))
        return load_dino_checkpoint(wp, cfg)
    print(
        "WARNING: no --weights given; using random initialization "
        "(features are not DINO features)."
    )
    return init_vit_params(cfg, (0, 0))


def world_size() -> int:
    """The ranks of the default process group, or of the one ``torchrun``'s
    environment describes; 1 without either."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def join_process_group(cpu: bool) -> None:
    """The default process group from ``torchrun``'s environment (gloo with
    ``--cpu``, NCCL on the cards), unless one exists."""
    dist = torch.distributed
    if not dist.is_initialized():
        dist.init_process_group("gloo" if cpu else "nccl")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    sharded = args.data_parallel and not args.streamed and world_size() > 1
    device = select_device(args.cpu, int(os.environ.get("LOCAL_RANK", 0)) if sharded else 0)
    if sharded:
        join_process_group(args.cpu)

    from vittf_tpu_torch.core.io import load_volume, save_features
    from vittf_tpu_torch.models.dino import resolve_model
    from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features

    cfg = resolve_model(args.dino_model, args.dino2_model, args.dino3_model)
    cache_path = handle_output_path(args, cfg.name)
    # streaming is for volumes past device comfort: keep them compact on the
    # host too (bit-identical features)
    vol = load_volume(args.data_path, preserve_dtype=args.preserve_dtype or args.streamed)
    print(f"Loaded volume: {vol.shape} {vol.dtype}")

    params = load_params(args, cfg)
    if args.precision == "highest":
        args.compute_dtype = "float32"
    ex_cfg = ExtractConfig(
        feature_output_size=args.feature_output_size,
        slice_along=args.slice_along,
        batch_size=args.batch_size,
        return_keys=tuple(args.return_keys),
        precision=args.precision,
        compute_dtype=args.compute_dtype,
        block_impl=args.block_impl,
        slice_subsample=args.fast,
    )
    t0 = time.time()
    if args.streamed:
        from vittf_tpu_torch.pipeline.streamed import extract_features_streamed

        qkv = extract_features_streamed(
            vol, params, cfg, ex_cfg, chunk_batches=args.chunk_batches, device=device
        )
    elif sharded:
        from vittf_tpu_torch.parallel.extract import extract_features_sharded
        from vittf_tpu_torch.parallel.mesh import make_mesh

        qkv = extract_features_sharded(vol, params, cfg, ex_cfg, make_mesh(), device=device)
    else:
        qkv = extract_features(vol, params, cfg, ex_cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if sharded and torch.distributed.get_rank() != 0:
        return 0  # every rank holds the result; rank 0 writes it
    print(
        f"Computed qkv along {args.slice_along} in {time.time() - t0}s, "
        f"saving now to: {cache_path}"
    )
    dtype = {"float16": np.float16, "float32": np.float32, "uint8": "uint8"}[
        args.feature_dtype
    ]
    save_features(cache_path, qkv, dtype=dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
