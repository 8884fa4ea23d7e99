"""Weight conversion CLI: torch DINO/DINOv2/visual-encoder checkpoints → the
flat-npz parameter format of both packages.

    python -m vittf_tpu_torch.cli.convert_weights dino_deitsmall8.pth out.npz \
        --arch vits8

Port of ``vittf_tpu/cli/convert_weights.py``. The ``.npz`` holds the JAX
package's parameter layout (``models.dino.params_to_jax``), so
``vittf_tpu.models.serialization.load_params_npz`` reads it and ``infer
--weights out.npz`` of either package takes it. A file conversion on the
host: it touches no device.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser


def main(argv=None) -> int:
    p = ArgumentParser("Convert a torch ViT checkpoint to flat-npz params")
    p.add_argument("checkpoint", type=str)
    p.add_argument("output", type=str, help="Output .npz path")
    p.add_argument("--arch", type=str, default="vits8",
                   help="Architecture name (vits8/vitb16/vits14/... or "
                        "blip_vitb16/clip_vitl14)")
    p.add_argument("--visual-encoder", action="store_true",
                   help="Strip a visual_encoder.* prefix (LAVIS BLIP/CLIP)")
    args = p.parse_args(argv)

    from vittf_tpu_torch.models.clip import CLIP_ARCHS, load_visual_checkpoint
    from vittf_tpu_torch.models.dino import ALL_ARCHS, load_dino_checkpoint, params_to_jax
    from vittf_tpu_torch.models.serialization import save_params_npz

    if args.arch in CLIP_ARCHS or args.visual_encoder:
        cfg = CLIP_ARCHS.get(args.arch) or ALL_ARCHS[args.arch]
        sd = load_visual_checkpoint(args.checkpoint, cfg)
    else:
        cfg = ALL_ARCHS[args.arch]
        sd = load_dino_checkpoint(args.checkpoint, cfg)
    out = save_params_npz(args.output, params_to_jax(sd))
    print(f"Wrote {out} ({cfg.name}: depth={cfg.depth}, dim={cfg.embed_dim})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
