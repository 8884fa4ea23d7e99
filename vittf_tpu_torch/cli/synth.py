"""Synthetic volume CLI — the reference ``create_synthetic_volumes.py``.

    python -m vittf_tpu_torch.cli.synth OUTDIR [--size 128] [--noise 0.0] [--torch] [--cpu]

Port of ``vittf_tpu/cli/synth.py``. The volumes are evaluated on the first
CUDA device, which must be visible unless ``--cpu`` is given. The noise is
``np.random.default_rng(0)``'s (``core/synthetic.py``).
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser
from pathlib import Path


def build_parser() -> ArgumentParser:
    p = ArgumentParser("Create synthetic SDF sphere/torus volumes + labels")
    p.add_argument("outdir", type=Path)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--torch", action="store_true", help="Save as .pt files")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from vittf_tpu_torch.cli.infer import select_device
    from vittf_tpu_torch.core.synthetic import write_synthetic_volumes

    written = write_synthetic_volumes(args.outdir, size=args.size, noise=args.noise,
                                      use_pt=args.torch, device=select_device(args.cpu))
    for w in written:
        print(w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
