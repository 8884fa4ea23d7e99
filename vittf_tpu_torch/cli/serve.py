"""Interactive serving CLI: the artifact-contract loop any frontend can use.

    python -m vittf_tpu_torch.cli.serve --data DIR [--bilateral-solver] [--cpu]

Port of ``vittf_tpu/cli/serve.py``. Loads the feature volume once onto the
first CUDA device (``--cpu`` for the CPU), then watches ``annotations.npy``
in the data directory; every change is answered by rewriting
``similarities.npy`` and ``predictions.npy``, the contract the reference's
GUI module speaks (SURVEY.md §3.5).
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    p = ArgumentParser("Serve interactive similarity over the artifact contract")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--bilateral-solver", action="store_true")
    p.add_argument("--impl", type=str, default="auto", choices=["auto", "plain"],
                   help="'auto': the CUDA kernels on the GPU; 'plain': their plain twins")
    p.add_argument("--poll-interval", type=float, default=0.25)
    p.add_argument("--max-updates", type=int, default=None,
                   help="Exit after N updates (default: run forever)")
    p.add_argument("--no-prewarm", action="store_true",
                   help="Skip the startup warm-up (the first real user edit then "
                        "pays the kernel build and the first allocations)")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from vittf_tpu_torch.cli.infer import select_device
    from vittf_tpu_torch.pipeline.session import InteractiveSession, watch_directory

    session = InteractiveSession.from_artifacts(
        args.data, bilateral_solver=args.bilateral_solver, impl=args.impl,
        device=select_device(args.cpu),
    )
    if not args.no_prewarm:
        t = session.prewarm()
        print(f"Warmed up in {t:.1f}s (first user edit runs at steady-state latency)")
    print(f"Serving {args.data}: features {tuple(session.features.shape)} on "
          f"{session.device}; watching annotations.npy")
    watch_directory(
        args.data, session,
        poll_interval=args.poll_interval, max_updates=args.max_updates,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
